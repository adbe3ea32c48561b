"""The corpus on the device, batch fetch, and the classifier train step.

Port of ``voicemap_tpu/train/steps.py``: ``DeviceStore``,
``device_store_for``, ``fetch_batch``, ``resolve_fused_block0``,
``resolve_blockn``, ``classifier_loss_fn`` and ``make_classifier_train_step``.
One step samples utterance ids, gathers and whitens their fragments (B1),
runs the train forward (``models/fused_train``: B4 for block 0, cuDNN convs
and B7 for blocks 1+), the softmax cross-entropy, the backward (B7's
routing, cuDNN's dX and dW, B5 for block 0) and the clipped Adam update,
all on the device. ``train_on_batch`` is the step after sampling, for a
batch the caller gives. The siamese and streaming steps are not ported yet.

The port has one preprocessing path, the fused one: the store is decimated
once when it is shipped, and every batch goes through the B1 gather+whiten
(``ops/cuda_preprocess``). Lengths and offsets are in decimated units, as on
the JAX package's Pallas path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..config import ExperimentConfig
from ..data.store import AudioStore
from ..models import fused_train
from ..models.classifier import SpeakerClassifier
from ..ops import preprocess, sampling
from ..ops.cuda_preprocess import decimate_store, gather_whiten
from . import losses
from .state import TrainState, apply_updates


@dataclass
class DeviceStore:
    """An :class:`AudioStore` on a device, decimated by ``downsampling``."""

    audio: torch.Tensor  # (N, ceil(T_store / ds)) int16
    lengths: torch.Tensor  # (N,) int32, decimated units
    labels: torch.Tensor  # (N,) int32
    speaker_utts: torch.Tensor  # (S, max_utt) int32
    speaker_counts: torch.Tensor  # (S,) int32
    downsampling: int

    @classmethod
    def from_host(cls, store: AudioStore, device, downsampling: int,
                  min_length: int = 0) -> "DeviceStore":
        """Ship the corpus to ``device`` and decimate it there, once.

        ``min_length`` zero-pads rows to at least this many raw samples.
        """
        audio = torch.from_numpy(store.audio).to(device)
        if audio.shape[1] < min_length:
            audio = F.pad(audio, (0, min_length - audio.shape[1]))
        put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        return cls(
            audio=decimate_store(audio, downsampling),
            lengths=put(store.lengths) // downsampling,
            labels=put(store.labels),
            speaker_utts=put(store.speaker_utts),
            speaker_counts=put(store.speaker_counts),
            downsampling=int(downsampling),
        )


def device_store_for(cfg: ExperimentConfig, audio_store: AudioStore,
                     device) -> DeviceStore:
    """The :class:`DeviceStore` that ``fetch_batch`` needs for this config."""
    return DeviceStore.from_host(audio_store, device, cfg.data.downsampling,
                                 min_length=cfg.data.fragment_length)


def fetch_batch(store: DeviceStore, indices: torch.Tensor, cfg: ExperimentConfig,
                generator: Optional[torch.Generator] = None,
                stochastic: bool = True) -> torch.Tensor:
    """Utterance ids ``(B,)`` → preprocessed model inputs ``(B, T_model, 1)`` f32."""
    d = cfg.data
    if store.downsampling != d.downsampling:
        raise ValueError(
            f"store decimated by {store.downsampling} but config expects "
            f"downsampling {d.downsampling}")
    t_out = d.model_length
    indices = indices.to(device=store.audio.device, dtype=torch.int32).contiguous()
    offsets = preprocess.sample_offsets(store.lengths[indices.long()], t_out,
                                        generator, stochastic)
    out = gather_whiten(store.audio, indices, offsets.contiguous(), t_out,
                        d.whiten_rms, d.whiten_eps)
    return out[..., None]


# The largest share of the card's memory that one block's saved full-rate
# activation may take under the save-act fused blocks-1+ op. The JAX package
# allowed 3.5 GB on a 16 GB v5e (22%), with the save-act residuals of all
# blocks and the rest of the program beside it; the same share of the card.
# Its lower limit (the op lost to autodiff at small batch on the TPU) is not
# carried over: on the card the op runs wherever it fits, and the two
# policies' times at B=32 and B=2048 are in PERF.md.
_SAVE_ACT_LIMIT_SHARE = 0.22


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def resolve_fused_block0(cfg: ExperimentConfig, model) -> bool:
    """The block-0 op (B4/B5) for the classifier: None = auto, on for a model
    on the card (on the CPU its plain versions are slower than autograd)."""
    if not isinstance(model, SpeakerClassifier):
        return False
    flag = cfg.train.use_fused_block0
    if flag is None:
        return _device_of(model).type == "cuda"
    return bool(flag)


def resolve_blockn(cfg: ExperimentConfig, device) -> str:
    """How blocks 1+ train: ``"fused"`` (the save-act op with B7) or ``"jnp"``.

    None = auto: ``"fused"`` on the card whenever every block's bf16
    full-rate activation stays under ``_SAVE_ACT_LIMIT_SHARE`` of its memory,
    else ``"jnp"``; ``"jnp"`` on the CPU.
    """
    if cfg.train.quant_forward == "int8":
        raise NotImplementedError("the int8 training forward (fused_int8) is not ported")
    if cfg.train.quant_forward != "none":
        raise ValueError(f"TrainConfig.quant_forward must be 'none' or 'int8', "
                         f"got {cfg.train.quant_forward!r}")
    flag = cfg.train.use_fused_blockn
    if flag is not None:
        return "fused" if flag else "jnp"
    device = torch.device(device)
    if device.type != "cuda":
        return "jnp"
    e = cfg.encoder
    B = cfg.train.batch_size * (2 if cfg.mode == "siamese" else 1)
    t = cfg.data.model_length
    worst = 0
    for i, (mult, pool) in enumerate(zip(e.filter_multipliers, e.pool_sizes)):
        if i >= 1:
            worst = max(worst, B * t * e.filters * mult * 2)  # bf16 activation
        if pool > 1:
            t //= pool
    limit = _SAVE_ACT_LIMIT_SHARE * torch.cuda.get_device_properties(device).total_memory
    return "fused" if worst <= limit else "jnp"


def classifier_loss_fn(model: SpeakerClassifier, cfg: ExperimentConfig) -> Callable:
    """``loss_fn(x, y, generator) → (loss, accuracy)`` through the train
    forward with the policies this config resolves to (set as the function's
    ``fused_block0`` and ``blockn`` attributes)."""
    fused0 = resolve_fused_block0(cfg, model)
    blockn = resolve_blockn(cfg, _device_of(model))

    def loss_fn(x: torch.Tensor, y: torch.Tensor, generator: Optional[torch.Generator]):
        model.train()
        logits = fused_train.classifier_train_forward(model, x, generator, blockn, fused0)
        return losses.softmax_ce(logits, y), losses.categorical_accuracy(logits, y)

    loss_fn.fused_block0, loss_fn.blockn = fused0, blockn
    return loss_fn


def train_on_batch(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                   generator: Optional[torch.Generator], loss_fn: Callable):
    """One update on the batch ``(x (B, T, 1) f32, y (B,))`` → ``(state,
    {"loss", "accuracy"})``; the metrics are the forward's, before the update,
    as 0-d tensors on the device (no host sync)."""
    state.optimizer.zero_grad()
    loss, acc = loss_fn(x, y, generator)
    loss.backward()
    apply_updates(state)
    return state, {"loss": loss.detach(), "accuracy": acc}


def make_classifier_train_step(model: SpeakerClassifier, cfg: ExperimentConfig):
    """``(step, loss_fn)``; ``step(state, store, generator) → (state, metrics)``
    samples ``batch_size`` utterance ids, fetches their fragments and trains
    on them."""
    loss_fn = classifier_loss_fn(model, cfg)
    B = cfg.train.batch_size

    def step(state: TrainState, store: DeviceStore, generator: Optional[torch.Generator]):
        idx = sampling.sample_classifier_batch(generator, store.labels.shape[0], B,
                                               store.audio.device)
        x = fetch_batch(store, idx, cfg, generator, stochastic=cfg.data.stochastic)
        return train_on_batch(state, x, store.labels[idx], generator, loss_fn)

    return step, loss_fn
