"""The corpus on the device, batch fetch, and the classifier and siamese
train steps.

Port of ``voicemap_tpu/train/steps.py``: ``DeviceStore``,
``device_store_for``, ``fetch_batch``, ``resolve_fused_block0``,
``resolve_blockn``, ``classifier_loss_fn``, ``make_classifier_train_step``,
``siamese_loss_fn`` and ``make_siamese_train_step``. A classifier step
samples utterance ids, gathers and whitens their fragments (B1), runs the
train forward (``models/fused_train``: B4 for block 0, cuDNN convs and B7 for
blocks 1+), the softmax cross-entropy, the backward (B7's routing, cuDNN's dX
and dW, B5 for block 0) and the clipped Adam update, all on the device. A
siamese step samples half alike and half differing pairs, fetches x1 and x2
through B1 apart (two launches, as the JAX step fetches them), encodes
``[x1; x2]`` as one batch and trains on the BCE of the head's logits or on
the contrastive loss of the embeddings' distance. ``train_on_batch`` and
``train_on_pairs`` are the steps after sampling, for a batch the caller
gives. The log-mel classifier (config #4) trains through its own forward
under autograd (B1 for the batch, then B6 with no gradient, cuDNN's 2D convs),
as the JAX package trains it through flax apply.

The streaming steps (``make_streaming_classifier_step``,
``make_streaming_siamese_step``) take host-cut int16 fragments from
``data/pipeline.StreamingPipeline``: the batch goes to the card through
pinned memory, ``preprocess_fragments`` converts, decimates and whitens it in
plain torch ops (the JAX package computes these outside any kernel), and
``train_on_batch`` / ``train_on_pairs`` train on it, so the card runs B4,
B5 and B7 and no B1. ``make_embed_fn`` embeds store rows at offset 0.

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
from ..models.siamese import SiameseNet
from ..models.spectrogram import MelSpecClassifier
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
    """The block-0 op (B4/B5) for the waveform models, the classifier and
    the siamese net: None = auto, on for a model on the card (on the CPU its
    plain versions are slower than autograd)."""
    if not isinstance(model, (SpeakerClassifier, SiameseNet)):
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


def classifier_loss_fn(model: SpeakerClassifier | MelSpecClassifier,
                       cfg: ExperimentConfig) -> Callable:
    """``loss_fn(x, y, generator) → (loss, accuracy)`` through the train
    forward with the policies this config resolves to (set as the function's
    ``fused_block0`` and ``blockn`` attributes). A :class:`MelSpecClassifier`
    trains through its own forward (``blockn`` ``"conv2d"``)."""
    if isinstance(model, MelSpecClassifier):
        def mel_loss_fn(x: torch.Tensor, y: torch.Tensor,
                        generator: Optional[torch.Generator]):
            model.train()
            logits = model(x, generator)
            return losses.softmax_ce(logits, y), losses.categorical_accuracy(logits, y)

        mel_loss_fn.fused_block0, mel_loss_fn.blockn = False, "conv2d"
        return mel_loss_fn
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


def siamese_loss_fn(model: SiameseNet, cfg: ExperimentConfig) -> Callable:
    """``loss_fn(x1, x2, y, generator) → (loss, accuracy)`` with the policies
    this config resolves to (the function's ``fused_block0`` and ``blockn``).

    BCE (the default): the head's logits against ``y``, binary accuracy.
    Contrastive: the Hadsell loss of the embeddings' euclidean distance
    ``d``; a pair is predicted "different" when ``d > margin / 2``, which is
    the label ``1 − same_label``.
    """
    fused0 = resolve_fused_block0(cfg, model)
    blockn = resolve_blockn(cfg, _device_of(model))
    same = cfg.siamese.same_label
    margin = cfg.train.contrastive_margin
    contrastive = cfg.train.loss == "contrastive"

    def loss_fn(x1: torch.Tensor, x2: torch.Tensor, y: torch.Tensor,
                generator: Optional[torch.Generator]):
        model.train()
        if contrastive:
            B = x1.shape[0]
            emb = fused_train.siamese_embed_train_forward(
                model, torch.cat([x1, x2], dim=0), generator, blockn, fused0)
            d = torch.sqrt((emb[:B] - emb[B:]).square().sum(-1) + 1e-12)
            pred = torch.where(d > margin / 2, 1.0 - same, float(same))
            return (losses.contrastive(d, y, margin=margin, same_label=same),
                    (pred == y).float().mean())
        logits = fused_train.siamese_train_forward(model, x1, x2, generator, blockn, fused0)
        return losses.bce_with_logits(logits, y), losses.binary_accuracy(logits, y)

    loss_fn.fused_block0, loss_fn.blockn = fused0, blockn
    return loss_fn


def train_on_pairs(state: TrainState, x1: torch.Tensor, x2: torch.Tensor, y: torch.Tensor,
                   generator: Optional[torch.Generator], loss_fn: Callable):
    """One update on the pairs ``(x1, x2)`` (each ``(B, T, 1)`` f32) with
    labels ``y (B,)`` f32 → ``(state, {"loss", "accuracy"})``, as
    :func:`train_on_batch`."""
    state.optimizer.zero_grad()
    loss, acc = loss_fn(x1, x2, y, generator)
    loss.backward()
    apply_updates(state)
    return state, {"loss": loss.detach(), "accuracy": acc}


def make_siamese_train_step(model: SiameseNet, cfg: ExperimentConfig):
    """``(step, loss_fn)``; ``step(state, store, generator) → (state,
    metrics)`` samples ``batch_size`` pairs (half alike, half differing),
    fetches x1 and x2 and trains on them."""
    loss_fn = siamese_loss_fn(model, cfg)
    B = cfg.train.batch_size
    same = cfg.siamese.same_label

    def step(state: TrainState, store: DeviceStore, generator: Optional[torch.Generator]):
        batch = sampling.sample_verification_batch(generator, store.speaker_utts,
                                                   store.speaker_counts, B, same)
        x1 = fetch_batch(store, batch.idx_1, cfg, generator, stochastic=cfg.data.stochastic)
        x2 = fetch_batch(store, batch.idx_2, cfg, generator, stochastic=cfg.data.stochastic)
        return train_on_pairs(state, x1, x2, batch.labels, generator, loss_fn)

    return step, loss_fn


def host_to_device(a, device) -> torch.Tensor:
    """A host batch (numpy or a CPU tensor) on ``device``; to the card through
    pinned memory, without waiting for the copy."""
    t = torch.as_tensor(a)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def preprocess_fragments(frags_i16: torch.Tensor, cfg: ExperimentConfig) -> torch.Tensor:
    """``(B, frag)`` int16 host-cut fragments → ``(B, T_model, 1)`` f32:
    ÷ 32768, stride decimation, whitening (the streaming path; plain torch
    ops, at whatever phase the host cut the fragment)."""
    d = cfg.data
    x = frags_i16.float() * preprocess.INT16_SCALE
    x = preprocess.stride_decimate(x, d.downsampling)
    if d.whiten_rms is not None:
        x = preprocess.whiten(x, d.whiten_rms, d.whiten_eps)
    return x[..., None]


def make_streaming_classifier_step(model: SpeakerClassifier | MelSpecClassifier,
                                   cfg: ExperimentConfig):
    """``(step, loss_fn)``; ``step(state, frags, y, generator) → (state,
    metrics)`` trains on host-streamed fragments ``(B, frag)`` int16 and
    labels ``(B,)`` (``data/pipeline.StreamingPipeline``)."""
    loss_fn = classifier_loss_fn(model, cfg)
    device = _device_of(model)

    def step(state: TrainState, frags, y, generator: Optional[torch.Generator]):
        x = preprocess_fragments(host_to_device(frags, device), cfg)
        return train_on_batch(state, x, host_to_device(y, device), generator, loss_fn)

    return step, loss_fn


def make_streaming_siamese_step(model: SiameseNet, cfg: ExperimentConfig):
    """``(step, loss_fn)``; ``step(state, f1, f2, y, generator) → (state,
    metrics)`` trains on host-streamed pair fragments."""
    loss_fn = siamese_loss_fn(model, cfg)
    device = _device_of(model)

    def step(state: TrainState, f1, f2, y, generator: Optional[torch.Generator]):
        x1 = preprocess_fragments(host_to_device(f1, device), cfg)
        x2 = preprocess_fragments(host_to_device(f2, device), cfg)
        return train_on_pairs(state, x1, x2, host_to_device(y, device), generator, loss_fn)

    return step, loss_fn


def make_embed_fn(model, cfg: ExperimentConfig) -> Callable:
    """``embed(store, indices) → (B, D)`` f32 embeddings of store rows at
    offset 0 (B1, then the model's own forward in eval mode)."""

    def embed(store: DeviceStore, indices: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model.embed(fetch_batch(store, indices, cfg, stochastic=False))

    return embed
