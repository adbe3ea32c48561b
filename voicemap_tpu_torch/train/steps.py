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

Every builder takes an optional process ``group`` (the ``data`` axis of a
mesh; ``parallel/data_parallel``'s builders pass it). With one, the step is
data-parallel over its ``n`` ranks: a device-store step samples and fetches
``batch_size / n`` rows on each rank from :func:`rank_generator` of the
step's generator; a streaming step keeps rank ``r``'s rows ``[r·B/n,
(r+1)·B/n)`` of the host batch, and only its dropout generator takes the
rank; after ``backward()`` every gradient, every floating BatchNorm buffer
and the two metrics are averaged over the group in one ``all_reduce``
(:func:`_mean_over_group`), and the clipped update then sees the averaged
gradient.

Two preprocessing paths, as in the JAX package, chosen by how the store was
shipped (``DeviceStore.downsampling``), never by the config at fetch time:
a store decimated once when it was shipped goes through the B1
gather+whiten (``ops/cuda_preprocess``), lengths and offsets in decimated
units (the JAX package's Pallas path); a raw int16 store
(``use_pallas_preprocess=False``) through the plain chain of
``ops/preprocess`` on the device: offsets over the raw fragment length, the
gather, ÷ 32768, the stride decimation, the whitening (the JAX package's
XLA chain, which it leaves to XLA; no kernel).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import ExperimentConfig
from ..data.store import AudioStore
from ..models import fused_train
from ..models.classifier import SpeakerClassifier
from ..models.siamese import SiameseNet
from ..models.spectrogram import MelSpecClassifier
from ..ops import preprocess, sampling
from ..ops.cuda_preprocess import decimate_store, gather_whiten
from ..utils.profiling import span
from . import losses
from .state import TrainState, apply_updates


@dataclass
class DeviceStore:
    """An :class:`AudioStore` on a device, as it was prepared: decimated once
    by ``downsampling`` > 0 (B1's store, lengths in decimated units), or raw
    (``downsampling`` 0, the plain chain's store, raw lengths), as the JAX
    ``DeviceStore.pallas_ds`` records it."""

    audio: torch.Tensor  # (N, ceil(T_store / ds)) int16; raw: (N, T_store)
    lengths: torch.Tensor  # (N,) int32, decimated units (raw units when raw)
    labels: torch.Tensor  # (N,) int32
    speaker_utts: torch.Tensor  # (S, max_utt) int32
    speaker_counts: torch.Tensor  # (S,) int32
    downsampling: int

    @classmethod
    def from_host(cls, store: AudioStore, device, downsampling: int,
                  min_length: int = 0) -> "DeviceStore":
        """Ship the corpus to ``device``, and decimate it there once by
        ``downsampling`` > 0; 0 keeps it raw.

        ``min_length`` zero-pads rows to at least this many raw samples.
        """
        audio = torch.from_numpy(store.audio).to(device)
        if audio.shape[1] < min_length:
            audio = F.pad(audio, (0, min_length - audio.shape[1]))
        put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        lengths = put(store.lengths)
        if downsampling:
            audio, lengths = decimate_store(audio, downsampling), lengths // downsampling
        return cls(
            audio=audio,
            lengths=lengths,
            labels=put(store.labels),
            speaker_utts=put(store.speaker_utts),
            speaker_counts=put(store.speaker_counts),
            downsampling=int(downsampling),
        )


def resolve_pallas_preprocess(cfg: ExperimentConfig) -> bool:
    """Whether the store is decimated once for B1 (True) or kept raw for the
    plain chain (False). ``cfg.train.use_pallas_preprocess``: None = auto,
    B1's store on every device: the card's counterpart of the JAX package's
    production path (its Pallas gather+whiten on the TPU); the JAX package
    resolves auto to its XLA chain off the TPU, a choice made for that
    device, not this one. False takes the raw chain."""
    flag = cfg.train.use_pallas_preprocess
    return True if flag is None else bool(flag)


def device_store_for(cfg: ExperimentConfig, audio_store: AudioStore,
                     device) -> DeviceStore:
    """The :class:`DeviceStore` prepared as this config resolves
    (:func:`resolve_pallas_preprocess`): decimated once, or raw."""
    ds = cfg.data.downsampling if resolve_pallas_preprocess(cfg) else 0
    return DeviceStore.from_host(audio_store, device, ds, min_length=cfg.data.fragment_length)


def fetch_batch(store: DeviceStore, indices: torch.Tensor, cfg: ExperimentConfig,
                generator: Optional[torch.Generator] = None,
                stochastic: bool = True) -> torch.Tensor:
    """Utterance ids ``(B,)`` → preprocessed model inputs ``(B, T_model, 1)`` f32.

    Dispatches on how the store was prepared, never on the config's flag: a
    decimated store takes B1, a raw one the plain chain (offsets over the
    raw fragment, gather, ÷ 32768, stride decimation, whitening where
    ``whiten_rms`` is set), in the JAX package's order."""
    d = cfg.data
    with span("fetch_batch", indices.shape[0]):
        indices = indices.to(device=store.audio.device, dtype=torch.int32).contiguous()
        if not store.downsampling:
            frag = d.fragment_length
            offsets = preprocess.sample_offsets(store.lengths[indices.long()], frag, generator,
                                                stochastic)
            return preprocess_fragments(
                preprocess.gather_fragments(store.audio, indices, offsets, frag), cfg)
        if store.downsampling != d.downsampling:
            raise ValueError(
                f"store decimated by {store.downsampling} but config expects "
                f"downsampling {d.downsampling}")
        t_out = d.model_length
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
    """How blocks 1+ train: ``"fused"`` (the save-act op with B7),
    ``"fused_int8"`` or ``"jnp"``.

    ``quant_forward="int8"`` is an explicit opt-in: ``"fused_int8"`` (the
    save-act op's int8 forward), whatever the flags and the size gate say,
    as the JAX package resolves it (blocks whose T does not divide the pool
    still take the plain block). Otherwise None = auto: ``"fused"`` on the
    card whenever every block's bf16 full-rate activation stays under
    ``_SAVE_ACT_LIMIT_SHARE`` of its memory, else ``"jnp"``; ``"jnp"`` on
    the CPU. ``"fused_recompute"`` is reached by no config, as in the JAX
    package: only a caller of the train forward names it.
    """
    if cfg.train.quant_forward == "int8":
        return "fused_int8"
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


_GOLDEN = 0x9E3779B97F4A7C15


def _splitmix64(x: int) -> int:
    """SplitMix64's finalizer: every output bit depends on every input bit
    (a CPU generator seeds its Mersenne twister from the low 32 bits only)."""
    x = (x + _GOLDEN) % 2 ** 64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) % 2 ** 64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) % 2 ** 64
    return x ^ (x >> 31)


def rank_generator(generator: Optional[torch.Generator],
                   rank: int) -> Optional[torch.Generator]:
    """Rank ``rank``'s generator for a step: the caller's own for rank 0
    (so at world 1 a data-parallel step draws what the single-device step
    draws), else a new one on its device seeded ``splitmix64(initial_seed +
    rank·φ)`` (φ = 0x9E3779B97F4A7C15). ``fit`` seeds step ``i``'s generator
    with ``seed·1000003 + i``, so a rank's draws are a function of (seed,
    step, rank), as ``fold_in(key, axis_index)`` makes them in JAX (torch's
    draws, not JAX's: ROADMAP §C "RNG")."""
    if generator is None or rank == 0:
        return generator
    seed = _splitmix64((generator.initial_seed() + rank * _GOLDEN) % 2 ** 64)
    return torch.Generator(device=generator.device).manual_seed(seed)


def _group_place(cfg: ExperimentConfig, group) -> Tuple[int, int]:
    """``(size, this rank's index)`` of the data-parallel group, ``(1, 0)``
    without one; the size must divide the global batch."""
    if group is None:
        return 1, 0
    n = dist.get_world_size(group)
    if cfg.train.batch_size % n:
        raise ValueError(f"data-axis size {n} must divide the global batch "
                         f"{cfg.train.batch_size}")
    return n, dist.get_rank(group)


def _draw_generator(generator: Optional[torch.Generator], group, rank: int):
    """The generator of this rank's sub-batch draws; a data-parallel step
    needs a seeded one, else every rank would draw from its own global
    stream."""
    if group is not None and generator is None:
        raise ValueError("a DP step draws its sub-batch from a seeded generator")
    return rank_generator(generator, rank)


def _local_rows(a, n: int, rank: int):
    """Rank ``rank``'s contiguous rows of a host batch of ``n`` ranks."""
    B = a.shape[0]
    if B % n:
        raise ValueError(f"host batch {B} does not divide the {n} ranks")
    return a[rank * B // n:(rank + 1) * B // n]


@torch.no_grad()
def _mean_over_group(state: TrainState, metrics: Tuple[torch.Tensor, ...],
                     group) -> Tuple[torch.Tensor, ...]:
    """Average, in one all_reduce, every gradient, every floating buffer of
    the model and ``metrics`` over ``group``, in place; → the averaged
    metrics. (Not ``DistributedDataParallel``: its wrapper renames the state
    dict and expects the forward to go through it, where the train forwards
    of ``models/fused_train`` call into the model's blocks themselves; and
    its reduce would carry neither the buffers nor the metrics.)"""
    grads = [p.grad for p in state.optimizer.params if p.grad is not None]
    buffers = [b for b in state.model.buffers() if b.is_floating_point()]
    parts = grads + buffers
    from ..parallel.comm import all_reduce_  # the parallel layer imports this module

    flat = torch.cat([t.reshape(-1).float() for t in parts]
                     + [m.detach().reshape(1).float() for m in metrics])
    all_reduce_(flat, group)  # staged through the host for a card's tensor under gloo
    flat /= dist.get_world_size(group)
    offset = 0
    for t in parts:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return tuple(flat[offset:])


def _update(state: TrainState, loss: torch.Tensor, acc: torch.Tensor, group, rows: int):
    """Backward, the mean over ``group`` when there is one, the clipped
    update (``rows``: the batch, for the spans)."""
    with span("backward", rows):
        loss.backward()
    if group is not None:
        loss, acc = _mean_over_group(state, (loss, acc), group)
    with span("optimizer", rows):
        apply_updates(state)
    return state, {"loss": loss.detach(), "accuracy": acc}


def train_on_batch(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                   generator: Optional[torch.Generator], loss_fn: Callable, group=None):
    """One update on the batch ``(x (B, T, 1) f32, y (B,))`` → ``(state,
    {"loss", "accuracy"})``; the metrics are the forward's, before the update,
    as 0-d tensors on the device (no host sync). With ``group``, averaged
    over it first (:func:`_mean_over_group`)."""
    state.optimizer.zero_grad()
    with span("forward", x.shape[0]):
        loss, acc = loss_fn(x, y, generator)
    return _update(state, loss, acc, group, x.shape[0])


def make_classifier_train_step(model: SpeakerClassifier, cfg: ExperimentConfig, group=None):
    """``(step, loss_fn)``; ``step(state, store, generator) → (state, metrics)``
    samples ``batch_size`` utterance ids (``batch_size / n`` on each of the
    ``n`` ranks of ``group``), fetches their fragments and trains on them."""
    loss_fn = classifier_loss_fn(model, cfg)
    n, rank = _group_place(cfg, group)
    B = cfg.train.batch_size // n

    def step(state: TrainState, store: DeviceStore, generator: Optional[torch.Generator]):
        with span("train_step", B):
            gen = _draw_generator(generator, group, rank)
            idx = sampling.sample_classifier_batch(gen, store.labels.shape[0], B,
                                                   store.audio.device)
            x = fetch_batch(store, idx, cfg, gen, stochastic=cfg.data.stochastic)
            return train_on_batch(state, x, store.labels[idx], gen, loss_fn, group)

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
                   generator: Optional[torch.Generator], loss_fn: Callable, group=None):
    """One update on the pairs ``(x1, x2)`` (each ``(B, T, 1)`` f32) with
    labels ``y (B,)`` f32 → ``(state, {"loss", "accuracy"})``, as
    :func:`train_on_batch`."""
    state.optimizer.zero_grad()
    return _update(state, *loss_fn(x1, x2, y, generator), group, x1.shape[0])


def make_siamese_train_step(model: SiameseNet, cfg: ExperimentConfig, group=None):
    """``(step, loss_fn)``; ``step(state, store, generator) → (state,
    metrics)`` samples ``batch_size`` pairs (half alike, half differing;
    ``batch_size / n`` on each rank of ``group``), fetches x1 and x2 and
    trains on them."""
    loss_fn = siamese_loss_fn(model, cfg)
    n, rank = _group_place(cfg, group)
    B = cfg.train.batch_size // n
    same = cfg.siamese.same_label

    def step(state: TrainState, store: DeviceStore, generator: Optional[torch.Generator]):
        gen = _draw_generator(generator, group, rank)
        batch = sampling.sample_verification_batch(gen, store.speaker_utts,
                                                   store.speaker_counts, B, same)
        x1 = fetch_batch(store, batch.idx_1, cfg, gen, stochastic=cfg.data.stochastic)
        x2 = fetch_batch(store, batch.idx_2, cfg, gen, stochastic=cfg.data.stochastic)
        return train_on_pairs(state, x1, x2, batch.labels, gen, loss_fn, group)

    return step, loss_fn


def host_to_device(a, device) -> torch.Tensor:
    """A host batch (numpy or a CPU tensor) on ``device``; to the card through
    pinned memory, without waiting for the copy."""
    with span("host_to_device", len(a)):
        t = torch.as_tensor(a)
        if torch.device(device).type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)


def preprocess_fragments(frags_i16: torch.Tensor, cfg: ExperimentConfig) -> torch.Tensor:
    """``(B, frag)`` int16 fragments → ``(B, T_model, 1)`` f32: ÷ 32768,
    stride decimation, whitening (plain torch ops: the streaming path, at
    whatever phase the host cut the fragment, and the raw store's)."""
    d = cfg.data
    with span("preprocess", frags_i16.shape[0]):
        x = frags_i16.float() * preprocess.INT16_SCALE
        x = preprocess.stride_decimate(x, d.downsampling)
        if d.whiten_rms is not None:
            x = preprocess.whiten(x, d.whiten_rms, d.whiten_eps)
        return x[..., None]


def make_streaming_classifier_step(model: SpeakerClassifier | MelSpecClassifier,
                                   cfg: ExperimentConfig, group=None):
    """``(step, loss_fn)``; ``step(state, frags, y, generator) → (state,
    metrics)`` trains on host-streamed fragments ``(B, frag)`` int16 and
    labels ``(B,)`` (``data/pipeline.StreamingPipeline``); each rank of
    ``group`` ships and trains on its own rows of the host batch."""
    loss_fn = classifier_loss_fn(model, cfg)
    device = _device_of(model)
    n, rank = _group_place(cfg, group)
    mine = lambda a: host_to_device(_local_rows(a, n, rank), device)  # noqa: E731

    def step(state: TrainState, frags, y, generator: Optional[torch.Generator]):
        x = preprocess_fragments(mine(frags), cfg)
        return train_on_batch(state, x, mine(y), rank_generator(generator, rank), loss_fn,
                              group)

    return step, loss_fn


def make_streaming_siamese_step(model: SiameseNet, cfg: ExperimentConfig, group=None):
    """``(step, loss_fn)``; ``step(state, f1, f2, y, generator) → (state,
    metrics)`` trains on host-streamed pair fragments. The pipeline's
    half-alike, half-differing layout needs no reshuffle across the ranks of
    ``group``: the loss is a mean over equal shards."""
    loss_fn = siamese_loss_fn(model, cfg)
    device = _device_of(model)
    n, rank = _group_place(cfg, group)
    mine = lambda a: host_to_device(_local_rows(a, n, rank), device)  # noqa: E731

    def step(state: TrainState, f1, f2, y, generator: Optional[torch.Generator]):
        x1 = preprocess_fragments(mine(f1), cfg)
        x2 = preprocess_fragments(mine(f2), cfg)
        return train_on_pairs(state, x1, x2, mine(y), rank_generator(generator, rank),
                              loss_fn, group)

    return step, loss_fn


def make_embed_fn(model, cfg: ExperimentConfig) -> Callable:
    """``embed(store, indices) → (B, D)`` f32 embeddings of store rows at
    offset 0 (B1, then the model's own forward in eval mode)."""

    def embed(store: DeviceStore, indices: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model.embed(fetch_batch(store, indices, cfg, stochastic=False))

    return embed
