"""The training forward with the fused block ops.

Port of ``voicemap_tpu/models/fused_train.py :: encoder_train_forward``,
``classifier_train_forward``, ``siamese_train_forward`` and
``siamese_embed_train_forward``. Block 0 runs through
``ops/conv_train.FusedBlock0Train`` (B4 forward, B5 backward) when it is
eligible; blocks 1+ run either flax's ``ConvBlock`` train semantics
differentiated by autograd (``blockn="jnp"``, ``ConvBlock.forward_train_nct``)
or a fused op, channels last from block 0's pooled output to the head, with
no copy between blocks (a block that falls back to ``forward_train_nct``
reads the strided tensor as it is): the save-act ``FusedBlocknTrain``
(``blockn="fused"``: cuDNN convs around B7's pool and routing passes); its
int8 forward (``"fused_int8"``: the conv in s8×s8→s32 on B3's train
epilogue with in-step scales, a straight-through backward); or the
pool-rate-residual ``FusedBlocknRecompute`` (``"fused_recompute"``: B8 or
cuDNN in f32, B7 with the phase index, the conv recomputed in the
backward), as the JAX package's ``blockn`` names them. With f32 compute and
dropout 0 the forward matches flax's ``model.apply(train=True)`` (the int8
forward its own JAX counterpart).

These functions take the module and use its parameters, so gradients land in
``.grad`` as usual, and they **update the BatchNorm running buffers of the
module in place** (``m·old + (1 − m)·batch``), where the JAX functions return
a new ``batch_stats`` tree. Dropout masks come from ``generator``, one
Bernoulli draw a (row, channel) a block, at pool rate after a fused block
(SpatialDropout scales whole channels by a non-negative factor, so it
commutes with the max-pool). A torch generator does not replay JAX's keys:
masks differ from the JAX package's at equal seeds.
"""

from __future__ import annotations

import torch

from ..ops import distance as dist_ops
from ..ops.conv_train import (
    FusedBlock0Train, FusedBlocknRecompute, FusedBlocknTrain, symmetric_padding,
)
from ..ops.cuda_conv_train import KERNEL_POOL, KERNEL_TAPS, MAX_CHANNELS
from .classifier import SpeakerClassifier
from .encoder import ConvEncoder, spatial_dropout
from .siamese import SiameseNet

BLOCKN = ("jnp", "fused", "fused_recompute", "fused_int8")


def _gemm_dtype(cdt: torch.dtype) -> torch.dtype:
    return torch.float32 if cdt == torch.float32 else torch.bfloat16


def fused_block0_train_eligible(encoder: ConvEncoder, x: torch.Tensor) -> bool:
    """The block-0 op takes Cin=1, k=32, pool 4, dilation 1, C ≤ 256, T % 4 == 0."""
    cfg = encoder.cfg
    return (cfg.dilations[0] == 1 and cfg.kernel_sizes[0] == KERNEL_TAPS
            and cfg.pool_sizes[0] == KERNEL_POOL and cfg.filters * cfg.filter_multipliers[0]
            <= MAX_CHANNELS and x.shape[-1] == 1 and x.shape[1] % KERNEL_POOL == 0)


def encoder_train_forward(encoder: ConvEncoder, x: torch.Tensor,
                          generator: torch.Generator | None = None, blockn: str = "jnp",
                          fused_block0: bool = True) -> torch.Tensor:
    """``(B, T, 1)`` f32 → ``(B, D)`` f32 embeddings, train semantics.

    ``blockn``: ``"jnp"`` for autograd through flax-semantics blocks,
    ``"fused"`` for the save-act fused op, ``"fused_int8"`` for its int8
    forward, ``"fused_recompute"`` for the pool-rate-residual op (under the
    three fused ones a block whose T does not divide its pool falls back to
    the plain block, as in the JAX package, and so does a block whose SAME
    padding is not symmetric).
    ``fused_block0`` sends an eligible block 0 through B4/B5.
    """
    if blockn not in BLOCKN:
        raise ValueError(f"blockn must be one of {BLOCKN}, got {blockn!r}")
    cfg = encoder.cfg
    if cfg.dropout > 0.0 and generator is None:
        raise ValueError("a generator is required when cfg.dropout > 0")
    cdt = encoder.compute_dtype
    gdt = _gemm_dtype(cdt)
    h = x.to(cdt).transpose(1, 2)
    start = 0
    if fused_block0 and fused_block0_train_eligible(encoder, x):
        blk = encoder.blocks[0]
        pooled, mu, var = FusedBlock0Train.apply(
            x, blk.conv.weight.permute(2, 1, 0), blk.conv.bias, blk.bn.weight, blk.bn.bias,
            blk.pool_size, blk.bn.eps, gdt, gdt)
        y = spatial_dropout(pooled.to(cdt), cfg.dropout, generator, channel_dim=2)
        blk.update_running_stats(mu, var)
        h = y.transpose(1, 2)  # (B, C, T/4), channels last: what the fused blocks take
        if blockn == "jnp":
            h = h.contiguous()  # channel first for the jnp blocks' cuDNN convs
        start = 1
    for i in range(start, len(encoder.blocks)):
        blk = encoder.blocks[i]
        pool = blk.pool_size
        symmetric = symmetric_padding(blk.conv.kernel_size[0], blk.conv.dilation[0]) is not None
        if blockn != "jnp" and i >= 1 and symmetric and (pool <= 1 or h.shape[2] % pool == 0):
            args = (h, blk.conv.weight, blk.conv.bias, blk.bn.weight, blk.bn.bias, max(pool, 1),
                    blk.bn.eps, blk.conv.dilation[0], gdt)
            if blockn == "fused_recompute":
                pooled, mu, var = FusedBlocknRecompute.apply(*args)
            else:
                pooled, mu, var = FusedBlocknTrain.apply(
                    *args, "int8" if blockn == "fused_int8" else "none")
            h = spatial_dropout(pooled.to(cdt), cfg.dropout, generator)
            blk.update_running_stats(mu, var)
        else:
            h = blk.forward_train_nct(h, generator)
    return encoder.pool_and_embed(h)


def classifier_train_forward(model: SpeakerClassifier, x: torch.Tensor,
                             generator: torch.Generator | None = None, blockn: str = "jnp",
                             fused_block0: bool = True) -> torch.Tensor:
    """``SpeakerClassifier`` train forward → ``(B, num_classes)`` f32 logits."""
    return model.logits(encoder_train_forward(model.encoder, x, generator, blockn,
                                              fused_block0))


def siamese_train_forward(model: SiameseNet, x1: torch.Tensor, x2: torch.Tensor,
                          generator: torch.Generator | None = None, blockn: str = "jnp",
                          fused_block0: bool = True) -> torch.Tensor:
    """``SiameseNet`` train forward → ``(B,)`` f32 logits: ``[x1; x2]``
    through ONE encoder forward at 2B rows (BatchNorm's batch statistics
    over both halves), then the merge and the Dense(1) in f32."""
    B = x1.shape[0]
    emb = encoder_train_forward(model.encoder, torch.cat([x1, x2], dim=0), generator, blockn,
                                fused_block0)
    feats = dist_ops.merge_features(emb[:B], emb[B:], model.siamese.distance_metric)
    return model.head_logits(feats)


def siamese_embed_train_forward(model: SiameseNet, x: torch.Tensor,
                                generator: torch.Generator | None = None, blockn: str = "jnp",
                                fused_block0: bool = True) -> torch.Tensor:
    """``SiameseNet.embed`` in train mode → ``(B, D)`` f32 (the contrastive
    loss's path: the head is not used)."""
    return encoder_train_forward(model.encoder, x, generator, blockn, fused_block0)
