"""Fast inference embedding: every block in a fused kernel where one exists.

Port of ``voicemap_tpu/models/fast_infer.py :: fast_embed``. Block 0 runs
through ``ops/cuda_conv.conv_block0`` (B2). In bf16, every later block that
B8 takes (k odd, pool 1 or 2, the reach d·(k − 1) within
``ops/conv_sm90.MAX_REACH``) runs through ``ops/cuda_conv.conv_blockn``
(B8), so no full-rate activation reaches device memory and the chain stays
channels last from B2 to the head: config #1's

    B2 (B, T/4, 128) → B8 → B8 → B8 (B, 375, 512) → global max and Dense,

and config #3's (``dilated_4khz``) seven dilated and pool-1 blocks, B2 → B8
× 7 → (B, 375, 512). f32 or f16 compute, and a block B8 does not take, keep
``ConvBlock.forward_nct`` (``F.conv1d``), as the JAX package's blocks 1+
keep XLA's conv; the config decides the route, never a failure. The JAX
package keeps its B8 off this path because of a TPU timing, and never has
it take a dilated block; that policy was re-decided on the H100. Same parameters, same inference
semantics as ``ConvEncoder.forward``; at bf16 the two round in different
places (the kernels round each block once, at its output).

Unlike the JAX package there is no backend switch: on a CUDA tensor each
fused block is its kernel, on a CPU tensor its plain version.
"""

from __future__ import annotations

import torch

from ..ops import conv_sm90
from ..ops.cuda_conv import conv_block0, conv_blockn
from .encoder import ConvBlock, ConvEncoder, block_eval_nct


def takes_blockn(blk: ConvBlock) -> bool:
    """Whether B8 computes this block: bf16, k odd, pool 1 or 2, a reach the
    kernel's input box holds (``conv_sm90.takes``)."""
    return takes(blk.conv.kernel_size[0], blk.conv.dilation[0], blk.pool_size,
                 blk.compute_dtype)


def takes(k: int, dilation: int, pool: int, cdt: torch.dtype) -> bool:
    """:func:`takes_blockn` from a block's shape and compute dtype."""
    return cdt == torch.bfloat16 and conv_sm90.takes(k, dilation, max(pool, 1))


def block0_apply(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 scale: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor,
                 var: torch.Tensor, eps: float, pool: int, cdt: torch.dtype) -> torch.Tensor:
    """Block 0 through B2, ``(B, T, 1)`` f32 → ``(B, T // pool, C)`` in
    ``cdt``; ``kernel`` in flax's layout ``(k, 1, C)``."""
    return conv_block0(x, kernel, bias, scale, beta, mean, var, eps, pool=pool,
                       out_dtype=cdt, gemm_dtype=cdt)


def blockn_apply(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 scale: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor,
                 var: torch.Tensor, eps: float, pool: int, dilation: int,
                 cdt: torch.dtype) -> torch.Tensor:
    """One block 1+ channels last, ``(B, T, Cin)`` → ``(B, T // pool, C)``:
    B8 where it takes the block (:func:`takes`), else
    ``encoder.block_eval_nct``; ``kernel`` in flax's layout ``(k, Cin, Cout)``."""
    if not takes(kernel.shape[0], dilation, pool, cdt):
        return block_eval_nct(h.transpose(1, 2), kernel.permute(2, 1, 0), bias, scale, beta,
                              mean, var, eps, pool, dilation, cdt).transpose(1, 2)
    return conv_blockn(h.to(cdt).contiguous(), kernel, bias, scale, beta, mean, var, eps,
                       max(pool, 1), out_dtype=cdt, gemm_dtype=cdt, dilation=dilation)


def _block_tensors(blk: ConvBlock) -> tuple:
    """A block's (flax-layout kernel, bias, scale, beta, mean, var, eps)."""
    bn = blk.bn
    return (blk.conv.weight.permute(2, 1, 0), blk.conv.bias, bn.weight, bn.bias,
            bn.running_mean, bn.running_var, bn.eps)


def blockn(blk: ConvBlock, h: torch.Tensor) -> torch.Tensor:
    """One block 1+ of a module channels last (:func:`blockn_apply`)."""
    return blockn_apply(h, *_block_tensors(blk), blk.pool_size, blk.conv.dilation[0],
                        blk.compute_dtype)


def fast_trunk(encoder: ConvEncoder, x: torch.Tensor) -> torch.Tensor:
    """The conv trunk of :func:`fast_embed`, ``(B, T, 1)`` f32 → ``(B, T',
    C)`` channels last in the compute dtype, before the global max: the ONE
    shared eval trunk (the tensor-parallel embed and the pipeline's stages
    run it too)."""
    cfg = encoder.cfg
    if cfg.dilations[0] != 1:
        raise ValueError("fast_embed: the block-0 kernel takes dilation 1 only")
    cdt = encoder.compute_dtype
    blk = encoder.blocks[0]
    with torch.inference_mode():
        h = block0_apply(x, *_block_tensors(blk), blk.pool_size, cdt)  # (B, T/4, C)
        for blk in encoder.blocks[1:]:
            h = blockn(blk, h)
    return h


def fast_embed(encoder: ConvEncoder, x: torch.Tensor) -> torch.Tensor:
    """``(B, T, 1)`` float32 → ``(B, embedding_dim)`` float32, inference forward."""
    h = fast_trunk(encoder, x)
    with torch.inference_mode():
        return encoder.pool_and_embed(h.transpose(1, 2))
