"""Fast inference embedding: the fused block-0 kernel, then cuDNN blocks.

Port of ``voicemap_tpu/models/fast_infer.py :: fast_embed``. Block 0 runs
through ``ops/cuda_conv.conv_block0`` (B2), so its full-rate ``(B, T, 128)``
activation never reaches device memory; blocks 1+ run ``F.conv1d``, then the
global max over time and the Dense. Same parameters, same inference
semantics as ``ConvEncoder.forward``; at bf16 the two round in different
places (the kernel rounds block 0 once, at its output).

Unlike the JAX package there is no backend switch: on a CUDA tensor block 0
is the kernel, on a CPU tensor its plain version.
"""

from __future__ import annotations

import torch

from ..ops.cuda_conv import conv_block0
from .encoder import ConvEncoder


def fast_embed(encoder: ConvEncoder, x: torch.Tensor) -> torch.Tensor:
    """``(B, T, 1)`` float32 → ``(B, embedding_dim)`` float32, inference forward."""
    cfg = encoder.cfg
    if cfg.dilations[0] != 1:
        raise ValueError("fast_embed: the block-0 kernel takes dilation 1 only")
    cdt = encoder.compute_dtype
    blk = encoder.blocks[0]
    with torch.inference_mode():
        h = conv_block0(
            x,
            blk.conv.weight.permute(2, 1, 0),  # (k, 1, C), the flax layout
            blk.conv.bias,
            blk.bn.weight,
            blk.bn.bias,
            blk.bn.running_mean,
            blk.bn.running_var,
            blk.bn.eps,
            pool=blk.pool_size,
            out_dtype=cdt,
            gemm_dtype=cdt,
        ).transpose(1, 2)  # (B, C, T/4) view for the channel-first blocks
        for blk in encoder.blocks[1:]:
            h = blk.forward_nct(h)
        return encoder.pool_and_embed(h)
