"""Pooled-GEMM encoder forward: conv+relu+BN+maxpool as one matmul per block.

Port of ``voicemap_tpu/models/fused_encoder.py``. For pool stride ``p`` and
kernel ``k`` (dilation ``d``), the ``p`` consecutive conv outputs that feed
one pooled position all read one input window of ``(k−1)·d + p`` rows. Stack
the ``p`` phase-shifted copies of the conv weights into one
``(win·Cin, p·C)`` matrix; then

    frames (B, T/p, win·Cin) @ W_stacked → (B, T/p, p·C)
    → relu → BN affine (tiled ×p) → max over the p lane-blocks → (B, T/p, C)

is one GEMM whose output is already pool-rate. Same parameters and the same
inference function as ``ConvEncoder.forward``, in every block: block 0 with
pool 4, the dilated blocks and the pool-1 blocks of config #3.

This module is the specification that the B8 kernel's plain version
(``ops/cuda_conv.conv_blockn_reference``) follows at pool 2 and dilation 1;
it is not a kernel and runs through none. It materializes the frame matrix,
so it is for checking, not serving.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .encoder import ConvEncoder


def _pool_frame_indices(t_out: int, win: int, pool: int) -> torch.Tensor:
    """(t_out, win) gather indices into the left-padded input."""
    return torch.arange(t_out)[:, None] * pool + torch.arange(win)[None, :]


def _stack_weights(w: torch.Tensor, pool: int, dilation: int) -> torch.Tensor:
    """w (k, Cin, C) → (win·Cin, pool·C) with the j-th phase shifted by j.

    win = (k−1)·dilation + pool. Zeros elsewhere reproduce 'SAME' behavior
    together with the caller's asymmetric edge padding.
    """
    k, cin, c = w.shape
    win = (k - 1) * dilation + pool
    out = torch.zeros((win, cin, pool, c), dtype=w.dtype, device=w.device)
    for j in range(pool):
        out[j:j + (k - 1) * dilation + 1:dilation, :, j, :] += w
    return out.reshape(win * cin, pool * c)


def fused_block_apply(
    x: torch.Tensor,  # (B, T, Cin)
    w: torch.Tensor,  # (k, Cin, C) conv kernel (flax layout)
    b: torch.Tensor,  # (C,)
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    bn_eps: float,
    pool: int,
    dilation: int = 1,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """One conv(SAME)+relu+BN(inference)+maxpool block as a pooled GEMM.

    The frames and stacked weights are rounded to ``compute_dtype`` and
    multiplied with f32 sums (the JAX einsum's ``preferred_element_type``);
    the epilogue is f32 and the output is rounded once, to ``compute_dtype``.
    """
    B, T, cin = x.shape
    k = w.shape[0]
    if T % pool:
        raise ValueError(f"T={T} not divisible by pool={pool}")
    t_out = T // pool
    reach = (k - 1) * dilation
    pad_l = reach // 2
    pad_r = reach - pad_l
    win = reach + pool
    xp = F.pad(x, (0, 0, pad_l, pad_r)).to(compute_dtype)
    idx = _pool_frame_indices(t_out, win, pool).to(x.device)
    frames = xp[:, idx, :].reshape(B, t_out, win * cin)  # (B, t_out, win·cin)
    w4 = _stack_weights(w.to(compute_dtype), pool, dilation)
    y = frames.float() @ w4.float()  # (B, t_out, pool·C), f32 sums
    c = w.shape[2]
    y = y + b.float().repeat(pool)
    y = torch.relu(y)
    # BN inference affine, tiled across the pool phases.
    inv = torch.rsqrt(bn_var.float() + bn_eps) * bn_scale.float()
    y = (y - bn_mean.float().repeat(pool)) * inv.repeat(pool) + bn_bias.float().repeat(pool)
    # Max over the pool phases: the lane-blocks of the GEMM's output.
    out = y[:, :, :c]
    for j in range(1, pool):
        out = torch.maximum(out, y[:, :, j * c:(j + 1) * c])
    return out.to(compute_dtype)


def fused_encoder_apply(encoder: ConvEncoder, x: torch.Tensor) -> torch.Tensor:
    """Inference forward of ``encoder`` with every block in pooled-GEMM form:
    ``(B, T, 1)`` float32 → ``(B, embedding_dim)`` float32."""
    cdt = encoder.compute_dtype
    h = x
    with torch.inference_mode():
        for blk in encoder.blocks:
            bn = blk.bn
            h = fused_block_apply(
                h, blk.conv.weight.permute(2, 1, 0), blk.conv.bias, bn.weight, bn.bias,
                bn.running_mean, bn.running_var, bn.eps, pool=blk.pool_size,
                dilation=blk.conv.dilation[0], compute_dtype=cdt)
        h = h.amax(dim=1)  # GlobalMaxPool1D
        emb = encoder.embed
        out = h @ emb.weight.t().to(cdt) + emb.bias.to(cdt)
        return out.float()
