"""The fused conv + relu + BatchNorm(train) + max-pool block, with its gradient.

Port of ``voicemap_tpu/ops/conv_train.py :: make_fused_block0_train`` and of
the save-act variant of ``make_fused_blockn_train``, as two
``torch.autograd.Function`` classes.

BatchNorm's train-mode affine ``y = (a − μ)·γ·r + β`` (``r = rsqrt(σ² + ε)``)
is monotone per channel, so the max-pool of ``y`` picks the phase that
maximises ``sign(γ)·a``: the forward keeps only that selected value
``a_sel`` and the batch statistics, and forms the pooled output at pool rate
afterwards. The backward of BatchNorm with respect to ``a`` folds to
``dz = 1[a>0]·(c0·g + c1 + c2·a)`` with per-channel constants ``c0, c1, c2``
computed at pool rate (the pool routes each pooled cotangent to one
full-rate position, so the full-rate sums equal their pooled sums).

- :class:`FusedBlock0Train` — block 0 (Cin = 1, k = 32, pool 4). Forward is
  B4 (``ops/cuda_conv_train.conv_block0_train``), backward B5
  (``conv_block0_train_bwd``): the full-rate activation never reaches device
  memory. The input gradient is ``None``: block 0's input is audio, not a
  parameter (the TPU op returned zeros).
- :class:`FusedBlocknTrain` — blocks 1+, the save-act variant: cuDNN's conv
  in the GEMM dtype without its bias, then B7's pool pass
  (``ops/cuda_routing.pool_fwd``), which adds the bias in that dtype and
  applies the relu as it reads the conv's output; the backward takes the
  pool-rate sums, B7's routing pass (``route_bwd``), which recomputes the
  activation from the same saved conv output, for ``dz``, then cuDNN's dW and
  dX (``aten.convolution_backward``, as the JAX package left them to XLA).
  Channels last, as the JAX package lays it out: ``(B, C, T)`` tensors with
  the memory of ``(B, T, C)``, so cuDNN runs its NHWC convs with no layout
  conversion around them.

Both return ``(pooled f32, μ, σ²)``, the biased variance
``max(E[a²] − E[a]², 0)`` as flax takes it, and both μ and σ² carry
gradients. T must divide by the pool; callers use the plain block otherwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_conv_train, cuda_routing


def _sign(gamma: torch.Tensor) -> torch.Tensor:
    return torch.where(gamma >= 0, 1.0, -1.0).to(torch.float32)


def _stats(sum_a, sumsq_a, n: int, eps: float):
    mu = sum_a / n
    var = torch.clamp(sumsq_a / n - mu * mu, min=0.0)
    return mu, var, torch.rsqrt(var + eps)


def _bn_backward_constants(g, a_sel, gamma, mu, var, g_mu, g_var, n, eps, channel_dim):
    """Pool-rate sums S1 = Σg, S2 = Σg·â and the ``dz`` constants c0, c1, c2."""
    r = torch.rsqrt(var + eps)
    m = gamma * r
    shape = [1, 1, 1]
    shape[channel_dim] = -1
    dims = tuple(d for d in range(3) if d != channel_dim)
    ahat = (a_sel.float() - mu.view(shape)) * r.view(shape)
    s1 = g.sum(dims)
    s2 = (g * ahat).sum(dims)
    c0 = m
    c1 = -m * s1 / n + m * r * mu * s2 / n + g_mu / n - 2.0 * mu * g_var / n
    c2 = -m * r * s2 / n + 2.0 * g_var / n
    return s1, s2, c0, c1, c2


class FusedBlock0Train(torch.autograd.Function):
    """``(x (B, T, 1) f32, w (k, 1, C), b, γ, β)`` → ``(pooled (B, T/pool, C) f32, μ, σ²)``."""

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, pool: int, eps: float,
                gemm_dtype: torch.dtype, sel_dtype: torch.dtype):
        n = x.shape[0] * x.shape[1]
        sgn = _sign(gamma)
        a_sel, sum_a, sumsq_a, _ = cuda_conv_train.conv_block0_train(
            x, w, b, sgn, pool, gemm_dtype, sel_dtype)
        mu, var, r = _stats(sum_a, sumsq_a, n, eps)
        pooled = (a_sel.float() - mu) * (gamma * r) + beta
        ctx.save_for_backward(x, w, b, gamma, sgn, a_sel, mu, var)
        ctx.cfg = (pool, eps, gemm_dtype)
        return pooled, mu, var

    @staticmethod
    def backward(ctx, g, g_mu, g_var):
        x, w, b, gamma, sgn, a_sel, mu, var = ctx.saved_tensors
        pool, eps, gemm_dtype = ctx.cfg
        n = x.shape[0] * x.shape[1]
        g = g.float()
        s1, s2, c0, c1, c2 = _bn_backward_constants(g, a_sel, gamma, mu, var, g_mu, g_var,
                                                     n, eps, 2)
        dw, db = cuda_conv_train.conv_block0_train_bwd(x, w, b, sgn, g, c0, c1, c2, pool,
                                                       gemm_dtype)
        return None, dw.to(w.dtype), db, s2, s1, None, None, None, None


def symmetric_padding(kernel_size: int, dilation: int) -> int | None:
    """Each side's share of XLA's SAME padding, or None where the reach is
    odd (an even kernel, undilated): SAME then pads one more on the right,
    which cuDNN's padding cannot say, and the caller uses the plain block."""
    reach = dilation * (kernel_size - 1)
    return None if reach % 2 else reach // 2


def _conv_backward(dz4, x4, w4, pad, dilation, need_dx: bool):
    """cuDNN's dX and dW of ``F.conv2d(x4, w4, padding=(0, pad), dilation=(1,
    dilation))`` on the (B, C, 1, T) channels-last views."""
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dz4, x4, w4, None, [1, 1], [0, pad], [1, dilation], False, [0, 0], 1,
        [need_dx, True, False])
    return dx, dw


def _nhwc(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``(B, C, T)`` → its ``(B, C, 1, T)`` view in ``dtype``, channels last;
    no copy where ``t`` is channels last in ``dtype`` already."""
    return t.unsqueeze(2).to(dtype, memory_format=torch.channels_last)


class FusedBlocknTrain(torch.autograd.Function):
    """``(x (B, Cin, T), w (Cout, Cin, k), b, γ, β)`` → ``(pooled (B, Cout, T/pool) f32, μ, σ²)``.

    Channels last: ``x`` may come in any layout, and one that is channels
    last (``cuda_routing.is_channels_last``, as the train forward hands it)
    in the GEMM dtype is not copied; ``pooled`` and dX come back channels
    last. The saved residual is the conv's raw output ``z``, in the GEMM
    dtype, which B7 reads in both passes (the activation itself is never
    written). ``a_sel`` is kept in the same dtype, so that the routing pass
    can match it exactly. The conv's SAME padding must be symmetric
    (:func:`symmetric_padding`), as for every block 1+ of the configs (k = 3).
    """

    cotangent_copies = 0  # backward calls whose cotangent came in another layout

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, pool: int, eps: float, dilation: int,
                gemm_dtype: torch.dtype):
        pad = symmetric_padding(w.shape[2], dilation)
        if pad is None:
            raise ValueError(f"FusedBlocknTrain: SAME padding of k={w.shape[2]}, "
                             f"dilation={dilation} is not symmetric")
        x4, w4 = _nhwc(x, gemm_dtype), _nhwc(w, gemm_dtype)
        z = F.conv2d(x4, w4, None, padding=(0, pad), dilation=(1, dilation)).squeeze(2)
        sgn = _sign(gamma)
        a_sel, sum_a, sumsq_a = cuda_routing.pool_fwd(z, b, sgn, pool, gemm_dtype)
        mu, var, r = _stats(sum_a, sumsq_a, z.shape[0] * z.shape[2], eps)
        pooled = (a_sel.float() - mu[:, None]) * (gamma * r)[:, None] + beta[:, None]
        ctx.save_for_backward(x4, w4, z, b, a_sel, gamma, mu, var)
        ctx.cfg = (pool, eps, pad, dilation, gemm_dtype, x.dtype, w.dtype)
        return pooled, mu, var

    @staticmethod
    def backward(ctx, g, g_mu, g_var):
        x4, w4, z, b, a_sel, gamma, mu, var = ctx.saved_tensors
        pool, eps, pad, dilation, gemm_dtype, x_dtype, w_dtype = ctx.cfg
        n = z.shape[0] * z.shape[2]
        g = g.float()
        if not cuda_routing.is_channels_last(g):
            # Autograd hands the cotangent in its producer's layout: on the
            # train forward the next block's dX or the head's max, channels
            # last both; a caller that reads ``pooled`` another way pays this copy.
            FusedBlocknTrain.cotangent_copies += 1
            g = g.permute(0, 2, 1).contiguous().permute(0, 2, 1)
        s1, s2, c0, c1, c2 = _bn_backward_constants(g, a_sel, gamma, mu, var, g_mu, g_var,
                                                     n, eps, 1)
        dz, db = cuda_routing.route_bwd(z, b, a_sel, g, c0, c1, c2, pool, gemm_dtype)
        need_dx = ctx.needs_input_grad[0]
        dx, dw = _conv_backward(dz.unsqueeze(2), x4, w4, pad, dilation, need_dx)
        return (dx.squeeze(2).to(x_dtype) if need_dx else None,
                dw.squeeze(2).to(w_dtype, memory_format=torch.contiguous_format), db, s2, s1,
                None, None, None, None)
