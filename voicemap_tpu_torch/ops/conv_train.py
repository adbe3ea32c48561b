"""The fused conv + relu + BatchNorm(train) + max-pool block, with its gradient.

Port of ``voicemap_tpu/ops/conv_train.py :: make_fused_block0_train`` and of
``make_fused_blockn_train`` (its save-act variant, that variant with
``quant="int8"``, and its pool-rate-residual variant ``save_act=False``), as
three ``torch.autograd.Function`` classes.

BatchNorm's train-mode affine ``y = (a − μ)·γ·r + β`` (``r = rsqrt(σ² + ε)``)
is monotone per channel, so the max-pool of ``y`` picks the phase that
maximises ``sign(γ)·a``: the forward keeps only that selected value
``a_sel`` and the batch statistics, and forms the pooled output at pool rate
afterwards. The backward of BatchNorm with respect to ``a`` folds to
``dz = 1[a>0]·(c0·g + c1 + c2·a)`` with per-channel constants ``c0, c1, c2``
computed at pool rate (the pool routes each pooled cotangent to one
full-rate position, so the full-rate sums equal their pooled sums).

The pool-rate epilogue, the affine, the cast to the output dtype and the
spatial dropout (a keep mask ``(B, C)`` drawn by the caller, SpatialDropout
commuting with the max-pool), runs as one kernel each way
(``ops/cuda_routing.bn_apply`` and ``bn_grad``): the forward writes ``y`` in
the output dtype; the backward writes the f32 cotangent that B5 and B7 read,
with the pool-rate sums ``Σg`` and ``Σg·â`` beside it.

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
  dX (``aten.convolution_backward``, as the JAX package left them to XLA);
  for a dilated conv (d > 1) in the kernel's domain (``wgrad_routed``: three
  taps, a bf16 GEMM, d ≤ 64, channels in eights), config #3's blocks 1, 3, 5
  and 7, dW comes from ``ops/cuda_wgrad.conv_wgrad`` instead
  (cuDNN's wgrad took 45 ms at d = 16 and B = 2048), inside a span
  ``conv.wgrad.<block>`` at the batch's rows, and cuDNN computes dX alone.
  Channels last, as the JAX package lays it out: ``(B, C, T)`` tensors with
  the memory of ``(B, T, C)``, so cuDNN runs its NHWC convs with no layout
  conversion around them. With ``quant="int8"`` (the int8 training forward)
  the forward conv runs in s8×s8→s32 on B3's train epilogue
  (``ops/cuda_quant_block.quant_block_train``) with in-step symmetric scales
  (:func:`quantize_int8`), which writes the dequantized activation
  ``a = relu(acc·sx·sw + b)`` in the GEMM dtype; B7 pools it with a zero
  bias (``relu(a + 0) = a``), it is the saved residual, and the backward is
  straight through: the routing, the relu gate and the ``c2·a`` term read
  ``a``, dW and dX take the real ``x`` and ``w`` in the GEMM dtype.
- :class:`FusedBlocknRecompute` — blocks 1+, the pool-rate-residual variant:
  the forward's activation in f32 (B8 at pool 1 with f32 output and rows
  ``(b, 1, 0)`` in bf16, ``ops/cuda_conv.conv_blockn_rows``; cuDNN in f32
  plus B7's bias in f32), B7's pool pass with the phase index
  (``pool_fwd(..., want_idx=True)``); only ``x``, ``w``, ``b``, ``a_sel``,
  ``idx`` and the statistics are saved. The backward recomputes the conv
  in the GEMM dtype and routes by ``idx`` (B7's index mode): the recomputed
  bf16 activation need not equal the forward's f32 one, so routing by
  value could miss.

All three end their arguments with ``out_dtype`` (the compute dtype: f32,
bf16 or f16), a keep ``mask`` (B, C) f32 or None at no dropout, and
``keep``, and return ``(y, μ, σ²)``: ``y`` is
``spatial_dropout(pooled.to(out_dtype))`` bit for bit, μ and the biased
variance ``max(E[a²] − E[a]², 0)`` as flax takes it are f32 and carry
gradients. T must divide by the pool; callers use the plain block otherwise.
The blocks-1+ ops take a last, optional ``block``: the block's index in the
encoder, which names the weight gradient's span (no span without it).
"""

from __future__ import annotations

from contextlib import nullcontext

import torch
import torch.nn.functional as F

from ..utils.profiling import span
from . import cuda_conv, cuda_conv_train, cuda_quant_block, cuda_routing, cuda_wgrad

QUANT = ("none", "int8")  # FusedBlocknTrain's forward convs


def _sign(gamma: torch.Tensor) -> torch.Tensor:
    return torch.where(gamma >= 0, 1.0, -1.0).to(torch.float32)


def _stats(sum_a, sumsq_a, n: int, eps: float):
    mu = sum_a / n
    var = torch.clamp(sumsq_a / n - mu * mu, min=0.0)
    return mu, var, torch.rsqrt(var + eps)


def _bn_backward(g, a_sel, mask, keep, gamma, mu, var, g_mu, g_var, n, eps):
    """``g`` (the cotangent of ``y``) and ``a_sel``, both ``(B, T', C)``
    memory → the f32 cotangent ``g'``, the pool-rate sums S1 = Σg',
    S2 = Σg'·â (``bn_grad``) and the ``dz`` constants c0, c1, c2."""
    r = torch.rsqrt(var + eps)
    m = gamma * r
    g, s1, s2 = cuda_routing.bn_grad(g, a_sel, mask, keep, mu, r)
    c0 = m
    c1 = -m * s1 / n + m * r * mu * s2 / n + g_mu / n - 2.0 * mu * g_var / n
    c2 = -m * r * s2 / n + 2.0 * g_var / n
    return g, s1, s2, c0, c1, c2


class FusedBlock0Train(torch.autograd.Function):
    """``(x (B, T, 1) f32, w (k, 1, C), b, γ, β)`` → ``(y (B, T/pool, C), μ, σ²)``."""

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, pool: int, eps: float, gemm_dtype: torch.dtype,
                sel_dtype: torch.dtype, out_dtype: torch.dtype, mask, keep: float):
        n = x.shape[0] * x.shape[1]
        sgn = _sign(gamma)
        a_sel, sum_a, sumsq_a, _ = cuda_conv_train.conv_block0_train(
            x, w, b, sgn, pool, gemm_dtype, sel_dtype)
        mu, var, r = _stats(sum_a, sumsq_a, n, eps)
        y = cuda_routing.bn_apply(a_sel, mu, gamma * r, beta, mask, keep, out_dtype)
        ctx.save_for_backward(x, w, b, gamma, sgn, a_sel, mu, var, mask)
        ctx.cfg = (pool, eps, gemm_dtype, keep)
        return y, mu, var

    @staticmethod
    def backward(ctx, g, g_mu, g_var):
        x, w, b, gamma, sgn, a_sel, mu, var, mask = ctx.saved_tensors
        pool, eps, gemm_dtype, keep = ctx.cfg
        n = x.shape[0] * x.shape[1]
        g, s1, s2, c0, c1, c2 = _bn_backward(g.contiguous(), a_sel, mask, keep, gamma, mu, var,
                                             g_mu, g_var, n, eps)
        dw, db = cuda_conv_train.conv_block0_train_bwd(x, w, b, sgn, g, c0, c1, c2, pool,
                                                       gemm_dtype)
        return None, dw.to(w.dtype), db, s2, s1, None, None, None, None, None, None, None


def symmetric_padding(kernel_size: int, dilation: int) -> int | None:
    """Each side's share of XLA's SAME padding, or None where the reach is
    odd (an even kernel, undilated): SAME then pads one more on the right,
    which cuDNN's padding cannot say, and the caller uses the plain block."""
    reach = dilation * (kernel_size - 1)
    return None if reach % 2 else reach // 2


def wgrad_routed(dtype: torch.dtype, k: int, dilation: int, cin: int, cout: int) -> bool:
    """Whether :func:`_conv_backward` takes dW from ``conv_wgrad``: a
    dilated conv (d > 1) in the kernel's domain (``cuda_wgrad.takes``);
    cuDNN computes every other dW."""
    return dilation > 1 and cuda_wgrad.takes(dtype, k, dilation, cin, cout)


def _conv_backward(dz4, x4, w4, pad, dilation, need_dx: bool, block):
    """dX and dW ``(Cout, Cin, k)`` of ``F.conv2d(x4, w4, padding=(0, pad),
    dilation=(1, dilation))`` on the (B, C, 1, T) channels-last views: both
    from cuDNN, but where :func:`wgrad_routed`, dW from ``conv_wgrad`` (f32)
    on the same memory read as (B, T, C) rows, inside a span
    ``conv.wgrad.<block>`` where the block is given."""
    cout, cin, _, k = w4.shape
    wgrad = wgrad_routed(x4.dtype, k, dilation, cin, cout)
    dx = dw = None
    if need_dx or not wgrad:
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dz4, x4, w4, None, [1, 1], [0, pad], [1, dilation], False, [0, 0], 1,
            [need_dx, not wgrad, False])
    if not wgrad:
        return dx, dw.squeeze(2)
    with span(f"conv.wgrad.{block}", x4.shape[0]) if block is not None else nullcontext():
        dw = cuda_wgrad.conv_wgrad(x4.squeeze(2).permute(0, 2, 1).contiguous(),
                                   dz4.squeeze(2).permute(0, 2, 1).contiguous(), k, dilation)
    return dx, dw


def _nhwc(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``(B, C, T)`` → its ``(B, C, 1, T)`` view in ``dtype``, channels last;
    no copy where ``t`` is channels last in ``dtype`` already."""
    return t.unsqueeze(2).to(dtype, memory_format=torch.channels_last)


def quantize_int8(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """The int8 training forward's in-step scales and operands, as
    ``make_fused_blockn_train(quant="int8")`` forms them: ``x (B, T, Cin)``
    in any float dtype and ``w (Cout, Cin, k)`` → ``(qx (B, T, Cin) int8,
    qw (k, Cin, Cout) int8, s (Cout,) f32)``, with ``sx = max(max|x| / 127,
    1e-12)`` for the tensor, ``sw[c] = max(max|w[c]| / 127, 1e-12)`` a
    channel, ``q = clip(round_half_even(v / scale), ±127)`` by true division
    (the divisors are tensors on the data's device: CUDA divides by a host
    scalar as a product with its reciprocal) and ``s = sx·sw``."""
    c127 = torch.tensor(127.0, device=x.device)
    sx = torch.clamp(x.abs().amax().float() / c127, min=1e-12)
    wf = w.float()
    sw = torch.clamp(wf.abs().amax(dim=(1, 2)) / c127, min=1e-12)
    qx = torch.round(x.float() / sx).clamp(-127, 127).to(torch.int8).contiguous()
    qw = torch.round(wf / sw[:, None, None]).clamp(-127, 127).to(torch.int8)
    return qx, qw.permute(2, 1, 0), sx * sw


def _blockn_backward(x4, w4, z, bias, a_sel, route, gamma, mu, var, mask, g, g_mu, g_var,
                     cfg: tuple, need_dx: bool) -> tuple:
    """The blocks-1+ ops' shared backward: the epilogue's gradient and the
    pool-rate sums from ``g`` and ``a_sel`` (``bn_grad``), B7's routing pass
    on ``z`` and ``bias`` (by value with ``route`` = ``a_sel``, by phase with
    ``route`` = ``idx``), dW and dX (:func:`_conv_backward`) → the gradients
    of ``(x, w, b, γ, β)``."""
    pool, eps, pad, dilation, gemm_dtype, x_dtype, w_dtype, keep, block = cfg
    n = z.shape[0] * z.shape[2]
    if not cuda_routing.is_channels_last(g):
        # Autograd hands the cotangent in its producer's layout: on the
        # train forward the next block's dX or the head's max, channels
        # last both; a caller that reads ``y`` another way pays this copy.
        FusedBlocknTrain.cotangent_copies += 1
        g = g.permute(0, 2, 1).contiguous().permute(0, 2, 1)
    g, s1, s2, c0, c1, c2 = _bn_backward(g.permute(0, 2, 1), a_sel.permute(0, 2, 1), mask, keep,
                                         gamma, mu, var, g_mu, g_var, n, eps)
    dz, db = cuda_routing.route_bwd(z, bias, route, g.permute(0, 2, 1), c0, c1, c2, pool,
                                    gemm_dtype)
    dx, dw = _conv_backward(dz.unsqueeze(2), x4, w4, pad, dilation, need_dx, block)
    return (dx.squeeze(2).to(x_dtype) if need_dx else None,
            dw.to(w_dtype, memory_format=torch.contiguous_format), db, s2, s1)


def _apply(a_sel, mu, scale, beta, mask, keep, out_dtype):
    """``bn_apply`` on a channels-last ``(B, C, T')`` ``a_sel`` → ``y`` in
    the same layout."""
    return cuda_routing.bn_apply(a_sel.permute(0, 2, 1), mu, scale, beta, mask, keep,
                                 out_dtype).permute(0, 2, 1)


def _padding(w: torch.Tensor, dilation: int) -> int:
    pad = symmetric_padding(w.shape[2], dilation)
    if pad is None:
        raise ValueError(f"the fused blocks-1+ op: SAME padding of k={w.shape[2]}, "
                         f"dilation={dilation} is not symmetric")
    return pad


class FusedBlocknTrain(torch.autograd.Function):
    """``(x (B, Cin, T), w (Cout, Cin, k), b, γ, β)`` → ``(y (B, Cout, T/pool), μ, σ²)``.

    Channels last: ``x`` may come in any layout, and one that is channels
    last (``cuda_routing.is_channels_last``, as the train forward hands it)
    in the GEMM dtype is not copied; ``y`` and dX come back channels
    last. The saved residual is the conv's raw output ``z``, in the GEMM
    dtype, which B7 reads in both passes (the activation itself is never
    written); with ``quant="int8"`` it is the dequantized activation ``a``
    itself, which B7 reads with a zero bias. ``a_sel`` is kept in the same
    dtype, so that the routing pass can match it exactly. The conv's SAME
    padding must be symmetric (:func:`symmetric_padding`), as for every
    block 1+ of the configs (k = 3).
    """

    # backward calls of this op and of FusedBlocknRecompute whose cotangent
    # came in another layout
    cotangent_copies = 0

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, pool: int, eps: float, dilation: int,
                gemm_dtype: torch.dtype, quant: str, out_dtype: torch.dtype, mask,
                keep: float, block: int | None = None):
        if quant not in QUANT:
            raise ValueError(f"FusedBlocknTrain: quant must be one of {QUANT}, got {quant!r}")
        pad = _padding(w, dilation)
        x4, w4 = _nhwc(x, gemm_dtype), _nhwc(w, gemm_dtype)
        sgn = _sign(gamma)
        if quant == "int8":
            qx, qw, scale = quantize_int8(x.permute(0, 2, 1), w)
            z = cuda_quant_block.quant_block_train(qx, qw, scale, b, gemm_dtype,
                                                   dilation).permute(0, 2, 1)
            bias = torch.zeros_like(b, dtype=torch.float32)
        else:
            z = F.conv2d(x4, w4, None, padding=(0, pad), dilation=(1, dilation)).squeeze(2)
            bias = b
        a_sel, sum_a, sumsq_a = cuda_routing.pool_fwd(z, bias, sgn, pool, gemm_dtype)
        mu, var, r = _stats(sum_a, sumsq_a, z.shape[0] * z.shape[2], eps)
        y = _apply(a_sel, mu, gamma * r, beta, mask, keep, out_dtype)
        ctx.save_for_backward(x4, w4, z, bias, a_sel, gamma, mu, var, mask)
        ctx.cfg = (pool, eps, pad, dilation, gemm_dtype, x.dtype, w.dtype, keep, block)
        return y, mu, var

    @staticmethod
    def backward(ctx, g, g_mu, g_var):
        x4, w4, z, bias, a_sel, gamma, mu, var, mask = ctx.saved_tensors
        return (*_blockn_backward(x4, w4, z, bias, a_sel, a_sel, gamma, mu, var, mask, g, g_mu,
                                  g_var, ctx.cfg, ctx.needs_input_grad[0]),
                None, None, None, None, None, None, None, None, None)


class FusedBlocknRecompute(torch.autograd.Function):
    """``make_fused_blockn_train(save_act=False)``: the signature and layout
    of :class:`FusedBlocknTrain`, with pool-rate residuals only.

    Forward: ``a = relu(conv(x, w) + b)`` in f32 with the conv's products in
    the GEMM dtype and f32 sums (B8, pool 1, rows ``(b, 1, 0)``, for a bf16
    GEMM; cuDNN in f32 and B7's bias for an f32 one), the statistics in f32,
    B7's selection with the phase index ``idx`` (the first phase of the
    strict max), ``a_sel`` rounded to the GEMM dtype. Saved: ``x`` and ``w``
    (their GEMM-dtype views), ``b``, ``a_sel``, ``idx``, γ, μ, σ². Backward:
    ``z = conv(x, w)`` again in the GEMM dtype, then B7's routing by ``idx``
    with the real ``b`` (``a = relu(z + b)`` in that dtype), cuDNN's dW and
    dX.
    """

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, pool: int, eps: float, dilation: int,
                gemm_dtype: torch.dtype, out_dtype: torch.dtype, mask, keep: float,
                block: int | None = None):
        pad = _padding(w, dilation)
        x4, w4 = _nhwc(x, gemm_dtype), _nhwc(w, gemm_dtype)
        sgn = _sign(gamma)
        zero = torch.zeros_like(b, dtype=torch.float32)
        if gemm_dtype == torch.bfloat16:
            a = cuda_conv.conv_blockn_rows(
                x4.squeeze(2).permute(0, 2, 1), w.permute(2, 1, 0), b, torch.ones_like(zero),
                zero, 1, torch.float32, torch.bfloat16, dilation).permute(0, 2, 1)
            bias = zero
        else:
            a = F.conv2d(x4, w4, None, padding=(0, pad), dilation=(1, dilation)).squeeze(2)
            bias = b
        a_sel, sum_a, sumsq_a, idx = cuda_routing.pool_fwd(a, bias, sgn, pool, gemm_dtype,
                                                           want_idx=True)
        mu, var, r = _stats(sum_a, sumsq_a, a.shape[0] * a.shape[2], eps)
        y = _apply(a_sel, mu, gamma * r, beta, mask, keep, out_dtype)
        ctx.save_for_backward(x4, w4, b, a_sel, idx, gamma, mu, var, mask)
        ctx.cfg = (pool, eps, pad, dilation, gemm_dtype, x.dtype, w.dtype, keep, block)
        return y, mu, var

    @staticmethod
    def backward(ctx, g, g_mu, g_var):
        x4, w4, b, a_sel, idx, gamma, mu, var, mask = ctx.saved_tensors
        pool, eps, pad, dilation = ctx.cfg[:4]
        z = F.conv2d(x4, w4, None, padding=(0, pad), dilation=(1, dilation)).squeeze(2)
        return (*_blockn_backward(x4, w4, z, b, a_sel, idx, gamma, mu, var, mask, g, g_mu, g_var,
                                  ctx.cfg, ctx.needs_input_grad[0]),
                None, None, None, None, None, None, None, None)
