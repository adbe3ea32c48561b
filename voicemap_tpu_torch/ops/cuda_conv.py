"""B2 and B8: the encoder's conv blocks fused in one kernel each.

B2 ports ``voicemap_tpu/ops/pallas_conv.py :: pallas_conv_block0``: block 0,
SAME conv (Cin=1, k=32) + bias → relu → BatchNorm inference affine →
max-pool 4, with only the pool-rate ``(B, T//4, C)`` output written. The
kernels are in ``csrc/conv_block0.cu``, chosen by ``gemm_dtype``: every
bf16 GEMM (the serving paths, bf16, f32 or int8 out) runs the tensor-core
kernel (``mma.sync``; its host side in ``ops/block0_tc``), whose f32 sums
agree with the plain version to an order bound; a float32 GEMM runs the
CUDA-core kernel, bit for bit the plain version. ``conv_block0_reference``
is the plain PyTorch version of both.

B8 ports ``pallas_conv_blockn`` and ``pallas_conv_blockn_streamed`` of the
same file: a bf16 block 1+, SAME conv (k odd, dilation d, channels last) +
bias → relu → BN affine → max-pool 2 (or none: pool 1) → ``(B, T//pool,
Cout)``. The TPU kernels take dilation 1 and pool 2; the JAX package sends
config #3's dilated and pool-1 blocks to XLA (``_xla_block``), and B8 takes
them too. The kernel is ``csrc/conv_blockn.cu``; ``conv_blockn_reference``
is its plain version, the pooled GEMM of
``models/fused_encoder.fused_block_apply`` with this module's epilogue.
Unlike the TPU wrappers it takes an odd T and floors, as the unfused block
does: the conv still reads the last row and the pool drops its output. The
tensor cores' f32 summation order cannot be pinned, so B8 agrees with its
plain version to a bound, not bit for bit.

Semantics shared by both kernels and their plain versions, each pinned by a
test:

- x and w are rounded to ``gemm_dtype``; products and sums are f32; the
  epilogue is f32 and the output is rounded once, to ``out_dtype``;
- the epilogue is ``relu(y + bias) * mul + add`` and the max over the pool
  phases comes after it (``mul`` can be negative);
- with ``requant_scale`` ``s0`` (the int8 serving path) the output is int8,
  ``clamp(round_half_even(pooled * (1 / s0)), ±127)`` from the f32 pooled
  value, with ``1 / s0`` computed in f32 first, as the Pallas wrapper does;
- SAME padding of the even k=32 puts 15 zeros left and 16 right; of an odd
  k at dilation d, d·(k−1)/2 each side;
- ``T % pool`` tail samples are dropped from the pooled output (floor).

Dispatch is by the input's device: a CPU tensor takes the plain version, a
CUDA tensor launches a kernel (B2: k=32, pool=4; B8: k odd, pool 1 or 2,
the reach d·(k−1) within ``conv_sm90.MAX_REACH``, bf16 in), and a failed
build or launch raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import block0_tc, conv_sm90

KERNEL_TAPS = 32
KERNEL_POOL = 4
_SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
_B2_OUT = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def bn_affine(b, bn_scale, bn_bias, bn_mean, bn_var, bn_eps):
    """``(bias, mul, add)`` in f32: ``relu(y + bias) * mul + add`` is the
    conv bias, relu and BatchNorm inference of the block."""
    mul = torch.rsqrt(bn_var.float() + bn_eps) * bn_scale.float()
    add = bn_bias.float() - bn_mean.float() * mul
    return b.float(), mul, add


def conv_block0_reference(
    x: torch.Tensor,  # (B, T, 1) or (B, T) float32
    w: torch.Tensor,  # (k, 1, C) flax layout
    b: torch.Tensor,
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    bn_eps: float = 1e-3,
    pool: int = 4,
    out_dtype: torch.dtype = torch.bfloat16,
    gemm_dtype: torch.dtype = torch.bfloat16,
    requant_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the B2 kernel → ``(B, T // pool, C)``,
    int8 when ``requant_scale`` is given (``out_dtype`` is then not read).

    The conv sums its taps in order, k = 0 … K−1, in f32, as the kernel
    does. A product of two bf16 values is exact in f32, so with bf16
    operands the two agree bit for bit; where the BatchNorm affine cancels
    to near zero, any other summation order would differ there by many bf16
    ulps.
    """
    if x.dim() == 3:
        x = x[..., 0]
    B, T = x.shape
    k, _, c = w.shape
    xp = F.pad(x.to(gemm_dtype).float(), ((k - 1) // 2, k // 2))  # (B, T + k - 1)
    wq = w[:, 0, :].to(gemm_dtype).float()  # (k, C)
    y = torch.zeros((B, c, T), dtype=torch.float32, device=x.device)
    for j in range(k):
        y += xp[:, None, j:j + T] * wq[j][:, None]
    bias, mul, add = bn_affine(b, bn_scale, bn_bias, bn_mean, bn_var, bn_eps)
    y = torch.relu(y + bias[:, None]) * mul[:, None] + add[:, None]
    y = F.max_pool1d(y, pool, pool).transpose(1, 2)  # floor: drops the T % pool tail
    if requant_scale is not None:
        return requantize(y, 1.0 / requant_scale.float())
    return y.to(out_dtype)


def requantize(y: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """``clamp(round_half_even(y * inv_scale), ±127)`` as int8; ``y`` f32."""
    return torch.round(y * inv_scale).clamp(-127, 127).to(torch.int8)


def conv_block0(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    bn_eps: float = 1e-3,
    pool: int = 4,
    out_dtype: torch.dtype = torch.bfloat16,
    gemm_dtype: torch.dtype = torch.bfloat16,
    requant_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused conv(SAME)+relu+BN(inference)+maxpool → ``(B, T // pool, C)``;
    with ``requant_scale`` ``(C,)`` the requantized int8 output of the int8
    serving path."""
    if x.device.type == "cpu":
        return conv_block0_reference(x, w, b, bn_scale, bn_bias, bn_mean, bn_var,
                                     bn_eps, pool, out_dtype, gemm_dtype, requant_scale)
    if x.device.type != "cuda":
        raise ValueError(f"conv_block0: no kernel for device {x.device}")
    if x.dim() == 3:
        if x.shape[-1] != 1:
            raise ValueError("conv_block0: the kernel is Cin=1 only")
        x = x[..., 0]
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("conv_block0: x must be a contiguous (B, T[, 1]) float32 tensor")
    k, cin, c = w.shape
    if (k, cin, pool) != (KERNEL_TAPS, 1, KERNEL_POOL):
        raise ValueError(
            f"conv_block0: the kernel takes k={KERNEL_TAPS}, Cin=1, pool={KERNEL_POOL}; "
            f"got k={k}, Cin={cin}, pool={pool}")
    if out_dtype not in _SUPPORTED_DTYPES or gemm_dtype not in _SUPPORTED_DTYPES:
        raise ValueError("conv_block0: out_dtype and gemm_dtype must be float32 or bfloat16")
    B, T = x.shape
    params = (w, b, bn_scale, bn_bias, bn_mean, bn_var)
    if requant_scale is not None:
        params += (requant_scale,)
        out_dtype = torch.int8
    if any(p.device != x.device for p in params):
        raise ValueError(f"conv_block0: every parameter must lie on {x.device}")
    if any(p.shape != (c,) for p in params[1:]):
        raise ValueError(f"conv_block0: bias and BatchNorm tensors must be ({c},)")
    tensor_cores = gemm_dtype == torch.bfloat16
    if tensor_cores:
        tile = block0_tc.pick_tile(B, T, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
        need = block0_tc.smem_bytes(c, tile, block0_tc.OUT_BYTES[out_dtype])
        if need > block0_tc.SMEM_LIMIT:
            raise ValueError(f"conv_block0: C = {c} needs {need} bytes of shared memory a "
                             f"CTA, over {block0_tc.SMEM_LIMIT}")
    elif B > 65535:
        raise ValueError("conv_block0: the float32 GEMM kernel takes at most 65535 rows a "
                         "launch")
    aff = torch.stack(bn_affine(b, bn_scale, bn_bias, bn_mean, bn_var, bn_eps)).contiguous()
    inv_s0 = None if requant_scale is None else (1.0 / requant_scale.float()).contiguous()
    out = torch.empty((B, T // pool, c), dtype=out_dtype, device=x.device)
    from .._build import check, library

    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        inv_ptr = None if inv_s0 is None else inv_s0.data_ptr()
        if tensor_cores:
            wp = block0_tc.pack_weights(w)
            err = lib.vm_conv_block0_tc(x.data_ptr(), wp.data_ptr(), aff.data_ptr(), inv_ptr,
                                        out.data_ptr(), B, T, c, _B2_OUT[out_dtype], tile,
                                        stream)
        else:
            wk = w[:, 0, :].float().contiguous()  # (k, C)
            err = lib.vm_conv_block0(x.data_ptr(), wk.data_ptr(), aff.data_ptr(), inv_ptr,
                                     out.data_ptr(), B, T, c, k, pool, 0,
                                     int(out_dtype == torch.bfloat16), stream)
    check(err, "conv_block0 (" + ("tensor cores" if tensor_cores else "float32 GEMM") + ")")
    if tensor_cores:
        conv_block0.launches += 1
    else:
        conv_block0.f32_launches += 1
    return out


# kernel launches; the CPU path does not count: the tensor-core kernel (every
# bf16 GEMM: bf16, f32 and int8 out) and the f32 CUDA-core kernel
conv_block0.launches = 0
conv_block0.f32_launches = 0


# ---------------------------------------------------------------------------
# B8: blocks 1+ in bf16 (k odd, dilation d, pool 1 or 2), channels last
# ---------------------------------------------------------------------------

BLOCKN_POOL = 2  # config #1's pool, the default
BLOCKN_CIN_MULTIPLE = 8  # TMA's row stride of the input: a multiple of 16 bytes
_BLOCKN_OUT = {torch.bfloat16: 1, torch.float32: 2}


def stacked_weights_chan(w: torch.Tensor, pool: int = BLOCKN_POOL,
                         dilation: int = 1) -> torch.Tensor:
    """w (k, Cin, C') → W4 (win·Cin, pool·C') in f32, win = d·(k − 1) +
    pool, ``W4[m·Cin + ci, j·C' + c'] = w[(m − j) / d, ci, c']`` (zero where
    (m − j) / d is no tap): the phase-stacked weights of the pooled GEMM."""
    k, cin, cout = w.shape
    reach = dilation * (k - 1)
    w4 = torch.zeros((reach + pool, cin, pool, cout), dtype=torch.float32, device=w.device)
    for j in range(pool):
        w4[j:j + reach + 1:dilation, :, j, :] = w.float()
    return w4.reshape((reach + pool) * cin, pool * cout)


def conv_blockn_reference(
    x: torch.Tensor,  # (B, T, Cin)
    w: torch.Tensor,  # (k, Cin, Cout) flax layout, k odd
    b: torch.Tensor,
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    bn_eps: float = 1e-3,
    pool: int = BLOCKN_POOL,
    out_dtype: torch.dtype = torch.bfloat16,
    gemm_dtype: torch.dtype = torch.bfloat16,
    dilation: int = 1,
) -> torch.Tensor:
    """Plain PyTorch version of the B8 kernel → ``(B, T // pool, Cout)``.

    The pooled GEMM: each output position's window of d·(k − 1) + pool input
    rows (SAME-padded, rounded to ``gemm_dtype``) times
    ``stacked_weights_chan``, summed in f32, gives the conv at times
    pool·u … pool·u + pool − 1 side by side; then ``relu(y + bias) * mul +
    add`` in f32, the max of the phases, and one rounding to ``out_dtype``.
    An odd T floors at pool 2.
    """
    return _blockn_reference(x, w, *bn_affine(b, bn_scale, bn_bias, bn_mean, bn_var, bn_eps),
                             pool, out_dtype, gemm_dtype, dilation)


def conv_blockn_rows_reference(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                               mul: torch.Tensor, add: torch.Tensor, pool: int = 1,
                               out_dtype: torch.dtype = torch.float32,
                               gemm_dtype: torch.dtype = torch.bfloat16,
                               dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv_blockn_rows`: B8's, with the
    epilogue's rows given."""
    return _blockn_reference(x, w, bias.float(), mul.float(), add.float(), pool, out_dtype,
                             gemm_dtype, dilation)


def _blockn_reference(x, w, bias, mul, add, pool, out_dtype, gemm_dtype, dilation):
    if pool not in conv_sm90.POOLS:
        raise ValueError(f"conv_blockn: pool 1 or 2, got {pool}")
    k, _, cout = w.shape
    if k % 2 == 0:
        raise ValueError(f"conv_blockn: k must be odd, got {k}")
    B, T, cin = x.shape
    t_out = T // pool
    if t_out == 0:
        return torch.zeros((B, 0, cout), dtype=out_dtype, device=x.device)
    h = dilation * (k - 1) // 2
    win = 2 * h + pool
    xp = F.pad(x.to(gemm_dtype).float(), (0, 0, h, h + pool - 1))  # (B, T + win - 1, Cin)
    frames = xp.unfold(1, win, pool)[:, :t_out]  # (B, t_out, Cin, win)
    frames = frames.transpose(2, 3).reshape(B, t_out, win * cin)
    y = frames @ stacked_weights_chan(w.to(gemm_dtype), pool, dilation)  # (B, t_out, pool·Cout)
    bias, mul, add = (v.repeat(pool) for v in (bias, mul, add))
    y = torch.relu(y + bias) * mul + add
    return y.unflatten(-1, (pool, cout)).amax(dim=-2).to(out_dtype)


def check_blockn_launch(x: torch.Tensor, w: torch.Tensor, vecs: tuple, pool: int,
                        out_dtype: torch.dtype, gemm_dtype: torch.dtype,
                        dilation: int = 1) -> None:
    """Raise ``ValueError`` for what the B8 kernel does not take: ``vecs``
    are the bias and the four BatchNorm tensors, or the epilogue's three
    rows."""
    if x.dim() != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("conv_blockn: x must be a contiguous (B, T, Cin) bfloat16 tensor")
    cin = x.shape[2]
    if w.dim() != 3 or w.shape[1] != cin:
        raise ValueError(f"conv_blockn: w must be (k, {cin}, Cout)")
    k, _, cout = w.shape
    if k % 2 == 0 or pool not in conv_sm90.POOLS or dilation < 1:
        raise ValueError(f"conv_blockn: the kernel takes k odd, pool 1 or 2 and dilation >= 1; "
                         f"got k={k}, pool={pool}, dilation={dilation}")
    if gemm_dtype != torch.bfloat16 or out_dtype not in _BLOCKN_OUT:
        raise ValueError("conv_blockn: the kernel multiplies in bfloat16 and writes "
                         "bfloat16 or float32")
    if cin % BLOCKN_CIN_MULTIPLE:
        raise ValueError(f"conv_blockn: the kernel takes Cin a multiple of "
                         f"{BLOCKN_CIN_MULTIPLE}, got {cin}")
    if not conv_sm90.takes(k, dilation, pool):
        raise ValueError(f"conv_blockn: k={k} at dilation {dilation} (reach "
                         f"{dilation * (k - 1)}) is wider than the kernel takes: k <= "
                         f"{conv_sm90.MAX_K}, reach <= {conv_sm90.MAX_REACH}")
    if any(p.device != x.device for p in (w, *vecs)):
        raise ValueError(f"conv_blockn: every parameter must lie on {x.device}")
    if any(p.shape != (cout,) for p in vecs):
        raise ValueError(f"conv_blockn: the per-channel tensors must be ({cout},)")
    if x.data_ptr() % 16:
        raise ValueError("conv_blockn: x must be 16-byte aligned")


def conv_blockn(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    bn_eps: float = 1e-3,
    pool: int = BLOCKN_POOL,
    out_dtype: torch.dtype = torch.bfloat16,
    gemm_dtype: torch.dtype = torch.bfloat16,
    dilation: int = 1,
) -> torch.Tensor:
    """Fused conv(SAME, k odd, dilation d)+relu+BN(inference)+maxpool(pool)
    of a block 1+, channels last: ``(B, T, Cin)`` → ``(B, T // pool,
    Cout)``, pool 1 or 2."""
    if x.device.type == "cpu":
        return conv_blockn_reference(x, w, b, bn_scale, bn_bias, bn_mean, bn_var, bn_eps,
                                     pool, out_dtype, gemm_dtype, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"conv_blockn: no kernel for device {x.device}")
    check_blockn_launch(x, w, (b, bn_scale, bn_bias, bn_mean, bn_var), pool, out_dtype,
                        gemm_dtype, dilation)
    return _launch_blockn(x, w, bn_affine(b, bn_scale, bn_bias, bn_mean, bn_var, bn_eps), pool,
                          out_dtype, dilation)


def conv_blockn_rows(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, mul: torch.Tensor,
                     add: torch.Tensor, pool: int = 1, out_dtype: torch.dtype = torch.float32,
                     gemm_dtype: torch.dtype = torch.bfloat16, dilation: int = 1) -> torch.Tensor:
    """B8 with the epilogue's rows given: ``relu(conv + bias) * mul + add``,
    max-pooled → ``(B, T // pool, Cout)``. The pool-rate-residual train
    forward (``ops/conv_train.FusedBlocknRecompute``) runs B8 unchanged
    through this at pool 1 with f32 output and rows ``(b, 1, 0)``: its
    epilogue then yields ``relu(acc + b)`` in f32 exactly (a product by 1 and
    a sum with 0 round to themselves), the JAX package's ``relu(conv with
    f32 accumulation + b)``. Counts on ``conv_blockn.launches``."""
    if x.device.type == "cpu":
        return conv_blockn_rows_reference(x, w, bias, mul, add, pool, out_dtype, gemm_dtype,
                                          dilation)
    if x.device.type != "cuda":
        raise ValueError(f"conv_blockn: no kernel for device {x.device}")
    check_blockn_launch(x, w, (bias, mul, add), pool, out_dtype, gemm_dtype, dilation)
    return _launch_blockn(x, w, (bias.float(), mul.float(), add.float()), pool, out_dtype,
                          dilation)


def _launch_blockn(x, w, rows: tuple, pool: int, out_dtype, dilation: int) -> torch.Tensor:
    """One B8 launch on checked inputs, the epilogue's rows ``(bias, mul,
    add)`` in f32."""
    B, T, cin = x.shape
    k, _, cout = w.shape
    out = torch.empty((B, T // pool, cout), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    # (Cout, k·Kp) K-major, each tap's Cin padded with zeros to 128 bytes
    wp = conv_sm90.pack_taps(w.to(torch.bfloat16))
    aff = torch.stack(rows).contiguous()
    from .._build import check, library

    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vm_conv_blockn(x.data_ptr(), wp.data_ptr(), aff.data_ptr(), out.data_ptr(),
                                 B, T, cin, cout, k, dilation, pool, _BLOCKN_OUT[out_dtype],
                                 stream)
    check(err, "conv_blockn")
    conv_blockn.launches += 1
    return out


conv_blockn.launches = 0  # kernel launches; the CPU path does not count
