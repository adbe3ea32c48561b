"""B3: the int8 mid block of the int8 serving path, fused in one kernel.

Port of ``voicemap_tpu/ops/pallas_quant_block.py :: pallas_quant_block`` and
of the block it stands for, ``voicemap_tpu/models/quant_infer.py ::
_quant_block``: SAME conv (k=3, dilation d) in s8×s8→s32, the folded
epilogue ``relu(acc + beta) * alpha + gamma``, requantization to int8 (or
the dequantized output of the last block), and max-pool 2 (or none: pool 1).
The TPU kernel takes dilation 1 and pool 2; the JAX package serves config
#3's dilated and pool-1 blocks through ``_quant_block`` on XLA's int8 conv
(``rhs_dilation``), and this kernel takes those too. The kernel is
``csrc/quant_block.cu``; ``quant_block_reference`` is its plain PyTorch
version, a port of ``_quant_block``.

Semantics shared by both, each pinned by a test:

- input ``(B, T, Cin)`` int8, channels last, as B2 and B3 write it; weights
  ``(3, Cin, Cout)`` int8, the JAX package's layout; ``alpha``, ``beta``,
  ``gamma`` ``(Cout,)`` f32;
- ``acc`` is the exact int32 sum over taps t − d, t, t + d, with zero rows
  outside [0, T);
- ``z = relu(float(acc) + beta) * alpha + gamma`` in f32, op by op;
- mid blocks: ``clamp(round_half_even(z), ±127)`` int8; the last block:
  ``z`` rounded to ``out_dtype``;
- max-pool 2 with floor (an odd T drops its last step), or pool 1.

The kernel pools the raw accumulator first (max where ``alpha > 0``, min
elsewhere) and runs the epilogue at pool rate; by monotonicity this equals
the plain version's epilogue-then-pool bit for bit.

B10, the stage prefixes of ``benchmarks/bench_qblock_attrib.py``
(``_kernel_staged``, ``_kernel_xk``) that attribute B3's time, is the same
kernel cut short (``quant_block_stage``): ``"mma"`` writes the int32
accumulator of the even times, ``acc[:, 0::2]``; ``"pool"`` the pair select
by the sign of alpha, ``sel``; ``"full"`` is B3's mid block itself, int8.
``quant_block_stage_reference`` is its plain version; every stage is exact.
The TPU's stages 1–2 (a ``(t+2, Cin) @ (Cin, 3·Cout)`` product, then the
shifted tap adds) have no separate stage here: the taps already sit inside
K = 3·Cin, the layout of the TPU's ``_kernel_xk``, which the ``full`` stage
is.

B3's train epilogue (``quant_block_train``) is the same kernel at pool 1
with the int8 training forward's epilogue (``make_fused_blockn_train(quant=
"int8")`` of ``voicemap_tpu/ops/conv_train.py``, whose conv the JAX package
leaves to XLA's int8 conv): ``a = relu(float(acc) · s + b)`` in f32, op by
op, with ``s = sx·sw`` per output channel formed by the caller, written
channels last in bf16 or f32, with no requantization and no pool (the train
op's pool pass, B7, reads ``a``). ``quant_block_train_reference`` is its
plain version; the two agree bit for bit.

Dispatch is by the input's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel, and a failed build or launch raises. PyTorch
has no int32 matrix product on the card, so the plain version accumulates in
float64, where every product and sum of int8 values here is exact
(|acc| ≤ 3·MAX_CIN·128² < 2³¹ < 2⁵³).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import conv_sm90

KERNEL_TAPS = 3
KERNEL_POOL = 2  # config #1's pool, the default; the kernel takes 1 or 2
CIN_MULTIPLE = 32  # one wgmma k-step of 32 bytes stays within one tap
# The kernel streams its weights, so shared memory no longer bounds Cin; the
# int32 sum does: |acc| <= 3 * Cin * 128^2 must stay below 2^31.
MAX_CIN = (2 ** 31 - 1) // (KERNEL_TAPS * 128 * 128) // CIN_MULTIPLE * CIN_MULTIPLE
_OUT_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
STAGES = ("mma", "pool", "full")  # B10's prefixes, in kernel order


def pack_weights(w_q: torch.Tensor) -> torch.Tensor:
    """``(3, Cin, Cout)`` → ``(Cout, 3·Kp)`` K-major, each tap's K run padded
    with zeros to Kp, a multiple of 128: ``[co, j·Kp + ci] = w_q[j, ci, co]``
    (``conv_sm90.pack_taps``)."""
    return conv_sm90.pack_taps(w_q)


def quant_block_reference(
    x_q: torch.Tensor,  # (B, T, Cin) int8
    w_q: torch.Tensor,  # (3, Cin, Cout) int8
    alpha: torch.Tensor,
    beta: torch.Tensor,
    gamma: torch.Tensor,
    *,
    last: bool = False,
    out_dtype: torch.dtype = torch.bfloat16,
    pool: int = KERNEL_POOL,
    dilation: int = 1,
) -> torch.Tensor:
    """Plain PyTorch version of the B3 kernel → ``(B, T // pool, Cout)``:
    int8, or ``out_dtype`` for the last block."""
    acc = accumulate(x_q, w_q, dilation)
    z = torch.relu(acc.float() + beta.float()) * alpha.float() + gamma.float()
    y = z.to(out_dtype) if last else torch.round(z).clamp(-127, 127).to(torch.int8)
    return pairs(y, pool).amax(dim=2)


def accumulate(x_q: torch.Tensor, w_q: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """The exact int32 conv sums ``(B, T, Cout)`` of dilation d, zero rows
    outside [0, T), accumulated in float64."""
    B, T, cin = x_q.shape
    k, _, cout = w_q.shape
    h = dilation * (k - 1) // 2
    xp = F.pad(x_q.double(), (0, 0, h, h))  # SAME: h zero rows each side
    cols = torch.cat([xp[:, j * dilation:j * dilation + T] for j in range(k)],
                     dim=-1)  # (B, T, 3·Cin)
    return (cols @ w_q.reshape(k * cin, cout).double()).to(torch.int32)


def pairs(y: torch.Tensor, pool: int = KERNEL_POOL) -> torch.Tensor:
    """``(B, T, C)`` → ``(B, T // pool, pool, C)``: the pooling windows, floor."""
    B, T, c = y.shape
    return y[:, :(T // pool) * pool].reshape(B, T // pool, pool, c)


def quant_block_stage_reference(x_q: torch.Tensor, w_q: torch.Tensor, alpha: torch.Tensor,
                                beta: torch.Tensor, gamma: torch.Tensor,
                                stage: str) -> torch.Tensor:
    """Plain PyTorch version of B10's ``stage`` → ``(B, T // 2, Cout)``:
    int32 ``acc[2u]`` (``"mma"``), int32 ``sel[u]``, the max of the pair
    where ``alpha > 0`` and the min elsewhere (``"pool"``), or the mid
    block's int8 output (``"full"``)."""
    if stage == "full":
        return quant_block_reference(x_q, w_q, alpha, beta, gamma)
    if stage not in STAGES:
        raise ValueError(f"quant_block_stage: stage must be one of {STAGES}, got {stage!r}")
    p = pairs(accumulate(x_q, w_q))
    if stage == "mma":
        return p[:, :, 0]
    return torch.where(alpha > 0, p.amax(dim=2), p.amin(dim=2))


def quant_block(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    gamma: torch.Tensor,
    *,
    last: bool = False,
    out_dtype: torch.dtype = torch.bfloat16,
    pool: int = KERNEL_POOL,
    dilation: int = 1,
) -> torch.Tensor:
    """int8 conv(k=3, SAME, dilation d) + epilogue + requantize + max-pool
    (pool 1 or 2) → ``(B, T // pool, Cout)``: int8, or ``out_dtype`` for the
    last block."""
    if x_q.device.type == "cpu":
        return quant_block_reference(x_q, w_q, alpha, beta, gamma, last=last,
                                     out_dtype=out_dtype, pool=pool, dilation=dilation)
    out_dtype = out_dtype if last else torch.int8
    if last and out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("quant_block: the last block dequantizes to bfloat16 or float32")
    out, wp, aff = _prepare("quant_block", x_q, w_q, alpha, beta, gamma, out_dtype, pool,
                            dilation)
    if out.numel() == 0:
        return out
    from .._build import check, library

    lib = library()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vm_quant_block(x_q.data_ptr(), wp.data_ptr(), aff.data_ptr(),
                                 out.data_ptr(), *x_q.shape, out.shape[2], dilation, pool,
                                 _OUT_KIND[out_dtype], stream)
    check(err, "quant_block")
    quant_block.launches += 1
    return out


quant_block.launches = 0  # kernel launches; the CPU path does not count


def quant_block_train_reference(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                                bias: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16,
                                dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch version of B3's train epilogue → ``(B, T, Cout)``
    ``out_dtype``: ``relu(float(acc) · scale + bias)``, each op rounded in
    f32, then one rounding to ``out_dtype``."""
    acc = accumulate(x_q, w_q, dilation).float()
    return torch.relu(acc * scale.float() + bias.float()).to(out_dtype)


def quant_block_train(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16,
                      dilation: int = 1) -> torch.Tensor:
    """B3's train epilogue: the int8 conv (k=3, SAME, dilation d) of ``x_q
    (B, T, Cin)`` and ``w_q (3, Cin, Cout)`` (``pack_weights`` packs it),
    dequantized as ``relu(float(acc) · scale + bias)`` → ``(B, T, Cout)``
    ``out_dtype`` (bf16 or f32), pool 1."""
    if x_q.device.type == "cpu":
        return quant_block_train_reference(x_q, w_q, scale, bias, out_dtype, dilation)
    if x_q.device.type != "cuda":
        raise ValueError(f"quant_block_train: no kernel for device {x_q.device}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("quant_block_train: the kernel writes bfloat16 or float32")
    check_quant_launch("quant_block_train", x_q, w_q, (scale, bias), 1, dilation)
    B, T, cin = x_q.shape
    cout = w_q.shape[2]
    out = torch.empty((B, T, cout), dtype=out_dtype, device=x_q.device)
    if out.numel() == 0:
        return out
    rows = torch.stack([scale.float(), bias.float(), torch.zeros_like(scale, dtype=torch.float32)])
    from .._build import check, library

    lib = library()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vm_quant_block_train(x_q.data_ptr(), pack_weights(w_q).data_ptr(),
                                       rows.contiguous().data_ptr(), out.data_ptr(), B, T, cin,
                                       cout, dilation, _OUT_KIND[out_dtype], stream)
    check(err, "quant_block_train")
    quant_block_train.launches += 1
    return out


quant_block_train.launches = 0  # kernel launches; the CPU path does not count


def check_quant_launch(name: str, x_q, w_q, vecs: tuple, pool: int = KERNEL_POOL,
                       dilation: int = 1) -> None:
    """Raise ``ValueError`` for what B3's kernel does not take: ``vecs`` are
    alpha, beta and gamma."""
    if x_q.dim() != 3 or x_q.dtype != torch.int8 or not x_q.is_contiguous():
        raise ValueError(f"{name}: x_q must be a contiguous (B, T, Cin) int8 tensor")
    cin = x_q.shape[2]
    if w_q.dim() != 3 or w_q.dtype != torch.int8 or w_q.shape[1] != cin:
        raise ValueError(f"{name}: w_q must be (3, {cin}, Cout) int8")
    k, _, cout = w_q.shape
    if k != KERNEL_TAPS:
        raise ValueError(f"{name}: the kernel takes k={KERNEL_TAPS}, got k={k}")
    if pool not in conv_sm90.POOLS or not 1 <= dilation <= conv_sm90.MAX_REACH // (k - 1):
        raise ValueError(f"{name}: the kernel takes pool 1 or 2 and dilation 1 to "
                         f"{conv_sm90.MAX_REACH // (k - 1)}; got pool {pool}, "
                         f"dilation {dilation}")
    if cin % CIN_MULTIPLE or cin > MAX_CIN:
        raise ValueError(
            f"{name}: the kernel takes Cin a multiple of {CIN_MULTIPLE} up to "
            f"{MAX_CIN}, got {cin}")
    if any(p.device != x_q.device for p in (w_q, *vecs)):
        raise ValueError(f"{name}: every parameter must lie on {x_q.device}")
    if any(p.shape != (cout,) for p in vecs):
        raise ValueError(f"{name}: the epilogue's rows must be ({cout},) each")
    if x_q.data_ptr() % 16:
        raise ValueError(f"{name}: x_q must be 16-byte aligned")


def _prepare(name: str, x_q, w_q, alpha, beta, gamma, out_dtype, pool: int = KERNEL_POOL,
             dilation: int = 1) -> tuple:
    """Check a launch of B3's kernel on a CUDA tensor; the output, the packed
    weights and the epilogue rows ``(3, Cout)``."""
    if x_q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x_q.device}")
    vecs = (alpha, beta, gamma)
    check_quant_launch(name, x_q, w_q, vecs, pool, dilation)
    B, T, _ = x_q.shape
    cout = w_q.shape[2]
    out = torch.empty((B, T // pool, cout), dtype=out_dtype, device=x_q.device)
    aff = torch.stack([v.float() for v in vecs]).contiguous()  # (3, Cout)
    return out, pack_weights(w_q), aff


def quant_block_stage(x_q: torch.Tensor, w_q: torch.Tensor, alpha: torch.Tensor,
                      beta: torch.Tensor, gamma: torch.Tensor, stage: str) -> torch.Tensor:
    """B10: B3's kernel cut after ``stage`` (``"mma"``, ``"pool"`` or
    ``"full"``) → ``(B, T // 2, Cout)``, int32 for the first two, int8 for
    ``"full"``."""
    if stage not in STAGES:
        raise ValueError(f"quant_block_stage: stage must be one of {STAGES}, got {stage!r}")
    if x_q.device.type == "cpu":
        return quant_block_stage_reference(x_q, w_q, alpha, beta, gamma, stage)
    out_dtype = torch.int8 if stage == "full" else torch.int32
    out, wp, aff = _prepare("quant_block_stage", x_q, w_q, alpha, beta, gamma, out_dtype)
    if out.numel() == 0:
        return out
    from .._build import check, library

    lib = library()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vm_quant_block_stage(x_q.data_ptr(), wp.data_ptr(), aff.data_ptr(),
                                       out.data_ptr(), *x_q.shape, out.shape[2],
                                       STAGES.index(stage), stream)
    check(err, "quant_block_stage")
    quant_block_stage.launches += 1
    return out


quant_block_stage.launches = 0  # kernel launches; the CPU path does not count
