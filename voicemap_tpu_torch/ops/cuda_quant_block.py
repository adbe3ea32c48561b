"""B3: the int8 mid block of the int8 serving path, fused in one kernel.

Port of ``voicemap_tpu/ops/pallas_quant_block.py :: pallas_quant_block`` and
of the block it stands for, ``voicemap_tpu/models/quant_infer.py ::
_quant_block``: SAME conv (k=3) in s8×s8→s32, the folded epilogue
``relu(acc + beta) * alpha + gamma``, requantization to int8 (or the
dequantized output of the last block), and max-pool 2. The kernel is
``csrc/quant_block.cu``; ``quant_block_reference`` is its plain PyTorch
version, a port of ``_quant_block``.

Semantics shared by both, each pinned by a test:

- input ``(B, T, Cin)`` int8, channels last, as B2 and B3 write it; weights
  ``(3, Cin, Cout)`` int8, the JAX package's layout; ``alpha``, ``beta``,
  ``gamma`` ``(Cout,)`` f32;
- ``acc`` is the exact int32 sum, with zero rows at t = −1 and t = T;
- ``z = relu(float(acc) + beta) * alpha + gamma`` in f32, op by op;
- mid blocks: ``clamp(round_half_even(z), ±127)`` int8; the last block:
  ``z`` rounded to ``out_dtype``;
- max-pool 2 with floor: an odd T drops its last step.

The kernel pools the raw accumulator first (max where ``alpha > 0``, min
elsewhere) and runs the epilogue at pool rate; by monotonicity this equals
the plain version's epilogue-then-pool bit for bit.

Dispatch is by the input's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel, and a failed build or launch raises. PyTorch
has no int32 matrix product on the card, so the plain version accumulates in
float64, where every product and sum of int8 values here is exact
(|acc| ≤ 3·480·127² < 2⁵³).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

KERNEL_TAPS = 3
KERNEL_POOL = 2
CIN_MULTIPLE = 32  # one mma k-step of 32 bytes stays within one tap
MAX_CIN = 480  # the CTA's shared memory: a 64-channel weight slab and two input tiles
_OUT_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def pack_weights(w_q: torch.Tensor) -> torch.Tensor:
    """``(3, Cin, Cout)`` → ``(Cout, 3·Cin)`` K-major: ``[co, j·Cin + ci] = w_q[j, ci, co]``."""
    k, cin, cout = w_q.shape
    return w_q.permute(2, 0, 1).reshape(cout, k * cin).contiguous()


def quant_block_reference(
    x_q: torch.Tensor,  # (B, T, Cin) int8
    w_q: torch.Tensor,  # (3, Cin, Cout) int8
    alpha: torch.Tensor,
    beta: torch.Tensor,
    gamma: torch.Tensor,
    *,
    last: bool = False,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version of the B3 kernel → ``(B, T // 2, Cout)``: int8,
    or ``out_dtype`` for the last block."""
    B, T, cin = x_q.shape
    k, _, cout = w_q.shape
    xp = F.pad(x_q.double(), (0, 0, 1, 1))  # SAME: one zero row each side
    cols = torch.cat([xp[:, j:j + T] for j in range(k)], dim=-1)  # (B, T, 3·Cin)
    acc = (cols @ w_q.reshape(k * cin, cout).double()).to(torch.int32)
    z = torch.relu(acc.float() + beta.float()) * alpha.float() + gamma.float()
    y = z.to(out_dtype) if last else torch.round(z).clamp(-127, 127).to(torch.int8)
    t_full = (T // 2) * 2
    return y[:, :t_full].reshape(B, T // 2, 2, cout).amax(dim=2)


def quant_block(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    gamma: torch.Tensor,
    *,
    last: bool = False,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """int8 conv(k=3, SAME) + epilogue + requantize + max-pool 2 →
    ``(B, T // 2, Cout)``: int8, or ``out_dtype`` for the last block."""
    if x_q.device.type == "cpu":
        return quant_block_reference(x_q, w_q, alpha, beta, gamma, last=last,
                                     out_dtype=out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"quant_block: no kernel for device {x_q.device}")
    if x_q.dim() != 3 or x_q.dtype != torch.int8 or not x_q.is_contiguous():
        raise ValueError("quant_block: x_q must be a contiguous (B, T, Cin) int8 tensor")
    B, T, cin = x_q.shape
    if w_q.dim() != 3 or w_q.dtype != torch.int8 or w_q.shape[1] != cin:
        raise ValueError(f"quant_block: w_q must be (3, {cin}, Cout) int8")
    k, _, cout = w_q.shape
    if k != KERNEL_TAPS:
        raise ValueError(f"quant_block: the kernel takes k={KERNEL_TAPS}, got k={k}")
    if cin % CIN_MULTIPLE or cin > MAX_CIN:
        raise ValueError(
            f"quant_block: the kernel takes Cin a multiple of {CIN_MULTIPLE} up to "
            f"{MAX_CIN}, got {cin}")
    out_dtype = out_dtype if last else torch.int8
    if last and out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("quant_block: the last block dequantizes to bfloat16 or float32")
    vecs = (alpha, beta, gamma)
    if any(p.device != x_q.device for p in (w_q, *vecs)):
        raise ValueError(f"quant_block: every parameter must lie on {x_q.device}")
    if any(p.shape != (cout,) for p in vecs):
        raise ValueError(f"quant_block: alpha, beta and gamma must be ({cout},)")
    if x_q.data_ptr() % 16:
        raise ValueError("quant_block: x_q must be 16-byte aligned")
    out = torch.empty((B, T // KERNEL_POOL, cout), dtype=out_dtype, device=x_q.device)
    if out.numel() == 0:
        return out
    wp = pack_weights(w_q)
    aff = torch.stack([v.float() for v in vecs]).contiguous()  # (3, Cout)
    from .._build import check, library

    lib = library()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vm_quant_block(x_q.data_ptr(), wp.data_ptr(), aff.data_ptr(),
                                 out.data_ptr(), B, T, cin, cout, _OUT_KIND[out_dtype],
                                 stream)
    check(err, "quant_block")
    quant_block.launches += 1
    return out


quant_block.launches = 0  # kernel launches; the CPU path does not count
