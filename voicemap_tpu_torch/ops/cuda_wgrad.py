"""conv_wgrad: the weight gradient of a dilated SAME conv of three taps in
training, one hand-written pass (``csrc/conv_wgrad.cu``), beside its plain
version.

For ``x (B, T, Cin)`` and the conv output's cotangent ``dz (B, T, Cout)``,
both channels-last rows, taps ``j < k``, dilation ``d`` and SAME zero
padding inside each batch row (``h = d·(k − 1)/2``):

    dW[co, ci, j] = Σ_{b,t} x[b, t + j·d − h, ci] · dz[b, t, co]

→ ``(Cout, Cin, k)`` f32, the conv weight's layout. The blocks-1+ train ops'
shared backward (``ops/conv_train._blockn_backward``) takes it for a dilated
conv (d > 1) of k = 3 taps in a bf16 GEMM, config #3's blocks 1, 3, 5 and 7;
cuDNN keeps the input gradient, and every other conv's weight gradient.

The kernel replaces no Pallas kernel: the JAX package leaves the conv's
backward to XLA. It is a GEMM of M = Cin, N = Cout and K = B·T a tap, whose
output is tiny against K, so it splits K: items of (a chunk of stages of
``ROWS`` time rows, a 128 × 128 channel tile with all three taps) over one
CTA an SM, each item's f32 sums in a slot of a scratch, then a second pass
that adds each tile's slots in split order (:func:`plan` chooses the
splits). The products are bf16 on the tensor cores with f32 sums, every
product exact; the tensor cores' f32 accumulation truncates, so an item adds
its accumulators into its slot every 128 stages (16384 rows) and starts
them again from zero, which holds dW within ~2e-5 of its largest element at
any batch. The kernel and :func:`conv_wgrad_reference` (f32) agree to that
bound, not bit for bit; two calls give the same bits.

Dispatch is by the inputs' device: a CPU tensor takes the plain version (any
float dtype), a CUDA tensor launches the kernel, which takes contiguous rows
16-byte aligned of what :func:`takes` admits, and raises on anything else.
``conv_wgrad.launches`` counts the kernel's calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

TAPS = 3  # the kernel's taps (config #3's kernel size)
TILE = 128  # input and output channels of an item's tile
ROWS = 128  # time rows a stage: K is cut into B · ceil(T / ROWS) stages
MAX_DILATION = 64  # the x slice of a stage, ROWS + 2h rows, within TMA's 256-row box
SLOT_BYTES = TAPS * TILE * TILE * 4  # an item's f32 sums
SCRATCH_CAP = 64 << 20  # bytes of the items' slots at most


def conv_wgrad_reference(x: torch.Tensor, dz: torch.Tensor, k: int,
                         dilation: int) -> torch.Tensor:
    """The plain version: zero-pad ``x`` by h in time, shift it by each tap,
    one ``einsum`` a tap in f32 → ``(Cout, Cin, k)`` f32."""
    T = x.shape[1]
    h = dilation * (k - 1) // 2
    xp = F.pad(x.float(), (0, 0, h, h))
    dzf = dz.float()
    return torch.stack([torch.einsum("btc,bto->oc", xp[:, j * dilation:j * dilation + T], dzf)
                        for j in range(k)], dim=2)


def plan(B: int, T: int, cin: int, cout: int, sms: int) -> tuple:
    """``(splits, tiles)``: the kernel's 128 × 128 channel tiles and the
    chunks K is cut into, as many as keep one item a CTA on ``sms`` SMs
    (at least 1, at most the stages)."""
    tiles = -(-cin // TILE) * -(-cout // TILE)
    stages = B * -(-T // ROWS)
    return max(1, min(stages, sms // tiles)), tiles


def takes(dtype: torch.dtype, k: int, dilation: int, cin: int, cout: int) -> bool:
    """Whether the kernel computes this conv's dW: bf16, its taps, a
    dilation up to ``MAX_DILATION`` and Cin, Cout multiples of 8 (TMA's
    16-byte row stride)."""
    return (dtype == torch.bfloat16 and k == TAPS and 1 <= dilation <= MAX_DILATION
            and cin % 8 == 0 and cout % 8 == 0)


def _check(x: torch.Tensor, dz: torch.Tensor, k: int, dilation: int) -> None:
    if x.dim() != 3 or dz.dim() != 3 or x.shape[:2] != dz.shape[:2]:
        raise ValueError(f"conv_wgrad: x (B, T, Cin) and dz (B, T, Cout) must share B and T, got "
                         f"{tuple(x.shape)} and {tuple(dz.shape)}")
    if x.device != dz.device or x.dtype != dz.dtype or not x.is_floating_point():
        raise ValueError(f"conv_wgrad: x and dz must be floats of one dtype on one device, got "
                         f"{x.dtype} on {x.device} and {dz.dtype} on {dz.device}")
    if k < 1 or k % 2 == 0 or dilation < 1:
        raise ValueError(f"conv_wgrad: k must be odd and the dilation at least 1, got k={k}, "
                         f"dilation={dilation}")


def conv_wgrad(x: torch.Tensor, dz: torch.Tensor, k: int, dilation: int) -> torch.Tensor:
    """``dW (Cout, Cin, k)`` f32 of the SAME conv of ``k`` taps and
    ``dilation`` from ``x (B, T, Cin)`` and ``dz (B, T, Cout)``: the plain
    version on the CPU, the kernel on the card."""
    _check(x, dz, k, dilation)
    if x.device.type == "cpu":
        return conv_wgrad_reference(x, dz, k, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"conv_wgrad: no kernel for device {x.device}")
    B, T, cin = x.shape
    cout = dz.shape[2]
    if not (x.is_contiguous() and dz.is_contiguous()):
        raise ValueError(f"conv_wgrad: the kernel takes contiguous rows, got strides "
                         f"{tuple(x.stride())} and {tuple(dz.stride())}")
    if not takes(x.dtype, k, dilation, cin, cout):
        raise ValueError(f"conv_wgrad: the kernel takes bfloat16, k={TAPS}, a dilation up to "
                         f"{MAX_DILATION} and Cin, Cout multiples of 8, got {x.dtype}, k={k}, "
                         f"dilation={dilation}, Cin={cin}, Cout={cout}")
    if x.data_ptr() % 16 or dz.data_ptr() % 16:
        raise ValueError("conv_wgrad: x and dz must start on a 16-byte boundary")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, tiles = plan(B, T, cin, cout, sms)
    if splits * tiles * SLOT_BYTES > SCRATCH_CAP:
        raise ValueError(f"conv_wgrad: {tiles} channel tiles need more than "
                         f"{SCRATCH_CAP >> 20} MiB of scratch")
    part = torch.empty(splits * tiles * SLOT_BYTES // 4, dtype=torch.float32, device=x.device)
    dw = torch.empty((cout, cin, k), dtype=torch.float32, device=x.device)
    from .._build import check, library

    with torch.cuda.device(x.device):
        err = library().vm_conv_wgrad(x.data_ptr(), dz.data_ptr(), part.data_ptr(),
                                      dw.data_ptr(), B, T, cin, cout, k, dilation, splits,
                                      torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "conv_wgrad")
    conv_wgrad.launches += 1
    return dw


conv_wgrad.launches = 0  # kernel launches; the CPU path does not count
