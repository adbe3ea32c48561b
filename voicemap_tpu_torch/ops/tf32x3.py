"""Plain model of ``csrc/tf32x3.cuh``: the 3xTF32 split and product that B6's
DFT route and B5's f32 route run on the tensor cores.

``round_tf32`` is ``cvt.rna.tf32.f32``: round an f32 to 10 mantissa bits,
to nearest with ties away from zero, on its bit pattern (half an ulp of
tf32 added to the magnitude, the 13 low bits cleared). ``split`` gives
``(big, small)`` with ``big = tf32(a)`` and ``small = tf32(a − big)``;
``matmul`` is the three-product sum ``A_small·B_big + A_big·B_small +
A_big·B_big`` of those planes. The products of two tf32 values are exact in
f32; the model sums them in float64 and rounds once to f32, so what it
shows is the split's own error. The tensor cores sum in f32 in an order of
their own, which an order bound, not this model, covers.
"""

from __future__ import annotations

import torch

TF32_DROPPED_BITS = 13  # f32's 23 mantissa bits less tf32's 10


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of every element of ``a`` (f32 in, f32 out)."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    half = 1 << (TF32_DROPPED_BITS - 1)
    mask = -(1 << TF32_DROPPED_BITS)  # ~0x1fff as int32: keeps the sign bit
    return ((bits + half) & mask).view(torch.float32)


def split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(big, small)`` tf32 planes of ``a``: ``big + small`` is ``a`` to
    about 2^-22 of ``|a|``."""
    a = a.to(torch.float32)
    big = round_tf32(a)
    return big, round_tf32(a - big)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels take it in 3xTF32, f32 out."""
    ab, as_ = (t.double() for t in split(a))
    bb, bs = (t.double() for t in split(b))
    return (as_ @ bb + ab @ bs + ab @ bb).float()
