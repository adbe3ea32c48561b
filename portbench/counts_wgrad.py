"""The least time of a dilated conv's weight gradient in training
(``voicemap_tpu_torch/ops/cuda_wgrad.conv_wgrad``), from the configuration's
widths, beside ``counts.py`` (whose peaks and block shapes it takes,
unchanged).

- ``wgrad_bound_s``: one block's dW at ``batch`` rows: the block's input x
  and its conv output's cotangent dz read once in bf16, dW written once in
  f32, and the block's conv FLOPs (``counts.conv_flops``: the weight
  gradient does as many as the forward) at the bf16 rate.
"""

from __future__ import annotations

from . import counts

BF16, F32 = 2, 4


def wgrad_bound_s(block: dict, batch: int) -> float:
    """dW of one block (``counts.blocks``' dict) at ``batch`` rows."""
    T, cin, cout, k = block["T"], block["cin"], block["cout"], block["k"]
    moved = batch * T * (cin + cout) * BF16 + k * cin * cout * F32
    return counts.bound_s(moved, batch * counts.conv_flops(block), counts.BF16_OPS_PER_S)
