"""Where the int8 mid block's time goes: B3's stage prefixes (B10), timed.

    python3 -m voicemap_tpu_torch.utils.qblock_attrib [--batch 2048] [--seed 0]

Port of ``benchmarks/bench_qblock_attrib.py :: main``, at config #1's block
shapes (128 → 256 at T 3000, 256 → 384 at 1500, 384 → 512 at 750), not the
harness's own 128 → 256 → 512 → 1024. For each block, on seeded int8
activations and weights at the given batch, the CUDA-event time of each
prefix of ``csrc/quant_block.cu`` (``ops/cuda_quant_block.quant_block_stage``):

- ``mma``: the tile loads, ``cp.async`` and the s8 ``mma`` over K = 3·Cin
  (the TPU harness's stages 1–2 and its ``xk`` product);
- ``pool``: + the pair select by the sign of alpha (its stage 3);
- ``full``: + the epilogue and requantization, B3's mid block itself;

each stage's increment over the one before, its TOP/s (the conv's
2·B·T·3·Cin·Cout operations over its time), and B3 as the int8 path
launches it (the last block dequantizes to bf16) beside them.

Prints the card line, then one JSON line per block. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from ..ops.cuda_quant_block import STAGES, quant_block, quant_block_stage
from .profiling import time_fn

# Config #1's int8 blocks 1-3: (T in, Cin, Cout, last).
BLOCKS = ((3000, 128, 256, False), (1500, 256, 384, False), (750, 384, 512, True))


def block_inputs(seed: int, B: int, T: int, cin: int, cout: int, device) -> tuple:
    """Random int8 activations and weights and epilogue vectors on ``device``;
    alpha crosses zero, and alpha and beta follow the accumulator's spread
    (≈ √(3·Cin)·5400 for uniform int8) so most outputs land inside ±127."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-127, 128, (B, T, cin), generator=g, device=device, dtype=torch.int8)
    w = torch.randint(-127, 128, (3, cin, cout), generator=g, device=device, dtype=torch.int8)
    spread = (3 * cin) ** 0.5 * 5400.0
    alpha = torch.randn(cout, generator=g, device=device) * (40.0 / spread)
    beta = torch.randn(cout, generator=g, device=device) * (0.5 * spread)
    gamma = torch.randn(cout, generator=g, device=device) * 10.0
    return x, w, alpha, beta, gamma


def attribute(batch: int, seed: int, blocks=BLOCKS, device="cuda", timer=time_fn,
              iters: int = 20) -> list:
    """One record per block: each stage's ms (mean of ``iters`` back-to-back
    launches), its increment and TOP/s, and B3's ms."""
    rows = []
    for i, (T, cin, cout, last) in enumerate(blocks):
        args = block_inputs(seed + i, batch, T, cin, cout, device)
        ops = 2.0 * batch * T * 3 * cin * cout
        stages, prev = [], 0.0
        for stage in STAGES:
            ms = timer(quant_block_stage, *args, stage, iters=iters)["mean_s"] * 1e3
            stages.append({"stage": stage, "ms": ms, "increment_ms": ms - prev,
                           "tops": ops / (ms * 1e-3) / 1e12})
            prev = ms
        b3 = timer(quant_block, *args, last=last, iters=iters)["mean_s"] * 1e3
        rows.append({"block": i + 1, "batch": batch, "T": T, "cin": cin, "cout": cout,
                     "ops": ops, "stages": stages, "quant_block_ms": b3,
                     "quant_block_out": "bfloat16" if last else "int8"})
        del args
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=2048)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("qblock_attrib: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout
    print(card.strip().splitlines()[0], flush=True)
    for row in attribute(args.batch, args.seed):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
