"""Time B8 and B3 at config #1's blocks 1–3 on the GPU, through their wrappers.

    python3 -m voicemap_tpu_torch.utils.block_timing [--batch 2048]

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line:
for each block the mean ms of 20 back-to-back launches (CUDA events) of
``conv_blockn`` (bf16 in and out) and ``quant_block`` (int8 in, int8 out,
bf16 at block 3), and their sums. It uses only the wrappers' public
signatures, so the same file can time another checkout of the package:
run it by path from that checkout's root (``python3
/path/to/block_timing.py``), where the checkout's ``voicemap_tpu_torch``
comes first on ``sys.path``. Two checkouts compared in one call, in turns
(A, B, B, A), share a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

from voicemap_tpu_torch.ops.cuda_conv import conv_blockn  # noqa: E402
from voicemap_tpu_torch.ops.cuda_quant_block import quant_block  # noqa: E402
from voicemap_tpu_torch.utils.profiling import time_fn  # noqa: E402

BLOCKS = ((3000, 128, 256, False), (1500, 256, 384, False), (750, 384, 512, True))
BN_EPS = 1e-3


def blockn_args(g: torch.Generator, B: int, T: int, cin: int, cout: int) -> tuple:
    x = torch.randn(B, T, cin, generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn(3, cin, cout, generator=g, device="cuda") * (3 * cin) ** -0.5
    vecs = [torch.randn(cout, generator=g, device="cuda") * 0.1 for _ in range(4)]
    var = torch.rand(cout, generator=g, device="cuda") + 0.5
    return (x, w, *vecs, var)


def quant_args(g: torch.Generator, B: int, T: int, cin: int, cout: int) -> tuple:
    x = torch.randint(-127, 128, (B, T, cin), generator=g, device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (3, cin, cout), generator=g, device="cuda", dtype=torch.int8)
    spread = (3 * cin) ** 0.5 * 5400.0
    alpha = torch.randn(cout, generator=g, device="cuda") * (40.0 / spread)
    beta = torch.randn(cout, generator=g, device="cuda") * (0.5 * spread)
    gamma = torch.randn(cout, generator=g, device="cuda") * 10.0
    return x, w, alpha, beta, gamma


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=2048)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("block_timing: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for i, (T, cin, cout, last) in enumerate(BLOCKS, start=1):
        a = blockn_args(g, args.batch, T, cin, cout)
        b8 = time_fn(conv_blockn, *a, BN_EPS, iters=20)["mean_s"] * 1e3
        del a
        q = quant_args(g, args.batch, T, cin, cout)
        b3 = time_fn(quant_block, *q, last=last, iters=20)["mean_s"] * 1e3
        del q
        torch.cuda.empty_cache()
        rows.append({"block": i, "T": T, "cin": cin, "cout": cout, "b8_ms": b8, "b3_ms": b3})
    print(json.dumps({"package": os.path.dirname(os.path.dirname(
                          os.path.dirname(os.path.abspath(conv_blockn.__code__.co_filename)))),
                      "batch": args.batch, "blocks": rows,
                      "b8_ms": sum(r["b8_ms"] for r in rows),
                      "b3_ms": sum(r["b3_ms"] for r in rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
