"""Time B2, B8, B3 and B6 at config #1's and config #4's shapes on the GPU,
through their wrappers.

    python3 -m voicemap_tpu_torch.utils.block_timing [--batch 2048]

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line:
the mean ms of back-to-back launches (CUDA events) of ``conv_block0``
(block 0 at T = 12000, C = 128: bf16 out, and int8 out with a requant
scale), of ``conv_blockn`` (bf16 in and out) and ``quant_block`` (int8 in,
int8 out, bf16 at block 3) for each of blocks 1-3 and their sums, and of
``log_mel`` at config #4's geometry (T = 48000, hop 128, win 384, n_fft
512, 64 mels). It uses only the wrappers' public signatures, so the same
file can time another checkout of the package: run it by path from that
checkout's root (``python3 /path/to/block_timing.py``), where the
checkout's ``voicemap_tpu_torch`` comes first on ``sys.path``. Two checkouts
compared in one call, in turns (A, B, B, A), share a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

from voicemap_tpu_torch.config import melspec_2d  # noqa: E402
from voicemap_tpu_torch.ops.cuda_conv import conv_block0, conv_blockn  # noqa: E402
from voicemap_tpu_torch.ops.cuda_melspec import log_mel  # noqa: E402
from voicemap_tpu_torch.ops.cuda_quant_block import quant_block  # noqa: E402
from voicemap_tpu_torch.utils.profiling import time_fn  # noqa: E402

BLOCKS = ((3000, 128, 256, False), (1500, 256, 384, False), (750, 384, 512, True))
BLOCK0 = (12000, 128)  # config #1's block 0: T, C
MEL_T = 48000  # config #4: 3 s at 16 kHz
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
    T, c = BLOCK0
    x = torch.randn(args.batch, T, 1, generator=g, device="cuda") * 0.3
    w = torch.randn(32, 1, c, generator=g, device="cuda") * 32 ** -0.5
    vecs = [torch.randn(c, generator=g, device="cuda") * 0.1 for _ in range(4)]
    p0 = (x, w, *vecs, torch.rand(c, generator=g, device="cuda") + 0.5, BN_EPS)
    s0 = torch.full((c,), 0.01, device="cuda")
    b2 = time_fn(conv_block0, *p0, iters=20)["mean_s"] * 1e3
    b2_int8 = time_fn(conv_block0, *p0, requant_scale=s0, iters=20)["mean_s"] * 1e3
    del x, p0
    mel = melspec_2d()
    xm = torch.randn(args.batch, MEL_T, generator=g, device="cuda")
    b6 = time_fn(log_mel, xm, mel.mel, mel.data.sample_rate, iters=10)["mean_s"] * 1e3
    del xm
    torch.cuda.empty_cache()
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
                      "batch": args.batch, "b2_bf16_ms": b2, "b2_int8_ms": b2_int8,
                      "b6_ms": b6, "blocks": rows,
                      "b8_ms": sum(r["b8_ms"] for r in rows),
                      "b3_ms": sum(r["b3_ms"] for r in rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
