"""Time B2, B8, B3 and B6 at config #1's and config #4's shapes on the GPU,
through their wrappers; or, with ``--dilated``, B8 and B3 at config #3's
seven dilated and pool-1 blocks; with ``--b7``, B7's two passes at the train
step's blocks 1-3; with ``--b45``, B4 and B5 at the train step's block 0;
with ``--b5f32``, their f32 route there; with ``--b6dft``, B6's DFT route;
with ``--b9``, B9 at config #2's scoring shapes; with ``--bn``, the
BatchNorm epilogue pair at the train step's four pool-rate outputs.

    python3 -m voicemap_tpu_torch.utils.block_timing [--batch 2048]
        [--dilated | --b7 | --b45 | --b5f32 | --b6dft | --b9 | --bn]

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line:
the mean ms of back-to-back launches (CUDA events) of ``conv_block0``
(block 0 at T = 12000, C = 128: bf16 out, and int8 out with a requant
scale), of ``conv_blockn`` (bf16 in and out) and ``quant_block`` (int8 in,
int8 out, bf16 at block 3) for each of blocks 1-3 and their sums, and of
``log_mel`` at config #4's geometry (T = 48000, hop 128, win 384, n_fft
512, 64 mels). ``--dilated``: the mean ms of ``conv_blockn`` and
``quant_block`` at config #3's blocks 1-7 ((T, Cin, Cout, pool, dilation) =
(3000, 128, 128, 1, 2), (3000, 128, 256, 2, 1), (1500, 256, 256, 1, 4),
(1500, 256, 384, 2, 1), (750, 384, 384, 1, 8), (750, 384, 512, 2, 1),
(375, 512, 512, 1, 16); int8 out, bf16 at block 7) and their sums; a
checkout whose wrappers take no dilation prints that it does not take
them. ``--b7``: the mean ms of ``pool_fwd`` and ``route_bwd``
(bf16, pool 2; queued, the device's time alone, and back to back, which at
small batches times the host) at each of config #1's blocks 1-3 conv outputs (C, T) =
(256, 3000), (384, 1500), (512, 750) and their sums. ``--b45``: the mean ms
of ``conv_block0_train`` and ``conv_block0_train_bwd`` (bf16 GEMM and
selection, the f32 cotangent as the train step hands it; queued and back to
back) at config #1's block 0 (T = 12000, C = 128) at B = 32 and 2048.
``--b5f32``: the same for ``gemm_dtype=float32`` (B5's f32 route, and B4's,
whose recompute B5 repeats). ``--b6dft``: the mean ms of ``log_mel`` at
n_fft 400, win 400, hop 160, 64 mels (the DFT route) on (2048, 48000),
queued and back to back. ``--b9``: ``weighted_l1`` at (T, nq, ns, D) = (1,
4096, 4096, 64) (the tiled form) and (500, 1, 5, 64) (the n-shot form of 500
1-shot 5-way tasks): queued and back-to-back ms and the host microseconds
of a call (the wall time to enqueue 200), beside ``torch.cdist``'s.
``--bn``: the queued ms of ``bn_apply`` and ``bn_grad`` (bf16 ``a_sel``, ``y``
and cotangent, dropout 0.05) at config #1's pool-rate outputs (T', C) =
(3000, 128), (1500, 256), (750, 384), (375, 512), beside their plain
versions on the card (the eager chain the pair replaced) and the bytes
bound (each element's bf16 ``a_sel`` read and ``y`` written; the bf16
cotangent and ``a_sel`` read and the f32 cotangent written), and the sums. A
checkout whose B7
takes the relu activation channel first (before the bias and relu were
folded into it) gets that activation, and the bias-and-relu pass its train
op ran before B7 is timed beside it. It uses only the wrappers' public signatures, so the same
file can time another checkout of the package: run it by path from that
checkout's root (``python3 /path/to/block_timing.py``), where the
checkout's ``voicemap_tpu_torch`` comes first on ``sys.path``. Two checkouts
compared in one call, in turns (A, B, B, A), share a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

from voicemap_tpu_torch.config import melspec_2d  # noqa: E402
from voicemap_tpu_torch.ops.cuda_conv import conv_block0, conv_blockn  # noqa: E402
from voicemap_tpu_torch.ops.cuda_conv_train import (  # noqa: E402
    conv_block0_train, conv_block0_train_bwd,
)
from voicemap_tpu_torch.ops.cuda_distance import weighted_l1  # noqa: E402
from voicemap_tpu_torch.ops.cuda_melspec import log_mel  # noqa: E402
from voicemap_tpu_torch.ops.cuda_quant_block import quant_block  # noqa: E402
from voicemap_tpu_torch.ops import cuda_routing  # noqa: E402
from voicemap_tpu_torch.ops.cuda_routing import pool_fwd, route_bwd  # noqa: E402
from voicemap_tpu_torch.utils.profiling import time_fn  # noqa: E402

BLOCKS = ((3000, 128, 256, False), (1500, 256, 384, False), (750, 384, 512, True))
# config #3's blocks 1-7: T, Cin, Cout, pool, dilation, last
DILATED_BLOCKS = ((3000, 128, 128, 1, 2, False), (3000, 128, 256, 2, 1, False),
                  (1500, 256, 256, 1, 4, False), (1500, 256, 384, 2, 1, False),
                  (750, 384, 384, 1, 8, False), (750, 384, 512, 2, 1, False),
                  (375, 512, 512, 1, 16, True))
BLOCK0 = (12000, 128)  # config #1's block 0: T, C
MEL_T = 48000  # config #4: 3 s at 16 kHz
BN_EPS = 1e-3
HOLD_CYCLES_PER_CALL = 400_000  # utils/profiling.py's
TRAIN_BLOCKS = ((256, 3000), (384, 1500), (512, 750))  # B7: blocks 1-3's (C, T), pool 2
B45_BATCHES = (32, 2048)  # B4/B5: the train step's batch and the large one
MEL_DFT = dict(n_fft=400, win_length=400, hop_length=160)  # B6's DFT route: librosa's
B9_SHAPES = {"tile": (1, 4096, 4096, 64), "nshot": (500, 1, 5, 64)}  # (T, nq, ns, D)
EPILOGUE_BLOCKS = ((3000, 128), (1500, 256), (750, 384), (375, 512))  # (T', C) of blocks 0-3
HBM_BYTES_PER_S = 3.35e12


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


def queued_ms(fn, *args, iters: int = 20) -> float:
    """Mean device ms of ``iters`` calls enqueued while the stream sleeps
    (``profiling.time_fn(queued=True)``, kept here so that the script times
    checkouts whose ``time_fn`` lacks it)."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES_PER_CALL * iters)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_b7(g: torch.Generator, batch: int) -> dict:
    """B7's passes at TRAIN_BLOCKS: channels-last z and bias where B7 folds
    them in, else the channel-first relu activation it took."""
    folded = "z" in inspect.signature(pool_fwd).parameters
    rows = []
    for C, T in TRAIN_BLOCKS:
        z = torch.randn(batch, T, C, generator=g, device="cuda").to(torch.bfloat16)
        z = z.permute(0, 2, 1)
        b = torch.randn(C, generator=g, device="cuda") * 0.5
        sgn = torch.where(torch.arange(C, device="cuda") % 3 == 1, -1.0, 1.0)
        gp = torch.randn(batch, T // 2, C, generator=g, device="cuda").permute(0, 2, 1)
        cs = [torch.randn(C, generator=g, device="cuda") * s for s in (1.0, 0.1, 0.05)]
        row = {"C": C, "T": T}
        if folded:
            fwd = (z, b, sgn, 2)
            sel = pool_fwd(*fwd)[0]
            bwd = (z, b, sel, gp, *cs, 2)
        else:
            z = z.contiguous()
            bq = b.to(z.dtype)[:, None]
            # the op's add_().relu_(): two passes over the activation, as these two
            row["bias_relu_ms"] = time_fn(lambda: torch.relu(z + bq), iters=10)["mean_s"] * 1e3
            a = torch.relu(z + bq)
            gp = gp.contiguous()
            fwd = (a, sgn, 2)
            sel = pool_fwd(*fwd)[0]
            bwd = (a, sel, gp, *cs, 2)
        for name, fn, fargs in (("pool_fwd", pool_fwd, fwd), ("route_bwd", route_bwd, bwd)):
            row[f"{name}_ms"] = queued_ms(fn, *fargs)
            row[f"{name}_back_to_back_ms"] = time_fn(fn, *fargs, iters=20)["mean_s"] * 1e3
        rows.append(row)
        del z, gp, sel, fwd, bwd
        torch.cuda.empty_cache()
    out = {"batch": batch, "b7_folded": folded, "b7_blocks": rows}
    for key in ("pool_fwd_ms", "route_bwd_ms"):
        out[key] = sum(r[key] for r in rows)
    return out


def time_b45(g: torch.Generator, gemm=torch.bfloat16) -> dict:
    """B4 and B5 through their wrappers at config #1's block 0, in ``gemm``
    (bf16: the tensor-core route, f32: the f32 route)."""
    T, c = BLOCK0
    f32 = gemm == torch.float32
    rows = []
    for batch in B45_BATCHES:
        x = torch.randn(batch, T, 1, generator=g, device="cuda") * 0.3
        w = torch.randn(32, 1, c, generator=g, device="cuda") * 32 ** -0.5
        b = torch.randn(c, generator=g, device="cuda") * 0.05
        sgn = torch.where(torch.arange(c, device="cuda") % 3 == 1, -1.0, 1.0)
        gp = torch.randn(batch, T // 4, c, generator=g, device="cuda")
        cs = [torch.randn(c, generator=g, device="cuda") * s for s in (1.0, 0.1, 0.05)]
        iters = (10 if f32 else 50) if batch <= 256 else (3 if f32 else 10)
        row = {"batch": batch}
        fwd = (x, w, b, sgn, 4, gemm, gemm) if f32 else (x, w, b, sgn)
        bwd = (x, w, b, sgn, gp, *cs, 4, gemm) if f32 else (x, w, b, sgn, gp, *cs)
        for name, fn, args in (("b4", conv_block0_train, fwd), ("b5", conv_block0_train_bwd, bwd)):
            row[f"{name}_ms"] = queued_ms(fn, *args, iters=iters)
            row[f"{name}_back_to_back_ms"] = time_fn(fn, *args, iters=iters)["mean_s"] * 1e3
        rows.append(row)
        del x, gp
        torch.cuda.empty_cache()
    return {"b45_f32" if f32 else "b45": rows}


def time_b6dft(g: torch.Generator, batch: int) -> dict:
    """B6's DFT route through its wrapper: n_fft 400 on (batch, 48000)."""
    mel = dataclasses.replace(melspec_2d().mel, **MEL_DFT)
    x = torch.randn(batch, MEL_T, generator=g, device="cuda")
    sr = melspec_2d().data.sample_rate
    return {"b6_dft": {"batch": batch, **MEL_DFT,
                       "ms": queued_ms(log_mel, x, mel, sr, iters=10),
                       "back_to_back_ms": time_fn(log_mel, x, mel, sr,
                                                  iters=10)["mean_s"] * 1e3}}


def time_dilated(g: torch.Generator, batch: int) -> dict:
    """B8 and B3 through their wrappers at DILATED_BLOCKS."""
    if "dilation" not in inspect.signature(conv_blockn).parameters:
        return {"dilated": "this checkout's B8 and B3 take no dilation"}
    rows = []
    for i, (T, cin, cout, pool, d, last) in enumerate(DILATED_BLOCKS, start=1):
        a = blockn_args(g, batch, T, cin, cout)
        b8 = time_fn(conv_blockn, *a, BN_EPS, pool, dilation=d, iters=20)["mean_s"] * 1e3
        del a
        q = quant_args(g, batch, T, cin, cout)
        b3 = time_fn(quant_block, *q, last=last, pool=pool, dilation=d,
                     iters=20)["mean_s"] * 1e3
        del q
        torch.cuda.empty_cache()
        rows.append({"block": i, "T": T, "cin": cin, "cout": cout, "pool": pool, "dilation": d,
                     "b8_ms": b8, "b3_ms": b3})
    return {"batch": batch, "dilated_blocks": rows, "b8_ms": sum(r["b8_ms"] for r in rows),
            "b3_ms": sum(r["b3_ms"] for r in rows)}


def time_bn(g: torch.Generator, batch: int, rate: float = 0.05) -> dict:
    """The BatchNorm epilogue pair and the eager chain it replaced, queued,
    at EPILOGUE_BLOCKS, beside the bytes bound."""
    rows = []
    for tp, c in EPILOGUE_BLOCKS:
        bf = torch.bfloat16
        sel = torch.randn(batch, tp, c, generator=g, device="cuda").relu().to(bf)
        gy = torch.randn(batch, tp, c, generator=g, device="cuda").to(bf)
        mu, r, scale, beta = (torch.rand(c, generator=g, device="cuda") for _ in range(4))
        mask = torch.empty(batch, c, device="cuda").bernoulli_(1.0 - rate, generator=g)
        fwd = (sel, mu, scale, beta, mask, 1.0 - rate, bf)
        bwd = (gy, sel, mask, 1.0 - rate, mu, r)
        n = batch * tp * c
        row = {"T'": tp, "C": c, "bn_apply_bound_ms": n * 4 / HBM_BYTES_PER_S * 1e3,
               "bn_grad_bound_ms": n * 8 / HBM_BYTES_PER_S * 1e3}
        for name, args in (("bn_apply", fwd), ("bn_grad", bwd)):
            row[f"{name}_ms"] = queued_ms(getattr(cuda_routing, name), *args)
            row[f"{name}_plain_ms"] = queued_ms(getattr(cuda_routing, f"{name}_reference"),
                                                *args, iters=5)
        rows.append(row)
        del sel, gy, fwd, bwd
        torch.cuda.empty_cache()
    out = {"batch": batch, "bn_blocks": rows}
    for key in rows[0]:
        if key.endswith("_ms"):
            out[key] = sum(r[key] for r in rows)
    return out


def host_us(fn, *args, iters: int = 200) -> float:
    """Host microseconds a call: the wall time to enqueue ``iters`` calls."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def time_b9(g: torch.Generator) -> dict:
    """B9 through its wrapper at B9_SHAPES, w of both signs and b != 0,
    beside ``torch.cdist`` on the operands scaled by |w|."""
    rows = {}
    for name, (T, nq, ns, D) in B9_SHAPES.items():
        q = torch.randn(T, nq, D, generator=g, device="cuda")
        s = torch.randn(T, ns, D, generator=g, device="cuda")
        w = torch.randn(D, generator=g, device="cuda")
        b = torch.tensor(0.375, device="cuda")
        qw, sw = q * w.abs(), s * w.abs()
        with torch.inference_mode():
            rows[name] = {"shape": [T, nq, ns, D],
                          "ms": queued_ms(weighted_l1, q, s, w, b, iters=50),
                          "back_to_back_ms": time_fn(weighted_l1, q, s, w, b,
                                                     iters=50)["mean_s"] * 1e3,
                          "host_us": host_us(weighted_l1, q, s, w, b),
                          "cdist_ms": queued_ms(torch.cdist, qw, sw, 1.0, iters=50),
                          "cdist_host_us": host_us(torch.cdist, qw, sw, 1.0)}
    return {"b9": rows}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=2048)
    parser.add_argument("--dilated", action="store_true",
                        help="time B8 and B3 at config #3's blocks")
    parser.add_argument("--b7", action="store_true", help="time B7 alone")
    parser.add_argument("--b45", action="store_true", help="time B4 and B5 alone")
    parser.add_argument("--b5f32", action="store_true", help="time B4 and B5's f32 route")
    parser.add_argument("--b6dft", action="store_true", help="time B6's DFT route")
    parser.add_argument("--b9", action="store_true", help="time B9")
    parser.add_argument("--bn", action="store_true", help="time the BatchNorm epilogue pair")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("block_timing: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    package = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(conv_blockn.__code__.co_filename))))
    if args.dilated:
        print(json.dumps({"package": package, **time_dilated(g, args.batch)}), flush=True)
        return 0
    if args.b7:
        print(json.dumps({"package": package, **time_b7(g, args.batch)}), flush=True)
        return 0
    if args.b45:
        print(json.dumps({"package": package, **time_b45(g)}), flush=True)
        return 0
    if args.b5f32:
        print(json.dumps({"package": package, **time_b45(g, torch.float32)}), flush=True)
        return 0
    if args.b6dft:
        print(json.dumps({"package": package, **time_b6dft(g, args.batch)}), flush=True)
        return 0
    if args.b9:
        print(json.dumps({"package": package, **time_b9(g)}), flush=True)
        return 0
    if args.bn:
        print(json.dumps({"package": package, **time_bn(g, args.batch)}), flush=True)
        return 0
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
    print(json.dumps({"package": package, "batch": args.batch, "b2_bf16_ms": b2, "b2_int8_ms": b2_int8,
                      "b6_ms": b6, "blocks": rows,
                      "b8_ms": sum(r["b8_ms"] for r in rows),
                      "b3_ms": sum(r["b3_ms"] for r in rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
