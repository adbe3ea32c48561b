"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root, on a machine with a CUDA card and ``nvcc``.
Each phase prints one JSON line; nothing here imports JAX.

1. device — exit non-zero without CUDA; print the ``nvidia-smi`` name and
   power limit;
2. build — compile ``voicemap_tpu_torch/csrc`` for ``sm_90a``;
3. kernels — each CUDA kernel against its plain PyTorch version on the card,
   at the main paths' shapes and at edge shapes, with the tolerance stated:
   B1, B2 (bf16, f32 and its int8 requantizing epilogue) and B3 at the three
   config #1 block shapes;
   train kernels — B4 and B5 at the train step's (32, 12000, 128) and at edge
   shapes, B7's pool and routing passes at the three config #1 block shapes
   of the train step and at an odd C, each against its plain version;
4. slice — config #1 at full width (filters 128, embedding 64, 3 s at 16 kHz,
   downsampling 4) built from a flax-layout tree through ``from_flax``,
   serving 500 1-shot 5-way n-shot tasks over a seeded synthetic store in
   bf16, with the kernels' launch counters read around that run and its
   embedding table held against the plain-version path;
5. int8 slice — the same model calibrated with ``quantize_from_store`` and
   served in int8 (B1 → B2 with requant → B3 × 3), the same 500 tasks, its
   launch counters read around that run, its table held against the
   plain-version int8 path and set beside the bf16 table;
6. int8 fidelity gate — as ``bench.py`` does it: calibrate on bench-store rows
   [0, 256), embed rows [256, 512) at fresh offsets in int8 and in bf16, and
   require a min cosine ≥ 0.999;
7. train slice — ``fit`` at full config #1 width, batch 32, for 40 steps on
   the seeded 40-speaker store with an n-shot evaluation at the end, the
   launch counters read around it and the evaluation's own launches counted
   apart: per step B1 1, B4 1, B5 1, B7 3 + 3; every loss finite and the
   last five below the first five; then one step from fixed weights and a
   fixed batch through the kernels and through their plain versions,
   held together (loss, gradient cosine per parameter);
8. timing — CUDA-event times of each kernel beside its plain version, its
   bound and (B3) a library GEMM; embed throughput at B=2048 in bf16 and
   int8; batch-1 latency; int8 against bf16 embed time over batch sizes;
9. train timing — B4, B5 and B7 beside their bounds, plain versions and
   (B5) a library weight-gradient conv at the train step's shapes; the train
   step's ms and utt/s at B=32 and B=2048 under both blocks-1+ policies, in
   turns (jnp, fused, fused, jnp), and peak memory.

It ends with the per-kernel summary line, then
``{"ok": true, "device": {...}}``. Any failed phase raises, so the exit code
is non-zero and that last line is never printed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from voicemap_tpu_torch import _build
from voicemap_tpu_torch.config import EncoderConfig, classifier_baseline
from voicemap_tpu_torch.data.store import synthetic_store
from voicemap_tpu_torch.eval import nshot
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.models.convert import from_flax
from voicemap_tpu_torch.models.fast_infer import fast_embed
from voicemap_tpu_torch.models.quant_infer import (
    quant_embed, quantize_encoder, quantize_from_store,
)
from voicemap_tpu_torch.ops import cuda_conv_train, cuda_routing, sampling
from voicemap_tpu_torch.ops.cuda_conv import conv_block0, conv_block0_reference
from voicemap_tpu_torch.ops.cuda_conv_train import (
    conv_block0_train, conv_block0_train_bwd, conv_block0_train_bwd_reference,
    conv_block0_train_reference,
)
from voicemap_tpu_torch.ops.cuda_preprocess import (
    decimate_store, gather_whiten, gather_whiten_reference,
)
from voicemap_tpu_torch.ops.cuda_quant_block import quant_block, quant_block_reference
from voicemap_tpu_torch.ops.cuda_routing import (
    pool_fwd, pool_fwd_reference, route_bwd, route_bwd_reference,
)
from voicemap_tpu_torch.train import steps
from voicemap_tpu_torch.train.loop import fit, init_model
from voicemap_tpu_torch.train.state import init_state
from voicemap_tpu_torch.train.steps import DeviceStore, device_store_for, fetch_batch
from voicemap_tpu_torch.utils.profiling import throughput, time_fn

DEVICE = "cuda"  # every tensor of the run lives here
# The store that bench.py measures: 2048 rows of 3.5 s raw int16, decimated
# once; 12000-sample fragments at decimated offsets in [0, 2000].
BATCH = 2048
STORE_T = 56000
DS = 4
FRAG = 12000
CHECK_ROWS = 256  # rows of the on-card checks and of each plain-version chunk
# Config #1's int8 blocks 1-3: (T in, Cin, Cout, last).
QBLOCKS = ((3000, 128, 256, False), (1500, 256, 384, False), (750, 384, 512, True))
SWEEP = (1, 8, 64, 256, 2048)
# The train step of config #1: batch 32 of 12000 samples; block 0's width;
# blocks 1-3's full-rate conv outputs (C, T), pool 2; train steps of the slice.
TRAIN_BATCH = 32
TRAIN_C0 = 128
TRAIN_BLOCKS = ((256, 3000), (384, 1500), (512, 750))
TRAIN_STEPS = 40
TRAIN_TIMING_BATCHES = (32, 2048)

B1_RTOL, B1_ATOL = 1e-5, 1e-6
B2_F32_RTOL, B2_F32_ATOL = 1e-5, 1e-5
B2_BF16_ULPS = 1
TABLE_MIN_COSINE = 0.999
TRAIN_REL_TOL = 1e-4  # stats, dW, db: of max |value|, for the other sum order
STEP_LOSS_RTOL = 1e-3
STEP_MIN_COSINE = 0.999
INT8_FIDELITY_GATE = 0.999  # bench.py's gate

# Published H100 SXM peaks (NVIDIA's data sheet): device memory, dense bf16
# and int8 tensor-core rates.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12

# name -> (wrapper, source, TPU kernel it replaces)
KERNELS = {
    "gather_whiten": (gather_whiten, "voicemap_tpu_torch/csrc/gather_whiten.cu",
                      "voicemap_tpu/ops/pallas_preprocess.py:88"),
    "conv_block0": (conv_block0, "voicemap_tpu_torch/csrc/conv_block0.cu",
                    "voicemap_tpu/ops/pallas_conv.py:97"),
    "quant_block": (quant_block, "voicemap_tpu_torch/csrc/quant_block.cu",
                    "voicemap_tpu/ops/pallas_quant_block.py:99"),
    "conv_block0_train": (conv_block0_train, "voicemap_tpu_torch/csrc/conv_block0_train.cu",
                          "voicemap_tpu/ops/pallas_conv_train.py:58"),
    "conv_block0_train_bwd": (conv_block0_train_bwd,
                              "voicemap_tpu_torch/csrc/conv_block0_train.cu",
                              "voicemap_tpu/ops/pallas_conv_train.py:125"),
    "pool_fwd": (pool_fwd, "voicemap_tpu_torch/csrc/routing.cu",
                 "voicemap_tpu/ops/pallas_routing.py:69"),
    "route_bwd": (route_bwd, "voicemap_tpu_torch/csrc/routing.cu",
                  "voicemap_tpu/ops/pallas_routing.py:133"),
}
# The train kernels' plain versions, by the module attribute each wrapper
# is reached through on the train path.
PLAIN = ((cuda_conv_train, "conv_block0_train", conv_block0_train_reference),
         (cuda_conv_train, "conv_block0_train_bwd", conv_block0_train_bwd_reference),
         (cuda_routing, "pool_fwd", pool_fwd_reference),
         (cuda_routing, "route_bwd", route_bwd_reference))


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def reset_counts() -> None:
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {name: wrapper.launches for name, (wrapper, _, _) in KERNELS.items()}


def bound(bytes_moved: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def random_flax_variables(cfg: EncoderConfig, num_classes: int, seed: int) -> dict:
    """A classifier's flax variable tree in ``ConvEncoder`` shapes, as numpy."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def uniform(lo, hi, n):
        return rng.uniform(lo, hi, n).astype(np.float32)

    params, stats = {}, {}
    cin = 1
    for i, (mult, k) in enumerate(zip(cfg.filter_multipliers, cfg.kernel_sizes)):
        c = cfg.filters * mult
        params[f"block_{i}"] = {
            "conv": {"kernel": normal((k, cin, c), (k * cin) ** -0.5),
                     "bias": normal((c,), 0.05)},
            "bn": {"scale": uniform(0.5, 1.5, c), "bias": normal((c,), 0.1)},
        }
        stats[f"block_{i}"] = {"bn": {"mean": normal((c,), 0.1),
                                      "var": uniform(0.5, 2.0, c)}}
        cin = c
    d = cfg.embedding_dim
    params["embed"] = {"kernel": normal((cin, d), cin ** -0.5), "bias": normal((d,), 0.01)}
    head = {"kernel": normal((d, num_classes), d ** -0.5), "bias": np.zeros(num_classes, np.float32)}
    return {"params": {"encoder": params, "head": head},
            "batch_stats": {"encoder": stats}}


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance between two bf16 tensors in units in the last place."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def min_cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=1).min())


def bench_store(seed: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decimated bench store, row ids, and decimated offsets with the
    edges: 0, the last valid start, and starts that run past the row."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(-20000, 20000, size=(BATCH, STORE_T), dtype=np.int16)
    store = decimate_store(torch.from_numpy(raw).to(DEVICE), DS)
    last = store.shape[1] - FRAG
    offsets = rng.integers(0, last + 1, BATCH).astype(np.int32)
    offsets[:5] = [0, last, last + 1, store.shape[1] - 100, store.shape[1]]
    idx = rng.permutation(BATCH).astype(np.int32)
    return store, torch.from_numpy(idx).to(DEVICE), torch.from_numpy(offsets).to(DEVICE)


def block0_params(seed: int, c: int = 128) -> tuple:
    """Block-0 parameters; half the BatchNorm scales negative, so the order of
    affine and max matters."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(32, 1, c, generator=g) * (32 ** -0.5)
    b = torch.randn(c, generator=g) * 0.05
    scale = torch.rand(c, generator=g) + 0.5
    scale[::2] *= -1.0
    bias, mean = torch.randn(c, generator=g) * 0.1, torch.randn(c, generator=g) * 0.1
    var = torch.rand(c, generator=g) * 1.5 + 0.5
    return tuple(t.to(DEVICE) for t in (w, b, scale, bias, mean, var))


def requant_scale_for(x: torch.Tensor, params: tuple) -> torch.Tensor:
    """Per-channel s0 = max-abs / 127 of the block's own f32 output, as
    calibration makes it."""
    pooled = conv_block0_reference(x, *params, out_dtype=torch.float32)
    return pooled.abs().amax(dim=(0, 1)).clamp(min=1e-8) / 127.0


def qblock_inputs(seed: int, B: int, T: int, cin: int, cout: int) -> tuple:
    """Random int8 activations and weights and epilogue vectors on the card;
    alpha crosses zero, and alpha and beta follow the accumulator's spread
    (≈ √(3·Cin)·5400 for uniform int8) so most outputs land inside ±127."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randint(-127, 128, (B, T, cin), generator=g, device=DEVICE, dtype=torch.int8)
    w = torch.randint(-127, 128, (3, cin, cout), generator=g, device=DEVICE, dtype=torch.int8)
    spread = (3 * cin) ** 0.5 * 5400.0
    alpha = torch.randn(cout, generator=g, device=DEVICE) * (40.0 / spread)
    beta = torch.randn(cout, generator=g, device=DEVICE) * (0.5 * spread)
    gamma = torch.randn(cout, generator=g, device=DEVICE) * 10.0
    return x, w, alpha, beta, gamma


def check_exact(name: str, out: torch.Tensor, ref: torch.Tensor, shape: tuple) -> dict:
    """``out`` equal to ``ref``: int8 by value, bf16 to 0 ulps."""
    torch.cuda.synchronize()
    if tuple(out.shape) != shape or out.dtype != ref.dtype:
        raise AssertionError(f"{name}: {tuple(out.shape)} {out.dtype}, want {shape} {ref.dtype}")
    if out.dtype == torch.bfloat16:
        ulps = bf16_ulps(out, ref) if out.numel() else 0
        ok, tol = ulps == 0, f"0 bf16 ulps (max {ulps})"
    else:
        ok, tol = bool(torch.equal(out, ref)), "equal"
    err = float((out.float() - ref.float()).abs().max()) if out.numel() else 0.0
    if not ok:
        raise AssertionError(f"{name} {shape} {out.dtype}: not {tol}, max abs err {err}")
    return {"kernel": name, "dtype": str(out.dtype).split(".")[-1], "shape": list(shape),
            "max_abs_err": err, "tolerance": tol}


def check_edges() -> list:
    """Shapes off the main path: T % 4 != 0 and C != 128 for B2 (bf16 and
    int8); a negative offset and indices outside the store for B1 (NaN rows,
    no stray read); odd T, B=3, a Cout that is no multiple of the CTA's 64
    channels (int8, bf16 and f32 out), Cin=480 and a one-step output for B3."""
    checks = []
    g = torch.Generator().manual_seed(1)
    for B, T, c in ((3, 1001, 16), (2, 4098, 160)):
        x = (torch.randn(B, T, 1, generator=g) * 0.05).to(DEVICE)
        params = block0_params(B + T, c)
        out = conv_block0(x, *params)
        ref = conv_block0_reference(x, *params)
        torch.cuda.synchronize()
        ulps = bf16_ulps(out, ref)
        if out.shape != (B, T // 4, c) or ulps > B2_BF16_ULPS:
            raise AssertionError(f"conv_block0 {(B, T, c)}: {tuple(out.shape)}, {ulps} ulps")
        checks.append({"kernel": "conv_block0", "dtype": "bfloat16", "shape": list(out.shape),
                       "max_abs_err": float((out.float() - ref.float()).abs().max()),
                       "tolerance": f"<= {B2_BF16_ULPS} bf16 ulp (max {ulps})"})
        s0 = requant_scale_for(x, params)
        checks.append(check_exact("conv_block0", conv_block0(x, *params, requant_scale=s0),
                                  conv_block0_reference(x, *params, requant_scale=s0),
                                  (B, T // 4, c)))
    store = torch.randint(-20000, 20000, (4, 1500), generator=g, dtype=torch.int16).to(DEVICE)
    idx = torch.tensor([2, 0, -1, 4], dtype=torch.int32, device=DEVICE)
    offsets = torch.tensor([-7, 600, 0, 0], dtype=torch.int32, device=DEVICE)
    got = gather_whiten(store, idx, offsets, 1000)
    want = gather_whiten_reference(store, idx[:2], offsets[:2], 1000)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[:2], want, rtol=B1_RTOL, atol=B1_ATOL)
    if not bool(got[2:].isnan().all()):
        raise AssertionError("gather_whiten: rows of indices outside the store are not NaN")
    checks.append({"kernel": "gather_whiten", "shape": list(got.shape),
                   "max_abs_err": float((got[:2] - want).abs().max()),
                   "tolerance": f"rtol {B1_RTOL}, atol {B1_ATOL}; NaN rows for indices -1, N"})
    for B, T, cin, cout, last, dt in ((3, 1001, 96, 40, False, None),
                                      (3, 1001, 96, 40, True, torch.bfloat16),
                                      (3, 1001, 96, 40, True, torch.float32),
                                      (1, 3, 32, 8, False, None),
                                      (2, 130, 480, 72, True, torch.bfloat16)):
        args = qblock_inputs(T + cin, B, T, cin, cout)
        kw = {"last": last, "out_dtype": dt} if last else {}
        checks.append(check_exact("quant_block", quant_block(*args, **kw),
                                  quant_block_reference(*args, **kw), (B, T // 2, cout)))
    return checks


def check_kernels(store, idx, offsets, params) -> dict:
    got = gather_whiten(store, idx, offsets, FRAG)
    want = gather_whiten_reference(store, idx, offsets, FRAG)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=B1_RTOL, atol=B1_ATOL)
    errors = {"gather_whiten": float((got - want).abs().max())}
    checks = [{"kernel": "gather_whiten", "shape": list(got.shape),
               "max_abs_err": errors["gather_whiten"],
               "tolerance": f"rtol {B1_RTOL}, atol {B1_ATOL}"}]

    x = got[:CHECK_ROWS, :, None]
    for dt in (torch.bfloat16, torch.float32):
        out = conv_block0(x, *params, out_dtype=dt, gemm_dtype=dt)
        ref = conv_block0_reference(x, *params, out_dtype=dt, gemm_dtype=dt)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        if dt == torch.bfloat16:
            ulps = bf16_ulps(out, ref)
            if ulps > B2_BF16_ULPS:
                raise AssertionError(f"conv_block0 bf16: {ulps} ulps > {B2_BF16_ULPS}")
            errors["conv_block0"] = err
            tol = f"<= {B2_BF16_ULPS} bf16 ulp (max {ulps})"
        else:
            torch.testing.assert_close(out, ref, rtol=B2_F32_RTOL, atol=B2_F32_ATOL)
            tol = f"rtol {B2_F32_RTOL}, atol {B2_F32_ATOL}"
        checks.append({"kernel": "conv_block0", "dtype": str(dt).split(".")[-1],
                       "shape": list(out.shape), "max_abs_err": err, "tolerance": tol})
    s0 = requant_scale_for(x, params)
    c = check_exact("conv_block0", conv_block0(x, *params, requant_scale=s0),
                    conv_block0_reference(x, *params, requant_scale=s0),
                    (CHECK_ROWS, FRAG // 4, params[1].shape[0]))
    errors["conv_block0_int8"] = c["max_abs_err"]
    checks.append(c)
    del x, got, want

    errors["quant_block"] = 0.0
    for i, (T, cin, cout, last) in enumerate(QBLOCKS):
        args = qblock_inputs(i, CHECK_ROWS, T, cin, cout)
        c = check_exact("quant_block", quant_block(*args, last=last),
                        quant_block_reference(*args, last=last), (CHECK_ROWS, T // 2, cout))
        errors["quant_block"] = max(errors["quant_block"], c["max_abs_err"])
        checks.append(c)
        del args
    checks.extend(check_edges())
    emit({"phase": "kernels", "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                                       "matmul": torch.backends.cuda.matmul.allow_tf32},
          "checks": checks})
    return {"errors": errors, "s0": s0}


def run_slice(seed: int) -> dict:
    cfg = classifier_baseline()
    host = synthetic_store(seed, n_speakers=40, utterances_per_speaker=8,
                           min_seconds=3.5, max_seconds=6.0)
    n_speakers = host.speaker_counts.shape[0]
    model = SpeakerClassifier(cfg.encoder, n_speakers, device=DEVICE)
    model.load_state_dict(from_flax(random_flax_variables(cfg.encoder, n_speakers, seed),
                                    cfg.encoder))
    store = device_store_for(cfg, host, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    reset_counts()
    t0 = time.perf_counter()
    table = nshot.embed_all(model, store, cfg, fast=True)
    acc = nshot.evaluate(model, store, cfg, gen, num_tasks=500, n=1, k=5, fast=True,
                         table=table)
    launches = read_counts()
    seconds = time.perf_counter() - t0

    n_utts = host.audio.shape[0]
    if table.shape != (n_utts, cfg.encoder.embedding_dim) or table.dtype != torch.float32:
        raise AssertionError(f"embedding table {tuple(table.shape)} {table.dtype}")
    if not bool(torch.isfinite(table).all()):
        raise AssertionError("embedding table is not finite")
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"accuracy {acc} outside [0, 1]")
    missing = [name for name in ("gather_whiten", "conv_block0") if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the slice: {missing}")

    # The plain-version path: reference gather + the module forward (cuDNN
    # for every block), from the same offset-0 fragments.
    plain = []
    with torch.inference_mode():
        for x in plain_fragments(store, cfg, n_utts):
            plain.append(model.embed(x))
    min_cos = min_cosine(table, torch.cat(plain))
    if min_cos < TABLE_MIN_COSINE:
        raise AssertionError(f"table vs plain path: min cosine {min_cos} < {TABLE_MIN_COSINE}")
    emit({"phase": "slice", "config": "classifier_baseline", "dtype": "bfloat16",
          "utterances": n_utts, "speakers": n_speakers, "tasks": 500, "n_shot": 1, "k_way": 5,
          "accuracy": acc, "table_shape": list(table.shape), "launches": launches,
          "min_cosine_vs_plain": min_cos, "cosine_tolerance": TABLE_MIN_COSINE,
          "seconds": seconds})
    return {"launches": launches, "model": model, "cfg": cfg, "store": store,
            "table": table, "accuracy": acc, "host": host}


def plain_fragments(store: DeviceStore, cfg, n_utts: int):
    """The offset-0 fragments of every utterance, through B1's plain version."""
    d = cfg.data
    for start in range(0, n_utts, CHECK_ROWS):
        idx = torch.arange(start, min(start + CHECK_ROWS, n_utts), device=DEVICE,
                           dtype=torch.int32)
        yield gather_whiten_reference(store.audio, idx, torch.zeros_like(idx),
                                      d.model_length, d.whiten_rms, d.whiten_eps)[..., None]


def quant_embed_plain(encoder, qvars: dict, x: torch.Tensor) -> torch.Tensor:
    """``quant_embed`` with every kernel replaced by its plain version."""
    cdt = encoder.compute_dtype
    blk = encoder.blocks[0]
    with torch.inference_mode():
        h = conv_block0_reference(
            x, blk.conv.weight.permute(2, 1, 0), blk.conv.bias, blk.bn.weight, blk.bn.bias,
            blk.bn.running_mean, blk.bn.running_var, blk.bn.eps, pool=blk.pool_size,
            gemm_dtype=cdt, requant_scale=qvars["s0"])
        n = len(qvars["blocks"])
        for i, q in enumerate(qvars["blocks"], start=1):
            h = quant_block_reference(h, q["w_q"], q["alpha"], q["beta"], q["gamma"],
                                      last=i == n, out_dtype=cdt)
        return encoder.pool_and_embed(h.transpose(1, 2))


def run_int8_slice(sliced: dict, seed: int) -> dict:
    model, cfg, store = sliced["model"], sliced["cfg"], sliced["store"]
    t0 = time.perf_counter()
    qvars = quantize_from_store(model, cfg, store, n_cal=256)
    torch.cuda.synchronize()
    calib_seconds = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    reset_counts()
    t0 = time.perf_counter()
    table = nshot.embed_all(model, store, cfg, qvars=qvars)
    acc = nshot.evaluate(model, store, cfg, gen, num_tasks=500, n=1, k=5, qvars=qvars,
                         table=table)
    launches = read_counts()
    seconds = time.perf_counter() - t0

    n_utts = store.labels.shape[0]
    chunks = -(-n_utts // 256)  # embed_all's batch_size
    if table.shape != (n_utts, cfg.encoder.embedding_dim) or table.dtype != torch.float32:
        raise AssertionError(f"int8 embedding table {tuple(table.shape)} {table.dtype}")
    if not bool(torch.isfinite(table).all()):
        raise AssertionError("int8 embedding table is not finite")
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"int8 accuracy {acc} outside [0, 1]")
    n_mid = len(qvars["blocks"])
    if (launches["gather_whiten"] == 0 or launches["conv_block0"] == 0
            or launches["quant_block"] != n_mid * chunks):
        raise AssertionError(f"int8 slice launches {launches}: want gather_whiten and "
                             f"conv_block0 > 0, quant_block = {n_mid} x {chunks} chunks")

    plain = torch.cat([quant_embed_plain(model.encoder, qvars, x)
                       for x in plain_fragments(store, cfg, n_utts)])
    cos_plain = min_cosine(table, plain)
    if cos_plain < TABLE_MIN_COSINE:
        raise AssertionError(f"int8 table vs plain path: min cosine {cos_plain}")
    tasks = sampling.sample_nshot_tasks(torch.Generator(device=DEVICE).manual_seed(seed),
                                        store.speaker_utts, store.speaker_counts, 500, 1, 5)
    pred = {name: nshot.classifier_nshot_predictions(t, tasks.query_idx, tasks.support_idx)
            for name, t in (("int8", table), ("bf16", sliced["table"]))}
    acc_again = float((pred["int8"] == 0).float().mean())
    if abs(acc_again - acc) > 1e-6:
        raise AssertionError(f"redrawn tasks score {acc_again}, evaluate gave {acc}")
    emit({"phase": "int8_slice", "config": "classifier_baseline", "utterances": n_utts,
          "tasks": 500, "n_shot": 1, "k_way": 5, "calibration_rows": min(256, n_utts),
          "accuracy_int8": acc, "accuracy_bf16": sliced["accuracy"],
          "same_decision_share": float((pred["int8"] == pred["bf16"]).float().mean()),
          "min_cosine_int8_vs_bf16_table": min_cosine(table, sliced["table"]),
          "min_cosine_vs_plain_int8_path": cos_plain, "cosine_tolerance": TABLE_MIN_COSINE,
          "launches": launches, "calibration_seconds": calib_seconds, "seconds": seconds})
    return {"launches": launches, "qvars": qvars}


def run_fidelity_gate(store, offsets, model, seed: int) -> dict:
    """bench.py's int8 gate: calibrate on rows [0, n_cal), measure on the
    disjoint rows [n_cal, 2·n_cal) at fresh decimated offsets."""
    n_cal = 256
    rng = np.random.default_rng(seed + 1)
    max_off = store.shape[1] - FRAG
    rows = torch.arange(n_cal, dtype=torch.int32, device=DEVICE)
    x_cal = gather_whiten(store[:n_cal], rows, offsets[:n_cal], FRAG)[..., None]
    qvars = quantize_encoder(model.encoder, x_cal)
    off_fid = torch.from_numpy(rng.integers(0, max_off, n_cal).astype(np.int32)).to(DEVICE)
    x_fid = gather_whiten(store[n_cal:2 * n_cal], rows, off_fid, FRAG)[..., None]
    with torch.inference_mode():
        ref = fast_embed(model.encoder, x_fid)
        out = quant_embed(model.encoder, qvars, x_fid)
    fidelity = min_cosine(out, ref)
    emit({"phase": "int8_fidelity_gate", "calibration_rows": [0, n_cal],
          "fidelity_rows": [n_cal, 2 * n_cal], "min_cosine": fidelity,
          "gate": INT8_FIDELITY_GATE, "pass": fidelity >= INT8_FIDELITY_GATE})
    if not fidelity >= INT8_FIDELITY_GATE:
        raise AssertionError(f"int8 fidelity gate: min cosine {fidelity} < {INT8_FIDELITY_GATE}")
    return {"qvars": qvars, "min_cosine": fidelity}


def in_chunks(fn, *tensors, **kw):
    """Run ``fn`` over CHECK_ROWS-row slices of the leading tensor (the plain
    versions hold full-rate f32 or f64 intermediates)."""
    def run():
        for start in range(0, tensors[0].shape[0], CHECK_ROWS):
            fn(tensors[0][start:start + CHECK_ROWS], *tensors[1:], **kw)
    return run


def time_quant_blocks(seed: int) -> dict:
    """Each B3 launch at config #1's block shapes and B=2048, beside its
    bound, its plain version and the library's int8 GEMM alone."""
    rows = []
    for i, (T, cin, cout, last) in enumerate(QBLOCKS):
        args = qblock_inputs(seed + i, BATCH, T, cin, cout)
        out_bytes = 2 if last else 1
        moved = BATCH * T * cin + 3 * cin * cout + 12 * cout + BATCH * (T // 2) * cout * out_bytes
        row = {"T": T, "cin": cin, "cout": cout, "out": "bfloat16" if last else "int8",
               **bound(moved, 2.0 * BATCH * T * 3 * cin * cout, INT8_OPS_PER_S)}
        row["ms"] = time_fn(quant_block, *args, last=last, iters=20)["mean_s"] * 1e3
        row["plain_ms"] = time_fn(in_chunks(quant_block_reference, *args, last=last),
                                  iters=2, warmup=1)["mean_s"] * 1e3
        x, w = args[0], args[1]
        try:  # library yardstick: torch._int_mm on the im2col'd input, GEMM only
            xp = torch.nn.functional.pad(x, (0, 0, 1, 1))
            a = torch.cat([xp[:, j:j + T] for j in range(3)], dim=-1).reshape(BATCH * T, 3 * cin)
            del xp
            row["library_ms"] = time_fn(torch._int_mm, a, w.reshape(3 * cin, cout).contiguous(),
                                        iters=10)["mean_s"] * 1e3
            row["library"] = "torch._int_mm on im2col (B*T, 3*Cin) x (3*Cin, Cout), GEMM only"
            del a
        except (RuntimeError, NotImplementedError) as e:
            row["library_ms"], row["library"] = None, f"torch._int_mm refused: {e}"
        rows.append(row)
        del args, x, w
        torch.cuda.empty_cache()
    return {"blocks": rows}


def run_timing(store, idx, offsets, params, s0, model, cfg, qvars, seed, card) -> dict:
    x = gather_whiten(store, idx, offsets, FRAG)[..., None]
    c = params[1].shape[0]
    x_bytes = BATCH * FRAG * 4
    conv_ops = 2.0 * BATCH * FRAG * c * 32
    ms = {
        "gather_whiten": time_fn(gather_whiten, store, idx, offsets, FRAG,
                                 iters=20)["mean_s"] * 1e3,
        "conv_block0": time_fn(conv_block0, x, *params, iters=20)["mean_s"] * 1e3,
        "conv_block0_int8": time_fn(conv_block0, x, *params, requant_scale=s0,
                                    iters=20)["mean_s"] * 1e3,
    }
    plain_ms = {
        "gather_whiten": time_fn(gather_whiten_reference, store, idx, offsets, FRAG,
                                 iters=10)["mean_s"] * 1e3,
        "conv_block0": time_fn(in_chunks(conv_block0_reference, x, *params),
                               iters=3, warmup=1)["mean_s"] * 1e3,
        "conv_block0_int8": time_fn(in_chunks(conv_block0_reference, x, *params,
                                              requant_scale=s0),
                                    iters=3, warmup=1)["mean_s"] * 1e3,
    }
    bounds = {
        "gather_whiten": bound(BATCH * FRAG * (2 + 4) + BATCH * 8, 0.0, BF16_OPS_PER_S),
        "conv_block0": bound(x_bytes + BATCH * (FRAG // 4) * c * 2, conv_ops, BF16_OPS_PER_S),
        "conv_block0_int8": bound(x_bytes + BATCH * (FRAG // 4) * c, conv_ops, BF16_OPS_PER_S),
    }
    del x
    qb = time_quant_blocks(seed)
    ms["quant_block"] = sum(r["ms"] for r in qb["blocks"])
    plain_ms["quant_block"] = sum(r["plain_ms"] for r in qb["blocks"])
    bounds["quant_block"] = {"bound_ms": sum(r["bound_ms"] for r in qb["blocks"]),
                             "bound_by": max(qb["blocks"], key=lambda r: r["bound_ms"])["bound_by"]}
    lib = [r["library_ms"] for r in qb["blocks"]]
    library_ms = {"gather_whiten": None, "conv_block0": None, "conv_block0_int8": None,
                  "quant_block": None if None in lib else sum(lib)}

    lengths = torch.full((BATCH,), store.shape[1], dtype=torch.int32, device=DEVICE)
    rows = torch.arange(BATCH, dtype=torch.int32, device=DEVICE)
    bench = DeviceStore(audio=store, lengths=lengths, labels=rows,
                        speaker_utts=rows[:, None], speaker_counts=torch.ones_like(rows),
                        downsampling=DS)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def serve(indices):
        with torch.inference_mode():
            return fast_embed(model.encoder, fetch_batch(bench, indices, cfg, gen))

    def serve_int8(indices):
        with torch.inference_mode():
            return quant_embed(model.encoder, qvars, fetch_batch(bench, indices, cfg, gen))

    def serve_plain(indices):
        with torch.inference_mode():
            offs = torch.zeros_like(indices)
            xp = gather_whiten_reference(store, indices, offs, FRAG)[..., None]
            return model.embed(xp)

    tput = throughput(serve, rows, items_per_call=BATCH, iters=10, warmup=2)
    tput_int8 = throughput(serve_int8, rows, items_per_call=BATCH, iters=10, warmup=2)
    tput_plain = throughput(serve_plain, rows, items_per_call=BATCH, iters=3, warmup=1)
    one = rows[:1]
    lat = time_fn(serve, one, iters=50, warmup=5)
    host = []
    for _ in range(50):
        t0 = time.perf_counter()
        serve(one)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    # int8 against bf16, store -> embedding, in turns at each batch size.
    sweep = []
    for b in SWEEP:
        iters = 5 if b >= 1024 else 20
        t_bf16 = time_fn(serve, rows[:b], iters=iters, warmup=2)["mean_s"]
        t_int8 = time_fn(serve_int8, rows[:b], iters=iters, warmup=2)["mean_s"]
        sweep.append({"batch": b, "bf16_ms": t_bf16 * 1e3, "int8_ms": t_int8 * 1e3,
                      "int8_over_bf16": t_int8 / t_bf16})
    faster = [r["batch"] for r in sweep if r["int8_ms"] < r["bf16_ms"]]
    min_batch = next((b for b in SWEEP if all(r["int8_ms"] < r["bf16_ms"]
                                              for r in sweep if r["batch"] >= b)), None)
    emit({"phase": "timing", "card": card, "kernel_ms": ms, "plain_ms": plain_ms,
          "bound": bounds, "library_ms": library_ms, "quant_block": qb["blocks"],
          "embed_utt_per_s_b2048": tput["items_per_sec"],
          "embed_ms_b2048": tput["sec_per_call"] * 1e3,
          "int8_embed_utt_per_s_b2048": tput_int8["items_per_sec"],
          "int8_embed_ms_b2048": tput_int8["sec_per_call"] * 1e3,
          "plain_path_utt_per_s_b2048": tput_plain["items_per_sec"],
          "batch1_p50_ms_events": lat["p50_s"] * 1e3,
          "batch1_p95_ms_events": lat["p95_s"] * 1e3,
          "batch1_p50_ms_host": float(np.median(host)) * 1e3,
          "int8_vs_bf16_sweep": sweep, "int8_faster_at": faster,
          "int8_min_batch_measured": min_batch,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"ms": ms, "plain_ms": plain_ms, "bounds": bounds, "library_ms": library_ms}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest difference over the largest magnitude of ``want``."""
    scale = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / (scale if scale > 0 else 1.0)


def check_rel(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> dict:
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)}, want {tuple(want.shape)}")
    err = rel_err(got, want)
    if not err <= tol:
        raise AssertionError(f"{name} {tuple(want.shape)}: {err} of max |value| > {tol}")
    return {"kernel": name, "shape": list(want.shape),
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "rel_err": err, "tolerance": f"<= {tol} of max |value|"}


def block0_train_inputs(seed: int, B: int, T: int, c: int) -> tuple:
    """B4/B5's parameters beside ``x``: w, b, sgn (γ of both signs), a pooled
    cotangent and the three dz constants."""
    w, b, scale = block0_params(seed, c)[:3]
    sgn = torch.where(scale >= 0, 1.0, -1.0)
    g = torch.Generator().manual_seed(seed)
    cot = torch.randn(B, T // 4, c, generator=g).to(DEVICE)
    c0, c1, c2 = (torch.randn(c, generator=g).mul(s).to(DEVICE) for s in (1.0, 0.1, 0.05))
    return w, b, sgn, cot, c0, c1, c2


def routing_inputs(seed: int, B: int, c: int, T: int, pool: int, dtype) -> tuple:
    """A relu activation (B, C, T) in ``dtype`` (half of it zero, ties among
    the rest), sgn of both signs, a pooled f32 cotangent and dz constants."""
    g = torch.Generator().manual_seed(seed)
    a = torch.relu(torch.randn(B, c, T, generator=g)).to(dtype).to(DEVICE)
    sgn = torch.where(torch.arange(c) % 3 == 1, -1.0, 1.0).to(DEVICE)
    cot = torch.randn(B, c, T // pool, generator=g).to(DEVICE)
    c0, c1, c2 = (torch.randn(c, generator=g).mul(s).to(DEVICE) for s in (1.0, 0.1, 0.05))
    return a, sgn, cot, c0, c1, c2


def check_block0_train(x: torch.Tensor, seed: int, c: int, dt) -> tuple[list, dict]:
    """B4 and B5 on ``x`` against their plain versions: a_sel 0 ulps (bf16)
    or equal (f32), the count equal, stats, dW and db to TRAIN_REL_TOL."""
    B, T = x.shape[0], x.shape[1]
    w, b, sgn, cot, c0, c1, c2 = block0_train_inputs(seed, B, T, c)
    got = conv_block0_train(x, w, b, sgn, 4, dt, dt)
    want = conv_block0_train_reference(x, w, b, sgn, 4, dt, dt)
    checks = [check_exact("conv_block0_train", got[0], want[0], (B, T // 4, c))]
    checks += [check_rel("conv_block0_train", g_, w_, TRAIN_REL_TOL)
               for g_, w_ in zip(got[1:3], want[1:3])]
    if not torch.equal(got[3], want[3]):
        raise AssertionError("conv_block0_train: #(a > 0) differs from the plain version")
    dw, db = conv_block0_train_bwd(x, w, b, sgn, cot, c0, c1, c2, 4, dt)
    want_dw, want_db = conv_block0_train_bwd_reference(x, w, b, sgn, cot, c0, c1, c2, 4, dt)
    checks += [check_rel("conv_block0_train_bwd", dw, want_dw, TRAIN_REL_TOL),
               check_rel("conv_block0_train_bwd", db, want_db, TRAIN_REL_TOL)]
    errors = {"conv_block0_train": max(checks[0]["max_abs_err"], checks[1]["max_abs_err"],
                                       checks[2]["max_abs_err"]),
              "conv_block0_train_bwd": max(checks[3]["max_abs_err"], checks[4]["max_abs_err"])}
    return checks, errors


def check_routing(seed: int, B: int, c: int, T: int, pool: int, dt) -> tuple[list, dict]:
    """B7 forward and backward against their plain versions: a_sel and dz
    0 ulps (bf16) or equal (f32), stats and db to TRAIN_REL_TOL."""
    a, sgn, cot, c0, c1, c2 = routing_inputs(seed, B, c, T, pool, dt)
    sel, s1, s2 = pool_fwd(a, sgn, pool, dt)
    want = pool_fwd_reference(a, sgn, pool, dt)
    checks = [check_exact("pool_fwd", sel, want[0], (B, c, T // pool)),
              check_rel("pool_fwd", s1, want[1], TRAIN_REL_TOL),
              check_rel("pool_fwd", s2, want[2], TRAIN_REL_TOL)]
    dz, db = route_bwd(a, sel, cot, c0, c1, c2, pool, dt)
    want_dz, want_db = route_bwd_reference(a, sel, cot, c0, c1, c2, pool, dt)
    checks += [check_exact("route_bwd", dz, want_dz, (B, c, T)),
               check_rel("route_bwd", db, want_db, TRAIN_REL_TOL)]
    errors = {"pool_fwd": max(ch["max_abs_err"] for ch in checks[:3]),
              "route_bwd": max(ch["max_abs_err"] for ch in checks[3:])}
    return checks, errors


def check_train_kernels(store, idx, offsets) -> dict:
    """B4/B5 at the train step's shape and at edges (B=3 with T/4 = 250, not
    a multiple of the 128-output tile; f32 at C=72); B7 at the three block
    shapes of the train step and at an odd C, bf16 and f32."""
    x = gather_whiten(store, idx[:TRAIN_BATCH], offsets[:TRAIN_BATCH], FRAG)[..., None]
    checks, errors = check_block0_train(x, 10, TRAIN_C0, torch.bfloat16)
    del x
    g = torch.Generator().manual_seed(11)
    for B, T, c, dt in ((3, 1000, TRAIN_C0, torch.bfloat16), (2, 4100, 72, torch.float32)):
        xe = (torch.randn(B, T, 1, generator=g) * 0.05).to(DEVICE)
        checks += check_block0_train(xe, B + T, c, dt)[0]
    for i, (c, T) in enumerate(TRAIN_BLOCKS):
        ch, err = check_routing(20 + i, TRAIN_BATCH, c, T, 2, torch.bfloat16)
        checks += ch
        for k, v in err.items():
            errors[k] = max(errors.get(k, 0.0), v)
    for B, c, T, pool, dt in ((5, 67, 250, 2, torch.bfloat16), (3, 67, 1000, 4, torch.float32)):
        checks += check_routing(B + c, B, c, T, pool, dt)[0]
    emit({"phase": "train_kernels", "checks": checks})
    return {"errors": errors}


@contextlib.contextmanager
def evaluation_launches():
    """Count the kernel launches made inside ``nshot.evaluate`` apart."""
    counts = {name: 0 for name in KERNELS}
    real = nshot.evaluate

    def counted(*args, **kw):
        before = read_counts()
        out = real(*args, **kw)
        after = read_counts()
        for name in counts:
            counts[name] += after[name] - before[name]
        return out

    nshot.evaluate = counted
    try:
        yield counts
    finally:
        nshot.evaluate = real


@contextlib.contextmanager
def plain_kernels():
    """The train path with every train kernel replaced by its plain version."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in PLAIN]
    for mod, name, plain in PLAIN:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def compare_plain_step(cfg, host, store, seed: int) -> dict:
    """One train step from fixed weights and a fixed batch, through the
    kernels and through their plain versions: the loss to STEP_LOSS_RTOL,
    every parameter's gradient to a cosine of STEP_MIN_COSINE."""
    n = len(host.label_names)
    model = SpeakerClassifier(cfg.encoder, n, device=DEVICE)
    model.load_state_dict(from_flax(random_flax_variables(cfg.encoder, n, seed), cfg.encoder))
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    idx = sampling.sample_classifier_batch(gen, store.labels.shape[0], TRAIN_BATCH, DEVICE)
    x, y = fetch_batch(store, idx, cfg, gen), store.labels[idx]
    runs = []
    for plain in (False, True):
        model.load_state_dict(snapshot)
        state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
        loss_fn = steps.classifier_loss_fn(model, cfg)
        with plain_kernels() if plain else contextlib.nullcontext():
            _, m = steps.train_on_batch(state, x, y, torch.Generator(device=DEVICE)
                                        .manual_seed(seed + 1), loss_fn)
            loss = float(m["loss"])
        runs.append((loss, {k: p.grad.detach().double().flatten().clone()
                            for k, p in model.named_parameters()}))
    (loss_k, grads_k), (loss_p, grads_p) = runs
    cos = {k: float(torch.nn.functional.cosine_similarity(grads_k[k], grads_p[k], dim=0))
           for k in grads_k}
    worst = min(cos, key=cos.get)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    if not (rel <= STEP_LOSS_RTOL and cos[worst] >= STEP_MIN_COSINE):
        raise AssertionError(f"kernel step against plain step: loss {loss_k} vs {loss_p}, "
                             f"min cosine {cos[worst]} at {worst}")
    return {"loss_kernels": loss_k, "loss_plain": loss_p, "loss_rel_diff": rel,
            "loss_rtol": STEP_LOSS_RTOL, "min_grad_cosine": cos[worst], "min_at": worst,
            "cosine_tolerance": STEP_MIN_COSINE}


def run_train_slice(sliced: dict, seed: int) -> dict:
    """``fit`` at full config #1 width, TRAIN_STEPS steps at batch 32, then
    one n-shot evaluation; the train launches are the counts read around
    ``fit`` less the evaluation's own."""
    host = sliced["host"]
    base = classifier_baseline()
    cfg = base.replace(train=dataclasses.replace(
        base.train, batch_size=TRAIN_BATCH, num_steps=TRAIN_STEPS, evaluate_every=TRAIN_STEPS,
        num_eval_tasks=500, seed=seed))
    losses, accs = [], []

    def on_step(i, m):
        losses.append(m["loss"])
        accs.append(m["accuracy"])

    reset_counts()
    with evaluation_launches() as eval_counts:
        t0 = time.perf_counter()
        state, history = fit(cfg, host, device=DEVICE, verbose=False, on_step=on_step)
        total = read_counts()
        seconds = time.perf_counter() - t0
    train = {k: total[k] - eval_counts[k] for k in total}
    S = TRAIN_STEPS
    want = {name: 0 for name in KERNELS}
    want.update(gather_whiten=S, conv_block0_train=S, conv_block0_train_bwd=S,
                pool_fwd=3 * S, route_bwd=3 * S)
    if train != want:
        raise AssertionError(f"train launches {train}, want {want} (per step: B1 1, B4 1, "
                             f"B5 1, B7 3 + 3)")
    if eval_counts["gather_whiten"] == 0 or eval_counts["conv_block0"] == 0:
        raise AssertionError(f"evaluation launches {eval_counts}: want B1 and B2")
    loss = torch.stack(losses).float().cpu()
    acc = torch.stack(accs).float().cpu()
    if not bool(torch.isfinite(loss).all()):
        raise AssertionError(f"non-finite train loss: {loss.tolist()}")
    first, last = float(loss[:5].mean()), float(loss[-5:].mean())
    if not last < first:
        raise AssertionError(f"train loss did not fall: first 5 {first}, last 5 {last}")
    val_acc = history[-1]["val_1-shot_acc"]
    if not (bool(((acc >= 0) & (acc <= 1)).all()) and 0.0 <= val_acc <= 1.0):
        raise AssertionError(f"accuracy outside [0, 1]: {acc.tolist()}, val {val_acc}")
    store = device_store_for(cfg, host, DEVICE)
    plain = compare_plain_step(cfg, host, store, seed)
    emit({"phase": "train_slice", "config": "classifier_baseline", "dtype": "bfloat16",
          "batch": TRAIN_BATCH, "steps": S, "speakers": len(host.label_names),
          "launches": train, "eval_launches": eval_counts,
          "loss_first5_mean": first, "loss_last5_mean": last, "losses": loss.tolist(),
          "final_record": history[-1], "seconds": seconds, "plain_step": plain})
    return {"launches": train, "cfg": cfg, "store": store, "host": host}


def run_train_timing(store, idx, offsets, trained: dict, seed: int, card: str) -> dict:
    """B4, B5 and B7 at the train step's shapes beside bounds, plain
    versions and (B5) a library call; the train step at each batch of
    TRAIN_TIMING_BATCHES under both blocks-1+ policies."""
    B, T, c = TRAIN_BATCH, FRAG, TRAIN_C0
    x = gather_whiten(store, idx[:B], offsets[:B], FRAG)[..., None]
    w, b, sgn, cot, c0, c1, c2 = block0_train_inputs(30, B, T, c)
    fwd, bwd = (x, w, b, sgn), (x, w, b, sgn, cot, c0, c1, c2)
    ms = {"conv_block0_train": time_fn(conv_block0_train, *fwd, iters=50)["mean_s"] * 1e3,
          "conv_block0_train_bwd": time_fn(conv_block0_train_bwd, *bwd,
                                           iters=50)["mean_s"] * 1e3}
    plain_ms = {
        "conv_block0_train": time_fn(conv_block0_train_reference, *fwd, iters=3,
                                     warmup=1)["mean_s"] * 1e3,
        "conv_block0_train_bwd": time_fn(conv_block0_train_bwd_reference, *bwd, iters=3,
                                         warmup=1)["mean_s"] * 1e3}
    conv_ops = 2.0 * B * T * c * 32
    pooled = B * (T // 4) * c
    bounds = {"conv_block0_train": bound(B * T * 4 + 32 * c * 4 + pooled * 2 + 3 * c * 4,
                                         conv_ops, BF16_OPS_PER_S),
              "conv_block0_train_bwd": bound(B * T * 4 + 32 * c * 4 + pooled * 4 + 33 * c * 4,
                                             2 * conv_ops, BF16_OPS_PER_S)}
    # Library yardstick for B5: cuDNN's weight gradient of the same conv from a
    # materialized full-rate dz, GEMM only (no recompute, routing or db).
    dz = torch.randn(B, c, T, device=DEVICE).to(torch.bfloat16)
    xp = torch.nn.functional.pad(x[..., 0].to(torch.bfloat16)[:, None, :], (15, 16))
    library_ms = {"conv_block0_train": None, "pool_fwd": None, "route_bwd": None,
                  "conv_block0_train_bwd": time_fn(torch.nn.grad.conv1d_weight, xp, (c, 1, 32),
                                                   dz, iters=20)["mean_s"] * 1e3}
    del dz, xp, x
    blocks = []
    for i, (cb, tb) in enumerate(TRAIN_BLOCKS):
        a, sg, g, k0, k1, k2 = routing_inputs(40 + i, B, cb, tb, 2, torch.bfloat16)
        sel = pool_fwd(a, sg, 2)[0]
        full, half = B * cb * tb, B * cb * (tb // 2)
        row = {"C": cb, "T": tb,
               "pool_fwd_ms": time_fn(pool_fwd, a, sg, 2, iters=50)["mean_s"] * 1e3,
               "route_bwd_ms": time_fn(route_bwd, a, sel, g, k0, k1, k2, 2,
                                       iters=50)["mean_s"] * 1e3,
               "pool_fwd_plain_ms": time_fn(pool_fwd_reference, a, sg, 2, iters=3,
                                            warmup=1)["mean_s"] * 1e3,
               "route_bwd_plain_ms": time_fn(route_bwd_reference, a, sel, g, k0, k1, k2, 2,
                                             iters=3, warmup=1)["mean_s"] * 1e3,
               "pool_fwd_bound": bound(full * 2 + half * 2 + 3 * cb * 4, 3.0 * full,
                                       BF16_OPS_PER_S),
               "route_bwd_bound": bound(full * 2 + half * 2 + half * 4 + full * 2 + 4 * cb * 4,
                                        6.0 * full, BF16_OPS_PER_S)}
        blocks.append(row)
        del a, sel, g
    for name in ("pool_fwd", "route_bwd"):
        ms[name] = sum(r[f"{name}_ms"] for r in blocks)
        plain_ms[name] = sum(r[f"{name}_plain_ms"] for r in blocks)
        bounds[name] = {"bound_ms": sum(r[f"{name}_bound"]["bound_ms"] for r in blocks),
                        "bound_by": "bytes"}

    host, base = trained["host"], trained["cfg"]
    dstore = trained["store"]
    # Each batch size in turns, jnp, fused, fused, jnp: a drift of the card or
    # the host over the run weighs on both policies alike.
    step_rows = []
    for bt in TRAIN_TIMING_BATCHES:
        for blockn in ("jnp", "fused", "fused", "jnp"):
            cfg = base.replace(train=dataclasses.replace(
                base.train, batch_size=bt, use_fused_blockn=blockn == "fused"))
            model = init_model(cfg, len(host.label_names), DEVICE, seed)
            state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
            step, loss_fn = steps.make_classifier_train_step(model, cfg)
            gen = torch.Generator(device=DEVICE).manual_seed(seed)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            r = time_fn(step, state, dstore, gen, iters=20 if bt <= 256 else 5, warmup=2)
            step_rows.append({"batch": bt, "blockn": blockn, "fused_block0": loss_fn.fused_block0,
                              "step_ms": r["mean_s"] * 1e3, "step_p50_ms": r["p50_s"] * 1e3,
                              "utt_per_s": bt / r["mean_s"],
                              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
            del model, state, step, loss_fn
    torch.cuda.empty_cache()
    summary = []
    for bt in TRAIN_TIMING_BATCHES:
        for blockn in ("jnp", "fused"):
            turns = [r for r in step_rows if (r["batch"], r["blockn"]) == (bt, blockn)]
            step_ms = sum(r["step_ms"] for r in turns) / len(turns)
            summary.append({"batch": bt, "blockn": blockn, "step_ms": step_ms,
                            "turns_ms": [r["step_ms"] for r in turns],
                            "utt_per_s": bt / step_ms * 1e3,
                            "peak_mem_gb": max(r["peak_mem_gb"] for r in turns)})
    emit({"phase": "train_timing", "card": card, "kernel_ms": ms, "plain_ms": plain_ms,
          "bound": bounds, "library_ms": library_ms,
          "library": {"conv_block0_train_bwd": "torch.nn.grad.conv1d_weight on a "
                      "materialized bf16 (B, C, T) dz, GEMM only"},
          "routing_blocks": blocks, "train_step_turns": step_rows,
          "train_step": summary})
    return {"ms": ms, "plain_ms": plain_ms, "bounds": bounds, "library_ms": library_ms}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda})
    # Stated, not inherited: every f32 conv and matmul here is full f32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    path, seconds, ptxas = _build.build()
    _build.library()
    emit({"phase": "build", "library": path.name, "seconds": seconds,
          "sources": [p.name for p in _build.sources()],
          "ptxas": [line.split(": ", 1)[-1] for line in ptxas.splitlines()
                    if "Used" in line or "spill" in line]})

    store, idx, offsets = bench_store(args.seed)
    params = block0_params(args.seed)
    checked = check_kernels(store, idx, offsets, params)
    checked_train = check_train_kernels(store, idx, offsets)
    sliced = run_slice(args.seed)
    sliced_int8 = run_int8_slice(sliced, args.seed)
    gate = run_fidelity_gate(store, offsets, sliced["model"], args.seed)
    trained = run_train_slice(sliced, args.seed)
    times = run_timing(store, idx, offsets, params, checked["s0"], sliced["model"],
                       sliced["cfg"], gate["qvars"], args.seed, card)
    train_times = run_train_timing(store, idx, offsets, trained, args.seed, card)
    for key in ("ms", "plain_ms", "bounds", "library_ms"):
        times[key].update(train_times[key])
    checked["errors"].update(checked_train["errors"])

    # Each entry's launches: the counts of the path runs above (phases slice,
    # int8_slice and train_slice), set to 0 just before each run and read
    # just after.
    paths = {"bf16": sliced["launches"], "int8": sliced_int8["launches"],
             "train": trained["launches"]}
    entries = (("gather_whiten", "gather_whiten", ("bf16", "int8", "train")),
               ("conv_block0", "conv_block0", ("bf16",)),
               ("conv_block0_int8", "conv_block0", ("int8",)),
               ("quant_block", "quant_block", ("int8",)),
               ("conv_block0_train", "conv_block0_train", ("train",)),
               ("conv_block0_train_bwd", "conv_block0_train_bwd", ("train",)),
               ("pool_fwd", "pool_fwd", ("train",)),
               ("route_bwd", "route_bwd", ("train",)))
    print(card, flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[kernel][1],
         "replaces": KERNELS[kernel][2],
         "launches": sum(paths[p][kernel] for p in on),
         "launches_by_path": {p: paths[p][kernel] for p in on},
         "max_abs_err": checked["errors"][name], "ms": times["ms"][name],
         "plain_ms": times["plain_ms"][name], **times["bounds"][name],
         "library_ms": times["library_ms"][name]}
        for name, kernel, on in entries
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
