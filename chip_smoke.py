"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root, on a machine with a CUDA card and ``nvcc``.
Each phase prints one JSON line; nothing here imports JAX.

1. device — exit non-zero without CUDA; print the ``nvidia-smi`` name and
   power limit;
2. build — compile ``voicemap_tpu_torch/csrc`` for ``sm_90a``;
3. kernels — each CUDA kernel against its plain PyTorch version on the card,
   at the main path's shapes, with the tolerance stated;
4. slice — config #1 at full width (filters 128, embedding 64, 3 s at 16 kHz,
   downsampling 4) built from a flax-layout tree through ``from_flax``,
   serving 500 1-shot 5-way n-shot tasks over a seeded synthetic store, with
   the kernels' launch counters read around that run and its embedding table
   held against the plain-version path;
5. timing — CUDA-event times of each kernel beside its plain version, embed
   throughput at B=2048 and batch-1 latency.

It ends with the per-kernel summary line, then
``{"ok": true, "device": {...}}``. Any failed phase raises, so the exit code
is non-zero and that last line is never printed.
"""

from __future__ import annotations

import argparse
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
from voicemap_tpu_torch.ops.cuda_conv import conv_block0, conv_block0_reference
from voicemap_tpu_torch.ops.cuda_preprocess import (
    decimate_store, gather_whiten, gather_whiten_reference,
)
from voicemap_tpu_torch.train.steps import DeviceStore, device_store_for, fetch_batch
from voicemap_tpu_torch.utils.profiling import throughput, time_fn

# The store that bench.py measures: 2048 rows of 3.5 s raw int16, decimated
# once; 12000-sample fragments at decimated offsets in [0, 2000].
BATCH = 2048
STORE_T = 56000
DS = 4
FRAG = 12000
B2_CHECK_ROWS = 256

B1_RTOL, B1_ATOL = 1e-5, 1e-6
B2_F32_RTOL, B2_F32_ATOL = 1e-5, 1e-5
B2_BF16_ULPS = 1
TABLE_MIN_COSINE = 0.999

KERNELS = (
    ("gather_whiten", gather_whiten, "voicemap_tpu_torch/csrc/gather_whiten.cu",
     "voicemap_tpu/ops/pallas_preprocess.py:88"),
    ("conv_block0", conv_block0, "voicemap_tpu_torch/csrc/conv_block0.cu",
     "voicemap_tpu/ops/pallas_conv.py:97"),
)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


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


def bench_store(seed: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decimated bench store, row ids, and decimated offsets with the
    edges: 0, the last valid start, and starts that run past the row."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(-20000, 20000, size=(BATCH, STORE_T), dtype=np.int16)
    store = decimate_store(torch.from_numpy(raw).cuda(), DS)
    last = store.shape[1] - FRAG
    offsets = rng.integers(0, last + 1, BATCH).astype(np.int32)
    offsets[:5] = [0, last, last + 1, store.shape[1] - 100, store.shape[1]]
    idx = rng.permutation(BATCH).astype(np.int32)
    return store, torch.from_numpy(idx).cuda(), torch.from_numpy(offsets).cuda()


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
    return tuple(t.cuda() for t in (w, b, scale, bias, mean, var))


def check_edges() -> list:
    """Shapes off the main path: T % 4 != 0 and C != 128 for B2; a negative
    offset and indices outside the store for B1 (NaN rows, no stray read)."""
    checks = []
    g = torch.Generator().manual_seed(1)
    for B, T, c in ((3, 1001, 16), (2, 4098, 160)):
        x = (torch.randn(B, T, 1, generator=g) * 0.05).cuda()
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
    store = torch.randint(-20000, 20000, (4, 1500), generator=g, dtype=torch.int16).cuda()
    idx = torch.tensor([2, 0, -1, 4], dtype=torch.int32, device="cuda")
    offsets = torch.tensor([-7, 600, 0, 0], dtype=torch.int32, device="cuda")
    got = gather_whiten(store, idx, offsets, 1000)
    want = gather_whiten_reference(store, idx[:2], offsets[:2], 1000)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[:2], want, rtol=B1_RTOL, atol=B1_ATOL)
    if not bool(got[2:].isnan().all()):
        raise AssertionError("gather_whiten: rows of indices outside the store are not NaN")
    checks.append({"kernel": "gather_whiten", "shape": list(got.shape),
                   "max_abs_err": float((got[:2] - want).abs().max()),
                   "tolerance": f"rtol {B1_RTOL}, atol {B1_ATOL}; NaN rows for indices -1, N"})
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

    x = got[:B2_CHECK_ROWS, :, None]
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
    checks.extend(check_edges())
    emit({"phase": "kernels", "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                                       "matmul": torch.backends.cuda.matmul.allow_tf32},
          "checks": checks})
    return errors


def run_slice(seed: int) -> dict:
    cfg = classifier_baseline()
    host = synthetic_store(seed, n_speakers=40, utterances_per_speaker=8,
                           min_seconds=3.5, max_seconds=6.0)
    n_speakers = host.speaker_counts.shape[0]
    model = SpeakerClassifier(cfg.encoder, n_speakers, device="cuda")
    model.load_state_dict(from_flax(random_flax_variables(cfg.encoder, n_speakers, seed),
                                    cfg.encoder))
    store = device_store_for(cfg, host, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    for _, wrapper, _, _ in KERNELS:
        wrapper.launches = 0
    t0 = time.perf_counter()
    table = nshot.embed_all(model, store, cfg, fast=True)
    acc = nshot.evaluate(model, store, cfg, gen, num_tasks=500, n=1, k=5, fast=True,
                         table=table)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: wrapper.launches for name, wrapper, _, _ in KERNELS}

    n_utts = host.audio.shape[0]
    if table.shape != (n_utts, cfg.encoder.embedding_dim) or table.dtype != torch.float32:
        raise AssertionError(f"embedding table {tuple(table.shape)} {table.dtype}")
    if not bool(torch.isfinite(table).all()):
        raise AssertionError("embedding table is not finite")
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"accuracy {acc} outside [0, 1]")
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the slice: {missing}")

    # The plain-version path: reference gather + the module forward (cuDNN
    # for every block), from the same offset-0 fragments.
    plain = []
    d = cfg.data
    with torch.inference_mode():
        for start in range(0, n_utts, 256):
            idx = torch.arange(start, min(start + 256, n_utts), device="cuda",
                               dtype=torch.int32)
            x = gather_whiten_reference(store.audio, idx, torch.zeros_like(idx),
                                        d.model_length, d.whiten_rms, d.whiten_eps)
            plain.append(model.embed(x[..., None]))
    cos = torch.nn.functional.cosine_similarity(table, torch.cat(plain), dim=1)
    min_cos = float(cos.min())
    if min_cos < TABLE_MIN_COSINE:
        raise AssertionError(f"table vs plain path: min cosine {min_cos} < {TABLE_MIN_COSINE}")
    record = {"phase": "slice", "config": "classifier_baseline", "utterances": n_utts,
              "speakers": n_speakers, "tasks": 500, "n_shot": 1, "k_way": 5,
              "accuracy": acc, "table_shape": list(table.shape), "launches": launches,
              "min_cosine_vs_plain": min_cos, "cosine_tolerance": TABLE_MIN_COSINE,
              "seconds": seconds}
    emit(record)
    return {"launches": launches, "model": model, "cfg": cfg}


def run_timing(store, idx, offsets, params, model, cfg, seed, card) -> dict:
    x = gather_whiten(store, idx, offsets, FRAG)[..., None]

    def plain_block0(x):
        for start in range(0, BATCH, B2_CHECK_ROWS):
            conv_block0_reference(x[start:start + B2_CHECK_ROWS], *params)

    ms = {
        "gather_whiten": time_fn(gather_whiten, store, idx, offsets, FRAG, iters=20)["mean_s"] * 1e3,
        "conv_block0": time_fn(conv_block0, x, *params, iters=20)["mean_s"] * 1e3,
    }
    plain_ms = {
        "gather_whiten": time_fn(gather_whiten_reference, store, idx, offsets, FRAG,
                                 iters=10)["mean_s"] * 1e3,
        "conv_block0": time_fn(plain_block0, x, iters=3, warmup=1)["mean_s"] * 1e3,
    }
    del x

    lengths = torch.full((BATCH,), store.shape[1], dtype=torch.int32, device="cuda")
    rows = torch.arange(BATCH, dtype=torch.int32, device="cuda")
    bench = DeviceStore(audio=store, lengths=lengths, labels=rows,
                        speaker_utts=rows[:, None], speaker_counts=torch.ones_like(rows),
                        downsampling=DS)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def serve(indices):
        with torch.inference_mode():
            return fast_embed(model.encoder, fetch_batch(bench, indices, cfg, gen))

    def serve_plain(indices):
        with torch.inference_mode():
            offs = torch.zeros_like(indices)
            xp = gather_whiten_reference(store, indices, offs, FRAG)[..., None]
            return model.embed(xp)

    tput = throughput(serve, rows, items_per_call=BATCH, iters=10, warmup=2)
    tput_plain = throughput(serve_plain, rows, items_per_call=BATCH, iters=3, warmup=1)
    one = rows[:1]
    lat = time_fn(serve, one, iters=50, warmup=5)
    host = []
    for _ in range(50):
        t0 = time.perf_counter()
        serve(one)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    emit({"phase": "timing", "card": card, "kernel_ms": ms, "plain_ms": plain_ms,
          "embed_utt_per_s_b2048": tput["items_per_sec"],
          "embed_ms_b2048": tput["sec_per_call"] * 1e3,
          "plain_path_utt_per_s_b2048": tput_plain["items_per_sec"],
          "batch1_p50_ms_events": lat["p50_s"] * 1e3,
          "batch1_p95_ms_events": lat["p95_s"] * 1e3,
          "batch1_p50_ms_host": float(np.median(host)) * 1e3,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"ms": ms, "plain_ms": plain_ms}


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
          "ptxas": [line.split(": ", 1)[-1] for line in ptxas.splitlines() if "Used" in line]})

    store, idx, offsets = bench_store(args.seed)
    params = block0_params(args.seed)
    errors = check_kernels(store, idx, offsets, params)
    sliced = run_slice(args.seed)
    times = run_timing(store, idx, offsets, params, sliced["model"], sliced["cfg"],
                       args.seed, card)

    print(card, flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": sliced["launches"][name], "max_abs_err": errors[name],
         "ms": times["ms"][name], "plain_ms": times["plain_ms"][name]}
        for name, _, source, replaces in KERNELS
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
