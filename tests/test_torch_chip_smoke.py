"""chip_smoke.py's phases rehearsed on the CPU at a tiny size.

The script routes every tensor through ``chip_smoke.DEVICE``; here that is the
CPU, the kernels' plain versions stand in for the kernels (and count as their
launches), the build and the CUDA-event timers are stubbed, and the sizes
and the config are cut down (filters 32, 0.128 s fragments, train batches of
8, 12 train steps); the train policies resolve as they do on the card (B4/B5
and the fused blocks-1+ op). What this shows
is the control flow, the shapes and the records of every phase, the
``kernels`` line's keys and the last line; what the kernels compute on the
card only the script itself, run there, shows.
"""

import json
from pathlib import Path

import pytest
import torch

import chip_smoke as cs
from voicemap_tpu_torch.config import DataConfig, EncoderConfig, ExperimentConfig
from voicemap_tpu_torch.ops import (
    cuda_conv, cuda_conv_train, cuda_preprocess, cuda_quant_block, cuda_routing,
)
from voicemap_tpu_torch.train import steps

KERNEL_KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms"}


@pytest.fixture
def on_the_cpu(monkeypatch):
    small = ExperimentConfig(data=DataConfig(seconds=0.128, downsampling=4),
                             encoder=EncoderConfig(filters=32, embedding_dim=16))
    for name, value in (("DEVICE", "cpu"), ("BATCH", 512), ("STORE_T", 1800), ("FRAG", 400),
                        ("CHECK_ROWS", 64), ("SWEEP", (1, 8, 512)),
                        ("QBLOCKS", ((100, 32, 64, False), (50, 64, 96, False),
                                     (25, 96, 128, True))),
                        ("classifier_baseline", lambda: small),
                        ("TRAIN_BATCH", 8), ("TRAIN_C0", 16), ("TRAIN_STEPS", 12),
                        ("TRAIN_BLOCKS", ((64, 100), (96, 50), (128, 24))),
                        ("TRAIN_TIMING_BATCHES", (4, 8)),
                        ("card_line", lambda: "CPU rehearsal, 0 W")):
        monkeypatch.setattr(cs, name, value)
    # The policies as they resolve on the card: B4/B5, and the fused
    # blocks-1+ op unless the config says otherwise.
    monkeypatch.setattr(steps, "resolve_fused_block0", lambda cfg, model: True)
    monkeypatch.setattr(steps, "resolve_blockn", lambda cfg, device: (
        "jnp" if cfg.train.use_fused_blockn is False else "fused"))
    # The plain versions count as launches where the wrappers call them.
    for mod, ref, wrapper in ((cuda_conv, "conv_block0_reference", cuda_conv.conv_block0),
                              (cuda_preprocess, "gather_whiten_reference",
                               cuda_preprocess.gather_whiten),
                              (cuda_quant_block, "quant_block_reference",
                               cuda_quant_block.quant_block),
                              (cuda_conv_train, "conv_block0_train_reference",
                               cuda_conv_train.conv_block0_train),
                              (cuda_conv_train, "conv_block0_train_bwd_reference",
                               cuda_conv_train.conv_block0_train_bwd),
                              (cuda_routing, "pool_fwd_reference", cuda_routing.pool_fwd),
                              (cuda_routing, "route_bwd_reference", cuda_routing.route_bwd)):
        def counted(*a, _ref=getattr(mod, ref), _w=wrapper, **k):
            _w.launches += 1
            return _ref(*a, **k)
        monkeypatch.setattr(mod, ref, counted)
    gather = cs.gather_whiten

    def gather_nan(store, idx, off, frag, *a, **k):  # the kernel's NaN rows for bad ids
        bad = (idx < 0) | (idx >= store.shape[0])
        out = gather(store, idx.clamp(0, store.shape[0] - 1), off, frag, *a, **k)
        out[bad] = float("nan")
        return out

    def fake_time(fn, *a, iters=30, warmup=5, **k):
        fn(*a, **k)
        return {"mean_s": 1e-3, "p50_s": 1e-3, "p95_s": 1e-3, "min_s": 1e-3}

    def fake_tput(fn, *a, items_per_call, iters=30, warmup=5, **k):
        fn(*a, **k)
        return {"items_per_sec": items_per_call / 1e-3, "sec_per_call": 1e-3}

    monkeypatch.setattr(cs, "gather_whiten", gather_nan)
    monkeypatch.setattr(cs, "time_fn", fake_time)
    monkeypatch.setattr(cs, "throughput", fake_tput)
    monkeypatch.setattr(cs._build, "build", lambda: (Path("none.so"), 0.0, ""))
    monkeypatch.setattr(cs._build, "library", lambda: None)
    for name, value in (("is_available", lambda: True), ("synchronize", lambda *a: None),
                        ("get_device_name", lambda *a: "cpu"), ("device_count", lambda: 1),
                        ("max_memory_allocated", lambda *a: 0),
                        ("reset_peak_memory_stats", lambda *a: None),
                        ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)


def test_every_phase_runs_on_the_cpu_at_a_tiny_size(on_the_cpu, capsys):
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == lines[-3] == "CPU rehearsal, 0 W"
    records = [json.loads(line) for line in lines if line.startswith("{")]
    phases = [r["phase"] for r in records if "phase" in r]
    assert phases == ["device", "build", "kernels", "train_kernels", "slice", "int8_slice",
                      "int8_fidelity_gate", "train_slice", "timing", "train_timing"]
    by_phase = {r["phase"]: r for r in records if "phase" in r}
    nothing = {name: 0 for name in cs.KERNELS}
    assert by_phase["int8_slice"]["launches"] == {**nothing, "gather_whiten": 2,
                                                  "conv_block0": 2, "quant_block": 6}
    train = by_phase["train_slice"]
    steps_run = 12
    assert train["launches"] == {**nothing, "gather_whiten": steps_run,
                                 "conv_block0_train": steps_run,
                                 "conv_block0_train_bwd": steps_run,
                                 "pool_fwd": 3 * steps_run, "route_bwd": 3 * steps_run}
    assert train["eval_launches"] == {**nothing, "gather_whiten": 2, "conv_block0": 2}
    assert train["loss_last5_mean"] < train["loss_first5_mean"]
    assert train["plain_step"]["min_grad_cosine"] >= cs.STEP_MIN_COSINE
    timing = by_phase["train_timing"]
    assert [(r["batch"], r["blockn"]) for r in timing["train_step_turns"]] == [
        (b, p) for b in (4, 8) for p in ("jnp", "fused", "fused", "jnp")]
    assert [(r["batch"], r["blockn"], len(r["turns_ms"])) for r in timing["train_step"]] == [
        (4, "jnp", 2), (4, "fused", 2), (8, "jnp", 2), (8, "fused", 2)]
    assert by_phase["int8_fidelity_gate"]["pass"]
    assert [r["batch"] for r in by_phase["timing"]["int8_vs_bf16_sweep"]] == [1, 8, 512]
    kernels = records[-2]["kernels"]
    assert [k["name"] for k in kernels] == ["gather_whiten", "conv_block0",
                                            "conv_block0_int8", "quant_block",
                                            "conv_block0_train", "conv_block0_train_bwd",
                                            "pool_fwd", "route_bwd"]
    for k in kernels:
        assert KERNEL_KEYS <= set(k) and k["launches"] > 0 and k["bound_by"] in (
            "bytes", "operations")
    by_name = {k["name"]: k for k in kernels}
    assert by_name["pool_fwd"]["launches_by_path"] == {"train": 3 * steps_run}
    assert by_name["gather_whiten"]["launches_by_path"]["train"] == steps_run
    assert by_name["conv_block0_train_bwd"]["library_ms"] is not None
    assert records[-1] == {"ok": True, "device": {"platform": "gpu", "kind": "cpu", "count": 1}}
