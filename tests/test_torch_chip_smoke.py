"""chip_smoke.py's phases rehearsed on the CPU at a tiny size.

The script routes every tensor through ``chip_smoke.DEVICE``; here that is the
CPU, the kernels' plain versions stand in for the kernels (and count as their
launches), the build and the CUDA-event timers are stubbed, and the sizes
and the config are cut down (filters 32, 0.1 s fragments). What this shows
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
from voicemap_tpu_torch.ops import cuda_conv, cuda_preprocess, cuda_quant_block

KERNEL_KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms"}


@pytest.fixture
def on_the_cpu(monkeypatch):
    small = ExperimentConfig(data=DataConfig(seconds=0.1, downsampling=4),
                             encoder=EncoderConfig(filters=32, embedding_dim=16))
    for name, value in (("DEVICE", "cpu"), ("BATCH", 512), ("STORE_T", 1800), ("FRAG", 400),
                        ("CHECK_ROWS", 64), ("SWEEP", (1, 8, 512)),
                        ("QBLOCKS", ((100, 32, 64, False), (50, 64, 96, False),
                                     (25, 96, 128, True))),
                        ("classifier_baseline", lambda: small),
                        ("card_line", lambda: "CPU rehearsal, 0 W")):
        monkeypatch.setattr(cs, name, value)
    # The plain versions count as launches where the wrappers call them.
    for mod, ref, wrapper in ((cuda_conv, "conv_block0_reference", cuda_conv.conv_block0),
                              (cuda_preprocess, "gather_whiten_reference",
                               cuda_preprocess.gather_whiten),
                              (cuda_quant_block, "quant_block_reference",
                               cuda_quant_block.quant_block)):
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
                        ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)


def test_every_phase_runs_on_the_cpu_at_a_tiny_size(on_the_cpu, capsys):
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == lines[-3] == "CPU rehearsal, 0 W"
    records = [json.loads(line) for line in lines if line.startswith("{")]
    phases = [r["phase"] for r in records if "phase" in r]
    assert phases == ["device", "build", "kernels", "slice", "int8_slice",
                      "int8_fidelity_gate", "timing"]
    by_phase = {r["phase"]: r for r in records if "phase" in r}
    assert by_phase["int8_slice"]["launches"] == {"gather_whiten": 2, "conv_block0": 2,
                                                  "quant_block": 6}
    assert by_phase["int8_fidelity_gate"]["pass"]
    assert [r["batch"] for r in by_phase["timing"]["int8_vs_bf16_sweep"]] == [1, 8, 512]
    kernels = records[-2]["kernels"]
    assert [k["name"] for k in kernels] == ["gather_whiten", "conv_block0",
                                            "conv_block0_int8", "quant_block"]
    for k in kernels:
        assert KERNEL_KEYS <= set(k) and k["launches"] > 0 and k["bound_by"] in (
            "bytes", "operations")
    assert records[-1] == {"ok": True, "device": {"platform": "gpu", "kind": "cpu", "count": 1}}
