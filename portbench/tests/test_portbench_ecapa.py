"""The ECAPA-TDNN cell (``ecapa_tdnn.embed_bulk_16k``) on the CPU: its
entries in ``BENCHMARK.json``, its kind end to end at a tiny size with each
control turning ``correct`` false, its spans read by its per-layer metrics,
no JAX, and ``counts_ecapa`` pinned at the published widths."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import controls_ecapa, counts, counts_ecapa, run

from .conftest import REPO, make_tiny_root, run_cell
from .test_portbench_run import ENV

CELL = "ecapa_tdnn.embed_bulk_16k"
CONFIG = json.loads((REPO / "portbench/configs/ecapa_tdnn.json").read_text())
SPAN_METRICS = ("res2block_roofline.ecapa", "mfa_roofline.ecapa", "asp_roofline.ecapa")


def make_ecapa_root(root: Path) -> Path:
    """``make_tiny_root`` with the ECAPA config cut to 64 channels, 40 mels
    and 0.5 s in float32, and its mix to the tiny store."""
    make_tiny_root(root)
    path = root / "portbench/configs/ecapa_tdnn.json"
    doc = json.loads(path.read_text())
    doc["encoder"] = {**CONFIG["encoder"], "channels": [64, 64, 64, 64, 192], "se_channels": 16,
                      "attention_channels": 16, "embedding_dim": 24,
                      "compute_dtype": "float32"}
    doc["data"]["seconds"] = 0.5
    doc["mel"]["n_mels"] = 40
    path.write_text(json.dumps(doc))
    path = root / "portbench/traffic/embed_bulk_16k.json"
    doc = json.loads(path.read_text())
    doc["store"].update(speakers=4, utterances=24, min_seconds=0.6, max_seconds=1.0)
    doc.update(batch_size=8, check_rows=24, trace_seconds=0.05)
    path.write_text(json.dumps(doc))
    return root


@pytest.fixture
def ecapa_root(tmp_path):
    return make_ecapa_root(tmp_path)


def test_entries_in_benchmark_json():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = run.by_name(bench["configs"], "ecapa_tdnn", "config")
    assert cfg["reduced"] == [] and cfg["file"] == "portbench/configs/ecapa_tdnn.json"
    for cell, config, traffic in ((CELL, "ecapa_tdnn", "embed_bulk_16k"),
                                  ("dilated_4khz.train_b2048", "dilated_4khz", "train_b2048")):
        w = run.by_name(bench["workloads"], cell, "workload")
        assert (w["config"], w["traffic"], w["chips"]) == (config, traffic, 1)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert CELL in e2e["embed_utt_per_s"]["workloads"]
    assert "dilated_4khz.train_b2048" in e2e["train_utt_per_s"]["workloads"]
    for name in ("mfu.ecapa",) + SPAN_METRICS:
        m = run.by_name(bench["per_layer"], name, "metric")
        assert (m["unit"], m["source"], m["moves"], m["workloads"]) == (
            "%", "device_trace", "embed_utt_per_s", [CELL])


def test_the_cell_runs_and_reads_its_span_metrics(ecapa_root, capsys):
    res = run_cell(ecapa_root, CELL, capsys=capsys)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"embed_utt_per_s", "peak_gb", "setup_s"}
    assert all(c["value"] < 1e-4 for c in res["checks"].values())  # f32: rounding alone
    traced = run_cell(ecapa_root, CELL, trace=1, capsys=capsys)
    assert traced["correct"]
    assert set(SPAN_METRICS) <= set(traced["metrics"])  # mfu.ecapa reads the device: none here


@pytest.mark.parametrize("control", controls_ecapa.CONTROLS)
def test_each_control_is_not_correct(ecapa_root, capsys, control):
    undo = controls_ecapa.plant(control)
    try:
        res = run_cell(ecapa_root, CELL, capsys=capsys)
    finally:
        undo()
    assert not res["correct"], res["checks"]
    assert run_cell(ecapa_root, CELL, capsys=capsys)["correct"]  # undone


def test_the_int8_variant_runs_the_fp8_control(ecapa_root, capsys):
    try:
        res = run_cell(ecapa_root, CELL, variant="int8", capsys=capsys)
    finally:
        controls_ecapa.plant("fp8")()  # the kind planted it: put the program back
    assert not res["correct"], res["checks"]


def test_the_new_modules_load_no_jax():
    code = ("import sys\n"
            "import portbench.kinds.embed_ecapa, portbench.reference.ecapa_tdnn\n"
            "import portbench.controls_ecapa, portbench.counts_ecapa\n"
            "print(','.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=ENV, capture_output=True,
                       text=True, timeout=120, check=True)
    assert not set(p.stdout.strip().split(",")) & set(run.FORBIDDEN)


def test_counts_at_the_published_widths():
    T = 298  # 1 + (48,000 − 400) // 160
    assert counts_ecapa.frames(CONFIG) == T
    per_frame = (2 * 5 * 80 * 1024  # layer 1
                 + 3 * (2 * 2 * 1024 * 1024 + 7 * 2 * 3 * 128 * 128)  # the blocks' TDNNs
                 + 2 * 3072 * 3072  # MFA
                 + 2 * 9216 * 128 + 2 * 128 * 3072)  # ASP's TDNN and conv
    assert per_frame == 37_486_592
    once = 3 * 2 * 2 * 1024 * 128 + 2 * 6144 * 192  # the SE convs and the linear layer
    assert counts_ecapa.embed_flops(CONFIG) == T * per_frame + once == 11_174_936_576
    B, rows = 2048, 2048 * T
    hbm, peak = counts.HBM_BYTES_PER_S, counts.BF16_OPS_PER_S
    gemm = lambda cin, cout, k: max(  # noqa: E731  B8's formula at pool 1
        (rows * cin * 2 + k * cin * cout * 4 + 5 * cout * 4 + rows * cout * 2) / hbm,
        2.0 * rows * k * cin * cout / peak)
    want_block = (2 * gemm(1024, 1024, 1) + 7 * gemm(128, 128, 3)
                  + 3 * rows * 1024 * 2 / hbm)
    assert counts_ecapa.block_bound_s(CONFIG, B) == pytest.approx(want_block, rel=1e-12)
    assert counts_ecapa.mfa_bound_s(CONFIG, B) == pytest.approx(gemm(3072, 3072, 1), rel=1e-12)
    want_asp = ((rows * 3072 * 2 + B * 2 * 3072 * 4) / hbm + gemm(3072, 128, 1)
                + max((rows * 128 * 2 + rows * 3072 * 2 + 128 * 3072 * 4) / hbm,
                      2.0 * rows * 128 * 3072 / peak)
                + (2 * rows * 3072 * 2 + B * 2 * 3072 * 4) / hbm)
    assert counts_ecapa.asp_bound_s(CONFIG, B) == pytest.approx(want_asp, rel=1e-12)
    # in milliseconds a 2,048 batch, for PERF.md
    ms = {k: 1e3 * f(CONFIG, B) for k, f in (("block", counts_ecapa.block_bound_s),
                                               ("mfa", counts_ecapa.mfa_bound_s),
                                               ("asp", counts_ecapa.asp_bound_s))}
    assert ms == pytest.approx({"block": 4.3609, "mfa": 11.6472, "asp": 5.7208}, abs=1e-4)
