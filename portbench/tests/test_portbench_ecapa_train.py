"""The ECAPA-TDNN training cell (``ecapa_tdnn.train_aam_b512``) on the CPU: its
entries in ``BENCHMARK.json``, its kind end to end through ``portbench.run``
at a tiny size in float32 with each control and planted fault turning
``correct`` false, its spans read by its per-layer metrics, no JAX, and
``counts_ecapa_train`` pinned at the published widths."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import controls_ecapa_train, counts, counts_ecapa, counts_ecapa_train, run

from .conftest import REPO, run_cell
from .test_portbench_ecapa import CONFIG, make_ecapa_root
from .test_portbench_run import ENV

CELL = "ecapa_tdnn.train_aam_b512"
TRAIN_CONFIG = "portbench/configs/ecapa_tdnn_train.json"
TRAIN = json.loads((REPO / TRAIN_CONFIG).read_text())
SPAN_METRICS = ("asp_bwd_roofline.ecapa_train", "forward_ms.train", "backward_ms.train",
                "optimizer_ms.train")


def make_train_root(root: Path) -> Path:
    """``make_ecapa_root`` (64 channels, 40 mels, 0.5 s, float32), the
    training configuration cut as the embed one, and the training mix cut to
    6 speakers, 24 rows of 0.6–1.0 s, batch 8 and one profiled set-up step."""
    make_ecapa_root(root)
    tiny = json.loads((root / "portbench/configs/ecapa_tdnn.json").read_text())
    path = root / TRAIN_CONFIG
    doc = json.loads(path.read_text())
    doc.update(encoder=tiny["encoder"], data=tiny["data"], mel=tiny["mel"])
    path.write_text(json.dumps(doc))
    path = root / "portbench/traffic/train_aam_b512.json"
    doc = json.loads(path.read_text())
    doc["store"].update(speakers=6, utterances=24, min_seconds=0.6, max_seconds=1.0)
    doc.update(batch_size=8, trace_seconds=0.05, profiled_steps=1)
    path.write_text(json.dumps(doc))
    return root


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    return make_train_root(tmp_path_factory.mktemp("ecapa_train"))


def test_entries_in_benchmark_json():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    w = run.by_name(bench["workloads"], CELL, "workload")
    assert (w["config"], w["traffic"], w["chips"]) == ("ecapa_tdnn_train", "train_aam_b512", 1)
    cfg = run.by_name(bench["configs"], "ecapa_tdnn_train", "config")
    assert cfg["reduced"] == [] and cfg["file"] == TRAIN_CONFIG
    embed = run.by_name(bench["configs"], "ecapa_tdnn", "config")
    assert cfg["source"] != embed["source"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert CELL in e2e["train_utt_per_s"]["workloads"]
    for name in ("forward_ms.train", "backward_ms.train", "optimizer_ms.train",
                 "idle_share.train"):
        assert CELL in run.by_name(bench["per_layer"], name, "metric")["workloads"]
    for name in ("library_ms.train", "routing_roofline.train", "mfu.train"):
        assert CELL not in run.by_name(bench["per_layer"], name, "metric")["workloads"]
    for name in ("mfu.ecapa_train", "asp_bwd_roofline.ecapa_train"):
        m = run.by_name(bench["per_layer"], name, "metric")
        assert (m["unit"], m["source"], m["moves"], m["workloads"]) == (
            "%", "device_trace", "train_utt_per_s", [CELL])


def test_the_training_configuration_is_the_embed_cells_model():
    for key in ("preset", "reference", "reduced", "encoder", "data", "mel"):
        assert TRAIN[key] == CONFIG[key], key
    assert "train_ecapa_tdnn.yaml" in TRAIN["source"]


def test_the_cell_runs_and_reads_its_span_metrics(train_root, capsys):
    res = run_cell(train_root, CELL, capsys=capsys)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_utt_per_s", "peak_gb", "setup_s"}
    # f32: the first step's numbers agree to rounding. The later steps' do
    # not: a 1e-5 change of the tiny model's weights moves its gradients by
    # ~0.3%, and Adam turns the rounding of a near-zero gradient element into
    # a step of up to its learning rate, so the free-running trajectories
    # part (tests/test_torch_ecapa_train.py holds each step from one state).
    assert res["checks"]["grad_gap"]["value"] < 1e-4, res["checks"]
    assert res["checks"]["bn_var_gap"]["value"] < 1e-4, res["checks"]
    traced = run_cell(train_root, CELL, trace=1, capsys=capsys)
    assert traced["correct"]
    # mfu.ecapa_train and idle_share.train read the device: none here
    assert set(SPAN_METRICS) <= set(traced["metrics"])


@pytest.mark.parametrize("control", controls_ecapa_train.CONTROLS)
def test_each_control_is_not_correct(train_root, capsys, control):
    undo = controls_ecapa_train.plant(control)
    try:
        res = run_cell(train_root, CELL, capsys=capsys)
    finally:
        undo()
    assert not res["correct"], res["checks"]


def test_the_int8_variant_runs_the_fp8_control(train_root, capsys):
    try:
        res = run_cell(train_root, CELL, variant="int8", capsys=capsys)
    finally:
        controls_ecapa_train.plant("fp8")()  # the kind planted it: put the program back
    assert not res["correct"], res["checks"]


# Each planted fault permanently patches the program: one child process each.
FAULT_CHILD = r"""
import json, sys
from pathlib import Path
from portbench import run
from portbench.tests.test_portbench_ecapa_train import make_train_root
root = make_train_root(Path(sys.argv[1]))
assert run.main(["--workload", "ecapa_tdnn.train_aam_b512", "--seed", "2147483659",
                 "--seconds", "0.2", "--trace", "0", "--variant", sys.argv[2]],
                root=root, device="cpu") == 0
"""


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_each_planted_fault_is_not_correct(tmp_path, fault):
    p = subprocess.run([sys.executable, "-c", FAULT_CHILD, str(tmp_path), fault], cwd=REPO,
                       env=ENV, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert not res["correct"], res["checks"]


def test_the_new_modules_load_no_jax():
    code = ("import sys\n"
            "import portbench.kinds.train_ecapa, portbench.reference.ecapa_tdnn_train\n"
            "import portbench.controls_ecapa_train, portbench.counts_ecapa_train\n"
            "print(','.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=ENV, capture_output=True,
                       text=True, timeout=120, check=True)
    assert not set(p.stdout.strip().split(",")) & set(run.FORBIDDEN)


def test_train_flops_at_the_published_widths():
    classes = 5994
    forward = counts_ecapa.embed_flops(TRAIN)
    layer1 = 298 * 2 * 5 * 80 * 1024
    assert counts_ecapa_train.train_flops(TRAIN, classes) == (
        3 * forward - layer1 + 3 * 2 * 192 * classes)
    # ≈ 33.3 GFLOP an utterance
    assert counts_ecapa_train.train_flops(TRAIN, classes) / 1e9 == pytest.approx(33.2876,
                                                                                 abs=1e-4)


def test_asp_bwd_bound_at_the_cell_shape():
    B, T, C = 512, 298, 3072
    hbm = counts.HBM_BYTES_PER_S
    weighted = (4 * B * T * C * 2 + 6 * B * C * 4) / hbm
    unweighted = (2 * B * T * C * 2 + 4 * B * C * 4) / hbm
    assert counts_ecapa_train.asp_bwd_bound_s(TRAIN, B) == pytest.approx(weighted, rel=1e-12)
    assert counts_ecapa_train.asp_bwd_bound_s(TRAIN, B, weighted=False) == pytest.approx(
        unweighted, rel=1e-12)
    # in milliseconds a 512 batch, for PERF.md
    assert 1e3 * weighted == pytest.approx(1.1306, abs=1e-4)
    assert 1e3 * unweighted == pytest.approx(0.5672, abs=1e-4)
