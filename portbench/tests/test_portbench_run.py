"""The harness end to end on the CPU at tiny sizes: no card, no result; no
JAX; a fault planted under the timed path turns ``correct`` false; a new
cell and a new metric are only new files."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import run

from .conftest import REPO, run_cell

ENV = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


def test_run_without_a_card_fails():
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "classifier_baseline.embed_bulk", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, env=ENV, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_harness_loads_no_jax():
    code = ("import sys, importlib, pathlib\n"
            "import portbench.run, portbench.program, portbench.faults, portbench.trace\n"
            "for kind in ('embed', 'train', 'request'):\n"
            "    importlib.import_module('portbench.kinds.' + kind)\n"
            "import portbench.reference.conv1d_encoder\n"
            "for p in pathlib.Path('portbench/metrics').glob('*.py'):\n"
            "    portbench.run.load_metric(pathlib.Path('.'), p.stem)\n"
            "print(','.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=ENV, capture_output=True,
                       text=True, timeout=120, check=True)
    tops = set(p.stdout.strip().split(","))
    assert "voicemap_tpu_torch" in tops  # the whole name is compared, not a prefix
    assert not tops & set(run.FORBIDDEN)


@pytest.fixture
def restore_program():
    """Faults patch the program's modules; put them back afterwards."""
    from voicemap_tpu_torch.eval import nshot
    from voicemap_tpu_torch.train import steps

    saved = [(steps, "apply_updates"), (steps, "train_on_batch"), (nshot, "fast_embed"),
             (nshot, "classifier_nshot_predictions")]
    saved = [(m, n, getattr(m, n)) for m, n in saved]
    yield
    for m, n, f in saved:
        setattr(m, n, f)


@pytest.mark.parametrize("cell,fault", [
    ("classifier_baseline.train_b2048", "frozen_state"),
    ("classifier_baseline.train_b2048", "half_batch"),
    ("classifier_baseline.embed_bulk", "altered_answer"),
    ("dilated_4khz.embed_bulk", "altered_answer"),
    ("classifier_baseline.request_b1", "altered_answer"),
])
def test_fault_is_not_correct(tiny_root, capsys, restore_program, cell, fault):
    assert run_cell(tiny_root, cell, capsys=capsys)["correct"]
    res = run_cell(tiny_root, cell, variant=fault, capsys=capsys)
    assert not res["correct"], res["checks"]


def test_result_line_and_checks_last(tiny_root, capsys):
    res = run_cell(tiny_root, "classifier_baseline.embed_bulk", capsys=capsys)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"embed_utt_per_s", "peak_gb", "setup_s"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())


def test_new_cell_and_metric_are_new_files(tiny_root, capsys):
    """A cell with a mix of its own and a per-layer metric, added as files and
    entries alone, run traced: the new metric is read and reported."""
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    traffic = json.loads((tiny_root / "portbench/traffic/embed_bulk.json").read_text())
    traffic.update(batch_size=5)
    (tiny_root / "portbench/traffic/dummy_mix.json").write_text(json.dumps(traffic))
    (tiny_root / "portbench/workloads/classifier_baseline.dummy_mix.json").write_text(
        json.dumps({"limits": {"embed_err_max": 1e-4}}))
    (tiny_root / "portbench/metrics/dummy_rows.embed.py").write_text(
        "def read(t):\n    return float(max(t.work['batches']))\n")
    bench["workloads"].append({"name": "classifier_baseline.dummy_mix",
                               "config": "classifier_baseline", "traffic": "dummy_mix",
                               "chips": 1, "why": "a dummy"})
    for m in bench["end_to_end"]:
        if m["name"] == "embed_utt_per_s":
            m["workloads"].append("classifier_baseline.dummy_mix")
    bench["per_layer"].append({"name": "dummy_rows.embed", "unit": "rows",
                               "better": "lower", "source": "device_trace", "layer": "dummy",
                               "moves": "embed_utt_per_s",
                               "workloads": ["classifier_baseline.dummy_mix"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_cell(tiny_root, "classifier_baseline.dummy_mix", trace=1, capsys=capsys)
    assert res["correct"]
    assert res["metrics"]["dummy_rows.embed"] == {"value": 5.0, "unit": "rows"}
    assert "blockn_roofline.embed" not in res["metrics"]  # not this cell's metric
