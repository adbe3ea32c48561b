"""BENCHMARK.json against the contract's shape, and every cell, mix, limit
file, reference and per-layer metric found from files by name."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from portbench import run

from .conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds_and_cover():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for w in BENCH["workloads"]:
        mine = {n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in mine and len(mine) >= 2
        assert any(run.applies(m, w["name"], mine) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    w = run.by_name(BENCH["workloads"], cell, "workload")
    assert w["chips"] == 1
    config = run.by_name(BENCH["configs"], w["config"], "config")
    doc = json.loads((REPO / config["file"]).read_text())
    assert doc["reduced"] == config["reduced"] and doc["source"] == config["source"]
    importlib.import_module(f"portbench.reference.{doc['reference']}")
    traffic = json.loads((REPO / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    assert hasattr(importlib.import_module(f"portbench.kinds.{traffic['kind']}"), "Job")
    limits = json.loads((REPO / "portbench" / "workloads" / f"{cell}.json").read_text())
    assert limits["limits"] and all(v >= 0 for v in limits["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_found_by_name(metric):
    m = run.by_name(BENCH["per_layer"], metric, "metric")
    assert callable(run.load_metric(REPO, metric).read)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    if "roofline" in metric or "mfu" in metric or "share" in metric:
        assert m["unit"] == "%"
