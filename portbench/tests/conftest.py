"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's data files
at a size the CPU runs in seconds, and the look for a card (made inside a
fixture, never at import)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
DATA_DIRS = ("configs", "traffic", "workloads", "metrics")

# Each mix at a size the CPU runs in seconds: a few speakers and short rows.
TINY_STORE = {"speakers": 4, "utterances": 24, "min_seconds": 0.6, "max_seconds": 1.0}
TINY_TRAFFIC = {"embed_bulk": {"batch_size": 8, "check_rows": 24, "trace_seconds": 0.05},
                "train_b2048": {"batch_size": 8, "trace_seconds": 0.05},
                "request_b1": {"query_pool": 5, "query_seconds": 0.5, "warm_requests": 2,
                               "check_requests": 8, "check_share": 1.0, "support": 2,
                               "rate_per_s": 200, "trace_seconds": 0.05}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """Skip the test where there is no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark measures the card only)")


def make_tiny_root(root: Path, compute_dtype: str = "float32") -> Path:
    """A checkout-shaped directory: ``BENCHMARK.json`` and the benchmark's data
    files, with the configs cut to 8 filters and 0.5 s and each mix to
    :data:`TINY_STORE`. In float32 the program and the reference agree to
    rounding, so the limits hold and a planted fault shows alone."""
    for d in DATA_DIRS:
        shutil.copytree(REPO / "portbench" / d, root / "portbench" / d)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        doc = json.loads((REPO / c["file"]).read_text())
        doc["encoder"].update(filters=8, compute_dtype=compute_dtype)
        doc["data"]["seconds"] = 0.5
        (root / c["file"]).write_text(json.dumps(doc))
    for name, changes in TINY_TRAFFIC.items():
        path = root / "portbench" / "traffic" / f"{name}.json"
        doc = json.loads(path.read_text())
        doc["store"].update(TINY_STORE)
        doc.update(changes)
        path.write_text(json.dumps(doc))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


def run_cell(root: Path, cell: str, *, trace: int = 0, variant: str = "", seed: int = 2**31 + 7,
             capsys=None) -> dict:
    """One run of ``cell`` on the CPU in this process → its result line."""
    from portbench import run

    argv = ["--workload", cell, "--seed", str(seed), "--seconds", "0.2", "--trace", str(trace)]
    if variant:
        argv += ["--variant", variant]
    assert run.main(argv, root=root, device="cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
