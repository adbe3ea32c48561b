"""On the card: each cell's control, the program's own int8 path, at the
cell's own size, has to come out as not correct (``python3 -m pytest
portbench/tests/test_portbench_card.py``, a few minutes)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from .conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_int8_control_is_not_correct(card, cell):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
                        str(2**31 + 101), "--seconds", "1", "--trace", "0", "--variant", "int8"],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert not res["correct"], res["checks"]
