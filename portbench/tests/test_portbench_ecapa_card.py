"""On the card: each control of the ECAPA-TDNN cell (``controls_ecapa``:
float8 e4m3 activations, the SE gate left out, Res2Net's hierarchical add
left out), planted in this process before a run of the cell at its own
size, has to come out as not correct (``python3 -m pytest -m card
portbench/tests/test_portbench_ecapa_card.py``, a few minutes)."""

from __future__ import annotations

import json

import pytest

from portbench import controls_ecapa, run

from .conftest import REPO


@pytest.mark.card
@pytest.mark.parametrize("control", controls_ecapa.CONTROLS)
def test_control_is_not_correct(card, capsys, control):
    undo = controls_ecapa.plant(control)
    try:
        assert run.main(["--workload", "ecapa_tdnn.embed_bulk_16k", "--seed", str(2**31 + 211),
                         "--seconds", "1", "--trace", "0"], root=REPO) == 0
    finally:
        undo()
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not res["correct"], res["checks"]
