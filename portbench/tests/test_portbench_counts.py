"""``counts.py`` against the numbers it was frozen from: the FLOPs an
utterance, and ``chip_smoke.py``'s bounds at the shapes it times."""

from __future__ import annotations

import json

import pytest

import chip_smoke
from portbench import counts

from .conftest import REPO

CONFIG1 = json.loads((REPO / "portbench/configs/classifier_baseline.json").read_text())
CONFIG3 = json.loads((REPO / "portbench/configs/dilated_4khz.json").read_text())
B = 2048


def test_flops_an_utterance():
    assert counts.embed_flops(CONFIG1) / 1e9 == pytest.approx(2.458, abs=5e-4)
    assert counts.embed_flops(CONFIG3) / 1e9 == pytest.approx(4.596, abs=5e-4)
    # 3 × 2.4576 − 0.0983 = 7.2745; 7.276 is the same sum of rounded terms
    assert counts.train_flops(CONFIG1) / 1e9 == pytest.approx(7.276, abs=2e-3)
    per_block = [counts.conv_flops(b) / 1e9 for b in counts.blocks(CONFIG1)]
    assert per_block == pytest.approx([0.098, 0.590, 0.885, 0.885], abs=5e-4)


def test_peaks_are_chip_smokes():
    for name in ("HBM_BYTES_PER_S", "BF16_OPS_PER_S", "INT8_OPS_PER_S", "TF32_OPS_PER_S",
                 "F32_OPS_PER_S"):
        assert getattr(counts, name) == getattr(chip_smoke, name)


def test_block_bounds_are_chip_smokes():
    # chip_smoke.run_timing's conv_block0 bound
    frag, c = chip_smoke.FRAG, 128
    want = chip_smoke.bound(B * frag * 4 + B * (frag // 4) * c * 2, 2.0 * B * frag * c * 32,
                            chip_smoke.BF16_OPS_PER_S)["bound_ms"]
    assert counts.block0_bound_s(CONFIG1, B) * 1e3 == pytest.approx(want)
    for config, total_ms in ((CONFIG1, 4.89), (CONFIG3, 9.64)):  # PERF.md's B8 bound rows
        got = sum(counts.blockn_bound_s(b, B) for b in counts.blocks(config)[1:]) * 1e3
        assert got == pytest.approx(total_ms, abs=0.01)
    for blk, (cb, tb) in zip(counts.blocks(CONFIG1)[1:], chip_smoke.TRAIN_BLOCKS):
        full, half = B * cb * tb, B * cb * (tb // 2)
        fwd = chip_smoke.bound(full * 2 + half * 2 + 4 * cb * 4, 8.0 * full,
                               chip_smoke.F32_OPS_PER_S)["bound_ms"]
        bwd = chip_smoke.bound(full * 2 + half * 2 + half * 4 + full * 2 + 5 * cb * 4,
                               12.0 * full, chip_smoke.F32_OPS_PER_S)["bound_ms"]
        assert counts.routing_bound_s(blk, B) * 1e3 == pytest.approx(fwd + bwd)
    total = sum(counts.routing_bound_s(b, B) for b in counts.blocks(CONFIG1)[1:]) * 1e3
    assert total == pytest.approx(3.17 + 7.40, abs=0.02)  # PERF.md's B7 bound rows
