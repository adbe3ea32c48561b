"""step_attrib.py rehearsed on the CPU at a tiny size.

On the CPU every train wrapper is its plain version, so each variant must
reproduce the reference step exactly and its probes must find nothing; what
the kernels change is only seen on the card. ``flip_ulps`` is pinned
directly.
"""

import pytest
import torch

import step_attrib
from voicemap_tpu_torch.config import DataConfig, EncoderConfig, ExperimentConfig
from voicemap_tpu_torch.train import steps


@pytest.fixture
def tiny(monkeypatch):
    small = ExperimentConfig(data=DataConfig(seconds=0.128, downsampling=4),
                             encoder=EncoderConfig(filters=32, embedding_dim=16))
    cs = step_attrib.cs
    for name, value in (("DEVICE", "cpu"), ("TRAIN_BATCH", 4),
                        ("classifier_baseline", lambda: small)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(step_attrib, "STORE", dict(n_speakers=5, utterances_per_speaker=3,
                                                   min_seconds=0.3, max_seconds=0.5))
    # The policies as they resolve on the card: B4/B5 and the fused blocks-1+ op
    # (its int8 forward for quant_forward="int8").
    monkeypatch.setattr(steps, "resolve_fused_block0", lambda cfg, model: True)
    monkeypatch.setattr(steps, "resolve_blockn", lambda cfg, device: (
        "fused_int8" if cfg.train.quant_forward == "int8" else "fused"))


def test_every_variant_reproduces_the_plain_step_on_the_cpu(tiny):
    variants_reproduce_the_plain_step(records=list(step_attrib.attribute(seed=3)))


def test_every_variant_reproduces_the_plain_int8_step_on_the_cpu(tiny):
    """``--quant-forward int8 --dtype float32``: the int8 forward's step,
    B3's train epilogue among the wrappers put back."""
    records = list(step_attrib.attribute(seed=3, quant_forward="int8", dtype="float32"))
    assert {(r["quant_forward"], r["dtype"]) for r in records} == {("int8", "float32")}
    variants_reproduce_the_plain_step(records)


def variants_reproduce_the_plain_step(records):
    assert [r["variant"] for r in records] == list(step_attrib.VARIANTS)
    for r in records:
        assert r["loss"] == r["loss_plain"], r["variant"]
        assert len(r["cosines"]) == 20
        assert min(r["cosines"].values()) > 1 - 1e-12, r["variant"]
    by = {r["variant"]: r["probe"] for r in records}
    assert by["plain"] == {} and by["b7"] == {} and by["b3_train"] == {}
    for variant in ("all", "b4", "b4_a_sel", "b4_stats", "a_sel_flips"):
        p = by[variant]
        assert p["a_sel_differ"] == 0 and p["a_sel_max_ulps"] == 0, variant
        # batch 4, filters 32, 2048 samples / downsampling 4 / pool 4
        assert p["a_sel_elements"] == 4 * 32 * (2048 // 4 // 4), variant
        assert p["relu_flips"] == 0 and p["sum_a_rel"] == 0 and p["sum_a2_rel"] == 0
        assert len(p["bias0_top_channels"]) == 5 and p["mean_sq_over_var_median"] >= 1
        for c in p["bias0_top_channels"]:
            assert c["err_share"] == 0
            assert c["mean_sq_over_var"] is None or c["mean_sq_over_var"] >= 1
    for variant in ("all", "b5", "b5_dw", "b5_db"):
        assert by[variant]["dw_rel"] == 0 and by[variant]["db_rel"] == 0, variant


def test_stand_ins_carry_the_wrappers_counters():
    # A wrapper counts on its module's name, which the stand-in then holds.
    use = step_attrib.wrappers(step_attrib.ALL, {}, seed=0)
    for mod, name, _ in step_attrib.cs.PLAIN:
        assert vars(use[name]) == vars(getattr(mod, name)), name


@pytest.mark.parametrize("n", [0, 1, 17, 200])
def test_flip_ulps_moves_n_nonzero_elements_by_one_ulp(n):
    g = torch.Generator().manual_seed(n)
    a = torch.relu(torch.randn(4, 50, 3, generator=g)).to(torch.bfloat16)
    out = step_attrib.flip_ulps(a, n, seed=7)
    assert out.shape == a.shape and out.dtype == torch.bfloat16
    moved = out != a
    assert int(moved.sum()) == n
    assert bool((a[moved] != 0).all())
    assert bool((out[a == 0] == 0).all())
    ulps = (out.view(torch.int16).int() - a.view(torch.int16).int()).abs()
    assert int(ulps.max()) == (1 if n else 0)
    assert torch.equal(step_attrib.flip_ulps(a, n, seed=7), out)


def test_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert step_attrib.main([]) == 1
