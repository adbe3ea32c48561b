"""The port's int8 serving path against the JAX package's, on the CPU.

Same flax variables (through ``from_flax``), same numpy inputs, and the JAX
qvars through ``qvars_from_numpy``; the kernels run as their plain versions.
Tolerances, each with its reason:

- the fold, given the JAX calibration scales: ``w_q`` equal, ``alpha``,
  ``beta``, ``gamma`` within 1e-6 relative (rsqrt may differ by an ulp);
- the port's own scales: within 1e-5 relative at f32. At bf16 the scale of
  block i's output within (i + 1)·2⁻⁶ relative: the two frameworks round a
  bf16 block's output at other places (2 bf16 ulps are 2⁻⁶), and each
  block's differences carry into the next block's input (0.026 seen at
  block 2);
- ``quant_embed`` end to end against ``quant_embed(interpret=True)``: row
  cosine ≥ 0.99999 at f32 and ≥ 0.9999 at bf16 (block 0's f32 sum order
  differs, so an int8 activation can land on the neighbouring step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.eval import nshot as jnshot
from voicemap_tpu.models import quant_infer as jq
from voicemap_tpu.models.encoder import ConvEncoder as JaxEncoder
from voicemap_tpu.ops import sampling as jsampling
from voicemap_tpu_torch.config import EncoderConfig
from voicemap_tpu_torch.eval import nshot
from voicemap_tpu_torch.models import quant_infer as tq
from voicemap_tpu_torch.models.convert import from_flax, qvars_from_numpy
from voicemap_tpu_torch.models.encoder import ConvEncoder
from test_torch_config import jax_config
from test_torch_encoder import randomize_bn

B, T = 5, 512
F32_MIN_COSINE = 0.99999
BF16_MIN_COSINE = 0.9999


def cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def build(dtype, seed=0):
    """Both packages' encoders over the same random variables, and an input."""
    cfg = EncoderConfig(filters=8, embedding_dim=16, compute_dtype=dtype)
    jcfg = jax_config(cfg)
    x = (np.random.default_rng(seed).standard_normal((B, T, 1)) * 0.04).astype(np.float32)
    jmodel = JaxEncoder(jcfg)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed + 1)
    model = ConvEncoder(cfg, device="cpu")
    model.load_state_dict(from_flax(variables, cfg))
    return cfg, jcfg, variables, model, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_of_the_jax_scales_equals_jax(dtype):
    cfg, jcfg, variables, model, x = build(dtype)
    scales = jq.calibrate_scales(variables, jcfg, jnp.asarray(x))
    want = to_numpy(jq.quantize_encoder(variables, jcfg, jnp.asarray(x)))
    got = tq.fold_scales(model, [torch.tensor(np.asarray(s)) for s in scales])
    np.testing.assert_array_equal(got["s0"].numpy(), want["s0"])
    assert len(got["blocks"]) == len(want["blocks"]) == 3
    for g, w in zip(got["blocks"], want["blocks"]):
        assert g["w_q"].dtype == torch.int8 and g["w_q"].shape == w["w_q"].shape
        np.testing.assert_array_equal(g["w_q"].numpy(), w["w_q"])
        for k in ("alpha", "beta", "gamma"):
            np.testing.assert_allclose(g[k].numpy(), w[k], rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calibrated_scales_match_jax(dtype):
    cfg, jcfg, variables, model, x = build(dtype, seed=2)
    want = jq.calibrate_scales(variables, jcfg, jnp.asarray(x))
    got = tq.calibrate_scales(model, torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        rtol = 1e-5 if dtype == "float32" else (i + 1) * 2 ** -6
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype,min_cos", [("float32", F32_MIN_COSINE),
                                           ("bfloat16", BF16_MIN_COSINE)])
def test_quant_embed_matches_jax(dtype, min_cos):
    """The JAX qvars served by the port (B2 with requant, then B3 for blocks
    1–3) against the JAX package's kernel route (Pallas block 0 in interpret
    mode, XLA int8 blocks)."""
    cfg, jcfg, variables, model, x = build(dtype, seed=4)
    jqvars = jq.quantize_encoder(variables, jcfg, jnp.asarray(x))
    want = np.asarray(jq.quant_embed(variables, jqvars, jcfg, jnp.asarray(x), interpret=True))
    got = tq.quant_embed(model, qvars_from_numpy(to_numpy(jqvars), "cpu"), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (B, 16)
    assert cosine(got.numpy(), want).min() >= min_cos
    # and the port's own calibration serves as well against the bf16 path
    own = tq.quant_embed(model, tq.quantize_encoder(model, torch.from_numpy(x)),
                         torch.from_numpy(x))
    with torch.inference_mode():
        ref = model(torch.from_numpy(x))
    assert cosine(own.numpy(), ref.numpy()).min() > 0.99


def test_npz_artifacts_load_across_packages(tmp_path):
    cfg, jcfg, variables, model, x = build("bfloat16", seed=6)
    jqvars = jq.quantize_encoder(variables, jcfg, jnp.asarray(x))
    jq.save_qvars(str(tmp_path / "jax.npz"), jqvars)
    got = tq.load_qvars(str(tmp_path / "jax.npz"), device="cpu")
    tqvars = tq.quantize_encoder(model, torch.from_numpy(x))
    tq.save_qvars(str(tmp_path / "port.npz"), tqvars)
    back = to_numpy(jq.load_qvars(str(tmp_path / "port.npz")))
    for loaded, saved in ((got, to_numpy(jqvars)), (back, tqvars)):
        assert "kind" not in loaded
        np.testing.assert_array_equal(np.asarray(loaded["s0"]), np.asarray(saved["s0"]))
        assert len(loaded["blocks"]) == len(saved["blocks"]) == 3
        for lb, sb in zip(loaded["blocks"], saved["blocks"]):
            for k in ("w_q", "alpha", "beta", "gamma"):
                assert np.asarray(lb[k]).dtype == np.asarray(sb[k]).dtype
                np.testing.assert_array_equal(np.asarray(lb[k]), np.asarray(sb[k]))
    assert got["blocks"][0]["w_q"].dtype == torch.int8


def test_policy_and_mode_checks_match_jax():
    for b in (1, 7, 8, 2048):
        assert tq.int8_worthwhile(b) == (b >= tq.INT8_MIN_BATCH)
        # config #4's int8 path wins at no measured batch on the H100
        assert not tq.int8_worthwhile(b, "melspec2d")
    from voicemap_tpu_torch.config import classifier_baseline, melspec_2d

    for cfg in (classifier_baseline(), melspec_2d(), classifier_baseline(mode="bogus")):
        for q in ({"kind": "mel"}, {}):
            outcomes = []
            for check, c in ((tq.check_qvars_mode, cfg), (jq.check_qvars_mode, jax_config(cfg))):
                try:
                    check(c, q)
                    outcomes.append(None)
                except ValueError as e:
                    outcomes.append(str(e))
            assert outcomes[0] == outcomes[1]


def test_quant_embed_refuses_what_it_does_not_port():
    cfg, _, _, model, x = build("float32", seed=8)
    qvars = tq.quantize_encoder(model, torch.from_numpy(x))
    # a mel artifact serves the mel encoder only (tests/test_torch_quant_mel.py)
    with pytest.raises(ValueError, match="MelSpecEncoder"):
        tq.quant_embed(model, dict(qvars, kind="mel"), torch.from_numpy(x))
    # B3 is a k=3 kernel: a k=5 block 1+ stays unported (config #3's dilated
    # and pool-1 blocks serve: tests/test_torch_dilated_serving.py)
    wide = EncoderConfig(filters=8, embedding_dim=16, compute_dtype="float32",
                         kernel_sizes=(32, 3, 5, 3))
    wmodel = ConvEncoder(wide, device="cpu")
    with pytest.raises(NotImplementedError, match="k=5"):
        tq.quant_embed(wmodel, tq.quantize_encoder(wmodel, torch.from_numpy(x)),
                       torch.from_numpy(x))


@pytest.fixture(scope="module")
def int8_eval():
    """The small n-shot setting of test_torch_nshot with both packages' qvars
    calibrated on the same store rows."""
    import dataclasses

    from voicemap_tpu.data.dataset import AudioStore as JaxAudioStore
    from voicemap_tpu.models.classifier import SpeakerClassifier as JaxClassifier
    from voicemap_tpu.train import steps as jsteps
    from voicemap_tpu.train.state import init_state, make_optimizer
    from voicemap_tpu_torch.config import DataConfig, ExperimentConfig
    from voicemap_tpu_torch.data.store import synthetic_store
    from voicemap_tpu_torch.models.classifier import SpeakerClassifier
    from voicemap_tpu_torch.train.steps import device_store_for

    cfg = ExperimentConfig(
        data=DataConfig(seconds=0.25, downsampling=4),
        encoder=EncoderConfig(filters=8, embedding_dim=16, compute_dtype="float32"))
    jcfg = jax_config(cfg)
    host = synthetic_store(9, n_speakers=5, utterances_per_speaker=3,
                           min_seconds=0.3, max_seconds=0.5)
    jmodel = JaxClassifier(jcfg.encoder, num_classes=5)
    variables = jmodel.init(jax.random.PRNGKey(2), jnp.zeros((1, cfg.data.model_length, 1)))
    variables = randomize_bn(variables, 3)
    jstate = init_state(variables["params"], variables["batch_stats"], make_optimizer(), 1e-3)
    jstore = jsteps.device_store_for(jcfg, JaxAudioStore(**dataclasses.asdict(host)))
    model = SpeakerClassifier(cfg.encoder, num_classes=5, device="cpu")
    model.load_state_dict(from_flax(variables, cfg.encoder))
    store = device_store_for(cfg, host, "cpu")
    jqvars = jq.quantize_from_store(jstate, jcfg, jstore, n_cal=8)
    qvars = qvars_from_numpy(to_numpy(jqvars), "cpu")
    return cfg, jcfg, model, store, jmodel, jstate, jstore, jqvars, qvars


def test_embed_all_and_scores_with_qvars_match_jax(int8_eval):
    """int8 tables of both packages (same qvars) agree by row cosine at f32,
    and the port's scoring of the tasks JAX drew gives the JAX accuracy."""
    cfg, jcfg, model, store, jmodel, jstate, jstore, jqvars, qvars = int8_eval
    want = np.asarray(jnshot.embed_all(jmodel, jstate, jstore, jcfg, batch_size=4,
                                       qvars=jqvars))
    got = nshot.embed_all(model, store, cfg, batch_size=4, qvars=qvars)
    assert got.shape == (15, 16)
    assert cosine(got.numpy(), want).min() >= F32_MIN_COSINE
    key = jax.random.PRNGKey(5)
    utts, counts = np.asarray(jstore.speaker_utts), np.asarray(jstore.speaker_counts)
    tasks = jsampling.sample_nshot_tasks(key, jnp.asarray(utts), jnp.asarray(counts), 200, 1, 3)
    pred = nshot.classifier_nshot_predictions(got, torch.from_numpy(np.array(tasks.query_idx)),
                                              torch.from_numpy(np.array(tasks.support_idx)))
    jacc = float(jnshot.classifier_nshot_accuracy(jnp.asarray(want), jnp.asarray(utts),
                                                  jnp.asarray(counts), key, 200, 1, 3))
    assert float((pred == 0).float().mean()) == pytest.approx(jacc, abs=1e-6)


def test_evaluate_with_qvars(int8_eval):
    cfg, jcfg, model, store, *_, qvars = int8_eval
    g = torch.Generator().manual_seed(0)
    acc = nshot.evaluate(model, store, cfg, g, num_tasks=50, n=1, k=3, qvars=qvars,
                         embed_batch=4)
    assert 0.0 <= acc <= 1.0
    own = tq.quantize_from_store(model, cfg, store, n_cal=8)  # the same 8 rows as JAX's
    np.testing.assert_allclose(own["s0"].numpy(), qvars["s0"].numpy(), rtol=1e-5, atol=0)
    with pytest.raises(ValueError):
        nshot.evaluate(model, store, cfg, g, num_tasks=5, n=1, k=3,
                       qvars=dict(qvars, kind="mel"))


def test_stage_profile_splits_reproduce_both_paths():
    """``utils/stage_profile`` times the bf16 and int8 paths stage by stage;
    run end to end, its stages give exactly ``fast_embed`` and
    ``quant_embed``, so its stage times are those paths' times."""
    from voicemap_tpu_torch.models.fast_infer import fast_embed
    from voicemap_tpu_torch.utils import stage_profile as sp

    _, _, _, model, x = build("bfloat16", seed=10)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        qvars = tq.quantize_encoder(model, xt)
        bf16 = sp.run(sp.stages_bf16(model, lambda: xt))
        int8 = sp.run(sp.stages_int8(model, qvars, lambda: xt))
        assert torch.equal(bf16, fast_embed(model, xt))
        assert torch.equal(int8, tq.quant_embed(model, qvars, xt))
