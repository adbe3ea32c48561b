"""The port's int8 serving of config #4 (``quant_infer``'s mel half) against
the JAX package's, on the CPU.

Same flax variables (through ``from_flax``), same numpy inputs, and the JAX
qvars through ``qvars_from_numpy``. Tolerances, each with its reason:

- the int8 conv2d: equal to XLA's s8×s8→s32 conv (both are exact);
- the port's calibration scales at f32: 1e-4 relative. B6's plain version
  is a DFT matmul where the JAX package takes an rfft (1e-6 apart on the
  image) and the convs sum in other orders; three f32 blocks carry that to
  1.5e-5 (seen over seeds 2, 3, 5), so 1e-6 does not hold. At bf16 within
  one bf16 ulp (2⁻⁷ relative): a scale is the max-abs of bf16 outputs, equal
  when the outputs round alike (3e-7 seen), one ulp apart when one rounds
  the other way;
- the fold, given the JAX scales: ``w_q`` equal, ``alpha``, ``beta``,
  ``gamma`` within 1e-6 relative (rsqrt may differ by an ulp);
- ``quant_embed_mel`` on the same qvars: row cosine ≥ 0.99999 at f32 and
  ≥ 0.9999 at bf16 (an image value on a rounding boundary of ``s0`` may land
  on the neighbouring int8 step; 1 − 1e-14 seen).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.eval import nshot as jnshot
from voicemap_tpu.models import quant_infer as jq
from voicemap_tpu.models.spectrogram import MelSpecClassifier as JaxMelClassifier
from voicemap_tpu.models.spectrogram import MelSpecEncoder as JaxMelEncoder
from voicemap_tpu_torch.config import (
    DataConfig, EncoderConfig, ExperimentConfig, MelConfig, classifier_baseline, melspec_2d,
)
from voicemap_tpu_torch.eval import nshot
from voicemap_tpu_torch.models import quant_infer as tq
from voicemap_tpu_torch.models.convert import from_flax, qvars_from_numpy
from voicemap_tpu_torch.models.spectrogram import MelSpecClassifier, MelSpecEncoder
from test_torch_config import jax_config
from test_torch_encoder import randomize_bn
from test_torch_quant_infer import cosine, to_numpy

SR = 16000
MEL = MelConfig(hop_length=128, win_length=384, n_mels=32)
B, T = 4, 5120
F32_MIN_COSINE = 0.99999
BF16_MIN_COSINE = 0.9999


def build(dtype, seed=0):
    """Both packages' mel encoders over the same random variables, and an input."""
    cfg = EncoderConfig(filters=16, embedding_dim=16, compute_dtype=dtype)
    jcfg, jmel = jax_config(cfg), jax_config(MEL)
    x = (np.random.default_rng(seed).standard_normal((B, T, 1)) * 0.1).astype(np.float32)
    jmodel = JaxMelEncoder(jcfg, jmel)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed + 1)
    model = MelSpecEncoder(cfg, MEL, device="cpu")
    model.load_state_dict(from_flax(variables, cfg))
    return cfg, jcfg, jmel, variables, model, x


@pytest.mark.parametrize("cin,cout,hw", [(1, 8, (13, 7)), (5, 16, (6, 9)), (24, 32, (4, 4))])
def test_int8_conv2d_equals_xlas_exact_conv(cin, cout, hw):
    rng = np.random.default_rng(cin)
    x = rng.integers(-127, 128, (2, *hw, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    got = tq.quant_conv2d(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_pool_and_block_equal_the_jax_block():
    rng = np.random.default_rng(3)
    x = rng.integers(-127, 128, (2, 9, 7, 8)).astype(np.int8)
    q = {"w_q": rng.integers(-127, 128, (3, 3, 8, 16)).astype(np.int8),
         "alpha": (rng.standard_normal(16) * 2e-3).astype(np.float32),
         "beta": (rng.standard_normal(16) * 3e3).astype(np.float32),
         "gamma": (rng.standard_normal(16) * 5).astype(np.float32)}
    tqblk = {k: torch.from_numpy(v) for k, v in q.items()}
    for last, dt, jdt in ((False, torch.int8, jnp.int8), (True, torch.float32, jnp.float32)):
        want = np.asarray(jq._quant_block2d(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                                             q.items()}, 2, last=last,
                                            out_dtype=jdt))
        got = tq.quant_block2d(torch.from_numpy(x), tqblk, 2, last=last, out_dtype=dt)
        assert got.dtype == dt and got.shape == want.shape == (2, 4, 3, 16)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calibrated_scales_match_jax(dtype):
    cfg, jcfg, jmel, variables, model, x = build(dtype, seed=2)
    want = jq._calib_sweep_mel(variables["params"], variables["batch_stats"], jnp.asarray(x),
                               cfg=jcfg, mel_cfg=jmel, sample_rate=SR, headroom=1.0)
    got = tq.calibrate_mel_scales(model, torch.from_numpy(x))
    assert len(got) == len(want) == 4 and got[0].dim() == 0
    for i, (g, w) in enumerate(zip(got, want)):
        rtol = 1e-4 if dtype == "float32" else 2 ** -7
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_of_the_jax_scales_equals_jax(dtype):
    cfg, jcfg, jmel, variables, model, x = build(dtype)
    scales = jq._calib_sweep_mel(variables["params"], variables["batch_stats"], jnp.asarray(x),
                                 cfg=jcfg, mel_cfg=jmel, sample_rate=SR, headroom=1.0)
    want = to_numpy(jq.quantize_mel_encoder(variables, jcfg, jmel, jnp.asarray(x), SR))
    got = tq.fold_mel_scales(model, [torch.tensor(np.asarray(s)) for s in scales])
    assert got["kind"] == want["kind"] == "mel"
    np.testing.assert_array_equal(got["s0"].numpy(), want["s0"])
    assert len(got["blocks"]) == len(want["blocks"]) == 4
    for g, w in zip(got["blocks"], want["blocks"]):
        assert g["w_q"].dtype == torch.int8 and g["w_q"].shape == w["w_q"].shape
        np.testing.assert_array_equal(g["w_q"].numpy(), w["w_q"])
        for k in ("alpha", "beta", "gamma"):
            np.testing.assert_allclose(g[k].numpy(), w[k], rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype,min_cos", [("float32", F32_MIN_COSINE),
                                           ("bfloat16", BF16_MIN_COSINE)])
def test_quant_embed_mel_matches_jax(dtype, min_cos):
    cfg, jcfg, jmel, variables, model, x = build(dtype, seed=4)
    jqvars = jq.quantize_mel_encoder(variables, jcfg, jmel, jnp.asarray(x), SR)
    want = np.asarray(jq.quant_embed_mel(variables, jqvars, jcfg, jmel, jnp.asarray(x), SR))
    qvars = qvars_from_numpy(to_numpy(jqvars), "cpu")
    got = tq.quant_embed_mel(model, qvars, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (B, 16)
    assert cosine(got.numpy(), want).min() >= min_cos
    assert torch.equal(tq.quant_embed(model, qvars, torch.from_numpy(x)), got)
    # the port's own calibration serves as well against the float path
    own = tq.quant_embed_mel(model, tq.quantize_mel_encoder(model, torch.from_numpy(x)),
                             torch.from_numpy(x))
    with torch.inference_mode():
        ref = model(torch.from_numpy(x))
    assert cosine(own.numpy(), ref.numpy()).min() > 0.99


def test_npz_artifacts_load_across_packages(tmp_path):
    cfg, jcfg, jmel, variables, model, x = build("bfloat16", seed=6)
    jqvars = jq.quantize_mel_encoder(variables, jcfg, jmel, jnp.asarray(x), SR)
    jq.save_qvars(str(tmp_path / "jax.npz"), jqvars)
    got = tq.load_qvars(str(tmp_path / "jax.npz"), device="cpu")
    tqvars = tq.quantize_mel_encoder(model, torch.from_numpy(x))
    tq.save_qvars(str(tmp_path / "port.npz"), tqvars)
    back = to_numpy(jq.load_qvars(str(tmp_path / "port.npz")))
    for loaded, saved in ((got, to_numpy(jqvars)), (back, tqvars)):
        assert loaded["kind"] == "mel" and np.asarray(loaded["s0"]).shape == ()
        np.testing.assert_array_equal(np.asarray(loaded["s0"]), np.asarray(saved["s0"]))
        assert len(loaded["blocks"]) == len(saved["blocks"]) == 4
        for lb, sb in zip(loaded["blocks"], saved["blocks"]):
            for k in ("w_q", "alpha", "beta", "gamma"):
                assert np.asarray(lb[k]).dtype == np.asarray(sb[k]).dtype
                np.testing.assert_array_equal(np.asarray(lb[k]), np.asarray(sb[k]))
    assert got["blocks"][0]["w_q"].shape == (3, 3, 1, 8)
    # an artifact of either package serves the same embedding
    np.testing.assert_array_equal(
        tq.quant_embed_mel(model, got, torch.from_numpy(x)).numpy(),
        tq.quant_embed_mel(model, qvars_from_numpy(to_numpy(jqvars), "cpu"),
                           torch.from_numpy(x)).numpy())


def test_artifact_kinds_and_modes_refuse_each_other():
    cfg, _, _, _, model, x = build("float32", seed=8)
    mel_q = tq.quantize_mel_encoder(model, torch.from_numpy(x))
    wave_q = dict(mel_q)
    del wave_q["kind"]
    with pytest.raises(ValueError):
        tq.quant_embed_mel(model, wave_q, torch.from_numpy(x))  # a wave artifact
    with pytest.raises(ValueError):
        tq.quant_embed(model, wave_q, torch.from_numpy(x))  # on the mel encoder
    for mode_cfg, q in ((melspec_2d(), wave_q), (classifier_baseline(), mel_q)):
        with pytest.raises(ValueError, match="artifact kind"):
            nshot.embed_all(None, None, mode_cfg, qvars=q)


@pytest.fixture(scope="module")
def mel_int8_eval():
    """A 5-speaker store at downsampling 1, both packages' f32 mel
    classifiers and JAX's qvars calibrated on the first 8 rows."""
    from voicemap_tpu.data.dataset import AudioStore as JaxAudioStore
    from voicemap_tpu.train import steps as jsteps
    from voicemap_tpu.train.state import init_state, make_optimizer
    from voicemap_tpu_torch.data.store import synthetic_store
    from voicemap_tpu_torch.train.steps import device_store_for

    ecfg = EncoderConfig(filters=16, embedding_dim=16, compute_dtype="float32")
    cfg = ExperimentConfig(mode="melspec2d", data=DataConfig(seconds=0.32, downsampling=1),
                           encoder=ecfg, mel=MEL)
    jcfg = jax_config(cfg)
    host = synthetic_store(12, n_speakers=5, utterances_per_speaker=3,
                           min_seconds=0.35, max_seconds=0.5)
    x0 = np.zeros((1, T, 1), np.float32)
    jmodel = JaxMelClassifier(jcfg.encoder, jcfg.mel, 5)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(12), jnp.asarray(x0)), 13)
    jstate = init_state(variables["params"], variables["batch_stats"], make_optimizer(), 1e-3)
    jstore = jsteps.device_store_for(jcfg, JaxAudioStore(**dataclasses.asdict(host)))
    model = MelSpecClassifier(ecfg, MEL, 5, device="cpu")
    model.load_state_dict(from_flax(variables, ecfg))
    store = device_store_for(cfg, host, "cpu")
    jqvars = jq.quantize_from_store(jstate, jcfg, jstore, n_cal=8)
    return cfg, jcfg, model, store, jmodel, jstate, jstore, jqvars


def test_quantize_from_store_and_embed_all_with_qvars_match_jax(mel_int8_eval):
    cfg, jcfg, model, store, jmodel, jstate, jstore, jqvars = mel_int8_eval
    own = tq.quantize_from_store(model, cfg, store, n_cal=8)  # the same 8 rows as JAX's
    assert own["kind"] == "mel"
    np.testing.assert_allclose(own["s0"].numpy(), np.asarray(jqvars["s0"]), rtol=1e-5, atol=0)
    qvars = qvars_from_numpy(to_numpy(jqvars), "cpu")
    want = np.asarray(jnshot.embed_all(jmodel, jstate, jstore, jcfg, batch_size=4,
                                       qvars=jqvars))
    got = nshot.embed_all(model, store, cfg, batch_size=4, qvars=qvars)
    assert got.shape == (15, 16)
    assert cosine(got.numpy(), want).min() >= F32_MIN_COSINE
    g = torch.Generator().manual_seed(0)
    acc = nshot.evaluate(model, store, cfg, g, num_tasks=50, n=1, k=3, qvars=own,
                         embed_batch=4)
    assert 0.0 <= acc <= 1.0


def test_stage_profile_splits_reproduce_both_mel_paths():
    """``utils/stage_profile`` times config #4 stage by stage; run end to
    end, its stages give exactly the encoder forward and ``quant_embed_mel``,
    so its stage times are those paths' times."""
    from voicemap_tpu_torch.utils import stage_profile as sp

    _, _, _, _, model, x = build("bfloat16", seed=10)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        qvars = tq.quantize_mel_encoder(model, xt)
        assert torch.equal(sp.run(sp.stages_mel_bf16(model, lambda: xt)), model(xt))
        assert torch.equal(sp.run(sp.stages_mel_int8(model, qvars, lambda: xt)),
                           tq.quant_embed_mel(model, qvars, xt))
