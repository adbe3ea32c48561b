"""Config #3 (``dilated_4khz``) served by the port against the JAX package, on
the CPU, at filters 8 with config #3's eight blocks, kernels, pools and
dilations.

Same flax variables (through ``from_flax``) and the same numpy inputs; the
kernels run as their plain versions (B2, then B3 × 7 in int8 and B8 × 7 in
bf16, every block 1–7 on its kernel's route). Tolerances, each with its
reason (those of ``tests/test_torch_quant_infer.py`` and
``tests/test_quant_infer.py``):

- calibration: the port's scales within 1e-5 relative of the JAX package's
  at f32;
- the fold of the JAX scales: ``w_q`` equal, ``alpha`` and ``beta`` within
  1e-6 relative (rsqrt may differ by an ulp); ``gamma = (β − μ·mul) / s_out``
  within 1e-6 relative plus the few f32 ulps of ``|β| + |μ·mul|`` over
  ``s_out`` that the cancellation in ``β − μ·mul`` leaves of them (seen at
  1.7e-6 relative over seven blocks);
- ``quant_embed`` on the JAX qvars against the JAX ``quant_embed``
  (interpret mode, XLA's int8 ``_quant_block`` for the dilated blocks): row
  cosine ≥ 0.99999 at f32 and ≥ 0.9999 at bf16 (block 0's f32 sum order
  differs, so an int8 activation can land on the neighbouring step);
- the int8 embeddings against the f32 float model: min cosine > 0.995, the
  JAX package's own bound for its dilated config;
- ``fast_embed`` at f32 within 1e-4 and at bf16 by row cosine ≥ 0.999
  against the JAX ``fast_embed`` (the two round bf16 at other places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_config import jax_config
from test_torch_encoder import randomize_bn
from test_torch_quant_infer import BF16_MIN_COSINE, F32_MIN_COSINE, cosine, to_numpy
from voicemap_tpu.models import quant_infer as jq
from voicemap_tpu.models.encoder import ConvEncoder as JaxEncoder
from voicemap_tpu.models.fast_infer import fast_embed as jax_fast_embed
from voicemap_tpu_torch.config import dilated_4khz
from voicemap_tpu_torch.models import fast_infer
from voicemap_tpu_torch.models import quant_infer as tq
from voicemap_tpu_torch.models.convert import from_flax, qvars_from_numpy
from voicemap_tpu_torch.models.encoder import ConvEncoder
from voicemap_tpu_torch.ops import cuda_conv, cuda_quant_block

B, T = 5, 1024
FLOAT_MIN_COSINE = 0.995


def build(dtype, seed=0):
    """Both packages' config #3 encoders at filters 8 over the same random
    variables, and an input."""
    cfg = dataclasses.replace(dilated_4khz().encoder, filters=8, embedding_dim=16,
                              compute_dtype=dtype)
    jcfg = jax_config(cfg)
    x = (np.random.default_rng(seed).standard_normal((B, T, 1)) * 0.05).astype(np.float32)
    jmodel = JaxEncoder(jcfg)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed + 1)
    model = ConvEncoder(cfg, device="cpu")
    model.load_state_dict(from_flax(variables, cfg))
    return cfg, jcfg, variables, model, x


def test_config_3_is_seven_dilated_and_pool_1_blocks():
    cfg = dilated_4khz().encoder
    assert cfg.kernel_sizes[1:] == (3,) * 7
    assert cfg.pool_sizes[1:] == (1, 2, 1, 2, 1, 2, 1)
    assert cfg.dilations[1:] == (2, 1, 4, 1, 8, 1, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calibration_and_fold_match_jax(dtype):
    cfg, jcfg, variables, model, x = build(dtype, seed=2)
    want = jq.calibrate_scales(variables, jcfg, jnp.asarray(x))
    got = tq.calibrate_scales(model, torch.from_numpy(x))
    assert len(got) == len(want) == 7
    if dtype == "float32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=0)
    scales = [torch.tensor(np.asarray(s)) for s in want]
    folded = tq.fold_scales(model, scales)
    jfold = to_numpy(jq.quantize_encoder(variables, jcfg, jnp.asarray(x)))
    assert len(folded["blocks"]) == len(jfold["blocks"]) == 7
    for i, (g, w) in enumerate(zip(folded["blocks"], jfold["blocks"]), start=1):
        np.testing.assert_array_equal(g["w_q"].numpy(), w["w_q"])
        for k in ("alpha", "beta"):
            np.testing.assert_allclose(g[k].numpy(), w[k], rtol=1e-6, atol=0)
        bn = model.blocks[i].bn
        mul = (torch.rsqrt(bn.running_var + bn.eps) * bn.weight).detach()
        s_out = scales[i].float() if i < 7 else torch.ones(())
        cancel = (4 * 2.0 ** -24 * (bn.bias.abs() + (bn.running_mean * mul).abs()) / s_out)
        diff = np.abs(g["gamma"].numpy() - w["gamma"])
        assert (diff <= 1e-6 * np.abs(w["gamma"]) + cancel.detach().numpy()).all()


@pytest.mark.parametrize("dtype,min_cos", [("float32", F32_MIN_COSINE),
                                           ("bfloat16", BF16_MIN_COSINE)])
def test_quant_embed_matches_jax_through_b3(monkeypatch, dtype, min_cos):
    """The JAX qvars served by the port, every block 1-7 through B3 (at its
    pool and dilation), against the JAX package's route (Pallas block 0 in
    interpret mode, XLA's int8 conv for blocks 1-7)."""
    cfg, jcfg, variables, model, x = build(dtype, seed=4)
    jqvars = jq.quantize_encoder(variables, jcfg, jnp.asarray(x))
    want = np.asarray(jq.quant_embed(variables, jqvars, jcfg, jnp.asarray(x), interpret=True))
    calls = []

    def counted(h, *a, **kw):
        calls.append((tuple(h.shape), kw["pool"], kw["dilation"]))
        return cuda_quant_block.quant_block(h, *a, **kw)

    monkeypatch.setattr(tq, "quant_block", counted)
    got = tq.quant_embed(model, qvars_from_numpy(to_numpy(jqvars), "cpu"), torch.from_numpy(x))
    assert [c[1:] for c in calls] == list(zip(cfg.pool_sizes[1:], cfg.dilations[1:]))
    assert [c[0][1] for c in calls] == [256, 256, 128, 128, 64, 64, 32]
    assert got.dtype == torch.float32 and got.shape == want.shape == (B, 16)
    assert cosine(got.numpy(), want).min() >= min_cos


def test_quant_embed_is_close_to_the_float_model():
    """The port's own calibration at f32 against the float encoder: the JAX
    package's bound for its dilated config."""
    cfg, _, _, model, x = build("float32", seed=6)
    xt = torch.from_numpy(x)
    qvars = tq.quantize_encoder(model, xt)
    out = tq.quant_embed(model, qvars, xt)
    with torch.inference_mode():
        ref = model(xt)
    assert cosine(out.numpy(), ref.numpy()).min() > FLOAT_MIN_COSINE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fast_embed_matches_jax_with_every_bf16_block_on_b8(monkeypatch, dtype):
    """bf16: blocks 1-7 each through B8 at their pool and dilation, channels
    last from B2 to the head; f32: the module's own forward."""
    cfg, jcfg, variables, model, x = build(dtype, seed=8)
    calls = []

    def counted(h, *a, **kw):
        calls.append((tuple(h.shape), a[7], kw["dilation"]))
        return cuda_conv.conv_blockn(h, *a, **kw)

    monkeypatch.setattr(fast_infer, "conv_blockn", counted)
    with torch.inference_mode():
        got = fast_infer.fast_embed(model, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_fast_embed(variables, jcfg, jnp.asarray(x)))
    if dtype == "float32":
        assert calls == []
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert [c[1:] for c in calls] == list(zip(cfg.pool_sizes[1:], cfg.dilations[1:]))
        assert all(takes for takes in map(fast_infer.takes_blockn, model.blocks[1:]))
        assert cosine(got, want).min() >= 0.999


def test_the_stage_profile_of_config_3_reproduces_both_paths():
    """``utils/stage_profile --config dilated_4khz`` times these stages; run
    end to end they give exactly ``fast_embed`` and ``quant_embed``."""
    from voicemap_tpu_torch.utils import stage_profile as sp

    _, _, _, model, x = build("bfloat16", seed=10)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        qvars = tq.quantize_encoder(model, xt)
        bf16 = sp.stages_bf16(model, lambda: xt)
        int8 = sp.stages_int8(model, qvars, lambda: xt)
        assert [n for n, _ in int8][2:-1] == [f"quant_block_{i}" for i in range(1, 8)]
        assert torch.equal(sp.run(bf16), fast_infer.fast_embed(model, xt))
        assert torch.equal(sp.run(int8), tq.quant_embed(model, qvars, xt))
    assert "dilated_4khz" in sp.CONFIGS
