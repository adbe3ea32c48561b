"""The port's pooled-GEMM encoder forward against the JAX package's, on the CPU.

``voicemap_tpu_torch/models/fused_encoder.py`` against
``voicemap_tpu/models/fused_encoder.py`` on the same numpy inputs and flax
variables: one block at the JAX test's four ``(k, pool, dilation, Cin)``
cases, the whole encoder of a small config #1 and a small ``dilated_4khz``
(config #3: pools 1 and 4, dilations up to 16), and the encoder against
``ConvEncoder``'s own forward. Tolerances: f32 1e-5 between the two pooled
GEMMs (the same f32 products and sums in another order), 1e-4 against the
unfused forward (the JAX test's bound), bf16 row cosine ≥ 0.999 (the two
frameworks round bf16 at other places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.models.encoder import ConvEncoder as JaxEncoder
from voicemap_tpu.models.fused_encoder import fused_block_apply as jax_block
from voicemap_tpu.models.fused_encoder import fused_encoder_apply as jax_encoder
from test_torch_config import jax_config
from test_torch_encoder import randomize_bn
from voicemap_tpu_torch.config import EncoderConfig, dilated_4khz
from voicemap_tpu_torch.models.convert import from_flax
from voicemap_tpu_torch.models.encoder import ConvEncoder
from voicemap_tpu_torch.models.fused_encoder import (
    _pool_frame_indices, _stack_weights, fused_block_apply, fused_encoder_apply,
)

PAIR_TOL = 1e-5
UNFUSED_TOL = 1e-4
BF16_MIN_COSINE = 0.999


@pytest.mark.parametrize("k,pool,dil,cin", [(32, 4, 1, 1), (3, 2, 1, 8), (3, 1, 4, 8),
                                            (5, 2, 2, 4)])
def test_fused_block_matches_jax(k, pool, dil, cin):
    rng = np.random.default_rng(0)
    B, T, C = 2, 256, 16
    x = rng.standard_normal((B, T, cin)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    scale[::2] *= -1.0
    params = [(rng.standard_normal((k, cin, C)) * 0.2).astype(np.float32),
              (rng.standard_normal(C) * 0.1).astype(np.float32), scale,
              (rng.standard_normal(C) * 0.1).astype(np.float32),
              (rng.standard_normal(C) * 0.1).astype(np.float32),
              rng.uniform(0.5, 2.0, C).astype(np.float32)]
    want = np.asarray(jax_block(jnp.asarray(x), *map(jnp.asarray, params), 1e-3, pool=pool,
                                dilation=dil, compute_dtype=jnp.float32))
    got = fused_block_apply(torch.from_numpy(x), *map(torch.from_numpy, params), 1e-3,
                            pool=pool, dilation=dil, compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (B, T // pool, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=PAIR_TOL, atol=PAIR_TOL)


def test_stacked_weights_and_frames_match_jax():
    from voicemap_tpu.models import fused_encoder as jfe

    w = np.random.default_rng(1).standard_normal((3, 2, 4)).astype(np.float32)
    for pool, dil in ((2, 1), (4, 2), (1, 16)):
        np.testing.assert_array_equal(_stack_weights(torch.from_numpy(w), pool, dil).numpy(),
                                      np.asarray(jfe._stack_weights(jnp.asarray(w), pool, dil)))
    np.testing.assert_array_equal(_pool_frame_indices(5, 4, 2).numpy(),
                                  jfe._pool_frame_indices(5, 4, 2))


def test_fused_block_refuses_a_ragged_t():
    x = torch.zeros(1, 9, 2)
    with pytest.raises(ValueError, match="divisible"):
        fused_block_apply(x, torch.zeros(3, 2, 4), *(torch.ones(4),) * 5, 1e-3, pool=2)


def encoders(cfg, T, seed):
    """The port's encoder and the flax variables it was converted from, and x."""
    x = (np.random.default_rng(seed).standard_normal((2, T, 1)) * 0.05).astype(np.float32)
    jmodel = JaxEncoder(jax_config(cfg))
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                                         train=False), seed + 1)
    model = ConvEncoder(cfg, device="cpu")
    model.load_state_dict(from_flax(variables, cfg))
    return model, variables, x


def small_configs(dtype):
    return {"classifier": EncoderConfig(filters=8, embedding_dim=16, dropout=0.0,
                                        compute_dtype=dtype),
            "dilated": dataclasses.replace(dilated_4khz().encoder, filters=4,
                                           compute_dtype=dtype)}


@pytest.mark.parametrize("name", ["classifier", "dilated"])
def test_fused_encoder_matches_jax_and_the_unfused_forward_at_f32(name):
    cfg = small_configs("float32")[name]
    model, variables, x = encoders(cfg, 1024, 2)
    got = fused_encoder_apply(model, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, cfg.embedding_dim)
    want = np.asarray(jax_encoder(variables, jax_config(cfg), jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=PAIR_TOL, atol=PAIR_TOL)
    with torch.inference_mode():
        unfused = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got.numpy(), unfused, rtol=UNFUSED_TOL, atol=UNFUSED_TOL)


@pytest.mark.parametrize("name", ["classifier", "dilated"])
def test_fused_encoder_matches_jax_at_bf16(name):
    cfg = small_configs("bfloat16")[name]
    model, variables, x = encoders(cfg, 1024, 3)
    got = fused_encoder_apply(model, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_encoder(variables, jax_config(cfg), jnp.asarray(x)))
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= BF16_MIN_COSINE, cos


def test_fused_encoder_refuses_a_t_the_pools_do_not_divide():
    model, _, _ = encoders(small_configs("float32")["classifier"], 64, 4)
    with pytest.raises(ValueError, match="divisible"):
        fused_encoder_apply(model, torch.zeros(1, 1001, 1))
