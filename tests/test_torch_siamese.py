"""The port's ``SiameseNet`` against flax's, on the CPU.

From the same flax variables (BatchNorm randomised, head bias non-zero),
converted with ``from_flax``: the eval forward, ``embed``, ``score_pairs``
and ``score_support`` for each of the five metrics at f32 within 1e-5; the
bf16 forward by cosine; the siamese tree through ``from_flax`` → ``to_flax``
unchanged; the head in f32 whatever the compute dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_config import jax_config
from test_torch_encoder import randomize_bn
from voicemap_tpu.models.siamese import SiameseNet as JaxSiamese
from voicemap_tpu_torch.config import EncoderConfig, SiameseConfig
from voicemap_tpu_torch.models.convert import from_flax, to_flax
from voicemap_tpu_torch.models.siamese import SiameseNet
from voicemap_tpu_torch.ops.distance import SIAMESE_METRICS, merge_features

B, T, D = 4, 256, 16
F32_TOL = 1e-5
BF16_MIN_COSINE = 0.99  # bf16 convs round at other places in the two frameworks


def encoder_cfg(dtype="float32"):
    return EncoderConfig(filters=8, embedding_dim=D, dropout=0.0, compute_dtype=dtype)


def build(metric, dtype="float32", seed=0, same_label=0):
    """Both packages' nets on one flax variable tree."""
    cfg, sia = encoder_cfg(dtype), SiameseConfig(distance_metric=metric, same_label=same_label)
    jmodel = JaxSiamese(jax_config(cfg), jax_config(sia))
    x = jnp.zeros((1, T, 1), jnp.float32)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(seed), x, x), seed + 1)
    variables["params"]["head"]["bias"] = np.array([0.3125], np.float32)
    model = SiameseNet(cfg, sia, device="cpu")
    model.load_state_dict(from_flax(variables, cfg))
    return jmodel, variables, model


def pair(seed):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((B, T, 1)) * 0.5).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("metric", SIAMESE_METRICS)
def test_forward_embed_and_scores_match_flax_at_f32(metric):
    jmodel, variables, model = build(metric, seed=1)
    x1, x2 = pair(2)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x1), jnp.asarray(x2)))
    got = model(torch.from_numpy(x1), torch.from_numpy(x2))
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=F32_TOL, atol=F32_TOL)

    e_want = np.asarray(jmodel.apply(variables, jnp.asarray(x1), method=jmodel.embed))
    e1 = model.embed(torch.from_numpy(x1))
    np.testing.assert_allclose(e1.detach().numpy(), e_want, rtol=F32_TOL, atol=F32_TOL)

    rng = np.random.default_rng(3)
    q = rng.standard_normal((5, D)).astype(np.float32)
    s = rng.standard_normal((7, D)).astype(np.float32)
    want_pairs = jmodel.apply(variables, jnp.asarray(q), jnp.asarray(s[:5]),
                              method=jmodel.score_pairs)
    got_pairs = model.score_pairs(torch.from_numpy(q), torch.from_numpy(s[:5]))
    np.testing.assert_allclose(got_pairs.detach().numpy(), np.asarray(want_pairs),
                               rtol=F32_TOL, atol=F32_TOL)
    want_support = jmodel.apply(variables, jnp.asarray(q), jnp.asarray(s),
                                method=jmodel.score_support)
    got_support = model.score_support(torch.from_numpy(q), torch.from_numpy(s))
    assert got_support.shape == (5, 7) and got_support.dtype == torch.float32
    np.testing.assert_allclose(got_support.numpy(), np.asarray(want_support),
                               rtol=F32_TOL, atol=F32_TOL)


def test_forward_at_bf16_agrees_by_cosine():
    """bf16 convs round at other places in the two frameworks: the
    embeddings are held to a cosine of 0.99 each, the logits (the f32 head
    over |e1 − e2|) to 2e-2 of their largest magnitude."""
    jmodel, variables, model = build("weighted_l1", "bfloat16", seed=4)
    x1, x2 = pair(5)
    e_want = np.asarray(jmodel.apply(variables, jnp.asarray(x1), method=jmodel.embed))
    e_got = model.embed(torch.from_numpy(x1)).detach().numpy()
    cos = (e_got * e_want).sum(-1) / (np.linalg.norm(e_got, axis=-1)
                                      * np.linalg.norm(e_want, axis=-1))
    assert cos.min() >= BF16_MIN_COSINE, cos
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x1), jnp.asarray(x2)))
    got = model(torch.from_numpy(x1), torch.from_numpy(x2)).detach().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("metric", ["weighted_l1", "uniform_euclidean"])
def test_from_flax_to_flax_round_trip_of_the_siamese_tree(metric):
    _, variables, model = build(metric, seed=6)
    back = to_flax(model.state_dict(), encoder_cfg())
    width = D if metric == "weighted_l1" else 1
    assert back["params"]["head"]["kernel"].shape == (width, 1)
    assert model.head.weight.shape == (1, width)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p)
                                                         for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=jax.tree_util.keystr(path))


def test_the_head_runs_in_f32_under_a_bf16_encoder():
    """The siamese head is flax's Dense(1, dtype=float32), not the
    classifier's compute-dtype head: its logits are the f32 product."""
    _, _, model = build("weighted_l1", "bfloat16", seed=7)
    rng = np.random.default_rng(8)
    e1, e2 = (torch.from_numpy(rng.standard_normal((6, D)).astype(np.float32))
              for _ in range(2))
    got = model.score_pairs(e1, e2)
    feats = merge_features(e1, e2, "weighted_l1")
    want = feats @ model.head.weight[0] + model.head.bias[0]
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    in_bf16 = (feats.bfloat16() @ model.head.weight[0].bfloat16()).float() + model.head.bias[0]
    assert not torch.equal(got, in_bf16)


def test_an_unknown_metric_is_refused():
    with pytest.raises(ValueError):
        SiameseNet(encoder_cfg(), SiameseConfig(distance_metric="manhattan"), device="cpu")
