"""The port's encoder, classifier and fast_embed against the JAX package's.

Same flax variables (converted with ``from_flax``) and same numpy inputs go
through ``ConvEncoder.apply`` / ``fast_embed`` in JAX and through the port on
the CPU, where block 0 of ``fast_embed`` is the B2 kernel's plain version.
f32 compute must agree within 1e-4; bf16 rounds at other places in the two
frameworks, so there each row's cosine must be ≥ 0.999.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.models.classifier import SpeakerClassifier as JaxClassifier
from voicemap_tpu.models.encoder import ConvEncoder as JaxEncoder
from voicemap_tpu.models.fast_infer import fast_embed as jax_fast_embed
from test_torch_config import jax_config
from voicemap_tpu_torch.config import EncoderConfig, classifier_baseline
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.models.convert import from_flax
from voicemap_tpu_torch.models.encoder import ConvEncoder
from voicemap_tpu_torch.models.fast_infer import fast_embed

B, T = 5, 256
F32_TOL = 1e-4
BF16_MIN_COSINE = 0.999


def to_numpy(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def randomize_bn(variables, seed):
    """Flax init leaves BN at scale 1, mean 0, var 1; give every BN tensor
    seeded values (half the scales negative) so the mapping is tested."""
    rng = np.random.default_rng(seed)
    v = to_numpy(variables)
    params = v["params"].get("encoder", v["params"])
    stats = v["batch_stats"].get("encoder", v["batch_stats"])
    for name, blk in params.items():
        if not name.startswith("block_"):
            continue
        c = blk["bn"]["scale"].shape[0]
        scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
        scale[::2] *= -1.0
        blk["bn"]["scale"] = scale
        blk["bn"]["bias"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
        blk["conv"]["bias"] = (rng.standard_normal(c) * 0.05).astype(np.float32)
        stats[name]["bn"]["mean"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
        stats[name]["bn"]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return v


def inputs(seed):
    return (np.random.default_rng(seed).standard_normal((B, T, 1)) * 0.04).astype(np.float32)


def cfg_for(dtype):
    return EncoderConfig(filters=8, embedding_dim=16, compute_dtype=dtype)


def assert_rows_agree(got, want, dtype):
    assert got.shape == want.shape and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
        assert cos.min() >= BF16_MIN_COSINE, cos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_and_fast_embed_match_jax(dtype):
    cfg = cfg_for(dtype)
    x = inputs(0)
    jmodel = JaxEncoder(jax_config(cfg))
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    model = ConvEncoder(cfg, device="cpu")
    model.load_state_dict(from_flax(variables, cfg))
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        got = model(xt).numpy()
        got_fast = fast_embed(model, xt).numpy()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    want_fast = np.asarray(jax_fast_embed(variables, jax_config(cfg), jnp.asarray(x)))
    assert_rows_agree(got, want, dtype)
    assert_rows_agree(got_fast, want_fast, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_classifier_tree_converts(dtype):
    """The classifier's tree (encoder + head) loads strictly; logits and
    embed() match the flax classifier."""
    cfg = cfg_for(dtype)
    x = inputs(2)
    jmodel = JaxClassifier(jax_config(cfg), num_classes=7)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x)), 4)
    model = SpeakerClassifier(cfg, num_classes=7, device="cpu")
    model.load_state_dict(from_flax(variables, cfg))  # strict: every key mapped
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        logits, emb = model(xt).numpy(), model.embed(xt).numpy()
    assert_rows_agree(logits, np.asarray(jmodel.apply(variables, jnp.asarray(x))), dtype)
    assert_rows_agree(emb, np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                                   method=jmodel.embed)), dtype)


def test_convert_layouts():
    cfg = cfg_for("float32")
    jmodel = JaxEncoder(jax_config(cfg))
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(5), jnp.zeros((1, 64, 1))), 6)
    sd = from_flax(variables, cfg)
    p, s = variables["params"], variables["batch_stats"]
    np.testing.assert_array_equal(sd["blocks.1.conv.weight"].numpy(),
                                  p["block_1"]["conv"]["kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(sd["embed.weight"].numpy(), p["embed"]["kernel"].T)
    np.testing.assert_array_equal(sd["blocks.2.bn.running_var"].numpy(),
                                  s["block_2"]["bn"]["var"])
    model = ConvEncoder(cfg, device="cpu")
    model.load_state_dict(sd)
    assert model.blocks[0].bn.eps == cfg.bn_epsilon == 1e-3  # not torch's 1e-5


def test_train_mode_refuses_to_run():
    model = ConvEncoder(cfg_for("float32"), device="cpu").train()
    with pytest.raises(NotImplementedError):
        model(torch.zeros(1, 64, 1))


def test_smoke_tree_has_flax_shapes():
    """chip_smoke.py's seeded flax-layout tree has the shapes of a flax
    SpeakerClassifier at full config #1 width, so from_flax takes it."""
    import chip_smoke

    cfg = classifier_baseline().encoder
    jmodel = JaxClassifier(jax_config(cfg), num_classes=40)
    want = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 12000, 1)))
    got = chip_smoke.random_flax_variables(cfg, 40, seed=0)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shapes(to_numpy(got)) == shapes(dict(want))
    model = SpeakerClassifier(cfg, num_classes=40, device="cpu")
    model.load_state_dict(from_flax(got, cfg))


@pytest.mark.parametrize("k,pool,dilation", [(3, 2, 1), (3, 2, 2), (32, 4, 1)])
def test_conv_block_matches_jax_at_f32(k, pool, dilation):
    """One ConvBlock in the JAX layout (B, T, Cin) against flax's, including a
    dilated block (config #3) and the even k=32 SAME padding."""
    from voicemap_tpu.models.encoder import ConvBlock as JaxBlock
    from voicemap_tpu_torch.models.encoder import ConvBlock

    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 66, 4)).astype(np.float32)
    jblock = JaxBlock(features=6, kernel_size=k, pool_size=pool, dropout=0.0,
                      dilation=dilation, compute_dtype=jnp.float32)
    init = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    v = randomize_bn({"params": {"block_0": init["params"]},
                      "batch_stats": {"block_0": init["batch_stats"]}}, 8)
    p, s = v["params"]["block_0"], v["batch_stats"]["block_0"]["bn"]
    want = np.asarray(jblock.apply({"params": p, "batch_stats": {"bn": s}}, jnp.asarray(x),
                                   train=False))
    block = ConvBlock(4, 6, k, pool, dilation, torch.float32, device="cpu")
    block.load_state_dict({
        "conv.weight": torch.tensor(p["conv"]["kernel"].transpose(2, 1, 0)),
        "conv.bias": torch.tensor(p["conv"]["bias"]),
        "bn.weight": torch.tensor(p["bn"]["scale"]), "bn.bias": torch.tensor(p["bn"]["bias"]),
        "bn.running_mean": torch.tensor(s["mean"]), "bn.running_var": torch.tensor(s["var"]),
        "bn.num_batches_tracked": torch.tensor(0)})
    with torch.inference_mode():
        got = block(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, 66 // pool, 6)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
