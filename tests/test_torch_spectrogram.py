"""The port's log-mel 2D models (``models/spectrogram``) and their n-shot
path against the JAX package's, on the CPU.

Same flax variables (through ``from_flax``), same numpy inputs. Tolerances,
each with its reason:

- f32: 1e-4 relative to the largest magnitude (the two frameworks' convs
  and the B6 plain version against the rfft sum in other orders; 3e-7 seen);
- bf16: embedding row cosine ≥ 0.999 (the two frameworks round a bf16 conv
  and its bias add at other places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.eval import nshot as jnshot
from voicemap_tpu.models import spectrogram as jspec
from voicemap_tpu.ops import sampling as jsampling
from voicemap_tpu_torch.config import (
    DataConfig, EncoderConfig, ExperimentConfig, MelConfig,
)
from voicemap_tpu_torch.data.store import synthetic_store
from voicemap_tpu_torch.eval import nshot
from voicemap_tpu_torch.models import spectrogram as tspec
from voicemap_tpu_torch.models.convert import from_flax, to_flax
from voicemap_tpu_torch.train.steps import device_store_for
from test_torch_config import jax_config
from test_torch_encoder import randomize_bn

SR = 16000
MEL = MelConfig(hop_length=128, win_length=384, n_mels=32)  # config #4's frontend, 32 mels
B, T = 3, 5120  # 38 frames: the pools floor 19 → 9
F32_RTOL = 1e-4
BF16_MIN_COSINE = 0.999


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def waveform(seed, b=B, t=T):
    return (np.random.default_rng(seed).standard_normal((b, t, 1)) * 0.05).astype(np.float32)


def encoder_cfg(dtype):
    return EncoderConfig(filters=16, embedding_dim=16, compute_dtype=dtype)


def build_classifier(dtype, seed=0, num_classes=5):
    """Both packages' MelSpecClassifier over the same randomized variables."""
    cfg = encoder_cfg(dtype)
    jmodel = jspec.MelSpecClassifier(jax_config(cfg), jax_config(MEL), num_classes)
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(waveform(seed)))
    variables = randomize_bn(variables, seed + 1)
    model = tspec.MelSpecClassifier(cfg, MEL, num_classes, device="cpu")
    model.load_state_dict(from_flax(variables, cfg))
    return jmodel, variables, model


def test_frontend_matches_flax():
    x = waveform(1)
    want = np.asarray(jspec.MelFrontend(jax_config(MEL)).apply({}, jnp.asarray(x)))
    with torch.inference_mode():
        got = tspec.MelFrontend(MEL)(torch.from_numpy(x))
    assert got.shape == want.shape == (B, 38, 32, 1) and got.dtype == torch.float32
    assert rel(got, want) <= F32_RTOL


def test_standardization_uses_the_population_std():
    """(m − mean)/(std + 1e-5) with ddof 0, as ``jnp.std``: torch's default
    correction 1 would be off by sqrt(12/11) here, 4%."""
    m = np.random.default_rng(2).standard_normal((2, 3, 4)).astype(np.float32)
    mean = m.mean(axis=(1, 2), keepdims=True)
    want = (m - mean) / (m.std(axis=(1, 2), keepdims=True) + 1e-5)
    got = tspec.standardize(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_block_matches_flax(dtype):
    """One block on an odd image (15 × 9: both pools floor) against flax."""
    cfg = encoder_cfg(dtype)
    jblock = jspec.Conv2DBlock(features=12, pool=2, dropout=0.0,
                               compute_dtype=jnp.dtype(dtype), param_dtype=jnp.float32,
                               bn_momentum=0.99, bn_epsilon=cfg.bn_epsilon)
    x = np.random.default_rng(3).standard_normal((2, 15, 9, 5)).astype(np.float32)
    variables = jblock.init(jax.random.PRNGKey(3), jnp.asarray(x), train=False)
    v = randomize_bn({"params": {"block_0": variables["params"]},
                      "batch_stats": {"block_0": variables["batch_stats"]}}, 4)
    p, s = v["params"]["block_0"], v["batch_stats"]["block_0"]["bn"]
    want = np.asarray(jblock.apply({"params": p, "batch_stats": {"bn": s}},
                                   jnp.asarray(x), train=False), np.float32)
    block = tspec.Conv2DBlock(5, 12, 2, getattr(torch, dtype), torch.float32,
                              cfg.bn_epsilon, device="cpu")
    block.load_state_dict({
        "conv.weight": torch.from_numpy(p["conv"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "conv.bias": torch.from_numpy(p["conv"]["bias"]),
        "bn.weight": torch.from_numpy(p["bn"]["scale"]),
        "bn.bias": torch.from_numpy(p["bn"]["bias"]),
        "bn.running_mean": torch.from_numpy(s["mean"]),
        "bn.running_var": torch.from_numpy(s["var"]),
        "bn.num_batches_tracked": torch.tensor(0)})
    with torch.inference_mode():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()
    assert got.shape == want.shape == (2, 7, 4, 12)
    tol = F32_RTOL if dtype == "float32" else 2 ** -7  # bf16: one rounding of the output
    assert rel(got, want) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_and_classifier_match_flax(dtype):
    jmodel, variables, model = build_classifier(dtype, seed=5)
    x = waveform(6)
    want_emb = np.asarray(jmodel.apply(variables, jnp.asarray(x), method=jmodel.embed))
    want_logits = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.inference_mode():
        emb = model.embed(torch.from_numpy(x))
        logits = model(torch.from_numpy(x))
    assert emb.dtype == logits.dtype == torch.float32
    assert emb.shape == (B, 16) and logits.shape == (B, 5)
    if dtype == "float32":
        assert rel(emb, want_emb) <= F32_RTOL
        assert rel(logits, want_logits) <= F32_RTOL
    else:
        assert cosine(emb, want_emb).min() >= BF16_MIN_COSINE
        assert cosine(logits, want_logits).min() >= BF16_MIN_COSINE


def test_a_block_refuses_train_mode():
    """A block trains (batch statistics, dropout), but in train mode with
    dropout it refuses to run without the generator that draws the masks."""
    model = tspec.MelSpecEncoder(encoder_cfg("float32"), MEL, device="cpu").train()
    x = torch.from_numpy(waveform(7))
    with pytest.raises(ValueError, match="Generator"):
        model(x)
    emb = model(x, torch.Generator().manual_seed(0))
    assert emb.shape == (B, 16) and torch.isfinite(emb).all() and emb.requires_grad
    emb.sum().backward()
    assert all(p.grad is not None for p in model.parameters())


def test_fit_still_refuses_melspec2d():
    """``fit`` trains config #4; what it still refuses, before any work, is
    a ``dp`` it does not know. ``dp="on"`` in one process warns, as the JAX
    ``fit`` does, and trains unsharded."""
    from voicemap_tpu_torch.config import TrainConfig, melspec_2d
    from voicemap_tpu_torch.train.loop import fit

    store = synthetic_store(0, 3, 2, 0.35, 0.4)
    with pytest.raises(ValueError, match="dp must be"):
        fit(melspec_2d(), store, device="cpu", dp="sharded")
    cfg = melspec_2d(data=DataConfig(seconds=0.32, downsampling=1),
                     encoder=encoder_cfg("float32"), mel=MEL,
                     train=TrainConfig(batch_size=4, num_steps=1, num_eval_tasks=4, k_way=3))
    with pytest.warns(UserWarning, match="TRAINING store"):
        state, history = fit(cfg, store, device="cpu", verbose=False)
    assert isinstance(state.model, tspec.MelSpecClassifier) and len(history) == 1
    with pytest.warns(UserWarning, match="single attached device"):
        state, history = fit(cfg, store, device="cpu", verbose=False, dp="on")
    assert state.step == 1 and len(history) == 1


def test_from_flax_to_flax_round_trip_of_the_mel_tree():
    _, variables, model = build_classifier("float32", seed=8)
    back = to_flax(model.state_dict(), encoder_cfg("float32"))
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    assert len(leaves) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in leaves:
        node = back
        for key in path:
            node = node[key.key]
        assert node.shape == np.shape(leaf)
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert model.encoder.blocks[1].conv.weight.shape == (16, 8, 3, 3)


def test_models_are_built_on_the_card_unless_asked():
    import inspect

    for cls in (tspec.Conv2DBlock, tspec.MelSpecEncoder, tspec.MelSpecClassifier):
        assert inspect.signature(cls).parameters["device"].default == "cuda"


@pytest.fixture(scope="module")
def mel_eval():
    """A 5-speaker store at downsampling 1 and both packages' f32 mel
    classifiers over the same variables."""
    from voicemap_tpu.data.dataset import AudioStore as JaxAudioStore
    from voicemap_tpu.train import steps as jsteps
    from voicemap_tpu.train.state import init_state, make_optimizer

    cfg = ExperimentConfig(mode="melspec2d", data=DataConfig(seconds=0.32, downsampling=1),
                           encoder=encoder_cfg("float32"), mel=MEL)
    jcfg = jax_config(cfg)
    host = synthetic_store(10, n_speakers=5, utterances_per_speaker=3,
                           min_seconds=0.35, max_seconds=0.5)
    jmodel, variables, model = build_classifier("float32", seed=9)
    jstate = init_state(variables["params"], variables["batch_stats"], make_optimizer(), 1e-3)
    jstore = jsteps.device_store_for(jcfg, JaxAudioStore(**dataclasses.asdict(host)))
    return cfg, jcfg, model, jmodel, jstate, jstore, device_store_for(cfg, host, "cpu")


def test_embed_all_and_scores_in_melspec2d_mode_match_jax(mel_eval):
    """Chunked offset-0 tables agree at f32 (``fast`` is ignored, as in the
    JAX package), and the port's scoring of the tasks JAX drew gives the
    JAX accuracy."""
    cfg, jcfg, model, jmodel, jstate, jstore, store = mel_eval
    want = np.asarray(jnshot.embed_all(jmodel, jstate, jstore, jcfg, batch_size=4))
    for fast in (False, True):
        got = nshot.embed_all(model, store, cfg, batch_size=4, fast=fast)
        assert got.shape == (15, 16)
        assert rel(got, want) <= F32_RTOL
    key = jax.random.PRNGKey(11)
    utts, counts = np.asarray(jstore.speaker_utts), np.asarray(jstore.speaker_counts)
    tasks = jsampling.sample_nshot_tasks(key, jnp.asarray(utts), jnp.asarray(counts), 200, 1, 3)
    pred = nshot.classifier_nshot_predictions(got, torch.from_numpy(np.array(tasks.query_idx)),
                                              torch.from_numpy(np.array(tasks.support_idx)))
    jacc = float(jnshot.score_table(jnp.asarray(want), jstate, jstore, jcfg, key, 200, 1, 3))
    assert float((pred == 0).float().mean()) == pytest.approx(jacc, abs=1e-6)
    g = torch.Generator().manual_seed(0)
    acc = nshot.score_table(got, store, cfg, g, 100, 1, 3)
    assert 0.0 <= acc <= 1.0
    assert 0.0 <= nshot.evaluate(model, store, cfg, g, num_tasks=50, n=1, k=3,
                                 embed_batch=4) <= 1.0
