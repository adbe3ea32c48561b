"""Config #4's training (``melspec_2d``): the port's train-mode 2D blocks, one
``MelSpecClassifier`` step, ``init_model`` and ``fit`` against the JAX
package's, on the CPU.

Same flax variables (through ``from_flax``), same numpy inputs. Tolerances,
each with its reason:

- f32 block and step: 1e-4 relative (the two frameworks' convs and
  reductions sum in other orders; the log-mel plain version against the rfft
  route);
- bf16 block: the output within one bf16 rounding of its largest value
  (2⁻⁷, as the eval-mode block's test), the batch statistics within 1e-2
  (they are f32 sums of a bf16 conv output that the two frameworks round at
  other places), the running statistics likewise;
- dropout: the JAX key stream cannot be replayed, so dropout is tested by its
  invariants and the steps run at dropout 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_config import jax_config
from test_torch_encoder import randomize_bn
from test_torch_spectrogram import MEL, rel, waveform
from test_torch_train_forward import assert_tree_close
from voicemap_tpu.models import spectrogram as jspec
from voicemap_tpu.train import loop as jloop
from voicemap_tpu.train import steps as jsteps
from voicemap_tpu_torch.config import (
    DataConfig, EncoderConfig, ExperimentConfig, TrainConfig,
)
from voicemap_tpu_torch.data.store import synthetic_store
from voicemap_tpu_torch.models import spectrogram as tspec
from voicemap_tpu_torch.models.convert import from_flax, to_flax
from voicemap_tpu_torch.models.encoder import spatial_dropout
from voicemap_tpu_torch.train import steps
from voicemap_tpu_torch.train.loop import fit, init_model
from voicemap_tpu_torch.train.state import init_state

F32_RTOL = 1e-4
BF16_OUT_TOL = 2 ** -7
BF16_STATS_TOL = 1e-2
CLASSES = 5


def block_pair(dtype, seed, cin=5, features=12, momentum=0.99):
    """flax's Conv2DBlock and the port's over the same randomized variables."""
    jblock = jspec.Conv2DBlock(features=features, pool=2, dropout=0.0,
                               compute_dtype=jnp.dtype(dtype), param_dtype=jnp.float32,
                               bn_momentum=momentum, bn_epsilon=1e-3)
    x = np.random.default_rng(seed).standard_normal((3, 15, 9, cin)).astype(np.float32)
    variables = jblock.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    v = randomize_bn({"params": {"block_0": variables["params"]},
                      "batch_stats": {"block_0": variables["batch_stats"]}}, seed + 1)
    p, s = v["params"]["block_0"], v["batch_stats"]["block_0"]["bn"]
    block = tspec.Conv2DBlock(cin, features, 2, getattr(torch, dtype), torch.float32, 1e-3,
                              device="cpu", bn_momentum=momentum)
    block.load_state_dict({
        "conv.weight": torch.from_numpy(p["conv"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "conv.bias": torch.from_numpy(p["conv"]["bias"]),
        "bn.weight": torch.from_numpy(p["bn"]["scale"]),
        "bn.bias": torch.from_numpy(p["bn"]["bias"]),
        "bn.running_mean": torch.from_numpy(s["mean"]),
        "bn.running_var": torch.from_numpy(s["var"]),
        "bn.num_batches_tracked": torch.tensor(0)})
    return jblock, {"params": p, "batch_stats": {"bn": s}}, block, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_block_trains_as_flax(dtype):
    """The train-mode output on the batch statistics (biased variance over
    B, F, M) and flax's running-statistics update (0.99 of the old kept)."""
    jblock, variables, block, x = block_pair(dtype, 11)
    want, mut = jblock.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    block.train()
    got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()
    assert got.shape == want.shape == (3, 7, 4, 12)
    assert got.dtype == torch.float32 and block.training
    out_tol, stats_tol = ((F32_RTOL, F32_RTOL) if dtype == "float32"
                          else (BF16_OUT_TOL, BF16_STATS_TOL))
    assert rel(got.detach(), np.asarray(want, np.float32)) <= out_tol
    new = mut["batch_stats"]["bn"]
    np.testing.assert_allclose(block.bn.running_mean.numpy(), np.asarray(new["mean"]),
                               rtol=stats_tol, atol=stats_tol * 1e-2)
    np.testing.assert_allclose(block.bn.running_var.numpy(), np.asarray(new["var"]),
                               rtol=stats_tol, atol=stats_tol * 1e-2)


def test_the_running_statistics_keep_the_momentum_and_the_biased_variance():
    """With momentum m the running mean becomes m·old + (1 − m)·E[a] and the
    running variance m·old + (1 − m)·Var_biased[a], a = relu(conv(x)), over
    (B, F, M); torch's BatchNorm2d (1 − m kept, unbiased) would miss both."""
    _, _, block, x = block_pair("float32", 12, momentum=0.9)
    old_mean, old_var = block.bn.running_mean.clone(), block.bn.running_var.clone()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        a = torch.relu(torch.nn.functional.conv2d(xt, block.conv.weight, block.conv.bias,
                                                  padding=1)).double()
    block.train()(xt)
    mean = a.mean((0, 2, 3))
    var = a.var((0, 2, 3), correction=0)
    np.testing.assert_allclose(block.bn.running_mean.numpy(),
                               (0.9 * old_mean.double() + 0.1 * mean).numpy(), rtol=1e-5)
    np.testing.assert_allclose(block.bn.running_var.numpy(),
                               (0.9 * old_var.double() + 0.1 * var).numpy(), rtol=1e-5)


def test_spatial_dropout_drops_whole_channels_over_both_image_axes():
    """One keep/drop draw a (row, channel) of NCHW, broadcast over F and M;
    survivors × 1/(1 − p) in the tensor's dtype; the drop rate near p over
    many draws; the identity in eval mode."""
    p = 0.25
    y = torch.rand(64, 32, 5, 7, dtype=torch.bfloat16) + 0.5
    gen = torch.Generator().manual_seed(3)
    out = spatial_dropout(y, p, gen)
    assert out.dtype == torch.bfloat16 and out.shape == y.shape
    dropped = out == 0
    per_channel = dropped.flatten(2)
    assert bool((per_channel.all(-1) | ~per_channel.any(-1)).all())  # whole channels
    kept = ~dropped[:, :, 0, 0]
    torch.testing.assert_close(out[kept], (y / (1 - p))[kept], rtol=0, atol=0)
    rate = float(dropped[:, :, 0, 0].float().mean())
    assert abs(rate - p) < 0.03  # 2048 draws: the standard error is 0.0096
    block = tspec.Conv2DBlock(32, 8, 2, torch.float32, device="cpu", dropout=0.5)
    with torch.inference_mode():
        a = block(y.float())
        b = block(y.float())
    torch.testing.assert_close(a, b)  # eval: no draw, no generator needed
    block.train()
    with pytest.raises(ValueError, match="Generator"):
        block(y.float())
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    torch.testing.assert_close(block(y.float(), g1), block(y.float(), g2))


def mel_experiment(dtype="float32", **train):
    enc = EncoderConfig(filters=16, embedding_dim=16, dropout=0.0, compute_dtype=dtype)
    return ExperimentConfig(mode="melspec2d", data=DataConfig(seconds=0.32, downsampling=1),
                            encoder=enc, mel=MEL, train=TrainConfig(batch_size=4, **train))


def test_one_melspec_step_matches_jax_at_f32():
    """``classifier_loss_fn`` + ``train_on_batch`` against the JAX step
    (``classifier_loss_fn`` through flax apply): the loss, every gradient leaf
    (the clip off) and the batch statistics."""
    cfg = mel_experiment(clipnorm=1e3)
    jcfg = jax_config(cfg)
    jmodel = jspec.MelSpecClassifier(jcfg.encoder, jcfg.mel, CLASSES)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(21), jnp.asarray(waveform(21))), 21)
    model = tspec.MelSpecClassifier(cfg.encoder, MEL, CLASSES, device="cpu")
    model.load_state_dict(from_flax(variables, cfg.encoder))
    x = waveform(22, b=4)
    y = np.random.default_rng(23).integers(0, CLASSES, 4).astype(np.int32)
    loss_fn = jsteps.classifier_loss_fn(jmodel, jcfg)
    (jl, (new_bs, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"], variables["batch_stats"], jnp.asarray(x), jnp.asarray(y),
        jax.random.PRNGKey(0))
    state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
    port_loss = steps.classifier_loss_fn(model, cfg)
    assert (port_loss.fused_block0, port_loss.blockn) == (False, "conv2d")
    state, m = steps.train_on_batch(state, torch.from_numpy(x), torch.from_numpy(y), None,
                                    port_loss)
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=F32_RTOL)
    got = to_flax({n: p.grad for n, p in model.named_parameters()}, cfg.encoder)["params"]
    assert_tree_close(got, grads, F32_RTOL)
    stats = to_flax(model.state_dict(), cfg.encoder)["batch_stats"]
    assert_tree_close(stats, new_bs, F32_RTOL)


def test_init_model_builds_the_mel_classifier_as_flax_inits_it():
    """Shapes of every leaf equal flax's; conv and Dense kernels truncated
    lecun-normal (fan-in 9·Cin for a 3×3 conv): std within 10% of flax's
    draw, nothing past two standard deviations; biases 0, BN at 1, 0, 0, 1."""
    cfg = mel_experiment()
    model = init_model(cfg, CLASSES, "cpu", 0)
    assert isinstance(model, tspec.MelSpecClassifier)
    jmodel = jloop.build_model(jax_config(cfg), CLASSES)
    jst = jloop.init_model_state(jmodel, jax_config(cfg))
    tree = to_flax(model.state_dict(), cfg.encoder)
    for path, want in jax.tree_util.tree_leaves_with_path(
            {"params": jst.params, "batch_stats": jst.batch_stats}):
        node = tree
        for k in path:
            node = node[k.key]
        want = np.asarray(want)
        assert node.shape == want.shape, path
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(want.shape[:-1]))
            std = fan_in ** -0.5
            assert abs(node.std() / want.std() - 1) < 0.1 if want.size > 400 else True, name
            assert np.abs(node).max() <= 2 * std / 0.87962566103423978 + 1e-6, name
        else:
            np.testing.assert_array_equal(node, want, err_msg=name)


def test_fit_trains_melspec2d(tmp_path):
    """``fit`` on a tiny mel config: losses fall and every record carries the
    n-shot accuracy of the evaluation."""
    cfg = ExperimentConfig(
        mode="melspec2d", data=DataConfig(seconds=0.32, downsampling=1),
        encoder=EncoderConfig(filters=16, embedding_dim=16, dropout=0.05), mel=MEL,
        train=TrainConfig(batch_size=16, num_steps=12, evaluate_every=6, num_eval_tasks=40,
                          learning_rate=3e-3, log_path=str(tmp_path / "m.jsonl")))
    store = synthetic_store(4, n_speakers=5, utterances_per_speaker=4, min_seconds=0.4,
                            max_seconds=0.6)
    losses = []
    with pytest.warns(UserWarning, match="TRAINING store"):
        state, history = fit(cfg, store, device="cpu", verbose=False,
                             on_step=lambda i, m: losses.append(float(m["loss"])))
    assert isinstance(state.model, tspec.MelSpecClassifier) and state.step == 12
    assert [r["step"] for r in history] == [6, 12]
    assert all("val_1-shot_acc" in r and 0.0 <= r["val_1-shot_acc"] <= 1.0 for r in history)
    assert np.isfinite(losses).all() and np.mean(losses[-3:]) < np.mean(losses[:3])
