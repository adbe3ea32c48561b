"""The siamese training port against the JAX package's, on the CPU.

``siamese_train_forward`` and ``siamese_embed_train_forward`` under each
policy (the module's own train forward, autograd blocks, the B4/B5 block-0
op, the B7 blocks-1+ op; the kernels' plain versions on the CPU) against the
JAX package's ``fused_train`` (``impl="xla"``) at f32 with dropout 0: logits
or embeddings, and the running statistics, within 1e-5. One BCE step and
one contrastive step from the same flax variables and the same pairs
against ``value_and_grad(siamese_loss_fn) + apply_updates``: the loss within
1e-5, the clipped gradients and the parameters after the step within 1e-4.
Then the policy, ``init_model``, and ``fit`` in siamese mode with its
checkpoint and resume.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_config import jax_config
from test_torch_encoder import randomize_bn
from test_torch_train_forward import assert_tree_close
from voicemap_tpu.models import fused_train as jfused
from voicemap_tpu.models.siamese import SiameseNet as JaxSiamese
from voicemap_tpu.train import state as jstate
from voicemap_tpu.train import steps as jsteps
from voicemap_tpu_torch.config import (
    DataConfig, EncoderConfig, ExperimentConfig, SiameseConfig, TrainConfig,
)
from voicemap_tpu_torch.data.store import synthetic_store
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.models.convert import from_flax, to_flax
from voicemap_tpu_torch.models.fused_train import (
    siamese_embed_train_forward, siamese_train_forward,
)
from voicemap_tpu_torch.models.siamese import SiameseNet
from voicemap_tpu_torch.train import steps
from voicemap_tpu_torch.train.checkpoints import CheckpointManager
from voicemap_tpu_torch.train.loop import fit, init_model
from voicemap_tpu_torch.train.state import init_state

B, T = 3, 256
ENC = EncoderConfig(filters=8, embedding_dim=16, dropout=0.0, compute_dtype="float32")
FWD_TOL = 1e-5
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
POLICIES = [("module", None), (False, "jnp"), (True, "jnp"), (True, "fused")]


def setup(metric, seed, loss="bce", fused=False, clipnorm=1.0):
    rng = np.random.default_rng(seed)
    x1, x2 = ((rng.standard_normal((B, T, 1)) * 0.5).astype(np.float32) for _ in range(2))
    y = np.array([0, 1, 0], np.float32)
    cfg = ExperimentConfig(
        mode="siamese", encoder=ENC, siamese=SiameseConfig(distance_metric=metric),
        train=TrainConfig(batch_size=B, loss=loss, clipnorm=clipnorm, use_fused_block0=fused,
                          use_fused_blockn=fused))
    jmodel = JaxSiamese(jax_config(cfg.encoder), jax_config(cfg.siamese))
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x1),
                                         jnp.asarray(x2)), seed + 1)
    variables["params"]["head"]["bias"] = np.array([-0.125], np.float32)
    model = SiameseNet(cfg.encoder, cfg.siamese, device="cpu")
    model.load_state_dict(from_flax(variables, cfg.encoder))
    return cfg, jmodel, variables, model, x1, x2, y


def stats_of(model):
    return to_flax(model.state_dict(), model.cfg)["batch_stats"]


@pytest.mark.parametrize("fused_block0,blockn", POLICIES)
@pytest.mark.parametrize("metric", ["weighted_l1", "uniform_euclidean"])
def test_siamese_train_forward_matches_jax(fused_block0, blockn, metric):
    cfg, _, variables, model, x1, x2, _ = setup(metric, 2)
    want, want_stats = jfused.siamese_train_forward(
        variables["params"], variables["batch_stats"], jax_config(cfg.encoder),
        jax_config(cfg.siamese), jnp.asarray(x1), jnp.asarray(x2), impl="xla")
    model.train()
    a, b = torch.from_numpy(x1), torch.from_numpy(x2)
    if fused_block0 == "module":
        got = model(a, b)
    else:
        got = siamese_train_forward(model, a, b, None, blockn, fused_block0)
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert_tree_close(stats_of(model), want_stats, FWD_TOL)


@pytest.mark.parametrize("fused_block0,blockn", POLICIES[1:])
def test_siamese_embed_train_forward_matches_jax(fused_block0, blockn):
    cfg, _, variables, model, x1, x2, _ = setup("weighted_l1", 3)
    stacked = np.concatenate([x1, x2])
    want, want_stats = jfused.siamese_embed_train_forward(
        variables["params"], variables["batch_stats"], jax_config(cfg.encoder),
        jnp.asarray(stacked), impl="xla")
    model.train()
    got = siamese_embed_train_forward(model, torch.from_numpy(stacked), None, blockn,
                                      fused_block0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert_tree_close(stats_of(model), want_stats, FWD_TOL)


def test_pairs_are_encoded_as_one_batch():
    """Train-mode BatchNorm takes its statistics over all 2B rows: encoding
    x1 and x2 apart would leave other running statistics."""
    cfg, _, variables, model, x1, x2, _ = setup("weighted_l1", 4)
    _, want_stats = jfused.siamese_train_forward(
        variables["params"], variables["batch_stats"], jax_config(cfg.encoder),
        jax_config(cfg.siamese), jnp.asarray(x1), jnp.asarray(x2), impl="xla")
    model.train()
    model(torch.from_numpy(x1), torch.from_numpy(x2))
    assert_tree_close(stats_of(model), want_stats, FWD_TOL)
    apart = SiameseNet(cfg.encoder, cfg.siamese, device="cpu")
    apart.load_state_dict(from_flax(variables, cfg.encoder))
    apart.train()
    apart.encoder(torch.from_numpy(x1))
    apart.encoder(torch.from_numpy(x2))
    got = stats_of(apart)["encoder"]["block_0"]["bn"]["mean"]
    assert np.abs(got - np.asarray(want_stats["encoder"]["block_0"]["bn"]["mean"])).max() > 1e-4


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("loss", ["bce", "contrastive"])
def test_one_step_matches_jax(loss, fused):
    """clipnorm 1e-3 forces the clip on, so the update depends on every
    gradient leaf together."""
    cfg, jmodel, variables, model, x1, x2, y = setup("weighted_l1", 5, loss, fused, 1e-3)
    jcfg = jax_config(cfg)
    tx = jstate.make_optimizer(cfg.train.clipnorm)
    st = jstate.init_state(variables["params"], variables["batch_stats"], tx,
                           cfg.train.learning_rate)
    jloss_fn = jsteps.siamese_loss_fn(jmodel, jcfg)
    (jl, (new_bs, jacc)), grads = jax.value_and_grad(jloss_fn, has_aux=True)(
        st.params, st.batch_stats, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(y),
        jax.random.PRNGKey(0))
    clipped, _ = optax.clip_by_global_norm(cfg.train.clipnorm).update(grads, None)
    jnew = jstate.apply_updates(st, grads, tx, new_bs)

    state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
    loss_fn = steps.siamese_loss_fn(model, cfg)
    assert (loss_fn.fused_block0, loss_fn.blockn) == (fused, "fused" if fused else "jnp")
    state, m = steps.train_on_pairs(state, torch.from_numpy(x1), torch.from_numpy(x2),
                                    torch.from_numpy(y), None, loss_fn)
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=LOSS_TOL)
    assert float(m["accuracy"]) == pytest.approx(float(jacc))
    # The contrastive loss never reaches the head: no gradient here, zeros in JAX.
    got_grads = to_flax({n: torch.zeros_like(p) if p.grad is None else p.grad
                         for n, p in model.named_parameters()}, cfg.encoder)["params"]
    assert_tree_close(got_grads, clipped, PARAM_TOL)
    tree = to_flax(state.model.state_dict(), cfg.encoder)
    assert_tree_close(tree["params"], jnew.params, PARAM_TOL)
    assert_tree_close(tree["batch_stats"], jnew.batch_stats, PARAM_TOL)


def test_the_block0_policy_admits_the_siamese_net():
    auto = ExperimentConfig(mode="siamese")
    net = SiameseNet(EncoderConfig(filters=8, embedding_dim=8), auto.siamese, device="cpu")
    assert steps.resolve_fused_block0(auto, net) is False  # auto: on the card only
    forced = auto.replace(train=TrainConfig(use_fused_block0=True))
    assert steps.resolve_fused_block0(forced, net) is True
    assert steps.resolve_fused_block0(forced, torch.nn.Linear(2, 2)) is False
    assert steps.resolve_fused_block0(
        forced, SpeakerClassifier(EncoderConfig(filters=8, embedding_dim=8), 3,
                                  device="cpu")) is True


@pytest.mark.parametrize("metric,width", [("weighted_l1", 16), ("cosine_distance", 1)])
def test_init_model_builds_the_siamese_net_as_flax_does(metric, width):
    cfg = ExperimentConfig(mode="siamese", encoder=EncoderConfig(filters=8, embedding_dim=16),
                           siamese=SiameseConfig(distance_metric=metric))
    model = init_model(cfg, 7, "cpu", 3)
    assert isinstance(model, SiameseNet)
    assert model.head.weight.shape == (1, width) and float(model.head.bias.detach().abs().sum()) == 0.0
    if width > 1:  # lecun normal over the fan-in D, truncated at 2 std
        std = width ** -0.5 / 0.87962566103423978
        assert float(model.head.weight.detach().abs().max()) <= 2 * std + 1e-6
    again = init_model(cfg, 7, "cpu", 3)
    assert torch.equal(again.head.weight, model.head.weight)


def tiny_siamese_config(tmp_path, num_steps, fused, loss="bce"):
    return ExperimentConfig(
        mode="siamese", data=DataConfig(seconds=0.1, downsampling=4),
        encoder=EncoderConfig(filters=8, embedding_dim=8, dropout=0.0),
        siamese=SiameseConfig(distance_metric="weighted_l1"),
        train=TrainConfig(batch_size=8, num_steps=num_steps, evaluate_every=2,
                          num_eval_tasks=16, loss=loss, use_fused_block0=fused,
                          use_fused_blockn=fused, checkpoint_dir=str(tmp_path / "ckpt"),
                          log_path=str(tmp_path / "m.jsonl")))


@pytest.mark.parametrize("fused,loss", [(False, "bce"), (True, "contrastive")])
def test_fit_trains_the_siamese_net_checkpoints_and_resumes(tmp_path, capsys, fused, loss):
    store = synthetic_store(2, n_speakers=5, utterances_per_speaker=3, min_seconds=0.2,
                            max_seconds=0.3)
    with pytest.warns(UserWarning, match="TRAINING store"):
        state, hist = fit(tiny_siamese_config(tmp_path, 4, fused, loss), store, device="cpu")
    assert isinstance(state.model, SiameseNet) and state.step == 4
    assert [r["step"] for r in hist] == [2, 4]
    rec = hist[-1]
    assert np.isfinite(rec["loss"]) and 0.0 <= rec["val_1-shot_acc"] <= 1.0
    assert 0.0 <= rec["accuracy"] <= 1.0
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    blob = ckpt.load()
    assert blob["step"] == 4 and blob["model"]["head.weight"].shape == (1, 8)
    assert ckpt.head_num_classes() is None  # a Dense(1) head counts no classes
    # The saved state loads into a fresh net, bit for bit.
    fresh = SiameseNet(state.model.cfg, state.model.siamese, device="cpu")
    fresh.load_state_dict(blob["model"])
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k

    with pytest.warns(UserWarning):
        state2, hist2 = fit(tiny_siamese_config(tmp_path, 6, fused, loss), store, device="cpu")
    assert "resumed from step 4" in capsys.readouterr().out
    assert state2.step == 6 and [r["step"] for r in hist2] == [6]
    assert [json.loads(s)["step"] for s in (tmp_path / "m.jsonl").read_text().splitlines()] \
        == [2, 4, 6]


def test_fit_still_refuses_other_modes():
    cfg = dataclasses.replace(ExperimentConfig(), mode="pairs")
    with pytest.raises(NotImplementedError, match="pairs"):
        fit(cfg, synthetic_store(0, 2, 2, 0.1, 0.2), device="cpu")
