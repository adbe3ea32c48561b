"""The port's train step, optimizer, losses, schedule, sampler and ``fit``.

One whole step against the JAX package's: from the same flax variables and
the same ``(x, y)``, ``value_and_grad(classifier_loss_fn) + apply_updates``
there and ``train_on_batch`` here; the loss, every gradient leaf (through
``to_flax``, after the clip), every updated parameter and the batch
statistics at f32 within 1e-4, with the clip off and forced on
(clipnorm 1e-3), under the autograd policy and under the B4/B5 + B7 one (on
the CPU, the kernels' plain versions). At bf16 each gradient leaf's cosine
against the JAX package's fused path is held to a bound. The optimizer
against optax over several steps; the losses against the JAX package's; the
plateau schedule against the JAX one on one metric sequence; the sampler on
its invariants (a torch generator does not replay JAX's keys); ``fit`` on a
tiny synthetic store: records, checkpoints, resume.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import voicemap_tpu.config as jconfig
from test_torch_config import jax_config
from test_torch_encoder import randomize_bn
from test_torch_train_forward import assert_tree_close
from voicemap_tpu.models.classifier import SpeakerClassifier as JaxClassifier
from voicemap_tpu.train import losses as jlosses
from voicemap_tpu.train import state as jstate
from voicemap_tpu.train import steps as jsteps
from voicemap_tpu.train.metrics import PlateauScheduler as JaxPlateau
from voicemap_tpu_torch.config import DataConfig, EncoderConfig, ExperimentConfig, TrainConfig
from voicemap_tpu_torch.data.store import synthetic_store
from voicemap_tpu_torch.eval import nshot
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.models.convert import from_flax, to_flax
from voicemap_tpu_torch.ops.sampling import sample_classifier_batch
from voicemap_tpu_torch.train import losses, steps
from voicemap_tpu_torch.train.checkpoints import CheckpointManager
from voicemap_tpu_torch.train.loop import fit
from voicemap_tpu_torch.train.metrics import PlateauScheduler
from voicemap_tpu_torch.train.state import init_state, make_optimizer

B, T, CLASSES = 4, 256, 5
TOL = 1e-4
BF16_MIN_COSINE = 0.99
BF16_MIN_LEAF_COSINE = 0.95


def experiment(dtype="float32", clipnorm=1.0, fused=False):
    enc = EncoderConfig(filters=8, embedding_dim=16, dropout=0.0, compute_dtype=dtype)
    return ExperimentConfig(encoder=enc, train=TrainConfig(
        batch_size=B, clipnorm=clipnorm, use_fused_block0=fused, use_fused_blockn=fused))


def one_step_both(cfg, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, 1)) * 0.5).astype(np.float32)
    y = rng.integers(0, CLASSES, B).astype(np.int32)
    jcfg = jax_config(cfg)
    jmodel = JaxClassifier(jcfg.encoder, num_classes=CLASSES)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed)

    tx = jstate.make_optimizer(cfg.train.clipnorm)
    st = jstate.init_state(variables["params"], variables["batch_stats"], tx,
                           cfg.train.learning_rate)
    loss_fn = jsteps.classifier_loss_fn(jmodel, jcfg)
    (jl, (new_bs, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        st.params, st.batch_stats, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    clipped, _ = optax.clip_by_global_norm(cfg.train.clipnorm).update(grads, None)
    jnew = jstate.apply_updates(st, grads, tx, new_bs)

    model = SpeakerClassifier(cfg.encoder, CLASSES, device="cpu")
    model.load_state_dict(from_flax(variables, cfg.encoder))
    state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
    port_loss_fn = steps.classifier_loss_fn(model, cfg)
    state, m = steps.train_on_batch(state, torch.from_numpy(x), torch.from_numpy(y), None,
                                    port_loss_fn)
    got_grads = to_flax({n: p.grad for n, p in model.named_parameters()}, cfg.encoder)["params"]
    return {"jax": (float(jl), clipped, jnew, grads), "port": (m, got_grads, state, port_loss_fn)}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("clipnorm", [1e3, 1e-3])
def test_one_step_matches_jax_at_f32(fused, clipnorm):
    r = one_step_both(experiment("float32", clipnorm, fused), 1)
    jl, clipped, jnew, _ = r["jax"]
    m, got_grads, state, loss_fn = r["port"]
    assert (loss_fn.fused_block0, loss_fn.blockn) == (fused, "fused" if fused else "jnp")
    assert state.step == 1 and int(jnew.step) == 1
    np.testing.assert_allclose(float(m["loss"]), jl, rtol=TOL)
    assert_tree_close(got_grads, clipped, TOL)
    tree = to_flax(state.model.state_dict(), state.model.cfg)
    assert_tree_close(tree["params"], jnew.params, TOL)
    assert_tree_close(tree["batch_stats"], jnew.batch_stats, TOL)


def leaf_cosines(tree, ref):
    out = {}
    for path, want in jax.tree_util.tree_leaves_with_path(ref):
        node = tree
        for k in path:
            node = node[k.key]
        a, b = np.asarray(node, np.float64).ravel(), np.asarray(want, np.float64).ravel()
        out[jax.tree_util.keystr(path)] = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    return out


def test_one_step_at_bf16_agrees_by_cosine():
    """bf16 rounds at other places in the two frameworks, and a value tie
    in one pool window may break apart in the other. At this size (filters
    8, B=4) the JAX package's own two bf16 paths, fused and autograd, agree
    only to a cosine of 0.89 on block 0's BatchNorm bias and 0.98 over all
    leaves, so a bound of 0.99 per leaf does not hold here: each leaf of the
    port's fused step is held to 0.95 against the JAX fused step (0.955
    seen), and all leaves together to 0.99 (0.995 seen)."""
    r = one_step_both(experiment("bfloat16", 1e3, True), 2)
    jl, _, _, grads = r["jax"]
    m, got_grads, _, _ = r["port"]
    np.testing.assert_allclose(float(m["loss"]), jl, rtol=1e-2)
    for leaf, cos in leaf_cosines(got_grads, grads).items():
        assert cos >= BF16_MIN_LEAF_COSINE, (leaf, cos)
    flat = lambda tree: np.concatenate([np.asarray(v, np.float64).ravel()  # noqa: E731
                                        for v in jax.tree_util.tree_leaves(tree)])
    a, b = flat(got_grads), flat(grads)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= BF16_MIN_COSINE


def test_clipped_adam_matches_optax_over_steps():
    rng = np.random.default_rng(3)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    gs = [[rng.standard_normal(p.shape).astype(np.float32) * s for p in p0]
          for s in (0.3, 2.0, 0.01)]
    lrs = (1e-3, 5e-4, 5e-4)
    tx = jstate.make_optimizer(1.0)
    jp = [jnp.asarray(p) for p in p0]
    opt_state = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = make_optimizer(params, 1.0)
    for g, lr in zip(gs, lrs):
        upd, opt_state = tx.update([jnp.asarray(v) for v in g], opt_state, jp)
        jp = optax.apply_updates(jp, [u * lr for u in upd])
        for p, v in zip(params, g):
            p.grad = torch.from_numpy(v.copy())
        opt.step(lr)
    for got, want in zip(params, jp):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["softmax_ce", "categorical_accuracy", "bce_with_logits",
                                  "binary_accuracy", "contrastive"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(4)
    if name in ("softmax_ce", "categorical_accuracy"):
        a = (rng.standard_normal((16, 7)) * 3).astype(np.float32)
        y = rng.integers(0, 7, 16).astype(np.int32)
    else:
        a = np.abs(rng.standard_normal(16) * 1.5).astype(np.float32)
        if name != "contrastive":
            a -= 1.0
        y = rng.integers(0, 2, 16).astype(np.float32)
    got = getattr(losses, name)(torch.from_numpy(a), torch.from_numpy(y))
    want = getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(y))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_plateau_matches_jax_and_round_trips():
    seq = [0.2, 0.3, 0.3, 0.25, 0.29, 0.31, 0.31, 0.3, 0.2, 0.1, 0.4, 0.4, 0.4, 0.4]
    port, ref = PlateauScheduler(1e-3, 0.5, 2, 1e-4), JaxPlateau(1e-3, 0.5, 2, 1e-4)
    for i, v in enumerate(seq):
        assert port.update(v) == ref.update(v)
        if i == 6:
            again = PlateauScheduler(1.0, 0.5, 2, 1e-4)
            again.load_state_dict(port.state_dict())
            port = again
    assert port.lr < 1e-3


def test_sampler_invariants():
    gen = torch.Generator().manual_seed(5)
    idx = sample_classifier_batch(gen, 37, 4096)
    assert idx.shape == (4096,) and idx.dtype == torch.int64
    assert int(idx.min()) == 0 and int(idx.max()) == 36
    assert torch.equal(idx, sample_classifier_batch(torch.Generator().manual_seed(5), 37, 4096))
    counts = torch.bincount(idx, minlength=37).float()
    assert float(counts.min()) > 0.5 * 4096 / 37  # uniform-ish, every id drawn


def test_policies_resolve():
    cpu_model = SpeakerClassifier(EncoderConfig(filters=8, embedding_dim=8), 3, device="cpu")
    auto = ExperimentConfig()
    assert steps.resolve_fused_block0(auto, cpu_model) is False
    assert steps.resolve_blockn(auto, "cpu") == "jnp"
    assert steps.resolve_fused_block0(experiment(fused=True), cpu_model) is True
    assert steps.resolve_blockn(experiment(fused=True), "cpu") == "fused"
    assert steps.resolve_blockn(experiment(fused=False), "cpu") == "jnp"
    int8 = auto.replace(train=dataclasses.replace(auto.train, quant_forward="int8"))
    assert steps.resolve_blockn(int8, "cpu") == "fused_int8"  # over every flag, as in JAX
    no = int8.replace(train=dataclasses.replace(int8.train, use_fused_blockn=False))
    assert steps.resolve_blockn(no, "cpu") == "fused_int8"
    int4 = auto.replace(train=dataclasses.replace(auto.train, quant_forward="int4"))
    with pytest.raises(ValueError):
        steps.resolve_blockn(int4, "cpu")
    assert jconfig.TrainConfig().quant_forward == "none"


def tiny_fit_config(tmp_path, num_steps, fused):
    return ExperimentConfig(
        data=DataConfig(seconds=0.1, downsampling=4),
        encoder=EncoderConfig(filters=8, embedding_dim=8),
        train=TrainConfig(batch_size=8, num_steps=num_steps, evaluate_every=2,
                          num_eval_tasks=16, use_fused_block0=fused, use_fused_blockn=fused,
                          checkpoint_dir=str(tmp_path / "ckpt"),
                          log_path=str(tmp_path / "m.jsonl")))


@pytest.mark.parametrize("fused", [False, True])
def test_fit_logs_checkpoints_and_resumes(tmp_path, capsys, fused):
    store = synthetic_store(0, n_speakers=5, utterances_per_speaker=3, min_seconds=0.2,
                            max_seconds=0.3)
    with pytest.warns(UserWarning, match="TRAINING store"):
        state, hist = fit(tiny_fit_config(tmp_path, 4, fused), store, device="cpu")
    assert state.step == 4 and [r["step"] for r in hist] == [2, 4]
    rec = hist[-1]
    assert {"loss", "accuracy", "val_1-shot_acc", "lr", "utterances_per_sec"} <= set(rec)
    assert np.isfinite(rec["loss"]) and 0.0 <= rec["val_1-shot_acc"] <= 1.0
    lines = [json.loads(s) for s in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [2, 4]
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.load()["step"] == 4 and ckpt.head_num_classes() == 5
    assert ckpt.best_metric is not None

    with pytest.warns(UserWarning):
        state2, hist2 = fit(tiny_fit_config(tmp_path, 6, fused), store, device="cpu")
    assert "resumed from step 4" in capsys.readouterr().out
    assert state2.step == 6 and [r["step"] for r in hist2] == [6]
    assert [json.loads(s)["step"] for s in (tmp_path / "m.jsonl").read_text().splitlines()] \
        == [2, 4, 6]
    steps_kept = sorted(p.stem for p in (tmp_path / "ckpt" / "latest").glob("*.pt"))
    assert steps_kept == ["2", "4", "6"]


def test_resume_schedules_the_lr_as_the_reference(tmp_path, monkeypatch):
    """After a resume, ``fit``'s lr at every evaluation is that of the JAX
    ``PlateauScheduler`` built fresh from the restored lr and fed the same
    accuracies, as the reference's ``fit`` builds it after
    ``restore_latest``: the first run's best and bad count do not carry
    over."""
    seq = [0.5, 0.4, 0.3, 0.3, 0.3, 0.3]
    accs = iter(seq)
    monkeypatch.setattr(nshot, "evaluate", lambda *a, **k: next(accs))
    store = synthetic_store(2, n_speakers=5, utterances_per_speaker=3, min_seconds=0.2,
                            max_seconds=0.3)

    def cfg(num_steps):
        c = tiny_fit_config(tmp_path, num_steps, False)
        return c.replace(train=dataclasses.replace(c.train, plateau_patience=2,
                                                   plateau_factor=0.5))

    with pytest.warns(UserWarning):
        fit(cfg(4), store, device="cpu", verbose=False)  # evaluations at 2 and 4
    blob = CheckpointManager(str(tmp_path / "ckpt")).load()
    assert blob["step"] == 4 and blob["plateau"]["bad_count"] == 1
    with pytest.warns(UserWarning):
        _, hist = fit(cfg(12), store, device="cpu", verbose=False)  # at 6, 8, 10, 12
    t = cfg(12).train
    ref = JaxPlateau(blob["lr"], t.plateau_factor, t.plateau_patience, t.min_lr)
    want = [ref.update(a) for a in seq[2:]]
    assert [r["step"] for r in hist] == [6, 8, 10, 12]
    assert [r["lr"] for r in hist] == want
    # the saved schedule, had it been loaded, would cut the lr at step 6
    stale = PlateauScheduler(blob["lr"], t.plateau_factor, t.plateau_patience, t.min_lr)
    stale.load_state_dict(blob["plateau"])
    assert [stale.update(a) for a in seq[2:]] != want


def test_fit_requires_holdout_when_asked(tmp_path):
    cfg = tiny_fit_config(tmp_path, 2, False)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, require_holdout_eval=True))
    store = synthetic_store(1, 5, 3, 0.2, 0.3)
    with pytest.raises(ValueError):
        fit(cfg, store, device="cpu", verbose=False)
