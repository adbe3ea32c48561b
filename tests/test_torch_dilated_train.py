"""Config #3 (``dilated_4khz``) trained by the port against the JAX package,
on the CPU, at filters 8 with config #3's eight blocks, kernels, pools and
dilations.

- the train forward (``classifier_train_forward``) under each policy (the
  module's own train forward; autograd blocks with and without the B4/B5
  block-0 op; the B7 blocks-1+ op, cuDNN's dilated NHWC convs around B7 at
  pool 1 and 2) against flax's ``apply(train=True)`` at f32 with dropout 0:
  logits, the gradients of the softmax cross-entropy and the running
  statistics, within 1e-4 (``tests/test_torch_train_forward.py``'s bound),
  the running statistics within 1e-5;
- one classifier step (Adam, the clip) against the JAX step at f32, the
  loss, every clipped gradient leaf, the updated parameters and the batch
  statistics within ``TOL`` = 1e-4 (``tests/test_torch_train_step.py``'s);
- the auto policy for blocks 1+ on eight blocks;
- ``quantize_from_store`` on config #3 against the JAX package's on the same
  store rows (scales within 1e-5 relative);
- ``fit`` on config #3 for a few steps on a synthetic store, with
  checkpoints and a resume.

On the CPU the kernels' plain versions stand in for B4, B5 and B7.
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
from test_torch_quant_infer import to_numpy
from test_torch_train_forward import assert_tree_close, jax_side
from voicemap_tpu.models.classifier import SpeakerClassifier as JaxClassifier
from voicemap_tpu.train import state as jstate
from voicemap_tpu.train import steps as jsteps
from voicemap_tpu_torch.config import (
    DataConfig, ExperimentConfig, TrainConfig, dilated_4khz,
)
from voicemap_tpu_torch.data.store import synthetic_store
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.models.convert import from_flax, to_flax
from voicemap_tpu_torch.models.fused_train import classifier_train_forward
from voicemap_tpu_torch.ops import cuda_routing
from voicemap_tpu_torch.train import steps
from voicemap_tpu_torch.train.checkpoints import CheckpointManager
from voicemap_tpu_torch.train.loop import fit
from voicemap_tpu_torch.train.losses import softmax_ce
from voicemap_tpu_torch.train.state import init_state

B, T, CLASSES = 4, 1024, 5
TOL = 1e-4
STATS_TOL = 1e-5


def encoder_cfg(dtype="float32"):
    return dataclasses.replace(dilated_4khz().encoder, filters=8, embedding_dim=16,
                               dropout=0.0, compute_dtype=dtype)


def setup(seed):
    cfg = encoder_cfg()
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, 1)) * 0.5).astype(np.float32)
    y = rng.integers(0, CLASSES, B).astype(np.int32)
    jmodel = JaxClassifier(jax_config(cfg), num_classes=CLASSES)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed + 1)
    return cfg, x, y, jmodel, variables


@pytest.mark.parametrize("fused_block0,blockn", [("module", None), (False, "jnp"),
                                                 (True, "jnp"), (False, "fused"),
                                                 (True, "fused")])
def test_train_forward_matches_flax(monkeypatch, fused_block0, blockn):
    """Under ``fused`` every block 1-7 goes through B7's pool pass, at pool
    1 for the dilated blocks and 2 between them."""
    cfg, x, y, jmodel, variables = setup(3)
    ce, logits, grads, stats = jax_side(jmodel, variables, x, y)
    model = SpeakerClassifier(cfg, CLASSES, device="cpu")
    model.load_state_dict(from_flax(variables, cfg))
    model.train()
    pools = []
    real = cuda_routing.pool_fwd

    def counted(z, b, sgn, pool, *a, **kw):
        pools.append(pool)
        return real(z, b, sgn, pool, *a, **kw)

    monkeypatch.setattr(cuda_routing, "pool_fwd", counted)
    xt = torch.from_numpy(x)
    if fused_block0 == "module":
        out = model(xt)
    else:
        out = classifier_train_forward(model, xt, None, blockn, fused_block0)
    assert pools == (list(cfg.pool_sizes[1:]) if blockn == "fused" else [])
    loss = softmax_ce(out, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ce, rtol=TOL)
    np.testing.assert_allclose(out.detach().numpy(), logits, rtol=TOL, atol=TOL)
    got = to_flax({n: p.grad for n, p in model.named_parameters()}, cfg)
    assert_tree_close(got["params"], grads, TOL)
    assert_tree_close(to_flax(model.state_dict(), cfg)["batch_stats"], stats, STATS_TOL)


def experiment(fused, clipnorm=1e3):
    return ExperimentConfig(name="dilated_4khz", encoder=encoder_cfg(), train=TrainConfig(
        batch_size=B, clipnorm=clipnorm, use_fused_block0=fused, use_fused_blockn=fused))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("clipnorm", [1e3, 1e-3])
def test_one_step_matches_jax_at_f32(fused, clipnorm):
    cfg = experiment(fused, clipnorm)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((B, T, 1)) * 0.5).astype(np.float32)
    y = rng.integers(0, CLASSES, B).astype(np.int32)
    jcfg = jax_config(cfg)
    jmodel = JaxClassifier(jcfg.encoder, num_classes=CLASSES)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x)), 1)
    tx = jstate.make_optimizer(clipnorm)
    st = jstate.init_state(variables["params"], variables["batch_stats"], tx,
                           cfg.train.learning_rate)
    (jl, (new_bs, _)), grads = jax.value_and_grad(jsteps.classifier_loss_fn(jmodel, jcfg),
                                                  has_aux=True)(
        st.params, st.batch_stats, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    clipped, _ = optax.clip_by_global_norm(clipnorm).update(grads, None)
    jnew = jstate.apply_updates(st, grads, tx, new_bs)

    model = SpeakerClassifier(cfg.encoder, CLASSES, device="cpu")
    model.load_state_dict(from_flax(variables, cfg.encoder))
    state = init_state(model, clipnorm, cfg.train.learning_rate)
    loss_fn = steps.classifier_loss_fn(model, cfg)
    assert (loss_fn.fused_block0, loss_fn.blockn) == (fused, "fused" if fused else "jnp")
    state, m = steps.train_on_batch(state, torch.from_numpy(x), torch.from_numpy(y), None,
                                    loss_fn)
    got = to_flax({n: p.grad for n, p in model.named_parameters()}, cfg.encoder)["params"]
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=TOL)
    assert_tree_close(got, clipped, TOL)
    tree = to_flax(state.model.state_dict(), cfg.encoder)
    assert_tree_close(tree["params"], jnew.params, TOL)
    assert_tree_close(tree["batch_stats"], jnew.batch_stats, TOL)


class _Props:
    def __init__(self, total_memory):
        self.total_memory = total_memory


@pytest.mark.parametrize("batch", [32, 2048])
def test_the_auto_policy_takes_the_fused_blocks_on_the_card(monkeypatch, batch):
    """Config #3 at full width: the widest block 1+ activation (block 2's
    (B, 256, 3000) conv output, 3.1 GB in bf16 at B = 2048) stays under the
    save-act limit of an 80 GB card; on a card of 1 GB it does not."""
    cfg = dilated_4khz()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=batch))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: _Props(80e9))
    assert steps.resolve_blockn(cfg, "cuda") == "fused"
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: _Props(1e9))
    assert steps.resolve_blockn(cfg, "cuda") == ("fused" if batch == 32 else "jnp")
    assert steps.resolve_blockn(cfg, "cpu") == "jnp"


def small_fit_config(tmp_path, num_steps, fused):
    return ExperimentConfig(
        name="dilated_4khz", data=DataConfig(seconds=0.256, downsampling=4),
        encoder=dataclasses.replace(encoder_cfg("bfloat16"), embedding_dim=8),
        train=TrainConfig(batch_size=8, num_steps=num_steps, evaluate_every=2,
                          num_eval_tasks=16, use_fused_block0=fused, use_fused_blockn=fused,
                          checkpoint_dir=str(tmp_path / "ckpt"),
                          log_path=str(tmp_path / "m.jsonl")))


def test_quantize_from_store_matches_jax():
    """The first n_cal offset-0 fragments of the store calibrate both
    packages: the scales of blocks 1-7 agree at f32."""
    from voicemap_tpu.data.dataset import AudioStore as JaxAudioStore
    from voicemap_tpu.models import quant_infer as jq
    from voicemap_tpu_torch.models import quant_infer as tq

    cfg = ExperimentConfig(name="dilated_4khz", data=DataConfig(seconds=0.256, downsampling=4),
                           encoder=encoder_cfg())
    jcfg = jax_config(cfg)
    host = synthetic_store(9, n_speakers=5, utterances_per_speaker=3, min_seconds=0.3,
                           max_seconds=0.5)
    jmodel = JaxClassifier(jcfg.encoder, num_classes=5)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(2),
                                         jnp.zeros((1, cfg.data.model_length, 1))), 3)
    jst = jstate.init_state(variables["params"], variables["batch_stats"],
                            jstate.make_optimizer(), 1e-3)
    jstore = jsteps.device_store_for(jcfg, JaxAudioStore(**dataclasses.asdict(host)))
    want = to_numpy(jq.quantize_from_store(jst, jcfg, jstore, n_cal=8))
    model = SpeakerClassifier(cfg.encoder, num_classes=5, device="cpu")
    model.load_state_dict(from_flax(variables, cfg.encoder))
    got = tq.quantize_from_store(model, cfg, steps.device_store_for(cfg, host, "cpu"), n_cal=8)
    np.testing.assert_allclose(got["s0"].numpy(), want["s0"], rtol=1e-5, atol=0)
    assert len(got["blocks"]) == len(want["blocks"]) == 7
    for g, w in zip(got["blocks"], want["blocks"]):
        assert g["w_q"].shape == w["w_q"].shape


@pytest.mark.parametrize("fused", [False, True])
def test_fit_on_config_3_logs_checkpoints_and_resumes(tmp_path, capsys, fused):
    store = synthetic_store(0, n_speakers=5, utterances_per_speaker=3, min_seconds=0.3,
                            max_seconds=0.4)
    with pytest.warns(UserWarning, match="TRAINING store"):
        state, hist = fit(small_fit_config(tmp_path, 4, fused), store, device="cpu")
    assert state.step == 4 and [r["step"] for r in hist] == [2, 4]
    rec = hist[-1]
    assert np.isfinite(rec["loss"]) and 0.0 <= rec["val_1-shot_acc"] <= 1.0
    assert len(state.model.encoder.blocks) == 8
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.load()["step"] == 4 and ckpt.head_num_classes() == 5
    with pytest.warns(UserWarning):
        state2, hist2 = fit(small_fit_config(tmp_path, 6, fused), store, device="cpu")
    assert "resumed from step 4" in capsys.readouterr().out
    assert state2.step == 6 and [r["step"] for r in hist2] == [6]
    assert [json.loads(s)["step"] for s in (tmp_path / "m.jsonl").read_text().splitlines()] \
        == [2, 4, 6]
