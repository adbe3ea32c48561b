"""The int8 and the pool-rate-residual train forwards, and the raw-store
chain, against the JAX package.

``FusedBlocknTrain(quant="int8")`` against ``make_fused_blockn_train(
quant="int8")`` and ``FusedBlocknRecompute`` against ``make_fused_blockn_train(
save_act=False)``, both with ``routing="xla"`` at f32: the same numpy inputs,
the forward and every gradient of one scalar that reads the pooled output,
μ and σ². B3's train epilogue and B7's index mode through their plain
versions against the JAX forward's own residuals (its dequantized ``a`` and
its ``_pool_lane`` selection and phase index), exactly. The whole train
forwards (classifier and siamese) under each new ``blockn`` against the JAX
ones, one int8 train step against the JAX step, ``fit`` training through
``fused_int8``, and ``fetch_batch`` on a raw store against the JAX raw chain.
On the CPU the plain versions stand in for the kernels; the JAX sides run
under ``jax.jit`` (eager, XLA compiles its int8 convs op by op: 20 s a
forward).

Bit for bit in the forward, except where the two frameworks sum in another
order. The int8 forward's conv sums are exact, so its activation ``a``,
``a_sel`` and the phase index are equal; the first op that differs is the
statistics' Σa and Σa² over every position (B7's order against XLA's), so
μ, σ² and ``pooled`` through them are held to ``SUM_TOL`` relative. The
pool-rate-residual forward's first differing op is the conv itself, its f32
sums of k·Cin products in another order, which σ² = E[a²] − μ² then
cancels: held to ``CONV_ORDER_TOL``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_config import jax_config
from test_torch_encoder import randomize_bn
from test_torch_train_forward import assert_tree_close
from voicemap_tpu.data.dataset import AudioStore as JaxAudioStore
from voicemap_tpu.models import fused_train as jfused
from voicemap_tpu.models.classifier import SpeakerClassifier as JaxClassifier
from voicemap_tpu.models.siamese import SiameseNet as JaxSiamese
from voicemap_tpu.ops import preprocess as jpre
from voicemap_tpu.ops.conv_train import make_fused_blockn_train
from voicemap_tpu.train import steps as jsteps
from voicemap_tpu_torch.config import (
    DataConfig, EncoderConfig, ExperimentConfig, SiameseConfig, TrainConfig,
)
from voicemap_tpu_torch.data.store import synthetic_store
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.models.convert import from_flax, to_flax
from voicemap_tpu_torch.models.fused_train import (
    classifier_train_forward, siamese_train_forward,
)
from voicemap_tpu_torch.models.siamese import SiameseNet
from voicemap_tpu_torch.ops import conv_train, cuda_routing, preprocess
from voicemap_tpu_torch.ops.conv_train import (
    FusedBlocknRecompute, FusedBlocknTrain, quantize_int8,
)
from voicemap_tpu_torch.ops.cuda_quant_block import quant_block_train_reference
from voicemap_tpu_torch.ops.cuda_routing import pool_fwd_reference, route_bwd_reference
from voicemap_tpu_torch.train import losses, steps
from voicemap_tpu_torch.train.loop import fit
from voicemap_tpu_torch.train.state import init_state

EPS = 1e-3
TOL = 1e-4  # tests/test_torch_train_ops.py's, for test_fused_blockn_matches_jax_custom_vjp
SUM_TOL = 1e-6  # μ, σ² and pooled: sums over B·T positions in another order, relative
CONV_ORDER_TOL = 1e-5  # the f32 conv's sums in another order, through σ²'s cancellation
CHAIN_TOL = 1e-6  # the raw chain: whitening's mean and RMS summed in another order
CASES = [(2, 1), (2, 4), (1, 2)]  # (pool, dilation)
NEW_BLOCKN = ("fused_int8", "fused_recompute")


def scalar(out, mu, var, gw):
    """Σ out·gw + 2Σμ + ½Σσ²: every output carries a cotangent."""
    return (out * gw).sum() + (mu * 2.0).sum() + (var * 0.5).sum()


def block_inputs(pool, dilation, cin=8, cout=8, k=3, B=3, T=64):
    """Numpy inputs of one block: negative BatchNorm scales, a stretch of
    silence (a = relu(b) there: exact ties in every pool window) and one of
    a constant (ties inside it)."""
    rng = np.random.default_rng(pool * 10 + dilation)
    x = rng.standard_normal((B, T, cin)).astype(np.float32)
    x[:, 20:36] = 0.0
    x[:, 40:52] = 0.7
    w = (rng.standard_normal((k, cin, cout)) * 0.4).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    gamma[::3] = -1.3
    beta = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    gw = rng.standard_normal((B, T // pool, cout)).astype(np.float32)
    return x, w, b, gamma, beta, gw


def jax_block(fn, x, w, b, gamma, beta, gw):
    def jloss(xx, p):
        out, mu, var = fn(xx, *p)
        return scalar(out, mu, var, jnp.asarray(gw)), (out, mu, var)

    jparams = tuple(map(jnp.asarray, (w, b, gamma, beta)))
    (jl, jouts), (jgx, jgp) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), jparams)
    return float(jl), jouts, jgx, jgp


def port_block(op, x, w, b, gamma, beta, gw, pool, dilation, *extra):
    tx = torch.tensor(x.transpose(0, 2, 1).copy(), requires_grad=True)  # (B, Cin, T)
    tp = [torch.tensor(w.transpose(2, 1, 0).copy(), requires_grad=True)] + [
        torch.tensor(p, requires_grad=True) for p in (b, gamma, beta)]
    out, mu, var = op.apply(tx, *tp, pool, EPS, dilation, torch.float32, *extra)
    loss = scalar(out, mu, var, torch.from_numpy(gw.transpose(0, 2, 1).copy()))
    gx, *gp = torch.autograd.grad(loss, [tx, *tp])
    return loss.item(), (out, mu, var), gx, gp


def assert_block_matches(port, jax_side, fwd_tol):
    loss, (out, mu, var), gx, gp = port
    jl, jouts, jgx, jgp = jax_side
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 1), np.asarray(jouts[0]),
                               rtol=fwd_tol, atol=fwd_tol, err_msg="pooled")
    for name, got, want in (("mu", mu, jouts[1]), ("var", var, jouts[2])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=fwd_tol,
                                   err_msg=name)
    np.testing.assert_allclose(loss, jl, rtol=TOL)
    np.testing.assert_allclose(gx.numpy().transpose(0, 2, 1), np.asarray(jgx), rtol=TOL,
                               atol=TOL, err_msg="dx")
    np.testing.assert_allclose(gp[0].numpy().transpose(2, 1, 0), np.asarray(jgp[0]), rtol=TOL,
                               atol=TOL, err_msg="dw")
    for name, got, want in zip(("b", "gamma", "beta"), gp[1:], jgp[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=name)


def jax_op(pool, dilation, save_act=True, quant="none"):
    return make_fused_blockn_train(pool, EPS, dilation=dilation, gemm_dtype="float32",
                                   sel_dtype="float32", save_act=save_act, routing="xla",
                                   quant=quant)


@pytest.mark.parametrize("pool,dilation", CASES)
def test_int8_block_matches_jax(pool, dilation):
    x, w, b, gamma, beta, gw = block_inputs(pool, dilation)
    want = jax_block(jax_op(pool, dilation, quant="int8"), x, w, b, gamma, beta, gw)
    got = port_block(FusedBlocknTrain, x, w, b, gamma, beta, gw, pool, dilation, "int8")
    assert_block_matches(got, want, SUM_TOL)


@pytest.mark.parametrize("pool,dilation", CASES)
def test_recompute_block_matches_jax(pool, dilation):
    x, w, b, gamma, beta, gw = block_inputs(pool, dilation)
    want = jax_block(jax_op(pool, dilation, save_act=False), x, w, b, gamma, beta, gw)
    got = port_block(FusedBlocknRecompute, x, w, b, gamma, beta, gw, pool, dilation)
    assert_block_matches(got, want, CONV_ORDER_TOL)


@pytest.mark.parametrize("pool,dilation", CASES)
def test_plain_versions_equal_the_jax_forwards_residuals(pool, dilation):
    """The JAX int8 forward's saved residuals: its dequantized ``a`` equals
    B3's train epilogue (plain version) on the port's quantized operands bit
    for bit, and its ``_pool_lane`` selection and phase index equal B7's
    (plain version) on that ``a``, the index mode included."""
    x, w, b, gamma, beta, _ = block_inputs(pool, dilation)
    fn = jax_op(pool, dilation, quant="int8")
    _, res = fn.fwd(*map(jnp.asarray, (x, w, b, gamma, beta)))
    a_jax, sel_jax, idx_jax = (np.asarray(r) for r in res[4:7])
    qx, qw, scale = quantize_int8(torch.from_numpy(x), torch.from_numpy(w.transpose(2, 1, 0)))
    a = quant_block_train_reference(qx, qw, scale, torch.from_numpy(b), torch.float32, dilation)
    np.testing.assert_array_equal(a.numpy(), a_jax)
    sgn = torch.where(torch.from_numpy(gamma) >= 0, 1.0, -1.0)
    a_cl = a.permute(0, 2, 1)
    zero = torch.zeros(w.shape[2])
    sel, _, _, idx = pool_fwd_reference(a_cl, zero, sgn, pool, torch.float32, want_idx=True)
    np.testing.assert_array_equal(sel.permute(0, 2, 1).numpy(), sel_jax)
    np.testing.assert_array_equal(idx.permute(0, 2, 1).numpy(), idx_jax)
    assert idx.dtype == torch.int8 and cuda_routing.is_channels_last(idx)
    if pool > 1:
        assert (idx_jax > 0).any() and (idx_jax == 0).any()
        # the silent stretch ties every window: the first phase is taken
        assert (idx_jax[:, 12:16] == 0).all()
    # the index mode routes where the value mode routes: the first phase
    # whose value equals a_sel is the first of the strict max
    g = torch.randn(sel.shape, generator=torch.Generator().manual_seed(1))
    consts = [torch.randn(w.shape[2], generator=torch.Generator().manual_seed(s))
              for s in (2, 3, 4)]
    by_value = route_bwd_reference(a_cl, zero, sel, g, *consts, pool, torch.float32)
    by_idx = route_bwd_reference(a_cl, zero, idx, g, *consts, pool, torch.float32)
    for got, want in zip(by_idx, by_value):
        assert torch.equal(got, want)


def test_quantize_int8_forms_the_scales_as_the_jax_package():
    x = np.random.default_rng(0).standard_normal((2, 16, 8)).astype(np.float32)
    x[1, 3, 4] = -4.0  # the largest |x|, negative
    w = np.random.default_rng(1).standard_normal((8, 8, 3)).astype(np.float32)  # (Cout, Cin, k)
    w[5] = 0.0  # a channel of zeros: sw falls to 1e-12
    qx, qw, scale = quantize_int8(torch.from_numpy(x), torch.from_numpy(w))
    sx = np.float32(np.float32(4.0) / np.float32(127.0))
    sw = np.maximum(np.abs(w).max(axis=(1, 2)) / np.float32(127.0), np.float32(1e-12))
    np.testing.assert_array_equal(qx.numpy(),
                                  np.clip(np.round(x / sx), -127, 127).astype(np.int8))
    np.testing.assert_array_equal(
        qw.numpy(), np.clip(np.round(w / sw[:, None, None]), -127, 127).astype(
            np.int8).transpose(2, 1, 0))
    np.testing.assert_array_equal(scale.numpy(), sx * sw)
    assert qx.dtype == qw.dtype == torch.int8 and qx.is_contiguous()
    assert int(qx.abs().max()) == 127 and not qw[:, :, 5].any()


ENC = EncoderConfig(filters=8, embedding_dim=16, dropout=0.0, compute_dtype="float32")
B, T, CLASSES = 3, 256, 5


def classifier_setup(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, 1)) * 0.5).astype(np.float32)
    y = rng.integers(0, CLASSES, B).astype(np.int32)
    jmodel = JaxClassifier(jax_config(ENC), num_classes=CLASSES)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed + 1)
    model = SpeakerClassifier(ENC, CLASSES, device="cpu")
    model.load_state_dict(from_flax(variables, ENC))
    return x, y, variables, model


@pytest.mark.parametrize("blockn", NEW_BLOCKN)
def test_classifier_train_forward_matches_jax(blockn):
    """Logits, every gradient of the cross-entropy and the running
    statistics against ``jfused.classifier_train_forward`` under the same
    ``blockn``, at f32."""
    x, y, variables, model = classifier_setup(4)

    def jloss(params):
        logits, stats = jfused.classifier_train_forward(
            params, variables["batch_stats"], jax_config(ENC), jnp.asarray(x), impl="xla",
            blockn=blockn)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()
        return ce, (logits, stats)

    (ce, (logits, stats)), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    model.train()
    out = classifier_train_forward(model, torch.from_numpy(x), None, blockn, True)
    loss = losses.softmax_ce(out, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ce), rtol=TOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(logits), rtol=TOL, atol=TOL)
    got = to_flax({n: p.grad for n, p in model.named_parameters()}, ENC)
    assert_tree_close(got["params"], grads, TOL)
    assert_tree_close(to_flax(model.state_dict(), ENC)["batch_stats"], stats, TOL)


@pytest.mark.parametrize("blockn", NEW_BLOCKN)
def test_siamese_train_forward_matches_jax(blockn):
    rng = np.random.default_rng(6)
    x1, x2 = ((rng.standard_normal((B, T, 1)) * 0.5).astype(np.float32) for _ in range(2))
    siamese = SiameseConfig(distance_metric="weighted_l1")
    jmodel = JaxSiamese(jax_config(ENC), jax_config(siamese))
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(6), jnp.asarray(x1),
                                         jnp.asarray(x2)), 7)
    model = SiameseNet(ENC, siamese, device="cpu")
    model.load_state_dict(from_flax(variables, ENC))
    y = np.array([0, 1, 0], np.float32)

    def jloss(params):
        logits, stats = jfused.siamese_train_forward(
            params, variables["batch_stats"], jax_config(ENC), jax_config(siamese),
            jnp.asarray(x1), jnp.asarray(x2), impl="xla", blockn=blockn)
        return optax.sigmoid_binary_cross_entropy(logits, jnp.asarray(y)).mean(), (logits, stats)

    (bce, (logits, stats)), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    model.train()
    out = siamese_train_forward(model, torch.from_numpy(x1), torch.from_numpy(x2), None, blockn,
                                True)
    loss = losses.bce_with_logits(out, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(logits), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(loss.item(), float(bce), rtol=TOL)
    got = to_flax({n: p.grad for n, p in model.named_parameters()}, ENC)
    assert_tree_close(got["params"]["encoder"], grads["encoder"], TOL)
    assert_tree_close(to_flax(model.state_dict(), ENC)["batch_stats"], stats, TOL)


def int8_experiment(**train):
    return ExperimentConfig(encoder=ENC, train=TrainConfig(
        batch_size=B, quant_forward="int8", use_fused_block0=True, **train))


def test_one_int8_step_matches_the_jax_step():
    """``quant_forward="int8"`` resolves to ``fused_int8`` in both packages
    (over the size gate: ``use_fused_blockn`` unset), and one clipped Adam
    step from the same variables on the same batch agrees: the loss to 1e-4
    relative, every clipped gradient and the batch statistics to 1e-4. (Not
    the updated parameters: Adam's first update moves an element by about
    ±lr whatever its gradient's size, so a gradient within rounding of zero
    moves it either way, ROADMAP §C "Adam's first update".)"""
    cfg = int8_experiment()
    x, y, variables, model = classifier_setup(8)
    jcfg = jax_config(cfg)
    assert jsteps.resolve_blockn(jcfg) == "fused_int8"
    jloss_fn = jsteps.classifier_loss_fn(JaxClassifier(jcfg.encoder, num_classes=CLASSES), jcfg)
    (jl, (new_bs, _)), grads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], jnp.asarray(x), jnp.asarray(y),
        jax.random.PRNGKey(0))
    clipped, _ = optax.clip_by_global_norm(cfg.train.clipnorm).update(grads, None)

    state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
    loss_fn = steps.classifier_loss_fn(model, cfg)
    assert loss_fn.blockn == "fused_int8"
    state, m = steps.train_on_batch(state, torch.from_numpy(x), torch.from_numpy(y), None,
                                    loss_fn)
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=TOL)
    got = to_flax({n: p.grad for n, p in model.named_parameters()}, ENC)["params"]
    assert_tree_close(got, clipped, TOL)
    assert_tree_close(to_flax(state.model.state_dict(), ENC)["batch_stats"], new_bs, TOL)


def test_fit_trains_through_the_int8_forward(tmp_path):
    """``fit`` with ``quant_forward="int8"``: every blocks-1+ call is the
    int8 op, the losses are finite."""
    cfg = ExperimentConfig(
        data=DataConfig(seconds=0.128, downsampling=4),  # T 512: every pool divides
        encoder=EncoderConfig(filters=8, embedding_dim=8),
        train=TrainConfig(batch_size=8, num_steps=3, evaluate_every=3, num_eval_tasks=8,
                          quant_forward="int8", use_fused_block0=True,
                          log_path=str(tmp_path / "m.jsonl")))
    host = synthetic_store(0, n_speakers=6, utterances_per_speaker=3, min_seconds=0.15,
                           max_seconds=0.3)
    quants = []
    real = FusedBlocknTrain.forward

    def spy(ctx, *args):
        quants.append(args[-1])
        return real(ctx, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FusedBlocknTrain, "forward", staticmethod(spy))
        _, history = fit(cfg, host, device="cpu", verbose=False)
    assert quants == ["int8"] * 3 * 3  # blocks 1-3, 3 steps
    assert np.isfinite(history[-1]["loss"])


def raw_config(**data):
    return ExperimentConfig(data=DataConfig(seconds=0.25, downsampling=4, **data),
                            train=TrainConfig(use_pallas_preprocess=False))


def test_the_raw_store_chain_matches_the_jax_chain():
    """``use_pallas_preprocess=False``: the store stays raw (raw lengths,
    downsampling 0), and ``fetch_batch`` gathers, scales, decimates and
    whitens on the port's offsets as the JAX chain does on the same
    offsets."""
    cfg = raw_config()
    host = synthetic_store(3, n_speakers=3, utterances_per_speaker=3, min_seconds=0.2,
                           max_seconds=0.6)
    store = steps.device_store_for(cfg, host, "cpu")
    assert store.downsampling == 0 and torch.equal(store.lengths, torch.from_numpy(host.lengths))
    assert store.audio.shape[1] == max(host.audio.shape[1], cfg.data.fragment_length)
    idx = torch.tensor([4, 0, 8, 2, 2], dtype=torch.int32)
    got = steps.fetch_batch(store, idx, cfg, torch.Generator().manual_seed(9))
    offsets = preprocess.sample_offsets(store.lengths[idx.long()], cfg.data.fragment_length,
                                        torch.Generator().manual_seed(9))
    assert (offsets % cfg.data.downsampling != 0).any()  # the raw phases B1's store lacks
    d = cfg.data
    rows = jpre.gather_fragments(jnp.asarray(store.audio.numpy()), jnp.asarray(idx.numpy()),
                                 jnp.asarray(offsets.numpy()), d.fragment_length)
    rows = jpre.stride_decimate(rows.astype(jnp.float32) * jpre.INT16_SCALE, d.downsampling)
    want = jpre.whiten(rows, d.whiten_rms, d.whiten_eps)[..., None]
    assert got.shape == (5, d.model_length, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=CHAIN_TOL, atol=CHAIN_TOL)


@pytest.mark.parametrize("whiten_rms", [0.038021, None])
def test_fetch_batch_on_a_raw_store_matches_the_jax_fetch_batch(whiten_rms):
    cfg = raw_config(whiten_rms=whiten_rms)
    host = synthetic_store(4, n_speakers=3, utterances_per_speaker=2, min_seconds=0.2,
                           max_seconds=0.5)
    jstore = jsteps.DeviceStore.from_host(JaxAudioStore(**dataclasses.asdict(host)),
                                          pallas_downsampling=0,
                                          min_length=cfg.data.fragment_length)
    jcfg = jax_config(cfg)
    assert jsteps.device_store_for(jcfg, JaxAudioStore(**dataclasses.asdict(host))).pallas_ds == 0
    idx = np.array([5, 0, 3, 1, 2], np.int32)
    want = np.asarray(jsteps.fetch_batch(jstore, jnp.asarray(idx), jax.random.PRNGKey(0), jcfg,
                                         stochastic=False))
    got = steps.fetch_batch(steps.device_store_for(cfg, host, "cpu"), torch.from_numpy(idx),
                            cfg, stochastic=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=CHAIN_TOL, atol=CHAIN_TOL)


def test_the_store_follows_the_flag_and_fetch_follows_the_store():
    host = synthetic_store(5, n_speakers=2, utterances_per_speaker=2, min_seconds=0.2,
                           max_seconds=0.3)
    base = ExperimentConfig(data=DataConfig(seconds=0.1, downsampling=4))
    for flag, ds in ((None, 4), (True, 4), (False, 0)):
        cfg = base.replace(train=dataclasses.replace(base.train, use_pallas_preprocess=flag))
        assert steps.device_store_for(cfg, host, "cpu").downsampling == ds
    # a decimated store fed with a raw config still takes B1 (dispatch by
    # the store), and a raw store with any flag the plain chain
    decimated = steps.device_store_for(base, host, "cpu")
    raw = steps.device_store_for(raw_config(), host, "cpu")
    idx = torch.tensor([0, 3], dtype=torch.int32)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(steps, "gather_whiten", lambda *a, **k: calls.append(1) or torch.zeros(2, 1))
        steps.fetch_batch(decimated, idx, base.replace(train=raw_config().train),
                          stochastic=False)
        steps.fetch_batch(raw, idx, base, stochastic=False)
    assert calls == [1]


def test_conv_train_module_names_the_new_ops():
    assert conv_train.QUANT == ("none", "int8")
    x = torch.randn(2, 8, 16)
    args = [torch.randn(8, 8, 3), torch.zeros(8), torch.ones(8), torch.zeros(8)]
    with pytest.raises(ValueError):
        FusedBlocknTrain.apply(x, *args, 2, EPS, 1, torch.float32, "int4")
    with pytest.raises(ValueError):  # SAME padding of an even k is not symmetric
        FusedBlocknRecompute.apply(x, torch.randn(8, 8, 4), *args[1:], 2, EPS, 1,
                                   torch.float32)
