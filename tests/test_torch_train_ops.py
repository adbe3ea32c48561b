"""The fused train ops' ``autograd.Function`` classes against the JAX custom VJPs.

``FusedBlock0Train`` against ``make_fused_block0_train`` (the XLA core and
the Pallas cores in interpret mode) and ``FusedBlocknTrain`` against
``make_fused_blockn_train(save_act=True)`` with ``routing="pallas"`` in
interpret mode, at f32: the same numpy inputs and parameters, values and
``torch.autograd.grad`` against ``jax.grad`` of one scalar that reads the
pooled output, μ and σ², within 1e-4. Negative BatchNorm scales and dead
relu regions in every case. The port's blocks-1+ op takes and gives
``(B, C, T)`` tensors; the test transposes at its edge (the op lays its
tensors out channels last itself). Then the fused path's layout: the
residual is the raw conv output, channels last from block 0's output to the
head, with no copy between blocks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.ops.conv_train import make_fused_block0_train, make_fused_blockn_train
from voicemap_tpu_torch.config import classifier_baseline
from voicemap_tpu_torch.models import fused_train
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.ops import cuda_routing
from voicemap_tpu_torch.ops.conv_train import FusedBlock0Train, FusedBlocknTrain
from voicemap_tpu_torch.ops.cuda_routing import is_channels_last

EPS = 1e-3
TOL = 1e-4


def scalar(out, mu, var, gw):
    """Σ out·gw + 2Σμ + ½Σσ²: every output carries a cotangent."""
    return (out * gw).sum() + (mu * 2.0).sum() + (var * 0.5).sum()


def block0_params(seed, c=16):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((32, 1, c)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(c) * 0.3).astype(np.float32)
    b[::4] -= 0.5  # dead relu regions
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    gamma[1::3] *= -1.0
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return w, b, gamma, beta


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_fused_block0_matches_jax_custom_vjp(impl):
    B, T, c = 3, 256, 16
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((B, T, 1)) * 0.5).astype(np.float32)
    x[:, 60:100] = 0.0
    params = block0_params(2, c)
    gw = rng.standard_normal((B, T // 4, c)).astype(np.float32)

    fn = make_fused_block0_train(4, EPS, impl=impl, gemm_dtype="float32",
                                 sel_dtype="float32", interpret=True)

    def jloss(p):
        out, mu, var = fn(jnp.asarray(x), *p)
        return scalar(out, mu, var, jnp.asarray(gw)), (out, mu, var)

    (jl, jouts), jgrads = jax.value_and_grad(jloss, has_aux=True)(tuple(map(jnp.asarray, params)))

    tp = [torch.tensor(p, requires_grad=True) for p in params]
    outs = FusedBlock0Train.apply(torch.from_numpy(x), *tp, 4, EPS, torch.float32, torch.float32)
    loss = scalar(*outs, torch.from_numpy(gw))
    grads = torch.autograd.grad(loss, tp)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=TOL)
    for name, got, want in zip(("pooled", "mu", "var"), outs, jouts):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=name)
    for name, got, want in zip(("w", "b", "gamma", "beta"), grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_fused_block0_input_gets_no_gradient():
    x = torch.randn(2, 64, 1, requires_grad=True)
    tp = [torch.tensor(p, requires_grad=True) for p in block0_params(3, 8)]
    out, _, _ = FusedBlock0Train.apply(x, *tp, 4, EPS, torch.float32, torch.float32)
    gx, gw = torch.autograd.grad(out.sum(), [x, tp[0]], allow_unused=True)
    assert gx is None and gw is not None  # audio is data, as the TPU op's zeros say


@pytest.mark.parametrize("pool,dilation", [(2, 1), (2, 4), (1, 2), (4, 1)])
def test_fused_blockn_matches_jax_custom_vjp(pool, dilation):
    cin, cout, k, B, T = 6, 8, 3, 3, 64
    rng = np.random.default_rng(pool * 10 + dilation)
    x = rng.standard_normal((B, T, cin)).astype(np.float32)
    w = (rng.standard_normal((k, cin, cout)) * 0.4).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    gamma[::3] = -1.3
    beta = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    gw = rng.standard_normal((B, T // pool, cout)).astype(np.float32)

    fn = make_fused_blockn_train(pool, EPS, dilation=dilation, gemm_dtype="float32",
                                 sel_dtype="float32", save_act=True, routing="pallas",
                                 interpret=True)

    def jloss(xx, p):
        out, mu, var = fn(xx, *p)
        return scalar(out, mu, var, jnp.asarray(gw)), (out, mu, var)

    jparams = tuple(map(jnp.asarray, (w, b, gamma, beta)))
    (jl, jouts), (jgx, jgp) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jparams)

    tx = torch.tensor(x.transpose(0, 2, 1).copy(), requires_grad=True)  # (B, Cin, T)
    tp = [torch.tensor(w.transpose(2, 1, 0).copy(), requires_grad=True)] + [
        torch.tensor(p, requires_grad=True) for p in (b, gamma, beta)]
    out, mu, var = FusedBlocknTrain.apply(tx, *tp, pool, EPS, dilation, torch.float32)
    assert out.shape == (B, cout, T // pool)
    loss = scalar(out, mu, var, torch.from_numpy(gw.transpose(0, 2, 1).copy()))
    gx, *gp = torch.autograd.grad(loss, [tx, *tp])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=TOL)
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 1), np.asarray(jouts[0]),
                               rtol=TOL, atol=TOL)
    for name, got, want in (("mu", mu, jouts[1]), ("var", var, jouts[2])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=name)
    np.testing.assert_allclose(gx.numpy().transpose(0, 2, 1), np.asarray(jgx), rtol=TOL,
                               atol=TOL, err_msg="dx")
    np.testing.assert_allclose(gp[0].numpy().transpose(2, 1, 0), np.asarray(jgp[0]), rtol=TOL,
                               atol=TOL, err_msg="dw")
    for name, got, want in zip(("b", "gamma", "beta"), gp[1:], jgp[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_fused_blockn_refuses_asymmetric_same_padding():
    """k=4, dilation 1: SAME pads 1 left and 2 right, which cuDNN's padding
    cannot say; the op refuses and the train forward uses the plain block."""
    x = torch.randn(2, 3, 32)
    args = [torch.randn(5, 3, 4), torch.zeros(5), torch.ones(5), torch.zeros(5)]
    with pytest.raises(ValueError):
        FusedBlocknTrain.apply(x, *args, 2, EPS, 1, torch.float32)
    out, _, _ = FusedBlocknTrain.apply(x, torch.randn(5, 3, 3), *args[1:], 2, EPS, 2,
                                       torch.float32)
    assert out.shape == (2, 5, 16)


def test_fused_blockn_saves_the_raw_conv_output_channels_last():
    """The op's residual is the conv's output without bias and relu (B7 adds
    both as it reads it), the conv runs on channels-last tensors, and
    ``pooled`` and dX come back channels last."""
    cin, cout, k, B, T, pool = 6, 8, 3, 2, 32, 2
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(B, T, cin, generator=gen).permute(0, 2, 1).requires_grad_()
    w = (torch.randn(cout, cin, k, generator=gen) * 0.4).requires_grad_()
    b = torch.randn(cout, generator=gen).mul(0.5).requires_grad_()
    gamma, beta = torch.ones(cout, requires_grad=True), torch.zeros(cout, requires_grad=True)
    out, _, _ = FusedBlocknTrain.apply(x, w, b, gamma, beta, pool, EPS, 1, torch.float32)
    x4, w4, z, *_ = out.grad_fn.saved_tensors
    want_z = torch.nn.functional.conv1d(x.detach(), w.detach(), None, padding=1)
    torch.testing.assert_close(z, want_z, rtol=1e-6, atol=1e-6)
    a = torch.relu(want_z + b.detach()[:, None])
    assert (a == 0).any() and (z < 0).any() and not torch.allclose(z, a)
    assert x4.data_ptr() == x.data_ptr()  # channels last in the GEMM dtype: not copied
    for t4 in (x4, w4):
        assert t4.dim() == 4 and t4.is_contiguous(memory_format=torch.channels_last)
    assert is_channels_last(z) and is_channels_last(out)
    (gx,) = torch.autograd.grad((out * out).sum(), [x])
    assert is_channels_last(gx)


def test_fused_train_forward_hands_channels_last_tensors_without_copies():
    """Under ``blockn="fused"`` block 0's pooled output enters block 1 as a
    channels-last view (no transpose copy), every fused block's z, a_sel and
    cotangent are channels last, and no backward copies its cotangent."""
    cfg = classifier_baseline()
    enc = dataclasses.replace(cfg.encoder, filters=8, compute_dtype="bfloat16")
    model = SpeakerClassifier(enc, 5, device="cpu")
    seen = []

    def pool_spy(z, *a, _real=cuda_routing.pool_fwd):
        seen.append(("z", is_channels_last(z)))
        return _real(z, *a)

    def route_spy(z, b, sel, g, *a, _real=cuda_routing.route_bwd):
        seen.append(("g", is_channels_last(sel) and is_channels_last(g)))
        return _real(z, b, sel, g, *a)

    inputs = []
    real_apply = FusedBlocknTrain.apply

    def apply_spy(x, *a):
        inputs.append(x)
        return real_apply(x, *a)

    before = FusedBlocknTrain.cotangent_copies
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_routing, "pool_fwd", pool_spy)
        mp.setattr(cuda_routing, "route_bwd", route_spy)
        mp.setattr(fused_train.FusedBlocknTrain, "apply", apply_spy)
        x = torch.randn(4, 2048, 1, generator=torch.Generator().manual_seed(0))
        logits = fused_train.classifier_train_forward(model, x, torch.Generator().manual_seed(1),
                                                      blockn="fused")
        logits.sum().backward()
    assert seen == [("z", True)] * 3 + [("g", True)] * 3
    assert len(inputs) == 3 and all(is_channels_last(h) for h in inputs)
    assert inputs[0]._base is not None  # block 0's output, viewed, not copied
    assert FusedBlocknTrain.cotangent_copies == before
