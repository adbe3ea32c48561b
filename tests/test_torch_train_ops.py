"""The fused train ops' ``autograd.Function`` classes against the JAX custom VJPs.

``FusedBlock0Train`` against ``make_fused_block0_train`` (the XLA core and
the Pallas cores in interpret mode) and ``FusedBlocknTrain`` against
``make_fused_blockn_train(save_act=True)`` with ``routing="pallas"`` in
interpret mode, at f32: the same numpy inputs and parameters, values and
``torch.autograd.grad`` against ``jax.grad`` of one scalar that reads the
pooled output, μ and σ², within 1e-4, with no dropout mask, with an
all-keeping one, and with a mask that drops channels at keep 0.7 (the JAX
side applies ``where(mask, y / keep, 0)`` after its op). Negative BatchNorm scales and dead relu regions in every
case. At d > 1 in a bf16 GEMM both blocks-1+ ops take dW from
``ops/cuda_wgrad``: each against its JAX op in bf16 at pool 1. The port's blocks-1+ op takes and gives ``(B, C, T)`` tensors; the
test transposes at its edge (the op lays its tensors out channels last
itself). Then the fused path's layout: the residual is the raw conv output,
channels last from block 0's output to the head, with no copy between
blocks. Then the pool-rate epilogue (``cuda_routing.bn_apply``/``bn_grad``)
inside each op against the chain it replaced, ``spatial_dropout(pooled.to(
dtype))`` after the op, bit for bit, and the fused forward's dropout draws
against the benchmark reference's ``draw_step``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.ops.conv_train import make_fused_block0_train, make_fused_blockn_train
from portbench.reference.conv1d_encoder import draw_step
from voicemap_tpu_torch.config import classifier_baseline
from voicemap_tpu_torch.models import fused_train
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.models.encoder import spatial_dropout
from voicemap_tpu_torch.ops import cuda_conv_train, cuda_routing, cuda_wgrad
from voicemap_tpu_torch.ops.conv_train import (
    FusedBlock0Train, FusedBlocknRecompute, FusedBlocknTrain,
)
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


MASKS = ["none", "all_kept", "keep_0.7"]


def epilogue(mask: str, B: int, c: int) -> tuple:
    """The ops' trailing ``(out_dtype, mask, keep)``: f32 out, and no mask,
    one that keeps every channel at keep 1 (the same values), or one that
    drops some channels of every row at keep 0.7."""
    if mask == "none":
        return torch.float32, None, 1.0
    if mask == "all_kept":
        return torch.float32, torch.ones(B, c), 1.0
    m = (torch.rand(B, c, generator=torch.Generator().manual_seed(B * c)) < 0.7).float()
    m[:, 0], m[:, 1] = 0.0, 1.0
    return torch.float32, m, 0.7


def jax_dropout(out, tail):
    """``where(mask, out / keep, 0)`` on a JAX ``(B, T', C)`` output, for the
    port's trailing ``(out_dtype, mask, keep)``."""
    _, mask, keep = tail
    if mask is None:
        return out
    return jnp.where(jnp.asarray(mask.numpy())[:, None, :] != 0, out / keep, 0.0)


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_fused_block0_matches_jax_custom_vjp(impl, mask):
    B, T, c = 3, 256, 16
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((B, T, 1)) * 0.5).astype(np.float32)
    x[:, 60:100] = 0.0
    params = block0_params(2, c)
    gw = rng.standard_normal((B, T // 4, c)).astype(np.float32)

    fn = make_fused_block0_train(4, EPS, impl=impl, gemm_dtype="float32",
                                 sel_dtype="float32", interpret=True)
    tail = epilogue(mask, B, c)

    def jloss(p):
        out, mu, var = fn(jnp.asarray(x), *p)
        out = jax_dropout(out, tail)
        return scalar(out, mu, var, jnp.asarray(gw)), (out, mu, var)

    (jl, jouts), jgrads = jax.value_and_grad(jloss, has_aux=True)(tuple(map(jnp.asarray, params)))

    tp = [torch.tensor(p, requires_grad=True) for p in params]
    outs = FusedBlock0Train.apply(torch.from_numpy(x), *tp, 4, EPS, torch.float32, torch.float32,
                                  *tail)
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
    out, _, _ = FusedBlock0Train.apply(x, *tp, 4, EPS, torch.float32, torch.float32,
                                       torch.float32, None, 1.0)
    gx, gw = torch.autograd.grad(out.sum(), [x, tp[0]], allow_unused=True)
    assert gx is None and gw is not None  # audio is data, as the TPU op's zeros say


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("pool,dilation", [(2, 1), (2, 4), (1, 2), (4, 1)])
def test_fused_blockn_matches_jax_custom_vjp(pool, dilation, mask):
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
    tail = epilogue(mask, B, cout)

    def jloss(xx, p):
        out, mu, var = fn(xx, *p)
        out = jax_dropout(out, tail)
        return scalar(out, mu, var, jnp.asarray(gw)), (out, mu, var)

    jparams = tuple(map(jnp.asarray, (w, b, gamma, beta)))
    (jl, jouts), (jgx, jgp) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jparams)

    tx = torch.tensor(x.transpose(0, 2, 1).copy(), requires_grad=True)  # (B, Cin, T)
    tp = [torch.tensor(w.transpose(2, 1, 0).copy(), requires_grad=True)] + [
        torch.tensor(p, requires_grad=True) for p in (b, gamma, beta)]
    out, mu, var = FusedBlocknTrain.apply(tx, *tp, pool, EPS, dilation, torch.float32, "none",
                                          *tail)
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


# A bf16 GEMM at d > 1 takes dW from ops/cuda_wgrad (its plain version on
# the CPU), in f32; the JAX custom VJP's dW is the bf16 conv transpose's,
# rounded to bf16 (2^-9 of each element) after sums in XLA's order: each
# element within 2^-7 of it, and 2^-12 of the largest. The pool-rate-residual
# op is held to its JAX op in norm, to 1e-2: that op computes dz from the
# BatchNorm constants rounded to bf16 (routing="xla"), 0.4% of the norm of
# dz, dX and dW alike at these inputs, where the port keeps them in f32.
WGRAD_ELEMENT_RTOL, WGRAD_MAX_ATOL, WGRAD_NORM_TOL = 2.0 ** -7, 2.0 ** -12, 1e-2


@pytest.mark.parametrize("dilation", [2, 16])
@pytest.mark.parametrize("kind", ["fused", "fused_recompute"])
def test_fused_blockn_bf16_dilated_weight_gradient_matches_jax_custom_vjp(kind, dilation):
    """Pool 1, as config #3's dilated blocks, in a bf16 GEMM: one call of
    ``conv_wgrad`` a backward, dW and dX against the JAX custom VJP."""
    B, T, cin, cout, pool = 3, 150, 24, 16, 1
    rng = np.random.default_rng(100 + dilation)
    x = rng.standard_normal((B, T, cin)).astype(np.float32)
    w = (rng.standard_normal((3, cin, cout)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    gamma[::3] = -1.3
    beta = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    gw = rng.standard_normal((B, T, cout)).astype(np.float32)
    save_act = kind == "fused"
    fn = make_fused_blockn_train(pool, EPS, dilation=dilation, gemm_dtype="bfloat16",
                                 sel_dtype="bfloat16", save_act=save_act,
                                 routing="pallas" if save_act else "xla", interpret=True)

    def jloss(xx, p):
        out, mu, var = fn(xx, *p)
        return scalar(out, mu, var, jnp.asarray(gw))

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                tuple(map(jnp.asarray, (w, b, gamma, beta))))
    tx = torch.tensor(x.transpose(0, 2, 1).copy(), requires_grad=True)
    tp = [torch.tensor(w.transpose(2, 1, 0).copy(), requires_grad=True)] + [
        torch.tensor(p, requires_grad=True) for p in (b, gamma, beta)]
    op, extra = (FusedBlocknTrain, ("none",)) if save_act else (FusedBlocknRecompute, ())
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        real = cuda_wgrad.conv_wgrad
        mp.setattr(cuda_wgrad, "conv_wgrad", lambda *a: (calls.append(a[3]), real(*a))[1])
        out, mu, var = op.apply(tx, *tp, pool, EPS, dilation, torch.bfloat16, *extra,
                                torch.float32, None, 1.0, 1)
        loss = scalar(out, mu, var, torch.from_numpy(gw.transpose(0, 2, 1).copy()))
        gx, *gp = torch.autograd.grad(loss, [tx, *tp])
    assert calls == [dilation]
    dw, jdw = gp[0].numpy().transpose(2, 1, 0), np.asarray(jgp[0])
    dx, jdx = gx.numpy().transpose(0, 2, 1), np.asarray(jgx)
    if save_act:
        np.testing.assert_allclose(dw, jdw, rtol=WGRAD_ELEMENT_RTOL,
                                   atol=WGRAD_MAX_ATOL * np.abs(jdw).max(), err_msg="dw")
        np.testing.assert_allclose(dx, jdx, rtol=TOL, atol=TOL, err_msg="dx")
    else:
        for name, got, want in (("dw", dw, jdw), ("dx", dx, jdx)):
            assert np.linalg.norm(got - want) <= WGRAD_NORM_TOL * np.linalg.norm(want), name


def test_fused_blockn_refuses_asymmetric_same_padding():
    """k=4, dilation 1: SAME pads 1 left and 2 right, which cuDNN's padding
    cannot say; the op refuses and the train forward uses the plain block."""
    x = torch.randn(2, 3, 32)
    args = [torch.randn(5, 3, 4), torch.zeros(5), torch.ones(5), torch.zeros(5)]
    with pytest.raises(ValueError):
        FusedBlocknTrain.apply(x, *args, 2, EPS, 1, torch.float32, "none", torch.float32, None,
                               1.0)
    out, _, _ = FusedBlocknTrain.apply(x, torch.randn(5, 3, 3), *args[1:], 2, EPS, 2,
                                       torch.float32, "none", torch.float32, None, 1.0)
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
    out, _, _ = FusedBlocknTrain.apply(x, w, b, gamma, beta, pool, EPS, 1, torch.float32,
                                       "none", torch.float32, None, 1.0)
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


# The ops with their epilogue against the chain that ran after them before:
# block 0 at pool 4; blocks 1+ at pools 4, 2 and 1 (dilation 2 at pool 1),
# in the int8 forward and in the pool-rate-residual op.
EPILOGUE_CASES = [("block0", 4, 1), ("fused", 4, 1), ("fused", 2, 1), ("fused", 1, 2),
                  ("fused_int8", 2, 1), ("fused_recompute", 2, 1)]
RATE = 0.3  # many dropped channels at these widths


def epilogue_op_inputs(kind, pool, dilation, dtype, seed=0):
    """``(op, leading args, cotangent of y, (B, C), channel_dim)`` at a size
    the CPU runs in a second; C = 24 so that 16 bytes of any dtype divide it.
    The GEMM dtype is the train forward's: bf16 under an f16 compute dtype."""
    gen = torch.Generator().manual_seed(seed)
    B, c = 3, 24
    gemm = fused_train._gemm_dtype(dtype)
    if kind == "block0":
        w, b, gamma, beta = (torch.from_numpy(p) for p in block0_params(seed, c))
        x = torch.randn(B, 256, 1, generator=gen) * 0.5
        args = [x, w, b, gamma, beta, pool, EPS, gemm, gemm]
        gy = torch.randn(B, 256 // pool, c, generator=gen).to(dtype)
        return FusedBlock0Train, args, gy, (B, c), 2
    cin, T = 16, 96
    x = torch.randn(B, T, cin, generator=gen).to(dtype).permute(0, 2, 1)  # as the forward hands it
    w = torch.randn(c, cin, 3, generator=gen) * 0.3
    b = torch.randn(c, generator=gen) * 0.3
    gamma = torch.rand(c, generator=gen) + 0.5
    gamma[::3] *= -1.0
    beta = torch.randn(c, generator=gen) * 0.1
    args = [x, w, b, gamma, beta, pool, EPS, dilation, gemm]
    if kind != "fused_recompute":
        args.append("int8" if kind == "fused_int8" else "none")
    gy = torch.randn(B, T // pool, c, generator=gen).to(dtype).permute(0, 2, 1)
    return FusedBlocknRecompute if kind == "fused_recompute" else FusedBlocknTrain, args, gy, \
        (B, c), 1


def run_op(op, args, gy, tail, spied, after=None):
    """One forward and backward with the trailing ``(out_dtype, mask, keep)``
    and ``after`` applied to ``y`` → ``(y, μ, σ², grads of the float
    inputs, the f32 cotangent handed to B5 or B7)``."""
    leaves = [a.detach().clone().requires_grad_() if torch.is_tensor(a) and a.is_floating_point()
              else a for a in args]
    y, mu, var = op.apply(*leaves, *tail)
    if after is not None:
        y = after(y)
    loss = (y.float() * gy.float()).sum() + (mu * 2.0).sum() + (var * 0.5).sum()
    spied.clear()
    grads = torch.autograd.grad(loss, [a for a in leaves if torch.is_tensor(a)
                                       and a.requires_grad], allow_unused=True)
    return y, mu, var, grads, spied[0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16],
                         ids=["bf16", "f32", "f16"])
@pytest.mark.parametrize("kind,pool,dilation", EPILOGUE_CASES)
def test_the_epilogue_equals_the_chain_it_replaced(kind, pool, dilation, dtype):
    """The op given the keep mask and the compute dtype against the op in
    f32 with no mask followed by ``spatial_dropout(pooled.to(dtype))`` on a
    generator of the same seed: ``y`` bit for bit (and its layout), the f32
    cotangent that B5 or B7 reads bit for bit, every gradient and μ, σ²
    equal."""
    op, args, gy, (B, c), channel_dim = epilogue_op_inputs(kind, pool, dilation, dtype)
    spied = []
    with pytest.MonkeyPatch.context() as mp:
        route, b5 = cuda_routing.route_bwd, cuda_conv_train.conv_block0_train_bwd
        mp.setattr(cuda_routing, "route_bwd",
                   lambda *a: (spied.append(a[3]), route(*a))[1])
        mp.setattr(cuda_conv_train, "conv_block0_train_bwd",
                   lambda *a: (spied.append(a[4]), b5(*a))[1])
        mask = fused_train.keep_mask(torch.Generator().manual_seed(7), RATE, B, c,
                                     channel_dim, "cpu")
        assert mask.shape == (B, c) and 0 < int(mask.sum()) < B * c
        new = run_op(op, args, gy, (dtype, mask, 1.0 - RATE), spied)

        def old_chain(pooled):
            assert pooled.dtype == torch.float32
            return spatial_dropout(pooled.to(dtype), RATE, torch.Generator().manual_seed(7),
                                   channel_dim=channel_dim)

        old = run_op(op, args, gy, (torch.float32, None, 1.0), spied, old_chain)
    y_new, y_old = new[0], old[0]
    assert y_new.dtype == y_old.dtype == dtype and y_new.stride() == y_old.stride()
    assert torch.equal(y_new, y_old)
    assert (y_new == 0).any()  # dropped channels
    assert new[4].dtype == torch.float32 and torch.equal(new[4], old[4])
    for got, want in zip((new[1], new[2], *new[3]), (old[1], old[2], *old[3])):
        assert (got is None) == (want is None)
        if got is not None:
            assert torch.equal(got, want)


@pytest.mark.parametrize("blockn", fused_train.BLOCKN)
def test_the_fused_forward_draws_the_masks_the_reference_replays(blockn):
    """The fused ops' masks come from the generator as ``spatial_dropout``
    drew them: after ``draw_step``'s ids and starts, the forward leaves the
    generator where ``draw_step`` leaves it after its four mask draws, and
    each fused block's mask is the reference's for that block."""
    enc = dataclasses.replace(classifier_baseline().encoder, filters=8)
    assert enc.dropout > 0
    model = SpeakerClassifier(enc, 5, device="cpu")
    B, T, n_utts = 4, 2048, 10
    lengths = torch.full((n_utts,), T)
    channels = [enc.filters * m for m in enc.filter_multipliers]
    ref = torch.Generator().manual_seed(11)
    _, _, masks = draw_step(ref, n_utts, lengths, B, T, channels, enc.dropout)
    gen = torch.Generator().manual_seed(11)
    draw_step(gen, n_utts, lengths, B, T, channels, 0.0)  # the ids and the starts alone
    seen = []
    real = fused_train.keep_mask
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_train, "keep_mask", lambda *a: seen.append(real(*a)) or seen[-1])
        x = torch.randn(B, T, 1, generator=torch.Generator().manual_seed(0))
        fused_train.classifier_train_forward(model, x, gen, blockn=blockn)
    assert torch.equal(gen.get_state(), ref.get_state())
    assert len(seen) == (1 if blockn == "jnp" else 4)  # jnp's blocks 1+ draw in spatial_dropout
    for got, want in zip(seen, masks):
        assert torch.equal(got, want)


def test_the_epilogue_ops_refuse_what_their_kernels_cannot_read():
    """Both ops take contiguous (B, T', C) memory, (C,) channel vectors and a
    contiguous (B, C) f32 mask on one device; the CPU path counts no launch."""
    sel, v = torch.randn(2, 5, 8), torch.zeros(8)
    before = (cuda_routing.bn_apply.launches, cuda_routing.bn_grad.launches)
    bad = [dict(sel=sel.permute(0, 2, 1)), dict(mu=torch.zeros(7)),
           dict(mask=torch.ones(2, 7)), dict(mask=torch.ones(2, 8, dtype=torch.bool)),
           dict(mask=torch.ones(8, 2).t())]
    for change in bad:
        a = dict(sel=sel, mu=v, mask=None)
        a.update(change)
        with pytest.raises(ValueError):
            cuda_routing.bn_apply(a["sel"], a["mu"], v, v, a["mask"], 0.9, torch.float32)
        with pytest.raises(ValueError):
            cuda_routing.bn_grad(a["sel"].contiguous(), a["sel"], a["mask"], 0.9, a["mu"], v)
    with pytest.raises(ValueError):
        cuda_routing.bn_grad(sel[:, :4], sel, None, 1.0, v, v)
    y = cuda_routing.bn_apply(sel, v, v + 1.0, v, torch.ones(2, 8), 0.5, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.equal(y, (sel / 0.5).to(torch.bfloat16))
    g, s1, s2 = cuda_routing.bn_grad(y, sel, None, 1.0, v, v + 1.0)
    assert g.dtype == torch.float32 and torch.equal(g, y.float())
    torch.testing.assert_close(s1, g.sum((0, 1)))
    torch.testing.assert_close(s2, (g * sel).sum((0, 1)))
    assert (cuda_routing.bn_apply.launches, cuda_routing.bn_grad.launches) == before


def test_the_kernels_take_the_reciprocal_cuda_divides_by():
    """On the card PyTorch divides by a host scalar as a product with the f32
    reciprocal of the f32 scalar; the kernels are handed that reciprocal."""
    for keep in (0.95, 0.7, 0.5, 1.0 - 0.05, 1.0 - 1e-3):
        want = np.float32(1.0) / np.float32(keep)
        assert cuda_routing._inv_keep(keep) == float(want)
