"""The BatchNorm epilogue pair on the card (``ops/cuda_routing.bn_apply`` and
``bn_grad``, ``csrc/routing.cu``) against the eager chain it replaced. Run on
a machine with a card, from the repository root:

    python -m pytest --noconftest -m card tests/test_torch_bn_epilogue_card.py -q

(``--noconftest``: the suite's ``conftest.py`` imports JAX, which these tests
do not need.) Without a card every test skips.

- The kernels at config #1's four pool-rate shapes, which config #3's pool-1
  blocks (dilations 2, 4, 8 and 16) share, at B = 32 and 2048, bf16, f32
  and f16 (an f16 compute dtype's ``y`` and cotangent over a bf16 ``a_sel``,
  the GEMM's dtype), with and without a dropout mask: ``y`` and the f32 cotangent ``g'`` bit
  for bit against ``spatial_dropout(pooled.to(dtype))`` and its autograd
  gradient, ``Σg'`` and ``Σg'·â`` within their summation-order bound of the
  float64 sums, as the eager sums are.
- The ops with the pair inside, at config #1's block 0 and config #3's
  pool-1 blocks 1 (d = 2) and 7 (d = 16), bf16 and f16 with dropout 0.05,
  B = 32 and 2048, against the op without the epilogue and the eager chain after it:
  ``y`` and the cotangent B5 or B7 reads bit for bit, every gradient within
  ``GRAD_REL`` of its norm (only the f32 sums' order differs).
"""

import pytest
import torch

from voicemap_tpu_torch.models import fused_train
from voicemap_tpu_torch.models.encoder import spatial_dropout
from voicemap_tpu_torch.ops import cuda_conv_train, cuda_routing
from voicemap_tpu_torch.ops.conv_train import FusedBlock0Train, FusedBlocknTrain

SHAPES = [(3000, 128), (1500, 256), (750, 384), (375, 512)]  # (T', C)
RATE = 0.05
EPS = 1e-3
SUM_BOUND = 1e-4  # of Σ|term|: 2^-24 times a summation depth of ~1,700
GRAD_REL = 1e-3
BITS = {torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.float32: torch.int32}
DTYPES = [torch.bfloat16, torch.float32, torch.float16]


def sel_dtype(dtype):
    """``a_sel``'s dtype, the GEMM's, under a compute dtype: bf16 under f16."""
    return torch.bfloat16 if dtype == torch.float16 else dtype


@pytest.fixture
def card():
    """Skip the test where there is no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(BITS[a.dtype]),
                                              b.contiguous().view(BITS[b.dtype]))


def within_order(got: torch.Tensor, terms: torch.Tensor) -> bool:
    """``got`` (C,) within SUM_BOUND·Σ|term| of the float64 sum of
    ``terms`` over every axis but the last."""
    exact = terms.double().sum((0, 1))
    return bool(((got.double() - exact).abs()
                 <= SUM_BOUND * terms.double().abs().sum((0, 1))).all())


def epilogue_inputs(B, tp, c, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sel = (torch.randn(B, tp, c, device="cuda", generator=gen) * 1.5 + 0.3).relu().to(
        sel_dtype(dtype))
    mu = sel.float().mean((0, 1))
    r = torch.rsqrt(sel.float().var((0, 1), unbiased=False) + EPS)
    gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
    gamma[::3] *= -1.0
    beta = torch.randn(c, device="cuda", generator=gen) * 0.1
    gy = torch.randn(B, tp, c, device="cuda", generator=gen).to(dtype)
    return sel, mu, r, gamma * r, beta, gy


@pytest.mark.card
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32", "f16"])
@pytest.mark.parametrize("B", [32, 2048])
@pytest.mark.parametrize("tp,c", SHAPES)
def test_the_kernels_equal_the_eager_chain(card, tp, c, B, dtype, masked):
    sel, mu, r, scale, beta, gy = epilogue_inputs(B, tp, c, dtype, tp + c + B)
    rate = RATE if masked else 0.0
    mask = fused_train.keep_mask(torch.Generator(device="cuda").manual_seed(c), rate, B, c, 2,
                                 "cuda")
    launches = (cuda_routing.bn_apply.launches, cuda_routing.bn_grad.launches)
    y = cuda_routing.bn_apply(sel, mu, scale, beta, mask, 1.0 - rate, dtype)
    g, s1, s2 = cuda_routing.bn_grad(gy, sel, mask, 1.0 - rate, mu, r)
    assert (cuda_routing.bn_apply.launches, cuda_routing.bn_grad.launches) == (
        launches[0] + 1, launches[1] + 1)

    pooled = ((sel.float() - mu) * scale + beta).requires_grad_()
    want = spatial_dropout(pooled.to(dtype), rate,
                           torch.Generator(device="cuda").manual_seed(c), channel_dim=2)
    (g_want,) = torch.autograd.grad(want, pooled, gy)
    assert same_bits(y, want.detach())
    assert same_bits(g, g_want)
    ahat = (sel.float() - mu) * r
    assert within_order(s1, g_want)
    assert within_order(s2, g_want * ahat)
    assert within_order(g_want.sum((0, 1)), g_want)  # the eager sums' own order


def spied_cotangents(monkeypatch, seen):
    """B7's and B5's wrappers, recording the f32 cotangent each is handed; a
    wrapper counts its launches on its module's name, so the stand-in carries
    its counters."""
    for mod, name, at in ((cuda_routing, "route_bwd", 3),
                          (cuda_conv_train, "conv_block0_train_bwd", 4)):
        def spy(*a, _real=getattr(mod, name), _at=at):
            seen.append(a[_at])
            return _real(*a)
        spy.__dict__.update(vars(getattr(mod, name)))
        monkeypatch.setattr(mod, name, spy)


def op_inputs(block, B, dtype):
    """Config #1's block 0, or config #3's block 1 (128 → 128, T' 3000, d 2)
    or 7 (512 → 512, T' 375, d 16), in the compute dtype ``dtype`` (bf16
    GEMMs): ``(op, leading args, cotangent, channel_dim)``."""
    gen = torch.Generator(device="cuda").manual_seed(B + block)
    bf = torch.bfloat16
    if block == 0:
        c = 128
        x = torch.randn(B, 12000, 1, device="cuda", generator=gen) * 0.3
        w = torch.randn(32, 1, c, device="cuda", generator=gen) * 0.2
        args = [x, w]
        gy = torch.randn(B, 3000, c, device="cuda", generator=gen).to(dtype)
    else:
        c, T, d = (128, 3000, 2) if block == 1 else (512, 375, 16)
        x = torch.randn(B, T, c, device="cuda", generator=gen).relu().to(dtype).permute(0, 2, 1)
        w = torch.randn(c, c, 3, device="cuda", generator=gen) * (1.0 / (3 * c) ** 0.5)
        args = [x, w]
        gy = torch.randn(B, T, c, device="cuda", generator=gen).to(dtype).permute(0, 2, 1)
    b = torch.randn(c, device="cuda", generator=gen) * 0.1
    gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
    gamma[1::3] *= -1.0
    beta = torch.randn(c, device="cuda", generator=gen) * 0.1
    args += [b, gamma, beta]
    if block == 0:
        return FusedBlock0Train, args + [4, EPS, bf, bf], gy, 2, c
    return FusedBlocknTrain, args + [1, EPS, d, bf, "none"], gy, 1, c


def run(op, args, gy, tail, after=None):
    leaves = [a.detach().clone().requires_grad_() if a.is_floating_point() else a
              for a in args[:5]]
    y, mu, var = op.apply(*leaves, *args[5:], *tail)
    if after is not None:
        y = after(y)
    loss = (y.float() * gy.float()).sum() + mu.sum() + var.sum()
    grads = torch.autograd.grad(loss, [t for t in leaves if t.requires_grad], allow_unused=True)
    return y.detach(), grads


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("B", [32, 2048])
@pytest.mark.parametrize("block", [0, 1, 7])
def test_the_ops_equal_the_eager_chain_after_them(card, monkeypatch, block, B, dtype):
    op, args, gy, channel_dim, c = op_inputs(block, B, dtype)
    seen = []
    spied_cotangents(monkeypatch, seen)
    mask = fused_train.keep_mask(torch.Generator(device="cuda").manual_seed(B), RATE, B, c,
                                 channel_dim, "cuda")
    y, grads = run(op, args, gy, (dtype, mask, 1.0 - RATE))

    def old_chain(pooled):
        return spatial_dropout(pooled.to(dtype), RATE,
                               torch.Generator(device="cuda").manual_seed(B),
                               channel_dim=channel_dim)

    y_old, grads_old = run(op, args, gy, (torch.float32, None, 1.0), old_chain)
    assert y.stride() == y_old.stride() and same_bits(y, y_old)
    assert len(seen) == 2 and same_bits(seen[0], seen[1])
    for got, want in zip(grads, grads_old):
        assert (got is None) == (want is None)
        if got is not None:
            rel = float((got.double() - want.double()).norm() / want.double().norm())
            assert rel <= GRAD_REL, rel
