"""B4, B5 and B7's plain versions against the TPU kernels' own code, on the CPU.

``conv_block0_train_reference`` and ``conv_block0_train_bwd_reference`` (the
plain versions of ``csrc/conv_block0_train.cu``) against
``pallas_fwd_core`` / ``pallas_bwd_core`` with ``interpret=True`` and the
JAX package's ``_xla_fwd_core`` / ``_xla_bwd_core``; ``pool_fwd_reference``
and ``route_bwd_reference`` (``csrc/routing.cu``) against
``pallas_pool_fwd`` / ``pallas_route_bwd`` with ``interpret=True``. Small
sizes: B ≤ 3, T = 256, C = 16 for block 0; C = 6 and 8, T = 64 for B7.

Tolerances: at f32 the selected values of B7 are exact (a selection of
given values); B4's a_sel, the statistics, dW and db differ only in the sum
order, ≤ 1e-5 of the largest magnitude; dz ≤ 1e-6 of it (XLA on the CPU may
contract ``c0·g + c1 + c2·a`` into FMAs). At bf16, a_sel and dz within 1
bf16 ulp. Every case has negative BatchNorm scales, dead relu regions and
tied pool phases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_conv_block0 import bf16_ulps
from voicemap_tpu.ops.conv_train import _xla_bwd_core, _xla_fwd_core
from voicemap_tpu.ops.pallas_conv_train import pallas_bwd_core, pallas_fwd_core
from voicemap_tpu.ops.pallas_routing import pallas_pool_fwd, pallas_route_bwd
from voicemap_tpu_torch.ops.cuda_conv_train import (
    conv_block0_train, conv_block0_train_bwd, conv_block0_train_bwd_reference,
    conv_block0_train_reference,
)
from voicemap_tpu_torch.ops.cuda_routing import (
    pool_fwd, pool_fwd_reference, route_bwd, route_bwd_reference,
)

C = 16
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def assert_rel(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (name, err, np.abs(want).max())


def block0_case(seed, B=2, T=256):
    """x with a silent stretch (every phase equal there: live ties where the
    bias is positive), biases of both signs (dead regions), and signs of γ
    mixed."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, 1)) * 0.5).astype(np.float32)
    x[:, 40:120] = 0.0
    w = (rng.standard_normal((32, 1, C)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(C) * 0.3).astype(np.float32)
    b[:4] = [0.2, -0.4, 0.1, -0.6]
    sgn = np.where(np.arange(C) % 3 == 0, -1.0, 1.0).astype(np.float32)
    g = rng.standard_normal((B, T // 4, C)).astype(np.float32)
    c = [(rng.standard_normal(C) * s).astype(np.float32) for s in (1.0, 0.1, 0.05)]
    return x, w, b, sgn, g, c


def t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b4_plain_matches_pallas_interpret(dtype):
    tdt, jdt = DTYPES[dtype]
    x, w, b, sgn, _, _ = block0_case(0)
    got = conv_block0_train_reference(*t(x, w, b, sgn), pool=4, gemm_dtype=tdt, sel_dtype=tdt)
    want = pallas_fwd_core(*map(jnp.asarray, (x, w, b, sgn)), pool=4, gemm_dtype=jdt,
                           sel_dtype=jdt, t_chunk=32, block_rows=2, interpret=True)
    sel, want_sel = got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32))
    if dtype == "float32":
        assert_rel(sel, want_sel, 1e-5, "a_sel")
    else:
        assert got[0].dtype == torch.bfloat16 and bf16_ulps(sel, want_sel) <= 1
    for name, g_, w_ in zip(("sum", "sumsq", "count"), got[1:], want[1:]):
        assert_rel(g_.numpy(), w_, 1e-5, name)


def test_b4_plain_matches_xla_core_at_f32():
    x, w, b, sgn, _, _ = block0_case(1, B=3)
    got = conv_block0_train_reference(*t(x, w, b, sgn), pool=4, gemm_dtype=torch.float32,
                                      sel_dtype=torch.float32)
    want = _xla_fwd_core(*map(jnp.asarray, (x, w, b, sgn)), pool=4, dtype=jnp.float32)
    assert got[0].shape == (3, 64, C)
    for name, g_, w_ in zip(("a_sel", "sum", "sumsq", "count"), got, want):
        assert_rel(g_.numpy(), w_, 1e-5, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b5_plain_matches_pallas_interpret(dtype):
    tdt, jdt = DTYPES[dtype]
    x, w, b, sgn, g, (c0, c1, c2) = block0_case(2)
    dw, db = conv_block0_train_bwd_reference(*t(x, w, b, sgn, g, c0, c1, c2), pool=4,
                                             gemm_dtype=tdt)
    want_dw, want_db = pallas_bwd_core(*map(jnp.asarray, (x, w, b, sgn, g, c0, c1, c2)),
                                       pool=4, gemm_dtype=jdt, t_chunk=32, interpret=True)
    assert dw.shape == (32, 1, C) and db.shape == (C,)
    # bf16 too: both round g and dz to bf16 at the same places.
    assert_rel(dw.numpy(), want_dw, 1e-5, "dw")
    assert_rel(db.numpy(), want_db, 1e-5, "db")


def test_b5_plain_matches_xla_core_at_f32():
    """At f32 nothing is rounded: the plain version is ``_xla_bwd_core``."""
    x, w, b, sgn, g, (c0, c1, c2) = block0_case(3, B=3)
    dw, db = conv_block0_train_bwd_reference(*t(x, w, b, sgn, g, c0, c1, c2), pool=4,
                                             gemm_dtype=torch.float32)
    want_dw, want_db = _xla_bwd_core(*map(jnp.asarray, (x, w, b, sgn, g, c0, c1, c2)),
                                     pool=4, dtype=jnp.float32)
    assert_rel(dw.numpy(), want_dw, 1e-5, "dw")
    assert_rel(db.numpy(), want_db, 1e-5, "db")


def routing_case(seed, B, T, c, pool, dtype):
    """A relu activation on a coarse grid (many exact ties between phases,
    many zeros), signs of γ mixed, cotangent and constants."""
    rng = np.random.default_rng(seed)
    a = np.maximum(np.round(rng.standard_normal((B, T, c)) * 2.0) / 2.0, 0.0)
    a = (a * rng.uniform(0.5, 1.5, c)).astype(np.float32)
    a = np.asarray(jnp.asarray(a).astype(dtype).astype(jnp.float32))
    sgn = np.where(np.arange(c) % 3 == 1, -1.0, 1.0).astype(np.float32)
    g = rng.standard_normal((B, T // pool, c)).astype(np.float32)
    consts = [(rng.standard_normal(c) * s).astype(np.float32) for s in (1.0, 0.1, 0.05)]
    return a, sgn, g, consts


def nct(a, dtype):
    """JAX (B, T, C) numpy → the port's (B, C, T) tensor."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1))).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,pool", [(8, 2), (6, 4)])
def test_b7_plain_matches_pallas_interpret(dtype, c, pool):
    tdt, jdt = DTYPES[dtype]
    B, T = 3, 64
    a, sgn, g, (c0, c1, c2) = routing_case(c + pool, B, T, c, pool, jdt)
    aj = jnp.asarray(a).astype(jdt)
    want_sel, want_s1, want_s2 = pallas_pool_fwd(aj, jnp.asarray(sgn), pool, sel_dtype=jdt,
                                                 interpret=True)
    sel, s1, s2 = pool_fwd_reference(nct(a, tdt), torch.from_numpy(sgn), pool, tdt)
    assert sel.dtype == tdt and sel.shape == (B, c, T // pool)
    np.testing.assert_array_equal(sel.float().numpy().transpose(0, 2, 1),
                                  np.asarray(want_sel.astype(jnp.float32)))
    assert_rel(s1.numpy(), want_s1, 1e-5, "sum")
    assert_rel(s2.numpy(), want_s2, 1e-5, "sumsq")

    want_dz, want_db = pallas_route_bwd(aj, want_sel, jnp.asarray(g), *map(jnp.asarray,
                                        (c0, c1, c2)), pool, out_dtype=jdt, interpret=True)
    dz, db = route_bwd_reference(nct(a, tdt), sel, nct(g, torch.float32),
                                 *t(c0, c1, c2), pool, tdt)
    assert dz.dtype == tdt and dz.shape == (B, c, T)
    got_dz = dz.float().numpy().transpose(0, 2, 1)
    want_dz = np.asarray(want_dz.astype(jnp.float32))
    if dtype == "float32":
        assert_rel(got_dz, want_dz, 1e-6, "dz")
    else:
        assert bf16_ulps(got_dz, want_dz) <= 1
    assert_rel(db.numpy(), want_db, 1e-5, "db")


def test_b7_routing_goes_to_the_first_equal_phase():
    a = torch.tensor([[[1.0, 1.0, 0.0, 2.0, 3.0, 3.0]]])  # (1, 1, 6), pool 2
    sel, _, _ = pool_fwd_reference(a, torch.tensor([1.0]), 2, torch.float32)
    assert sel.tolist() == [[[1.0, 2.0, 3.0]]]
    one, zero = torch.ones(1), torch.zeros(1)
    dz, db = route_bwd_reference(a, sel, torch.ones(1, 1, 3), one, zero, zero, 2,
                                 torch.float32)
    assert dz.tolist() == [[[1.0, 0.0, 0.0, 1.0, 1.0, 0.0]]]
    assert db.tolist() == [3.0]
    sel_neg, _, _ = pool_fwd_reference(a, -one, 2, torch.float32)  # γ < 0: the min
    assert sel_neg.tolist() == [[[1.0, 0.0, 3.0]]]


def test_wrappers_on_cpu_are_the_plain_versions():
    x, w, b, sgn, g, (c0, c1, c2) = block0_case(4, B=1, T=64)
    before = (conv_block0_train.launches, conv_block0_train_bwd.launches,
              pool_fwd.launches, route_bwd.launches)
    args = t(x, w, b, sgn)
    for got, want in zip(conv_block0_train(*args), conv_block0_train_reference(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    bwd = t(x, w, b, sgn, g, c0, c1, c2)
    for got, want in zip(conv_block0_train_bwd(*bwd), conv_block0_train_bwd_reference(*bwd)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    a = torch.relu(torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(0)))
    s = torch.ones(5)
    sel, _, _ = pool_fwd(a, s, 2, torch.float32)
    torch.testing.assert_close(sel, pool_fwd_reference(a, s, 2, torch.float32)[0], rtol=0, atol=0)
    route_bwd(a, sel, torch.ones(2, 5, 4), s, s, s, 2, torch.float32)
    assert (conv_block0_train.launches, conv_block0_train_bwd.launches,
            pool_fwd.launches, route_bwd.launches) == before  # the CPU path launches nothing
    with pytest.raises(ValueError):
        conv_block0_train(*[v.to("meta") for v in args])
    with pytest.raises(ValueError):
        pool_fwd(a.to("meta"), s.to("meta"), 2)
