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

import jax
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
    BWD_CTAS_PER_SM, FWD_CTAS_PER_SM, THREADS, UNROLL, channels_last, is_channels_last,
    launch_plan, pool_fwd, pool_fwd_reference, route_bwd, route_bwd_reference, vector_width,
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


def btc(a, dtype):
    """JAX (B, T, C) numpy → the port's channels-last (B, C, T) view of the
    same memory (no transpose copy)."""
    return torch.from_numpy(np.array(a, np.float32)).to(dtype).permute(0, 2, 1)


def as_jax(t):
    """The port's channels-last (B, C, T) tensor → its (B, T, C) memory as
    f32 numpy (a view, then a widening)."""
    return t.permute(0, 2, 1).float().numpy()


B7_CASES = [(8, 2), (6, 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,pool", B7_CASES)
def test_b7_plain_matches_pallas_interpret(dtype, c, pool):
    """A relu activation as z, bias 0: the plain versions on the (B, T, C)
    memory held directly against the Pallas kernels."""
    tdt, jdt = DTYPES[dtype]
    B, T = 3, 64
    a, sgn, g, (c0, c1, c2) = routing_case(c + pool, B, T, c, pool, jdt)
    aj = jnp.asarray(a).astype(jdt)
    want_sel, want_s1, want_s2 = pallas_pool_fwd(aj, jnp.asarray(sgn), pool, sel_dtype=jdt,
                                                 interpret=True)
    z, b0 = btc(a, tdt), torch.zeros(c)
    sel, s1, s2 = pool_fwd_reference(z, b0, torch.from_numpy(sgn), pool, tdt)
    assert sel.dtype == tdt and sel.shape == (B, c, T // pool) and is_channels_last(sel)
    np.testing.assert_array_equal(as_jax(sel), np.asarray(want_sel.astype(jnp.float32)))
    assert_rel(s1.numpy(), want_s1, 1e-5, "sum")
    assert_rel(s2.numpy(), want_s2, 1e-5, "sumsq")

    want_dz, want_db = pallas_route_bwd(aj, want_sel, jnp.asarray(g), *map(jnp.asarray,
                                        (c0, c1, c2)), pool, out_dtype=jdt, interpret=True)
    dz, db = route_bwd_reference(z, b0, sel, btc(g, torch.float32), *t(c0, c1, c2), pool, tdt)
    assert dz.dtype == tdt and dz.shape == (B, c, T) and is_channels_last(dz)
    got_dz, want_dz = as_jax(dz), np.asarray(want_dz.astype(jnp.float32))
    if dtype == "float32":
        assert_rel(got_dz, want_dz, 1e-6, "dz")
    else:
        assert bf16_ulps(got_dz, want_dz) <= 1
    assert_rel(db.numpy(), want_db, 1e-5, "db")


def conv_output_case(seed, B, T, c, dtype):
    """A raw conv output of both signs on a coarse grid (ties and dead relu
    regions once the bias is added) and a bias of both signs."""
    rng = np.random.default_rng(seed)
    z = (np.round(rng.standard_normal((B, T, c)) * 4.0) / 4.0).astype(np.float32)
    z = np.asarray(jnp.asarray(z).astype(dtype).astype(jnp.float32))
    b = (rng.standard_normal(c) * 0.37).astype(np.float32)
    return z, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,pool", B7_CASES)
def test_b7_plain_folds_bias_and_relu(dtype, c, pool):
    """The plain versions take the raw conv output z and the bias and match
    ``jax.nn.relu(z + b.astype(dtype))`` then the Pallas kernels: a_sel bit
    for bit, dz bit for bit in bf16 (the same f32 ops on the same values,
    rounded once) and within 1e-6 of the largest in f32 (XLA on the CPU
    contracts ``c0·g + c1 + c2·a`` into FMAs, the port's versions do not),
    Σa, Σa² and db within 1e-5 of the largest (the sum order)."""
    tdt, jdt = DTYPES[dtype]
    B, T = 3, 64
    z, b = conv_output_case(100 + c + pool, B, T, c, jdt)
    _, sgn, g, (c0, c1, c2) = routing_case(c + pool, B, T, c, pool, jdt)
    aj = jax.nn.relu(jnp.asarray(z).astype(jdt) + jnp.asarray(b).astype(jdt))
    assert float((aj == 0).mean()) > 0.2  # dead regions: the relu is exercised
    want_sel, want_s1, want_s2 = pallas_pool_fwd(aj, jnp.asarray(sgn), pool, sel_dtype=jdt,
                                                 interpret=True)
    zt = btc(z, tdt)
    sel, s1, s2 = pool_fwd_reference(zt, torch.from_numpy(b), torch.from_numpy(sgn), pool, tdt)
    np.testing.assert_array_equal(as_jax(sel), np.asarray(want_sel.astype(jnp.float32)))
    assert_rel(s1.numpy(), want_s1, 1e-5, "sum")
    assert_rel(s2.numpy(), want_s2, 1e-5, "sumsq")
    want_dz, want_db = pallas_route_bwd(aj, want_sel, jnp.asarray(g), *map(jnp.asarray,
                                        (c0, c1, c2)), pool, out_dtype=jdt, interpret=True)
    dz, db = route_bwd_reference(zt, torch.from_numpy(b), sel, btc(g, torch.float32),
                                 *t(c0, c1, c2), pool, tdt)
    got_dz, want_dz = as_jax(dz), np.asarray(want_dz.astype(jnp.float32))
    if dtype == "float32":
        assert_rel(got_dz, want_dz, 1e-6, "dz")
    else:
        np.testing.assert_array_equal(got_dz, want_dz)
    assert_rel(db.numpy(), want_db, 1e-5, "db")


def test_b7_backward_rounds_the_f32_cotangent_as_the_pallas_wrapper():
    """g in f32, off the bf16 grid: the plain backward rounds it to z's dtype
    inside, as ``pallas_route_bwd`` casts it, and equals the same call on g
    rounded beforehand."""
    c, pool, B, T = 8, 2, 2, 32
    z, b = conv_output_case(7, B, T, c, jnp.bfloat16)
    _, sgn, _, (c0, c1, c2) = routing_case(7, B, T, c, pool, jnp.bfloat16)
    g = (np.random.default_rng(8).standard_normal((B, T // pool, c)) * 3.0).astype(np.float32)
    g_bf16 = np.asarray(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32))
    assert (g != g_bf16).mean() > 0.9
    zt, bt = btc(z, torch.bfloat16), torch.from_numpy(b)
    sel, _, _ = pool_fwd_reference(zt, bt, torch.from_numpy(sgn), pool, torch.bfloat16)
    dz, db = route_bwd_reference(zt, bt, sel, btc(g, torch.float32), *t(c0, c1, c2), pool,
                                 torch.bfloat16)
    dz_pre, db_pre = route_bwd_reference(zt, bt, sel, btc(g_bf16, torch.float32),
                                         *t(c0, c1, c2), pool, torch.bfloat16)
    assert torch.equal(dz, dz_pre) and torch.equal(db, db_pre)
    aj = jax.nn.relu(jnp.asarray(z).astype(jnp.bfloat16) + jnp.asarray(b).astype(jnp.bfloat16))
    want_dz, _ = pallas_route_bwd(aj, jnp.asarray(as_jax(sel)).astype(jnp.bfloat16),
                                  jnp.asarray(g), *map(jnp.asarray, (c0, c1, c2)), pool,
                                  out_dtype=jnp.bfloat16, interpret=True)
    np.testing.assert_array_equal(as_jax(dz), np.asarray(want_dz.astype(jnp.float32)))


def test_b7_routing_goes_to_the_first_equal_phase():
    a = torch.tensor([[[1.0, 1.0, 0.0, 2.0, 3.0, 3.0]]])  # (1, 1, 6), pool 2
    one, zero = torch.ones(1), torch.zeros(1)
    sel, _, _ = pool_fwd_reference(a, zero, one, 2, torch.float32)
    assert sel.tolist() == [[[1.0, 2.0, 3.0]]]
    dz, db = route_bwd_reference(a, zero, sel, torch.ones(1, 1, 3), one, zero, zero, 2,
                                 torch.float32)
    assert dz.tolist() == [[[1.0, 0.0, 0.0, 1.0, 1.0, 0.0]]]
    assert db.tolist() == [3.0]
    sel_neg, _, _ = pool_fwd_reference(a, zero, -one, 2, torch.float32)  # γ < 0: the min
    assert sel_neg.tolist() == [[[1.0, 0.0, 3.0]]]
    # The bias moves every phase alike and the relu zeroes what falls below 0.
    sel_b, _, _ = pool_fwd_reference(a, -torch.full((1,), 1.5), one, 2, torch.float32)
    assert sel_b.tolist() == [[[0.0, 0.5, 1.5]]]


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
    z = torch.randn(2, 8, 5, generator=torch.Generator().manual_seed(0)).permute(0, 2, 1)
    s, b = torch.ones(5), torch.full((5,), 0.1)
    sel, _, _ = pool_fwd(z, b, s, 2, torch.float32)
    torch.testing.assert_close(sel, pool_fwd_reference(z, b, s, 2, torch.float32)[0], rtol=0,
                               atol=0)
    g = torch.ones(2, 4, 5).permute(0, 2, 1)
    for got, want in zip(route_bwd(z, b, sel, g, s, s, s, 2, torch.float32),
                         route_bwd_reference(z, b, sel, g, s, s, s, 2, torch.float32)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (conv_block0_train.launches, conv_block0_train_bwd.launches,
            pool_fwd.launches, route_bwd.launches) == before  # the CPU path launches nothing
    with pytest.raises(ValueError):
        conv_block0_train(*[v.to("meta") for v in args])
    with pytest.raises(ValueError):
        pool_fwd(z.to("meta"), b.to("meta"), s.to("meta"), 2)


def test_b7_wrappers_refuse_channel_first_tensors():
    """The wrappers take channels-last tensors only and never copy one into
    that layout: a (B, C, T)-contiguous z, a_sel or g raises, on the CPU too."""
    gen = torch.Generator().manual_seed(1)
    z_nct = torch.randn(2, 5, 8, generator=gen)
    z = z_nct.permute(0, 2, 1).contiguous().permute(0, 2, 1)
    s, b = torch.ones(5), torch.zeros(5)
    with pytest.raises(ValueError, match="channels last"):
        pool_fwd(z_nct, b, s, 2)
    sel, _, _ = pool_fwd(z, b, s, 2, torch.float32)
    g = torch.ones(2, 4, 5).permute(0, 2, 1)
    with pytest.raises(ValueError, match="channels last"):
        route_bwd(z_nct, b, sel, g, s, s, s, 2, torch.float32)
    with pytest.raises(ValueError, match="channels last"):
        route_bwd(z, b, sel.contiguous(), g, s, s, s, 2, torch.float32)
    with pytest.raises(ValueError, match="channels last"):
        route_bwd(z, b, sel, g.contiguous(), s, s, s, 2, torch.float32)
    with pytest.raises(ValueError, match="float32"):
        route_bwd(z, b, sel, g.to(torch.bfloat16), s, s, s, 2, torch.float32)
    assert is_channels_last(channels_last((2, 5, 8), torch.bfloat16, "cpu"))
    assert not is_channels_last(z_nct)


@pytest.mark.parametrize("B,c,T,pool,dtype,vec", [
    (32, 256, 3000, 2, torch.bfloat16, 8), (2048, 512, 750, 2, torch.bfloat16, 8),
    (5, 67, 250, 2, torch.bfloat16, 1), (1, 384, 1501 * 2, 2, torch.float32, 4),
    (3, 2048 * 8, 8, 4, torch.bfloat16, 8)])
@pytest.mark.parametrize("per_sm", [FWD_CTAS_PER_SM, BWD_CTAS_PER_SM])
def test_b7_launch_plan_covers_every_position_once(B, c, T, pool, dtype, vec, per_sm):
    """csrc/routing.cu's grid from ``launch_plan``: the strips cover each
    row's T/pool positions once, every thread of a cut row gets at least two
    batches of UNROLL positions, and the CTAs fill the 132 SMs' slots at
    most once, as many as the batch and that floor allow."""
    tp, slots = T // pool, 132 * per_sm
    strips, span = launch_plan(B, c, T, pool, vec, slots)
    assert strips >= 1 and (strips - 1) * span < tp <= strips * span
    chunks = -(-(c // vec) // THREADS)
    rows = THREADS // min(c // vec, THREADS)
    floor = max(1, tp // (rows * UNROLL * 2))
    assert span == -(-tp // max(1, min(slots // (B * chunks), floor)))
    if strips > 1:
        assert span >= rows * UNROLL * 2 and B * strips * chunks <= slots
    assert vector_width(c, dtype, torch.empty(16, dtype=dtype)) == vec
