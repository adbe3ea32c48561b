"""Config #3's dilated and pool-1 blocks: B3's and B8's plain versions
against the JAX package's own functions for them, on the CPU.

The JAX package serves config #3's (``dilated_4khz``) blocks 1–7 through
XLA: ``_quant_block`` (int8, ``rhs_dilation``) and ``_xla_block`` (bf16);
its Pallas B3 and B8 take dilation 1 and pool 2 only. The port's B3 and B8
take these blocks, so their plain versions are held against those XLA
functions and against the pooled-GEMM specification ``fused_block_apply``:

- B3: ``quant_block_reference`` against ``_quant_block`` at (pool, dilation)
  (1, 2), (2, 1), (1, 4), (1, 8), (1, 16), int8 and the last block's bf16
  out, odd T, Cin 32–64: equal (the int32 sums are exact, the epilogue the
  same f32 ops in the same order);
- B8: ``conv_blockn_reference`` against ``_xla_block`` (odd T, floor) and
  ``fused_block_apply`` at f32 within 1e-5; at bf16 operands with f32 out
  within the summation-order bound of ``tests/test_torch_conv_blockn.py``
  (every product exact in f32, only the order of the K = k·Cin sums differs:
  ``u·((2K + 4)·|mul|·(S + |bias|) + 4·(|out| + |add|))``), where
  ``fused_block_apply`` multiplies the same bf16 values;
- the wrappers on CPU tensors are their plain versions at these shapes, and
  refuse a reach past the kernel's box and a pool of 3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_conv_blockn import make_case
from test_torch_quant_block import NAMES, as_f32, rand_qblk
from voicemap_tpu.models.fast_infer import _xla_block
from voicemap_tpu.models.fused_encoder import fused_block_apply as jax_block
from voicemap_tpu.models.quant_infer import _quant_block
from voicemap_tpu_torch.ops import conv_sm90
from voicemap_tpu_torch.ops.cuda_conv import (
    bn_affine, check_blockn_launch, conv_blockn, conv_blockn_reference, stacked_weights_chan,
)
from voicemap_tpu_torch.ops.cuda_quant_block import (
    check_quant_launch, quant_block, quant_block_reference,
)

EPS = 1e-3
U = 2.0 ** -24
F32_TOL = 1e-5
# config #3's (pool, dilation) of blocks 1-7, and the undilated pool 2
POOL_DILATION = [(1, 2), (2, 1), (1, 4), (1, 8), (1, 16)]


def port_b3(x, q, last, out, pool, d):
    return quant_block_reference(torch.from_numpy(x), *(torch.from_numpy(q[k]) for k in NAMES),
                                 last=last, out_dtype=getattr(torch, out), pool=pool,
                                 dilation=d)


@pytest.mark.parametrize("pool,d", POOL_DILATION)
@pytest.mark.parametrize("cin,cout,T,last,out", [
    (32, 40, 61, False, "int8"),
    (64, 24, 37, True, "bfloat16"),
])
def test_b3_plain_equals_xla_quant_block_dilated(pool, d, cin, cout, T, last, out):
    """Odd T: at pool 2 the last step drops out; at d = 16 the reach 32 is
    about T itself, so most taps read the zero padding."""
    rng = np.random.default_rng(cin + T + d)
    x = rng.integers(-127, 128, (3, T, cin)).astype(np.int8)
    q = rand_qblk(rng, cin, cout, realistic=True)
    want = _quant_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v in q.items()}, pool, d,
                        last=last, out_dtype=getattr(jnp, out))
    got = port_b3(x, q, last, out, pool, d)
    assert got.dtype == getattr(torch, out)
    assert tuple(got.shape) == want.shape == (3, T // pool, cout)
    np.testing.assert_array_equal(as_f32(got), as_f32(want))


def test_b3_wrapper_on_cpu_is_the_plain_version_at_a_dilation():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 45, 32)).astype(np.int8))
    qblk = rand_qblk(rng, 32, 16, realistic=True)
    q = [torch.from_numpy(qblk[k]) for k in NAMES]
    before = quant_block.launches
    got = quant_block(x, *q, pool=1, dilation=8)
    assert quant_block.launches == before and got.shape == (2, 45, 16)
    assert torch.equal(got, quant_block_reference(x, *q, pool=1, dilation=8))


def block_trees(params):
    blk = {"conv": {"kernel": jnp.asarray(params[0]), "bias": jnp.asarray(params[1])},
           "bn": {"scale": jnp.asarray(params[2]), "bias": jnp.asarray(params[3])}}
    return blk, {"mean": jnp.asarray(params[4]), "var": jnp.asarray(params[5])}


def port_b8(x, params, pool, d, gemm=torch.float32):
    return conv_blockn_reference(torch.from_numpy(np.asarray(x, np.float32)),
                                 *map(torch.from_numpy, params), EPS, pool,
                                 out_dtype=torch.float32, gemm_dtype=gemm, dilation=d)


@pytest.mark.parametrize("pool,d", POOL_DILATION)
@pytest.mark.parametrize("k,T", [(3, 45), (3, 64), (5, 33)])
def test_b8_plain_matches_xla_block_dilated_at_f32(pool, d, k, T):
    x, params = make_case(k + T + d, 2, T, k, 16, 24)
    blk, bst = block_trees(params)
    want = np.asarray(_xla_block(jnp.asarray(x), blk, bst, pool, d, EPS, jnp.float32))
    got = port_b8(x, params, pool, d).numpy()
    assert got.shape == want.shape == (2, T // pool, 24)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def order_bound(xb, params, out, pool, d):
    """The bf16-operand bound of tests/test_torch_conv_blockn.py at (pool, d):
    K = k·Cin products whatever the dilation."""
    w = torch.from_numpy(params[0])
    k, cin, cout = w.shape
    zeros, ones = torch.zeros(cout), torch.ones(cout)
    s = conv_blockn_reference(xb.abs(), w.abs(), zeros, ones, zeros, zeros, ones, 0.0, pool,
                              out_dtype=torch.float32, dilation=d)
    bias, mul, add = bn_affine(*map(torch.from_numpy, params[1:]), EPS)
    return U * ((2 * k * cin + 4) * mul.abs() * (s + bias.abs()) + 4 * (out.abs() + add.abs()))


@pytest.mark.parametrize("pool,d", POOL_DILATION)
@pytest.mark.parametrize("gemm", ["float32", "bfloat16"])
def test_b8_plain_matches_fused_block_apply_dilated(pool, d, gemm):
    """The pooled GEMM both packages specify, at even T (fused_block_apply
    takes T divisible by the pool): f32 within 1e-5; with bf16 operands
    within the summation-order bound, against ``fused_block_apply`` at f32
    on x and w rounded to bf16 first (the same bf16 values, f32 sums, f32
    out)."""
    x, params = make_case(d + pool, 3, 64, 3, 16, 8)
    if gemm == "bfloat16":
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
        params[0] = np.array(jnp.asarray(params[0]).astype(jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(jax_block(jnp.asarray(x), *map(jnp.asarray, params), EPS, pool, d,
                                compute_dtype=jnp.float32))
    got = port_b8(x, params, pool, d, getattr(torch, gemm)).numpy()
    assert got.shape == want.shape == (3, 64 // pool, 8)
    if gemm == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        bound = order_bound(torch.from_numpy(x), params, torch.from_numpy(want.copy()), pool,
                            d).numpy()
        assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


@pytest.mark.parametrize("pool,d", POOL_DILATION)
def test_stacked_weights_chan_dilated_matches_jax(pool, d):
    from voicemap_tpu.models.fused_encoder import _stack_weights

    w = np.random.default_rng(d).standard_normal((3, 4, 5)).astype(np.float32)
    want = np.asarray(_stack_weights(jnp.asarray(w), pool, d))
    got = stacked_weights_chan(torch.from_numpy(w), pool, d).numpy()
    assert got.shape == want.shape == ((2 * d + pool) * 4, pool * 5)
    np.testing.assert_array_equal(got, want)


def test_b8_wrapper_on_cpu_is_the_plain_version_at_pool_1():
    x, params = make_case(9, 2, 41, 3, 16, 8)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    tp = [torch.from_numpy(p) for p in params]
    before = conv_blockn.launches
    got = conv_blockn(xt, *tp, EPS, 1, dilation=4)
    assert conv_blockn.launches == before and got.shape == (2, 41, 8)
    assert torch.equal(got, conv_blockn_reference(xt, *tp, EPS, 1, dilation=4))


def test_the_wrappers_refuse_a_reach_past_the_box_and_pool_3():
    vec5, vec3 = tuple(torch.zeros(8) for _ in range(5)), tuple(torch.zeros(8) for _ in range(3))
    xb = torch.zeros(2, 10, 16, dtype=torch.bfloat16)
    d_max = conv_sm90.MAX_REACH // 2
    check_blockn_launch(xb, torch.zeros(3, 16, 8), vec5, 1, torch.bfloat16, torch.bfloat16,
                        d_max)
    for pool, d in ((1, d_max + 1), (3, 1), (2, 0)):
        with pytest.raises(ValueError):
            check_blockn_launch(xb, torch.zeros(3, 16, 8), vec5, pool, torch.bfloat16,
                                torch.bfloat16, d)
    xq, wq = torch.zeros(2, 10, 32, dtype=torch.int8), torch.zeros(3, 32, 8, dtype=torch.int8)
    check_quant_launch("quant_block", xq, wq, vec3, 1, d_max)
    for pool, d in ((1, d_max + 1), (3, 1), (1, 0)):
        with pytest.raises(ValueError):
            check_quant_launch("quant_block", xq, wq, vec3, pool, d)
