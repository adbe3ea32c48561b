"""B10's plain version against the JAX package's code, on the CPU.

``quant_block_stage_reference`` (the plain version of the stage prefixes of
``csrc/quant_block.cu``) on the same int8 inputs as:

- ``jax.lax.conv_general_dilated(..., preferred_element_type=jnp.int32)``,
  the exact SAME conv, for the ``mma`` stage (its even times) and the
  ``pool`` stage (the pair's max where alpha > 0, its min elsewhere);
- the TPU attribution harness's own kernel,
  ``benchmarks/bench_qblock_attrib.py :: _kernel_staged(stage=4)`` through
  ``pl.pallas_call(..., interpret=True)``, for the ``full`` stage.

The int32 sums are exact and the epilogue is the same f32 ops in the same
order, so every tolerance is zero.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from benchmarks.bench_qblock_attrib import _kernel_staged
from test_torch_quant_block import NAMES, rand_qblk
from voicemap_tpu_torch.ops.cuda_quant_block import (
    STAGES, quant_block_reference, quant_block_stage, quant_block_stage_reference,
)


def exact_conv(x, w):
    """The SAME conv's int32 sums (B, T, Cout), from XLA."""
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1,), "SAME", dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.int32))


def port(x, q, stage):
    return quant_block_stage_reference(torch.from_numpy(x),
                                       *(torch.from_numpy(q[k]) for k in NAMES), stage)


CASES = [(16, 32, 60), (16, 32, 61), (32, 40, 101), (64, 24, 2), (8, 8, 3)]


@pytest.mark.parametrize("cin,cout,T", CASES)
def test_mma_stage_is_the_exact_conv_at_even_times(cin, cout, T):
    rng = np.random.default_rng(cin + T)
    x = rng.integers(-127, 128, (3, T, cin)).astype(np.int8)
    q = rand_qblk(rng, cin, cout, realistic=True)
    acc = exact_conv(x, q["w_q"])
    got = port(x, q, "mma")
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, T // 2, cout)
    np.testing.assert_array_equal(got.numpy(), acc[:, 0:(T // 2) * 2:2])


@pytest.mark.parametrize("cin,cout,T", CASES)
def test_pool_stage_selects_by_the_sign_of_alpha(cin, cout, T):
    rng = np.random.default_rng(cin * T)
    x = rng.integers(-127, 128, (2, T, cin)).astype(np.int8)
    q = rand_qblk(rng, cin, cout, realistic=True)
    q["alpha"][::3] = 0.0  # alpha = 0 takes the min, as the kernel's `alpha > 0` test
    acc = exact_conv(x, q["w_q"])
    pairs = acc[:, :(T // 2) * 2].reshape(2, T // 2, 2, cout)
    want = np.where(q["alpha"] > 0, pairs.max(axis=2), pairs.min(axis=2))
    got = port(x, q, "pool")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def staged_full(x, q, t_len, b_blk):
    """``_kernel_staged(stage=4)`` in interpret mode, launched as the harness
    launches it (``bench_qblock_attrib.main``), over a T that is a multiple
    of ``t_len``."""
    B, T, cin = x.shape
    cout = q["w_q"].shape[2]
    w = q["w_q"]
    wcat = jnp.asarray(np.concatenate([w[0], w[1], w[2]], 1))  # (Cin, 3·Cout)
    aff = np.zeros((8, cout), np.float32)
    aff[0], aff[1], aff[2] = q["alpha"], q["beta"], q["gamma"]
    kernel = functools.partial(_kernel_staged, b_blk=b_blk, t_len=t_len, n_ch=T // t_len,
                               c_out=cout, t_valid=T, stage=4)
    return np.asarray(pl.pallas_call(
        kernel, grid=(B // b_blk,),
        in_specs=[pl.BlockSpec((b_blk, T, cin), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec(wcat.shape, lambda i: (0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec(aff.shape, lambda i: (0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((b_blk, T // 2, cout), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((B, T // 2, cout), jnp.int8),
        interpret=True)(jnp.asarray(x), wcat, jnp.asarray(aff)))


@pytest.mark.parametrize("cin,cout,T,t_len", [(32, 16, 64, 32), (64, 24, 96, 32)])
def test_full_stage_equals_the_tpu_harness_kernel(cin, cout, T, t_len):
    rng = np.random.default_rng(T)
    x = rng.integers(-127, 128, (4, T, cin)).astype(np.int8)
    q = rand_qblk(rng, cin, cout, realistic=True)
    want = staged_full(x, q, t_len, b_blk=2)
    got = port(x, q, "full")
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape == (4, T // 2, cout)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.abs(want.astype(np.int32)) < 127).mean() > 0.5  # most outputs inside ±127


def test_stage_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 21, 32)).astype(np.int8))
    q = rand_qblk(rng, 32, 8, realistic=True)
    t = [torch.from_numpy(q[k]) for k in NAMES]
    before = quant_block_stage.launches
    outs = {s: quant_block_stage(x, *t, s) for s in STAGES}
    assert quant_block_stage.launches == before  # the CPU path launches nothing
    assert [outs[s].dtype for s in STAGES] == [torch.int32, torch.int32, torch.int8]
    for s in STAGES:
        assert outs[s].shape == (2, 10, 8)
        assert torch.equal(outs[s], quant_block_stage_reference(x, *t, s))
    assert torch.equal(outs["full"], quant_block_reference(x, *t))
    with pytest.raises(ValueError, match="stage"):
        quant_block_stage(x, *t, "taps")
    with pytest.raises(ValueError):
        quant_block_stage(x.to("meta"), *[p.to("meta") for p in t], "mma")
