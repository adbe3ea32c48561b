"""The int8 kernels' plain versions against the TPU kernels' own code, on the CPU.

- B3: ``quant_block_reference`` (the plain version of ``csrc/quant_block.cu``)
  against the JAX package's ``_quant_block`` and against
  ``pallas_quant_block(interpret=True)``, with ``alpha`` crossing zero, odd T
  and the last block's bf16 and f32 output. The int32 sums are exact and the
  epilogue is the same f32 ops in the same order, so the tolerance is zero.
- B2 with ``requant_scale``: ``conv_block0_reference`` against
  ``pallas_conv_block0(requant_scale=s0, interpret=True)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.models.quant_infer import _quant_block
from voicemap_tpu.ops.pallas_conv import pallas_conv_block0
from voicemap_tpu.ops.pallas_quant_block import pallas_quant_block, stack_weights
from voicemap_tpu_torch.ops.cuda_conv import conv_block0, conv_block0_reference, requantize
from voicemap_tpu_torch.ops.cuda_quant_block import (
    pack_weights, quant_block, quant_block_reference,
)
from test_torch_conv_block0 import make_case

NAMES = ("w_q", "alpha", "beta", "gamma")


def rand_qblk(rng, cin, cout, realistic):
    """int8 weights and f32 epilogue vectors; ``alpha`` crosses zero. The
    JAX package's test draws (``realistic=False``) saturate most outputs; the
    realistic draw scales ``alpha`` and ``beta`` to the accumulator's spread
    (≈ √(3·Cin)·5400 for uniform int8), so most outputs land inside ±127."""
    spread = np.sqrt(3 * cin) * 5400.0 if realistic else 1.0
    return {
        "w_q": rng.integers(-127, 128, (3, cin, cout)).astype(np.int8),
        "alpha": (rng.standard_normal(cout) * (40.0 / spread if realistic else 0.01)
                  ).astype(np.float32),
        "beta": (rng.standard_normal(cout) * (0.5 * spread)).astype(np.float32),
        "gamma": (rng.standard_normal(cout) * (10.0 if realistic else 1.0)).astype(np.float32),
    }


def port(x, q, last, out_dtype=torch.bfloat16):
    return quant_block_reference(torch.from_numpy(x), *(torch.from_numpy(q[k]) for k in NAMES),
                                 last=last, out_dtype=out_dtype)


def as_f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("realistic", [False, True])
@pytest.mark.parametrize("cin,cout,T,last,out", [
    (16, 32, 60, False, "int8"),
    (16, 32, 61, False, "int8"),   # odd T: the last step drops out of the pool
    (32, 40, 101, True, "bfloat16"),
    (8, 16, 30, True, "float32"),
    (64, 24, 2, False, "int8"),    # one pooled output
])
def test_b3_plain_equals_xla_quant_block(cin, cout, T, last, out, realistic):
    rng = np.random.default_rng(cin + T)
    x = rng.integers(-127, 128, (3, T, cin)).astype(np.int8)
    q = rand_qblk(rng, cin, cout, realistic)
    want = _quant_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v in q.items()}, 2, 1,
                        last=last, out_dtype=getattr(jnp, out))
    got = port(x, q, last, getattr(torch, out))
    assert got.dtype == getattr(torch, out) and tuple(got.shape) == want.shape == (3, T // 2, cout)
    np.testing.assert_array_equal(as_f32(got), as_f32(want))


@pytest.mark.parametrize("cin,cout,T,last", [(16, 32, 64, False), (32, 16, 48, True)])
def test_b3_plain_equals_pallas_interpret(cin, cout, T, last):
    """Against the TPU kernel's own code (its xk formulation, K = 3·Cin, as the
    CUDA kernel lays the GEMM out): equal, int8 and the last block's bf16."""
    rng = np.random.default_rng(11)
    x = rng.integers(-127, 128, (4, T, cin)).astype(np.int8)
    q = rand_qblk(rng, cin, cout, realistic=True)
    want = pallas_quant_block(
        jnp.asarray(x), stack_weights(jnp.asarray(q["w_q"])),
        *(jnp.asarray(q[k]) for k in NAMES[1:]), t_valid=T, t_len=16, last=last, out_dtype=jnp.bfloat16 if last else jnp.int8,
        variant="xk", interpret=True)
    got = port(x, q, last)
    np.testing.assert_array_equal(as_f32(got), as_f32(want))


def test_pack_weights_is_k_major():
    """K-major, each tap's run of 4 input channels padded with zeros to the
    kernel's 128 bytes."""
    w = torch.arange(3 * 4 * 5, dtype=torch.int32).reshape(3, 4, 5).to(torch.int8)
    p = pack_weights(w)
    assert p.shape == (5, 3 * 128) and p.is_contiguous()
    for j in range(3):
        for ci in range(4):
            torch.testing.assert_close(p[:, j * 128 + ci], w[j, ci, :], rtol=0, atol=0)
        assert not p[:, j * 128 + 4:(j + 1) * 128].any()


def test_b3_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    x = rng.integers(-127, 128, (2, 20, 32)).astype(np.int8)
    q = rand_qblk(rng, 32, 8, realistic=True)
    t = [torch.from_numpy(q[k]) for k in NAMES]
    before = quant_block.launches
    got = quant_block(torch.from_numpy(x), *t)
    assert quant_block.launches == before  # the CPU path launches nothing
    assert got.dtype == torch.int8 and got.shape == (2, 10, 8)
    torch.testing.assert_close(got, port(x, q, last=False), rtol=0, atol=0)
    with pytest.raises(ValueError):
        quant_block(torch.from_numpy(x).to("meta"), *[p.to("meta") for p in t])


def requant_case(seed, gemm):
    """B2 inputs and an s0 calibrated as quant_infer does it: per-channel
    max-abs / 127 of the block's own output."""
    x, params = make_case(seed, B=3, T=256)
    tp = [torch.from_numpy(p) for p in params]
    pooled = conv_block0_reference(torch.from_numpy(x), *tp, 1e-3, out_dtype=torch.float32,
                                   gemm_dtype=gemm)
    s0 = (pooled.abs().amax(dim=(0, 1)).clamp(min=1e-8) / 127.0).numpy()
    return x, params, s0


# At bf16 the Pallas kernel sums the 32 taps in its own GEMM's order and the
# plain version in tap order, so a pooled value that lands near a rounding
# boundary of the int8 grid may round to the neighbouring integer: allowed
# ±1 on at most 1% of the outputs. At f32 the GEMM operands are the same
# values and only the order of the f32 sum differs: ±1 on at most 0.1%.
@pytest.mark.parametrize("gemm,share", [("bfloat16", 0.01), ("float32", 0.001)])
def test_b2_requant_plain_matches_pallas_interpret(gemm, share):
    x, params, s0 = requant_case(5, getattr(torch, gemm))
    got = conv_block0_reference(torch.from_numpy(x), *map(torch.from_numpy, params), 1e-3,
                                gemm_dtype=getattr(torch, gemm),
                                requant_scale=torch.from_numpy(s0))
    want = np.asarray(pallas_conv_block0(
        jnp.asarray(x), *map(jnp.asarray, params), 1e-3, pool=4, block_rows=3, t_chunk=32,
        interpret=True, gemm_dtype=getattr(jnp, gemm), requant_scale=jnp.asarray(s0)))
    assert got.dtype == torch.int8 and want.dtype == np.int8
    assert tuple(got.shape) == want.shape == (3, 64, 16)
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= share
    assert np.abs(want).max() == 127  # the calibrated grid is used end to end


def test_b2_requant_rounds_half_to_even_from_f32():
    """``requant_scale`` rounds the f32 pooled value times 1/s0 half to even
    and clamps to ±127: the plain version equals that formula exactly."""
    x, params, s0 = requant_case(6, torch.bfloat16)
    tp = [torch.from_numpy(p) for p in params]
    pooled = conv_block0_reference(torch.from_numpy(x), *tp, 1e-3, out_dtype=torch.float32)
    inv = 1.0 / torch.from_numpy(s0)
    want = np.clip(np.round(pooled.numpy() * inv.numpy()), -127, 127).astype(np.int8)
    got = conv_block0(torch.from_numpy(x), *tp, 1e-3, requant_scale=torch.from_numpy(s0))
    np.testing.assert_array_equal(got.numpy(), want)
    half = torch.tensor([[[0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0]]])
    ones = torch.ones(7)
    np.testing.assert_array_equal(requantize(half, ones).numpy()[0, 0],
                                  [0, 2, 2, 0, -2, 127, -127])
