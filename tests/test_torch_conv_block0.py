"""B2's plain version against the TPU kernel's own code, on the CPU.

``conv_block0_reference`` (the plain PyTorch version of the CUDA kernel
``csrc/conv_block0.cu``) against ``pallas_conv_block0(interpret=True)`` and
the JAX package's ``_xla_block``, at B up to 5, T=256, C=16, with half the
BatchNorm scales negative so that the affine-before-max order is pinned.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.models.fast_infer import _xla_block
from voicemap_tpu.ops.pallas_conv import pallas_conv_block0
from voicemap_tpu_torch.ops.cuda_conv import conv_block0, conv_block0_reference

EPS = 1e-3
C = 16


def make_case(seed, B, T):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, 1)) * 0.05).astype(np.float32)
    w = (rng.standard_normal((32, 1, C)) * 0.2).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    scale[::2] *= -1.0  # negative BN scales: max after the affine differs
    params = [
        w,
        (rng.standard_normal(C) * 0.1).astype(np.float32),  # conv bias
        scale,
        (rng.standard_normal(C) * 0.1).astype(np.float32),  # bn bias
        (rng.standard_normal(C) * 0.1).astype(np.float32),  # running mean
        rng.uniform(0.5, 2.0, C).astype(np.float32),  # running var
    ]
    return x, params


def bf16_ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in bf16 ulps between two arrays of bf16 values."""
    def ordered(v):
        bits = (np.asarray(v, np.float32).view(np.uint32) >> 16).astype(np.int32)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)
    return int(np.abs(ordered(a) - ordered(b)).max())


def port(x, params, out_dtype, gemm_dtype):
    t = [torch.from_numpy(p) for p in params]
    return conv_block0_reference(torch.from_numpy(x), *t, EPS, pool=4,
                                 out_dtype=out_dtype, gemm_dtype=gemm_dtype)


# (gemm, out) dtype pairs and their tolerances: f32 GEMM 1e-5 absolute;
# bf16 operands with f32 output only the sum order differs (rtol 1e-5,
# atol 1e-6); bf16 output within 1 bf16 ulp.
@pytest.mark.parametrize("gemm,out", [("float32", "float32"), ("bfloat16", "float32"),
                                      ("bfloat16", "bfloat16")])
def test_b2_plain_matches_pallas_interpret(gemm, out):
    x, params = make_case(0, B=2, T=256)
    got = port(x, params, getattr(torch, out), getattr(torch, gemm)).float().numpy()
    want = np.asarray(pallas_conv_block0(
        jnp.asarray(x), *map(jnp.asarray, params), EPS, pool=4, block_rows=2,
        t_chunk=32, interpret=True, out_dtype=getattr(jnp, out),
        gemm_dtype=getattr(jnp, gemm)).astype(jnp.float32))
    assert got.shape == want.shape == (2, 64, C)
    if out == "bfloat16":
        assert bf16_ulps(got, want) <= 1
    elif gemm == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("T", [258, 257, 255])
def test_b2_plain_floor_pools_like_xla_block(T):
    """T % 4 != 0: the pooled output drops the tail, as ``_xla_block`` does
    (nn.max_pool VALID), at f32 within 1e-5."""
    x, params = make_case(1, B=5, T=T)
    w, b, scale, bias, mean, var = map(jnp.asarray, params)
    want = np.asarray(_xla_block(
        jnp.asarray(x), {"conv": {"kernel": w, "bias": b}, "bn": {"scale": scale, "bias": bias}},
        {"mean": mean, "var": var}, 4, 1, EPS, jnp.float32))
    got = port(x, params, torch.float32, torch.float32).numpy()
    assert got.shape == want.shape == (5, T // 4, C)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_b2_wrapper_on_cpu_is_the_plain_version():
    x, params = make_case(2, B=5, T=64)
    t = [torch.from_numpy(p) for p in params]
    before = conv_block0.launches
    got = conv_block0(torch.from_numpy(x), *t, EPS)
    assert conv_block0.launches == before  # the CPU path launches nothing
    assert got.dtype == torch.bfloat16 and got.shape == (5, 16, C)
    torch.testing.assert_close(got, conv_block0_reference(torch.from_numpy(x), *t, EPS),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        conv_block0(torch.from_numpy(x).to("meta"), *[p.to("meta") for p in t], EPS)
