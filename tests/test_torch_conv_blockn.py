"""B8's plain version against the TPU kernels' own code, on the CPU.

``conv_blockn_reference`` (the plain PyTorch version of the CUDA kernel
``csrc/conv_blockn.cu``) against ``pallas_conv_blockn(interpret=True)`` and
``pallas_conv_blockn_streamed(interpret=True)`` at the JAX tests' shapes,
against the JAX package's unfused ``_xla_block`` where T is odd (floor), and
bf16 ``fast_embed`` against B2's and B8's plain versions chained. Half the
BatchNorm scales are negative, so the affine-before-max order is pinned.

Tolerances, each with its reason:

- f32 GEMM: 1e-4, as the JAX tests hold the TPU kernels to XLA's conv;
- bf16 operands with f32 output: both sides multiply the same bf16 values,
  so every product is exact in f32 and only the order of the f32 sums
  differs. Two orders of K = k·Cin terms each lie within (K − 1)·u·S of the
  exact sum (u = 2⁻²⁴, S = Σ|x·w|), so per output the bound is
  ``u·((2K + 4)·|mul|·(S + |bias|) + 4·(|out| + |add|))``, the epilogue's own
  roundings included;
- the odd-T floor against ``_xla_block`` at f32: 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.models.fast_infer import _xla_block
from voicemap_tpu.models.fast_infer import fast_embed as jax_fast_embed
from voicemap_tpu.ops.pallas_conv import (
    pallas_conv_blockn, pallas_conv_blockn_streamed,
)
from voicemap_tpu.ops.pallas_conv import stacked_weights_chan as jax_stacked_weights_chan
from test_torch_config import jax_config
from test_torch_encoder import randomize_bn
from voicemap_tpu_torch.config import EncoderConfig, dilated_4khz
from voicemap_tpu_torch.models import fast_infer
from voicemap_tpu_torch.models.convert import from_flax
from voicemap_tpu_torch.models.encoder import ConvEncoder
from voicemap_tpu_torch.ops.cuda_conv import (
    bn_affine, check_blockn_launch, conv_block0_reference, conv_blockn, conv_blockn_reference,
    stacked_weights_chan,
)

EPS = 1e-3
U = 2.0 ** -24
F32_TOL = 1e-4


def make_case(seed, B, T, k, cin, cout):
    """numpy x (B, T, Cin) and the block's parameters; half the scales negative."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, cin)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    scale[::2] *= -1.0
    params = [
        (rng.standard_normal((k, cin, cout)) * 0.2).astype(np.float32),
        (rng.standard_normal(cout) * 0.1).astype(np.float32),  # conv bias
        scale,
        (rng.standard_normal(cout) * 0.1).astype(np.float32),  # bn bias
        (rng.standard_normal(cout) * 0.1).astype(np.float32),  # running mean
        rng.uniform(0.5, 2.0, cout).astype(np.float32),  # running var
    ]
    return x, params


def port(x, params, out_dtype=torch.float32, gemm_dtype=torch.float32):
    return conv_blockn_reference(torch.from_numpy(np.array(x, np.float32)),
                                 *map(torch.from_numpy, params), EPS,
                                 out_dtype=out_dtype, gemm_dtype=gemm_dtype)


def order_bound(x, params, out):
    """The per-output bound above for bf16 operands and f32 output."""
    w = torch.from_numpy(params[0])
    k, cin, cout = w.shape
    zeros, ones = torch.zeros(cout), torch.ones(cout)
    s = conv_blockn_reference(torch.from_numpy(np.array(x, np.float32)).abs(), w.abs(),
                              zeros, ones, zeros, zeros, ones, 0.0,
                              out_dtype=torch.float32)  # Σ|x·w|, the larger of the pair
    bias, mul, add = bn_affine(*map(torch.from_numpy, params[1:]), EPS)
    out = torch.from_numpy(np.array(out, np.float32))
    return (U * ((2 * k * cin + 4) * mul.abs() * (s + bias.abs())
                 + 4 * (out.abs() + add.abs()))).numpy()


def assert_within(got, want, x, params, gemm):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if gemm == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        bound = order_bound(np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32),
                            params, want)
        assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


@pytest.mark.parametrize("gemm", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,C,Cout,T", [(3, 8, 16, 128), (3, 16, 8, 250), (5, 8, 8, 64)])
def test_b8_plain_matches_pallas_blockn(k, C, Cout, T, gemm):
    x, params = make_case(3, 3, T, k, C, Cout)
    want = pallas_conv_blockn(jnp.asarray(x), *map(jnp.asarray, params), EPS, pool=2,
                              t_chunk=16, interpret=True, out_dtype=jnp.float32,
                              gemm_dtype=getattr(jnp, gemm))
    got = port(x, params, gemm_dtype=getattr(torch, gemm))
    assert tuple(got.shape) == (3, T // 2, Cout)
    assert_within(got.numpy(), want, x, params, gemm)


@pytest.mark.parametrize("gemm", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,C,Cout,T,dtype", [
    (3, 8, 16, 128, "float32"),
    (3, 16, 8, 250, "float32"),  # t_out not a multiple of the chunk
    (5, 8, 8, 64, "float32"),
    (3, 8, 16, 128, "bfloat16"),  # bf16 streamed input
])
def test_b8_plain_matches_pallas_blockn_streamed(k, C, Cout, T, dtype, gemm):
    x, params = make_case(5, 3, T, k, C, Cout)
    x = np.asarray(jnp.asarray(x).astype(getattr(jnp, dtype)).astype(jnp.float32))
    want = pallas_conv_blockn_streamed(
        jnp.asarray(x).astype(getattr(jnp, dtype)), *map(jnp.asarray, params), EPS, pool=2,
        t_chunk=32, interpret=True, out_dtype=jnp.float32, gemm_dtype=getattr(jnp, gemm))
    got = port(x, params, gemm_dtype=getattr(torch, gemm))
    assert_within(got.numpy(), want, x, params, gemm)


@pytest.mark.parametrize("k,T", [(3, 251), (5, 65), (3, 2), (3, 3), (5, 3)])
def test_b8_plain_floors_an_odd_t_like_the_unfused_block(k, T):
    """The TPU wrappers refuse an odd T; the port floors as ``_xla_block``
    does: the conv reads the last row, the pool drops its output."""
    x, params = make_case(k + T, 2, T, k, 16, 24)
    blk = {"conv": {"kernel": jnp.asarray(params[0]), "bias": jnp.asarray(params[1])},
           "bn": {"scale": jnp.asarray(params[2]), "bias": jnp.asarray(params[3])}}
    bst = {"mean": jnp.asarray(params[4]), "var": jnp.asarray(params[5])}
    want = np.asarray(_xla_block(jnp.asarray(x), blk, bst, 2, 1, EPS, jnp.float32))
    got = port(x, params).numpy()
    assert got.shape == want.shape == (2, T // 2, 24)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_b8_plain_of_a_single_step_is_empty():
    x, params = make_case(0, 2, 1, 3, 8, 8)
    got = port(x, params, out_dtype=torch.bfloat16)
    assert got.shape == (2, 0, 8) and got.dtype == torch.bfloat16


def test_stacked_weights_chan_matches_jax():
    w = np.random.default_rng(1).standard_normal((5, 3, 4)).astype(np.float32)
    want = np.asarray(jax_stacked_weights_chan(jnp.asarray(w), 2))
    got = stacked_weights_chan(torch.from_numpy(w)).numpy()
    assert got.shape == want.shape == (6 * 3, 2 * 4)
    np.testing.assert_array_equal(got, want)


def test_b8_wrapper_on_cpu_is_the_plain_version():
    x, params = make_case(2, 2, 40, 3, 16, 8)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    tp = [torch.from_numpy(p) for p in params]
    before = conv_blockn.launches
    got = conv_blockn(xt, *tp, EPS)
    assert conv_blockn.launches == before  # the CPU path launches nothing
    assert got.dtype == torch.bfloat16 and got.shape == (2, 20, 8)
    assert torch.equal(got, conv_blockn_reference(xt, *tp, EPS))
    with pytest.raises(ValueError):
        conv_blockn(xt.to("meta"), *[p.to("meta") for p in tp], EPS)
    with pytest.raises(ValueError, match="odd"):
        conv_blockn(xt, torch.zeros(4, 16, 8), *tp[1:], EPS)
    with pytest.raises(ValueError, match="pool"):
        conv_blockn(xt, *tp, EPS, pool=4)


def refusal_cases():
    x = torch.zeros(2, 10, 16, dtype=torch.bfloat16)
    w = torch.zeros(3, 16, 8)
    vecs = tuple(torch.zeros(8) for _ in range(5))
    ok = dict(x=x, w=w, vecs=vecs, pool=2, out_dtype=torch.bfloat16, gemm_dtype=torch.bfloat16)
    return [
        ("f32 input", dict(ok, x=x.float())),
        ("strided input", dict(ok, x=torch.zeros(2, 16, 10, dtype=torch.bfloat16)
                               .transpose(1, 2))),
        ("unaligned input", dict(ok, x=torch.zeros(2 * 10 * 16 + 1, dtype=torch.bfloat16)[1:]
                                 .view(2, 10, 16))),
        ("Cin mismatch", dict(ok, w=torch.zeros(3, 24, 8))),
        ("even k", dict(ok, w=torch.zeros(4, 16, 8))),
        ("pool 4", dict(ok, pool=4)),
        ("f32 GEMM", dict(ok, gemm_dtype=torch.float32)),
        ("int8 out", dict(ok, out_dtype=torch.int8)),
        ("Cin 12", dict(ok, x=torch.zeros(2, 10, 12, dtype=torch.bfloat16),
                        w=torch.zeros(3, 12, 8))),
        ("vector shape", dict(ok, vecs=vecs[:4] + (torch.zeros(9),))),
        ("vector device", dict(ok, vecs=vecs[:4] + (torch.zeros(8, device="meta"),))),
    ]


@pytest.mark.parametrize("name,kw", refusal_cases(), ids=[c[0] for c in refusal_cases()])
def test_b8_launch_refuses_what_the_kernel_does_not_take(name, kw):
    with pytest.raises(ValueError):
        check_blockn_launch(**kw)


def test_b8_launch_takes_the_main_path_inputs():
    check_blockn_launch(torch.zeros(2, 10, 40, dtype=torch.bfloat16), torch.zeros(5, 40, 72),
                        tuple(torch.zeros(72) for _ in range(5)), 2, torch.float32,
                        torch.bfloat16)


def small_encoder(dtype, filters=16, seed=0, cfg=None):
    """A port encoder with seeded random weights (BN of both signs) through
    ``from_flax``, its JAX twin's variables and config, and an input."""
    from voicemap_tpu.models.encoder import ConvEncoder as JaxEncoder

    cfg = cfg or EncoderConfig(filters=filters, embedding_dim=16, compute_dtype=dtype)
    x = (np.random.default_rng(seed).standard_normal((3, 1024, 1)) * 0.04).astype(np.float32)
    jmodel = JaxEncoder(jax_config(cfg))
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed + 1)
    model = ConvEncoder(cfg, device="cpu")
    model.load_state_dict(from_flax(variables, cfg))
    return model, variables, cfg, x


def test_bf16_fast_embed_is_b2_then_b8_plain_versions_bit_for_bit():
    model, _, _, x = small_encoder("bfloat16")
    xt = torch.from_numpy(x)
    blk = model.blocks[0]
    with torch.inference_mode():
        h = conv_block0_reference(xt, blk.conv.weight.permute(2, 1, 0), blk.conv.bias,
                                  blk.bn.weight, blk.bn.bias, blk.bn.running_mean,
                                  blk.bn.running_var, blk.bn.eps)
        for blk in model.blocks[1:]:
            h = conv_blockn_reference(h, blk.conv.weight.permute(2, 1, 0), blk.conv.bias,
                                      blk.bn.weight, blk.bn.bias, blk.bn.running_mean,
                                      blk.bn.running_var, blk.bn.eps)
        assert h.shape == (3, 1024 // 32, 64) and h.dtype == torch.bfloat16
        want = model.pool_and_embed(h.transpose(1, 2))
        got = fast_infer.fast_embed(model, xt)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,config,b8_blocks", [
    ("bfloat16", "classifier", 3),
    ("float32", "classifier", 0),
    ("bfloat16", "dilated", 7),  # blocks 1-7: dilations 2-16 at pool 1, pool 2 between
])
def test_fast_embed_routes_blocks_by_the_config(monkeypatch, dtype, config, b8_blocks):
    """B8 takes exactly the bf16 blocks of k odd, pool 1 or 2 and a reach its
    input box holds, config #3's dilated and pool-1 blocks among them; f32
    keeps the module's forward. Each route against the JAX package's
    fast_embed: 1e-4 at f32, row cosine ≥ 0.999 at bf16 (the two round in
    other places)."""
    cfg = None
    if config == "dilated":
        cfg = dataclasses.replace(dilated_4khz().encoder, filters=8, embedding_dim=16,
                                  compute_dtype=dtype)
    model, variables, cfg, x = small_encoder(dtype, cfg=cfg, seed=4)
    calls = []

    def counted(h, *a, **kw):
        calls.append(tuple(h.shape))
        return conv_blockn(h, *a, **kw)

    monkeypatch.setattr(fast_infer, "conv_blockn", counted)
    with torch.inference_mode():
        got = fast_infer.fast_embed(model, torch.from_numpy(x)).numpy()
    assert len(calls) == b8_blocks
    want = np.asarray(jax_fast_embed(variables, jax_config(cfg), jnp.asarray(x)))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
        assert cos.min() >= 0.999, cos
