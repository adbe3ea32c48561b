"""The 3xTF32 arithmetic of B6's DFT route and B5's f32 weight gradient
(``csrc/tf32x3.cuh``), through its plain model ``ops/tf32x3``, and the host
side of B6's tensor-core kernel (``ops/mel_dft_tc``), on the CPU.

The kernels run only on the card; here the model of their split (the
``cvt.rna.tf32.f32`` rounding, the three products) carries a DFT log-mel
to within B6_ATOL (1e-3, the JAX package's bound for its own kernel) of
``pallas_log_mel(interpret=True)`` on the rows that stress it most (a pure
tone, zeros, rows scaled by 1e3 and 1e-3), and B5's weight gradient to
within TRAIN_REL_TOL (1e-4 of its largest value, the card's check) of the
plain version. The model sums the three exact products in float64, so what
it shows is the split's own error, ~2^-21 of each product; the tensor
cores' f32 sum order adds an f32 rounding per term, which the card's checks
cover.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.config import MelConfig as JaxMelConfig
from voicemap_tpu.ops.pallas_melspec import pallas_log_mel
from voicemap_tpu_torch.config import MelConfig
from voicemap_tpu_torch.ops import cuda_melspec, mel_dft_tc, mel_fft, melspec, tf32x3
from voicemap_tpu_torch.ops.cuda_conv_train import (
    bwd_dz, conv_block0_train_bwd_reference,
)

SR = 16000
B6_ATOL = 1e-3
TRAIN_REL_TOL = 1e-4
H100_SMEM_PER_SM = 233472
# The DFT route's geometries: the librosa n_fft 400, and an odd n_fft with a
# window shorter than it.
DFT_GEOMETRIES = {"n400": dict(n_fft=400, win_length=400, hop_length=160, n_mels=64),
                  "n255": dict(n_fft=255, win_length=200, hop_length=128, n_mels=32)}


def special_rows(seed: int, T: int) -> np.ndarray:
    """A 440 Hz tone, zeros, and a random row scaled by 1e3 and by 1e-3."""
    t = np.arange(T, dtype=np.float32)
    x = np.random.default_rng(seed).standard_normal((2, T)).astype(np.float32)
    tone = np.sin(2 * np.pi * 440.0 / SR * t).astype(np.float32)
    return np.stack([tone, np.zeros_like(tone), x[0] * 1e3, x[1] * 1e-3]).astype(np.float32)


@pytest.mark.parametrize("value, want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),  # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),  # below half an ulp
    (1.0 + 5 * 2.0 ** -11, 1.0 + 3 * 2.0 ** -10),  # a tie above an even tf32: away, not to even
    (2.0 - 2.0 ** -23, 2.0),  # the carry into the exponent
    (0.0, 0.0),
])
def test_round_tf32_is_cvt_rna(value, want):
    got = tf32x3.round_tf32(torch.tensor([value], dtype=torch.float32))
    assert got.item() == want
    assert int(got.view(torch.int32).item()) & 0x1FFF == 0


def test_split_adds_back_to_the_value():
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    a = a * torch.logspace(-6, 6, 4096)
    big, small = tf32x3.split(a)
    for plane in (big, small):
        assert not (plane.view(torch.int32) & 0x1FFF).any()
    rel = ((big.double() + small.double() - a.double()).abs() / a.double().abs()).max()
    assert rel <= 2.0 ** -21
    assert bool((small.abs() <= a.abs() * 2.0 ** -11).all())


def test_three_products_keep_f32_precision_where_one_does_not():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((64, 400)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((400, 48)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = (a.double().abs() @ b.double().abs())
    err3 = ((tf32x3.matmul(a, b).double() - exact).abs() / scale).max()
    err1 = ((tf32x3.round_tf32(a).double() @ tf32x3.round_tf32(b).double() - exact).abs()
            / scale).max()
    assert err3 <= 2.0 ** -19 and err1 >= 2.0 ** -14


@pytest.mark.parametrize("geometry", sorted(DFT_GEOMETRIES))
def test_dft_route_model_matches_the_pallas_kernel_on_special_rows(geometry):
    cfg, jcfg = MelConfig(**DFT_GEOMETRIES[geometry]), JaxMelConfig(**DFT_GEOMETRIES[geometry])
    assert cuda_melspec.log_mel_route(cfg, SR) == "dft"
    x = special_rows(3, 4000)
    want = np.asarray(pallas_log_mel(jnp.asarray(x), jcfg, SR, block_rows=4, interpret=True))
    got = mel_dft_tc.log_mel_model(torch.from_numpy(x), cfg, SR)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert want.shape == (4, melspec.num_frames(4000, cfg), cfg.n_mels)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=B6_ATOL)
    # and the plain version, which the card holds the kernel against
    ref = cuda_melspec.log_mel_reference(torch.from_numpy(x), cfg, SR)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=B6_ATOL)


def test_b5_dw_in_3xtf32_matches_the_plain_version():
    """B5's f32-route dW as the kernel forms it, dW = X (taps × positions) ·
    dZ (positions × channels) with X the Toeplitz view of the padded x, in
    3xTF32, against ``conv_block0_train_bwd_reference`` at (2, 4100, 72)."""
    B, T, c = 2, 4100, 72
    rng = np.random.default_rng(5)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    x, w = f(B, T, 1) * 0.3, f(32, 1, c) * 32 ** -0.5
    b, g = f(c) * 0.05, f(B, T // 4, c)
    sgn = torch.where(torch.arange(c) % 3 == 1, -1.0, 1.0)
    c0, c1, c2 = f(c), f(c) * 0.1, f(c) * 0.05
    f32 = torch.float32
    want_dw, want_db = conv_block0_train_bwd_reference(x, w, b, sgn, g, c0, c1, c2, 4, f32)
    dz, xp = bwd_dz(x, w, b, sgn, g, c0, c1, c2, 4, f32)
    X = xp.unfold(1, 32, 1)[:, :T].reshape(B * T, 32)  # row t: x[t - 15 .. t + 16]
    dw = tf32x3.matmul(X.T, dz.transpose(1, 2).reshape(B * T, c))
    rel = float((dw - want_dw[:, 0]).abs().max() / want_dw.abs().max())
    assert rel <= TRAIN_REL_TOL
    assert torch.equal(dz.sum((0, 2)), want_db)  # db stays f32, in the plain version's order


def test_interleaved_bases_and_their_padding():
    cfg = MelConfig(**DFT_GEOMETRIES["n400"])
    C, S = melspec.dft_bases(cfg)
    bases = mel_dft_tc.interleaved(cfg)
    assert mel_dft_tc.columns(400) == 408 and bases.shape == (400, 408)  # 402 → 408, not 576
    np.testing.assert_array_equal(bases[:, 0:402:2], C)
    np.testing.assert_array_equal(bases[:, 1:402:2], S)
    assert not bases[:, 402:].any()
    odd = mel_dft_tc.interleaved(MelConfig(**DFT_GEOMETRIES["n255"]))
    assert odd.shape == (200, 256)  # K = 128 bins, win 200 a multiple of 8
    assert mel_dft_tc.rows(203) == 208 and mel_dft_tc.interleaved(
        dataclasses.replace(cfg, win_length=203)).shape == (208, 408)
    assert not mel_dft_tc.interleaved(dataclasses.replace(cfg, win_length=203))[203:].any()


def test_planes_add_back_to_the_f32_bases_and_pack_in_fragment_order():
    cfg = MelConfig(**DFT_GEOMETRIES["n400"])
    bases = mel_dft_tc.interleaved(cfg)
    big, small = mel_dft_tc.planes(cfg)
    assert not (big.view(np.int32) & 0x1FFF).any() and not (small.view(np.int32) & 0x1FFF).any()
    np.testing.assert_allclose(big.astype(np.float64) + small, bases, rtol=2.0 ** -21, atol=0)
    frag = mel_dft_tc.tables(cfg)
    # 51 n8 tiles: 2 passes of 26 (wgmma's n208), 50 k8 steps, both planes
    assert mel_dft_tc.passes(400) == 2
    assert frag.shape == (2, 50, 2, 26, 2, 8, 4) and frag.dtype == np.float32
    flat = frag.reshape(-1)
    for p, s, q, h, r, e in ((0, 0, 0, 0, 0, 0), (1, 7, 13, 1, 5, 3), (1, 49, 24, 1, 7, 2),
                             (0, 21, 25, 0, 2, 1)):
        k, n = 8 * s + 4 * h + e, 8 * (26 * p + q) + r
        for plane, want in ((0, big), (1, small)):
            # the byte offsets wgmma's descriptor walks: a k8 step's tile per
            # plane, n8 groups 256 bytes apart, k halves 128, 16-byte rows
            i = (((p * 50 + s) * 2 + plane) * mel_dft_tc.TILE_FLOATS
                 + q * 64 + h * 32 + r * 4 + e)
            assert flat[i] == frag[p, s, plane, q, h, r, e] == want[k, n]
    # a pass's slab of one k8 step is contiguous, both planes
    assert mel_dft_tc.SLAB_FLOATS == frag[0, 0].size
    # columns past the last tile, up to a whole pass, are zero
    assert not frag[1, :, :, 25:].any()
    odd = mel_dft_tc.tables(MelConfig(**DFT_GEOMETRIES["n255"]))
    assert odd.shape == (2, 25, 2, 26, 2, 8, 4) and not odd[1, :, :, 6:].any()


def test_band_weights_are_the_filterbanks_nonzero_runs():
    for geo in DFT_GEOMETRIES.values():
        cfg = MelConfig(**geo)
        fb = melspec.mel_filterbank(SR, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
        bw = mel_dft_tc.band_weights(cfg, SR)
        n_pass, M = mel_dft_tc.passes(cfg.n_fft), cfg.n_mels
        lo, hi, off = bw["bands"][:3 * M].reshape(3, M)
        ma, mb = bw["bands"][3 * M:].reshape(2, n_pass)
        for p in range(n_pass):  # the filters that reach pass p's bins, and no other
            p_lo, p_hi = p * mel_dft_tc.PASS_BINS, (p + 1) * mel_dft_tc.PASS_BINS
            reach = [m for m in range(M) if lo[m] < p_hi and hi[m] > p_lo]
            assert reach == list(range(ma[p], mb[p])) and reach
        for m in range(cfg.n_mels):
            np.testing.assert_array_equal(bw["weights"][off[m]:off[m] + hi[m] - lo[m]],
                                          fb[lo[m]:hi[m], m])
            assert not fb[:lo[m], m].any() and not fb[hi[m]:, m].any()
        assert bw["weights"].size <= 2 * (cfg.n_fft // 2 + 1)  # each bin in two filters at most


def test_span_layout_and_shared_memory():
    for hop in (160, 100, 128, 1, 3, 513):
        pitch = mel_dft_tc.span_pitch(hop)
        assert pitch >= hop and pitch % 8 == 4
        banks = {(g * pitch + tq) % 32 for g in range(8) for tq in range(4)}
        assert len(banks) == 32  # a fragment load's lanes on 32 banks
        offs = mel_dft_tc.column_offsets(400, hop)
        n = np.arange(400)
        np.testing.assert_array_equal(offs, (n // hop) * pitch + n % hop)
    # frame f's sample n: row f + n // hop of the span, all inside it
    assert mel_dft_tc.span_rows(400, 160) == 64 + 2
    for name, geo in DFT_GEOMETRIES.items():
        cfg = MelConfig(**geo)
        need = mel_dft_tc.smem_bytes(cfg)
        assert need <= mel_fft.SMEM_LIMIT, name
        # more than one CTA an SM: the H100's 228 KB, 1 KB of it kept per CTA
        assert H100_SMEM_PER_SM // (need + 1024) >= 2, name
    # the power tile of a pass fits over the slabs, its rows g = 0..7 on 8
    # bank groups
    assert mel_dft_tc.FRAME_TILE * mel_dft_tc.POWER_PITCH <= (
        mel_dft_tc.STAGES * mel_dft_tc.SLAB_FLOATS)
    assert len({g * mel_dft_tc.POWER_PITCH % 32 for g in range(8)}) == 8
    # a hop and win whose CTA does not fit are refused by the route
    wide = MelConfig(n_fft=400, win_length=400, hop_length=1000)
    assert mel_dft_tc.smem_bytes(wide) > mel_fft.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared"):
        cuda_melspec.log_mel_route(wide, SR)
