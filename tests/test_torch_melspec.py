"""The port's log-mel frontend (``ops/melspec``, ``ops/cuda_melspec``) against
the JAX package's, on the CPU.

The numpy copies must give the JAX package's arrays bit for bit. The B6
plain version (a DFT matmul in f32) is held against ``pallas_log_mel`` in
interpret mode in both of the TPU kernel's geometries, and the rfft route
against JAX's rfft route. Tolerance: 2e-5 absolute on the log-mel, tighter
than the JAX package's own 1e-3 (``tests/test_melspec.py``) because both
sides sum in f32 here (no TPU matmul passes): the largest difference seen is
1.5e-6, from f32 sums of 200–384 window terms in other orders, relative
errors of ~1e-6 in the mel power that the log turns into absolute ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.config import MelConfig as JaxMelConfig
from voicemap_tpu.ops import melspec as jmel
from voicemap_tpu.ops.pallas_melspec import pallas_log_mel
from voicemap_tpu_torch.config import MelConfig
from voicemap_tpu_torch.ops import cuda_melspec, mel_dft_tc, melspec

SR = 16000
LOGMEL_ATOL = 2e-5
T = 5120
# The TPU's fused geometry (hop and win multiples of 128: config #4's) and
# its pre-framed one (librosa's 80/200 at n_fft 256).
GEOMETRIES = {"fused": dict(n_fft=512, hop_length=128, win_length=384, n_mels=32),
              "preframed": dict(n_fft=256, hop_length=80, win_length=200, n_mels=32)}


def waveform(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_numpy_copies_equal_the_jax_packages(geometry):
    cfg, jcfg = MelConfig(**GEOMETRIES[geometry]), JaxMelConfig(**GEOMETRIES[geometry])
    for got, want in zip(melspec.dft_bases(cfg), jmel.dft_bases(jcfg)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for args in ((SR, cfg.n_fft, cfg.n_mels), (SR, 512, 64, 0.0, 8000.0),
                 (8000, 256, 40, 100.0, None, True)):
        assert np.array_equal(melspec.mel_filterbank(*args), jmel.mel_filterbank(*args))
    for n in (cfg.win_length, 7):
        for periodic in (True, False):
            assert np.array_equal(melspec.hann_window(n, periodic), jmel.hann_window(n, periodic))
    f = np.array([0.0, 250.0, 999.0, 1000.0, 4000.0, 7999.0])
    for htk in (False, True):
        assert np.array_equal(melspec.hz_to_mel(f, htk), jmel.hz_to_mel(f, htk))
        assert np.array_equal(melspec.mel_to_hz(f / 100, htk), jmel.mel_to_hz(f / 100, htk))
    assert melspec.num_frames(T, cfg) == jmel.num_frames(T, jcfg)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("B", [1, 5])
def test_reference_matches_the_pallas_kernel(geometry, B):
    cfg, jcfg = MelConfig(**GEOMETRIES[geometry]), JaxMelConfig(**GEOMETRIES[geometry])
    x = waveform(B, (B, T))
    want = np.asarray(pallas_log_mel(jnp.asarray(x), jcfg, SR, interpret=True))
    got = cuda_melspec.log_mel_reference(torch.from_numpy(x), cfg, SR)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert want.shape == (B, melspec.num_frames(T, cfg), cfg.n_mels)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGMEL_ATOL)


def test_wrapper_takes_b_t_1_input_and_runs_the_plain_version_on_the_cpu():
    cfg, jcfg = MelConfig(**GEOMETRIES["preframed"]), JaxMelConfig(**GEOMETRIES["preframed"])
    x = waveform(2, (2, 1600, 1))
    want = np.asarray(pallas_log_mel(jnp.asarray(x), jcfg, SR, block_rows=2, interpret=True))
    before = cuda_melspec.log_mel.launches
    got = cuda_melspec.log_mel(torch.from_numpy(x), cfg, SR)
    assert cuda_melspec.log_mel.launches == before  # the CPU path launches nothing
    assert torch.equal(got, cuda_melspec.log_mel_reference(torch.from_numpy(x[..., 0]), cfg, SR))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGMEL_ATOL)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_rfft_route_matches_the_jax_packages(geometry):
    cfg, jcfg = MelConfig(**GEOMETRIES[geometry]), JaxMelConfig(**GEOMETRIES[geometry])
    x = waveform(7, (3, T - 17))
    want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(x), jcfg, SR))
    got = melspec.log_mel_spectrogram(torch.from_numpy(x), cfg, SR)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGMEL_ATOL)
    # and the DFT matmul of the plain version is the same function
    np.testing.assert_allclose(cuda_melspec.log_mel_reference(torch.from_numpy(x), cfg, SR),
                               got.numpy(), rtol=0, atol=LOGMEL_ATOL)
    frames = melspec.frame_signal(torch.from_numpy(x), cfg.win_length, cfg.hop_length)
    np.testing.assert_array_equal(frames.numpy(),
                                  np.asarray(jmel.frame_signal(jnp.asarray(x), cfg.win_length,
                                                               cfg.hop_length)))


def test_wrapper_refuses_short_input_and_other_dtypes():
    cfg = MelConfig(**GEOMETRIES["fused"])
    with pytest.raises(ValueError, match="shorter than one window"):
        cuda_melspec.log_mel(torch.zeros(2, cfg.win_length - 1), cfg, SR)
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(ValueError, match="float32"):
            cuda_melspec.log_mel(torch.zeros(2, T, dtype=dtype), cfg, SR)
    with pytest.raises(ValueError, match="n_fft"):
        cuda_melspec.log_mel(torch.zeros(2, T), MelConfig(n_fft=256, win_length=400), SR)
    assert cuda_melspec.log_mel(torch.zeros(2, cfg.win_length), cfg, SR).shape == (2, 1, 32)


def test_kernel_constants_pack_the_bases_and_the_filter_bands():
    """The kernel's packed operands hold what the plain version multiplies:
    the DFT kernel's bases with bin k's C and S in columns 2k and 2k + 1 and
    zero columns past 2K, and band weights that are the filterbank's
    nonzero runs, bands that cover every nonzero of it."""
    cfg = MelConfig(hop_length=128, win_length=384)  # config #4's frontend
    c = cuda_melspec._constants(cfg, SR, torch.device("cpu"))
    K = cfg.n_fft // 2 + 1
    cs = mel_dft_tc.interleaved(cfg)
    assert cs.shape == (384, 520)  # 2K = 514 columns, padded to the n8 tile
    np.testing.assert_array_equal(cs[:, 0:2 * K:2], c["C"].numpy())
    np.testing.assert_array_equal(cs[:, 1:2 * K:2], c["S"].numpy())
    assert not cs[:, 2 * K:].any()
    fb = c["fb"].numpy()
    bw = mel_dft_tc.band_weights(cfg, SR)
    lo, hi, off = bw["bands"][:3 * cfg.n_mels].reshape(3, cfg.n_mels)
    inside = (np.arange(K)[:, None] >= lo) & (np.arange(K)[:, None] < hi)
    assert not fb[~inside].any() and (fb[inside] > 0).all()
    np.testing.assert_array_equal(bw["weights"], np.concatenate(
        [fb[lo[m]:hi[m], m] for m in range(cfg.n_mels)]))
    np.testing.assert_array_equal(off, np.concatenate([[0], np.cumsum(hi - lo)[:-1]]))
    assert c["band_bins"] == bw["weights"].size == int((hi - lo).sum())
    work = cuda_melspec.log_mel_work(2048, 48000, cfg, SR)
    assert work["bytes"] == 4.0 * 2048 * 48000 + 4.0 * 2048 * 373 * 64
    # the function's least work: window, a 512-point real FFT (2.5·512·9),
    # power, the mel bands and the log, a frame
    frame = 384 + 2.5 * 512 * 9 + 3 * K + 64 + 2 * c["band_bins"]
    assert work["ops"] == 2048 * 373 * frame
    # the kernel's DFT-as-matmul algorithm
    assert work["dft_ops"] == 2048 * 373 * (2.0 * 384 * 514 + 2.0 * c["band_bins"])
    assert work["dft_ops"] > 25 * work["ops"]
