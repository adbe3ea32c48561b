"""B6's FFT route on the CPU: the plain model of the kernel's schedule.

``ops/mel_fft.py`` builds the tables the wrapper hands
``csrc/log_mel.cu :: log_mel_fft_kernel`` and a plain PyTorch model of the
kernel's schedule from them (the Stockham passes of radix 8/4/2 and their
twiddles, the real split pass, the power, the mel bands in bin order, the
log). The kernel itself runs only on the card. Here the model is held:

- against ``torch.fft.rfft`` in float64 for N = 64 … 1024: within
  4·log₂N·u·Σ|x·w| (u = 2⁻²⁴), the error the f32-rounded twiddles allow;
- against ``pallas_log_mel(interpret=True)`` at both geometries of
  ``tests/test_torch_melspec.py``, at its ``LOGMEL_ATOL``;
- on a pure tone (against float64 truth) and an all-zero row;

and the wrapper's route choice by shape (512 and 256 take the FFT kernel,
400 the DFT kernel), its refusals, and the tables' contents are pinned.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_melspec import GEOMETRIES, LOGMEL_ATOL, SR, waveform
from voicemap_tpu.config import MelConfig as JaxMelConfig
from voicemap_tpu.ops.pallas_melspec import pallas_log_mel
from voicemap_tpu_torch.config import MelConfig
from voicemap_tpu_torch.ops import cuda_melspec, mel_fft, melspec

U = 2.0 ** -24


@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024])
def test_rfft_model_is_the_real_fft_in_float64(n_fft):
    cfg = MelConfig(n_fft=n_fft, win_length=n_fft - n_fft // 4, hop_length=n_fft // 4,
                    n_mels=16)
    x = torch.from_numpy(np.random.default_rng(n_fft).standard_normal((7, cfg.win_length)))
    got = mel_fft.rfft_model(x, cfg, SR, torch.float64)
    xw = x * torch.from_numpy(melspec.hann_window(cfg.win_length)).double()
    want = torch.fft.rfft(xw, n=n_fft)
    assert got.shape == want.shape == (7, n_fft // 2 + 1)
    bound = 4 * np.log2(n_fft) * U * xw.abs().sum(dim=1, keepdim=True)
    assert bool(((got - want).abs() <= bound).all())
    # the two real ends of the split pass
    assert float(got[:, [0, -1]].imag.abs().max()) <= float(bound.max())


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_log_mel_model_matches_the_pallas_kernel(geometry):
    cfg, jcfg = MelConfig(**GEOMETRIES[geometry]), JaxMelConfig(**GEOMETRIES[geometry])
    x = waveform(11, (2, 5120))
    want = np.asarray(pallas_log_mel(jnp.asarray(x), jcfg, SR, interpret=True))
    got = mel_fft.log_mel_model(torch.from_numpy(x), cfg, SR)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGMEL_ATOL)


def test_a_pure_tone_and_a_zero_row():
    """A tone's far bins hold ~1e-8 of its frames' energy, and an f32
    transform's error is relative to the frame's energy, not the bin's: the
    tone is held to float64 truth at the JAX package's own 1e-3
    (``tests/test_melspec.py``; 1.2e-4 seen), the zero row exactly."""
    cfg = MelConfig(n_fft=512, hop_length=128, win_length=384, n_mels=64)
    t = np.arange(4000)
    x = torch.from_numpy(np.stack([np.sin(2 * np.pi * 440.0 / SR * t),
                                   np.zeros(4000)]).astype(np.float32))
    got = mel_fft.log_mel_model(x, cfg, SR)
    frames = melspec.frame_signal(x.double(), cfg.win_length, cfg.hop_length)
    frames = frames * torch.from_numpy(melspec.hann_window(cfg.win_length)).double()
    power = torch.fft.rfft(frames, n=cfg.n_fft).abs() ** 2
    fb = torch.from_numpy(melspec.mel_filterbank(SR, cfg.n_fft, cfg.n_mels)).double()
    want = torch.log(power @ fb + cfg.log_eps)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-3)
    assert bool((got[1] == np.float32(np.log(np.float32(cfg.log_eps)))).all())
    # the tone's energy lands in the filter around 440 Hz
    peak = int(got[0].mean(0).argmax())
    assert fb[int(round(440 / SR * 512)), peak] > 0


@pytest.mark.parametrize("n_fft,win,hop,route", [
    (512, 384, 128, "fft"), (256, 200, 80, "fft"), (1024, 400, 160, "fft"),
    (64, 64, 16, "fft"), (400, 400, 160, "dft"), (300, 256, 100, "dft")])
def test_the_route_is_chosen_by_shape(n_fft, win, hop, route):
    cfg = MelConfig(n_fft=n_fft, win_length=win, hop_length=hop)
    assert cuda_melspec.log_mel_route(cfg, SR) == route
    assert mel_fft.takes(n_fft) == (route == "fft")


@pytest.mark.parametrize("kw,match", [
    (dict(n_fft=2048, win_length=400), "no kernel takes"),
    (dict(n_fft=32, win_length=32, hop_length=8), "no kernel takes"),
    (dict(n_fft=600, win_length=400), "no kernel takes"),
    (dict(n_fft=1024, win_length=1024, hop_length=1024), "shared memory"),
    (dict(n_fft=400, win_length=400, hop_length=3000), "shared memory")])
def test_the_wrapper_refuses_what_neither_kernel_takes(kw, match):
    with pytest.raises(ValueError, match=match):
        cuda_melspec.log_mel_route(MelConfig(**kw), SR)


def test_the_fft_kernels_shared_memory_rule():
    """Config #4's CTA fits with room for three a SM; the rule counts the
    tables, eight padded buffers, the span, the weights and the bands."""
    cfg = MelConfig(n_fft=512, hop_length=128, win_length=384, n_mels=64)
    n_w = mel_fft.fft_tables(cfg, SR)["weights"].size
    smem = mel_fft.smem_bytes(cfg, n_w)
    assert 3 * smem <= mel_fft.SMEM_LIMIT
    assert mel_fft.twiddle_entries(256) == 8 * 7 + 64 * 3
    assert smem == 8 * (513 + 248) + 8 * 8 * 288 + 4 * (63 * 128 + 384) + 4 * n_w + 12 * 64


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_tables_hold_the_window_twiddles_and_bands(geometry):
    cfg = MelConfig(**GEOMETRIES[geometry])
    t = mel_fft.fft_tables(cfg, SR)
    nc = cfg.n_fft // 2
    tab = t["tables"].astype(np.float64)
    n_tw = mel_fft.twiddle_entries(nc)
    assert tab.shape == (2 * nc + 1 + n_tw, 2) and t["tables"].dtype == np.float32
    w = np.zeros(cfg.n_fft, np.float32)
    w[:cfg.win_length] = melspec.hann_window(cfg.win_length)
    np.testing.assert_array_equal(t["tables"][:nc].reshape(-1), w)
    # each pass after the first: W_{NS·R}^{t·r} at t·(R − 1) + r − 1
    passes, ns = [], 1
    for radix in mel_fft.plan(nc):
        if ns > 1:
            passes += [np.exp(-2j * np.pi * t * r / (ns * radix))
                       for t in range(ns) for r in range(1, radix)]
        ns *= radix
    exact = np.concatenate([np.array(passes),
                            np.exp(-2j * np.pi * np.arange(nc + 1) / cfg.n_fft)])
    got = tab[nc:, 0] + 1j * tab[nc:, 1]
    assert np.abs(got.real - exact.real).max() <= U and np.abs(got.imag - exact.imag).max() <= U
    # the packed band weights put the filterbank back together
    fb = melspec.mel_filterbank(SR, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    back = np.zeros_like(fb)
    for m, (lo, hi, off) in enumerate(t["bands"].T):
        back[lo:hi, m] = t["weights"][off:off + hi - lo]
    np.testing.assert_array_equal(back, fb)


def test_padding_spreads_the_exchanges_over_the_banks():
    """Pass 1 writes j·8 + r and pass 2 writes (j / 8)·64 + j % 8 + 8r at
    nc = 256: with a pad after every 8 complex values, the 16 lanes of a
    64-bit half-warp hit 16 distinct 8-byte bank pairs. So do the twiddle
    reads of passes 2 (t = j % 8, 8 distinct) and 3 (t = j) at any r."""
    j = np.arange(16)
    for r in range(8):
        for idx in (j * 8 + r, (j // 8) * 64 + j % 8 + 8 * r):
            assert len(set(mel_fft.padded(idx) % 16)) == 16
    for r in range(1, 8):
        assert len(set((np.arange(8) * 7 + r - 1) % 16)) == 8
    for r in range(1, 4):
        assert len(set((j * 3 + r - 1) % 16)) == 16
