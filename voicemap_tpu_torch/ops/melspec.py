"""Log-mel spectrogram frontend (config #4): the plain PyTorch reference.

Port of ``voicemap_tpu/ops/melspec.py``. The numpy functions (``hz_to_mel``,
``mel_to_hz``, ``mel_filterbank``, ``hann_window``, ``dft_bases``,
``num_frames``) are copied as they are: the JAX module imports JAX, so the
port keeps its own copy, and ``tests/test_torch_melspec.py`` holds the
arrays equal bit for bit. ``frame_signal`` and ``log_mel_spectrogram`` are
torch functions; the latter keeps the reference's rfft route (Hann window,
centered=False framing, zero-pad to ``n_fft``, power spectrum, Slaney mel
filterbank, ``log(· + log_eps)``). The serving path does not call it: it
runs the B6 kernel (``ops/cuda_melspec``), whose plain version is the same
function as a DFT matmul.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import MelConfig


def hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above.
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log_branch = min_log_mel + np.log(
            np.maximum(f, 1e-300) / min_log_hz
        ) / logstep
    return np.where(f >= min_log_hz, log_branch, mels)


def mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs
    )


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
) -> np.ndarray:
    """(n_freq, n_mels) triangular filterbank, Slaney-normalized."""
    fmax = fmax or sample_rate / 2
    n_freq = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_freq)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    fb = np.zeros((n_freq, n_mels))
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
        # Slaney area normalization.
        fb[:, m] *= 2.0 / (hi - lo)
    return fb.astype(np.float32)


def hann_window(n: int, periodic: bool = True) -> np.ndarray:
    """Hann window; ``periodic=True`` matches librosa/scipy ``fftbins=True``
    (denominator N, not N−1 — np.hanning is the symmetric variant)."""
    k = np.arange(n)
    denom = n if periodic else n - 1
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / denom)).astype(np.float32)


def dft_bases(cfg: MelConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed cos/sin DFT bases (win_length, n_freq) for the matmul-form
    STFT: power[f] = (x·C[:,f])² + (x·S[:,f])². Window folded into the basis."""
    n_freq = cfg.n_fft // 2 + 1
    n = np.arange(cfg.win_length)[:, None]
    k = np.arange(n_freq)[None, :]
    ang = 2.0 * np.pi * n * k / cfg.n_fft
    w = hann_window(cfg.win_length)[:, None]
    C = (np.cos(ang) * w).astype(np.float32)
    S = (-np.sin(ang) * w).astype(np.float32)
    return C, S


def num_frames(T: int, cfg: MelConfig) -> int:
    return 1 + (T - cfg.win_length) // cfg.hop_length


def frame_signal(x: torch.Tensor, win_length: int, hop_length: int) -> torch.Tensor:
    """(B, T) → (B, n_frames, win_length), centered=False framing (a view)."""
    return x.unfold(-1, win_length, hop_length)


def log_mel_spectrogram(x: torch.Tensor, cfg: MelConfig, sample_rate: int) -> torch.Tensor:
    """(B, T) or (B, T, 1) waveform → (B, n_frames, n_mels) float32 log-mel.

    Hann window → zero-pad to n_fft → power spectrum → mel → log(·+eps).
    """
    if x.dim() == 3:
        x = x[..., 0]
    frames = frame_signal(x.float(), cfg.win_length, cfg.hop_length)
    frames = frames * torch.from_numpy(hann_window(cfg.win_length)).to(x.device)
    spec = torch.fft.rfft(frames, n=cfg.n_fft, dim=-1)  # zero-pads past win_length
    power = spec.real.square() + spec.imag.square()
    fb = torch.from_numpy(
        mel_filterbank(sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)).to(x.device)
    return torch.log(power @ fb + cfg.log_eps)
