"""B6: the fused log-mel frontend of config #4 (STFT as a DFT matmul, power,
mel, log) in one kernel.

Port of ``voicemap_tpu/ops/pallas_melspec.py :: pallas_log_mel``. The kernel
is ``csrc/log_mel.cu``; ``log_mel_reference`` is its plain PyTorch version,
the same DFT-as-matmul function in f32:
``log(((F·C)² + (F·S)²)·fb + log_eps)`` with F the ``(B, n_frames, win)``
frame view, C and S the Hann-windowed cos and −sin bases of
``melspec.dft_bases`` and fb the Slaney filterbank. The CPU tests hold it
against ``pallas_log_mel(interpret=True)`` and the rfft reference; the GPU
smoke run holds the kernel against it.

One kernel serves both of the TPU's framings: it frames from the waveform at
``f·hop`` itself, for any hop, any ``win_length ≤ n_fft`` and any T ≥ win.
The TPU's duplicate-row batch padding and block-size search are not ported.

Dispatch is by the input's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel, and a failed build or launch raises. Both
refuse a non-float32 input, T < win_length and win_length > n_fft.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..config import MelConfig
from . import melspec

KERNEL_MAX_FREQS = 288  # the kernel's padded frequency columns: n_fft ≤ 574


@functools.lru_cache(maxsize=None)
def _constants(cfg: MelConfig, sample_rate: int, device: torch.device) -> dict:
    """The bases, filterbank and the kernel's packed forms on ``device``,
    built once per (config, rate, device) from the numpy copies."""
    C, S = melspec.dft_bases(cfg)
    fb = melspec.mel_filterbank(sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    win, K = C.shape
    cs = np.zeros((win, 2, KERNEL_MAX_FREQS), np.float32)
    if K <= KERNEL_MAX_FREQS:
        cs[:, 0, :K], cs[:, 1, :K] = C, S
    nz = fb != 0
    lo = np.where(nz.any(0), nz.argmax(0), 0)
    hi = np.where(nz.any(0), K - nz[::-1].argmax(0), 0)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return {"C": put(C), "S": put(S), "fb": put(fb), "cs": put(cs), "fbt": put(fb.T),
            "bands": put(np.stack([lo, hi]).astype(np.int32)),
            "band_bins": int((hi - lo).sum())}


def _waveform(x: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """``(B, T)`` or ``(B, T, 1)`` f32 → ``(B, T)``, checked."""
    if x.dim() == 3 and x.shape[-1] == 1:
        x = x[..., 0]
    if x.dim() != 2:
        raise ValueError(f"log_mel: x must be (B, T) or (B, T, 1), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"log_mel: x must be float32, got {x.dtype}")
    if cfg.win_length > cfg.n_fft:
        raise ValueError(f"log_mel: win_length {cfg.win_length} > n_fft {cfg.n_fft}")
    if x.shape[1] < cfg.win_length:
        raise ValueError(f"log_mel: T = {x.shape[1]} is shorter than one window "
                         f"({cfg.win_length})")
    return x


def log_mel_reference(x: torch.Tensor, cfg: MelConfig, sample_rate: int) -> torch.Tensor:
    """Plain PyTorch version of the B6 kernel → ``(B, n_frames, n_mels)`` f32."""
    x = _waveform(x, cfg)
    c = _constants(cfg, sample_rate, x.device)
    frames = melspec.frame_signal(x, cfg.win_length, cfg.hop_length)
    re = frames @ c["C"]
    im = frames @ c["S"]
    power = re * re + im * im
    return torch.log(power @ c["fb"] + cfg.log_eps)


def log_mel(x: torch.Tensor, cfg: MelConfig, sample_rate: int) -> torch.Tensor:
    """Fused log-mel: ``(B, T)`` or ``(B, T, 1)`` float32 waveform →
    ``(B, n_frames, n_mels)`` float32."""
    x = _waveform(x, cfg)
    if x.device.type == "cpu":
        return log_mel_reference(x, cfg, sample_rate)
    if x.device.type != "cuda":
        raise ValueError(f"log_mel: no kernel for device {x.device}")
    B, T = x.shape
    win, hop = cfg.win_length, cfg.hop_length
    K = cfg.n_fft // 2 + 1
    if K > KERNEL_MAX_FREQS:
        raise ValueError(f"log_mel: the kernel takes n_fft up to {2 * KERNEL_MAX_FREQS - 2}")
    x = x.contiguous()
    F = melspec.num_frames(T, cfg)
    out = torch.empty((B, F, cfg.n_mels), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    c = _constants(cfg, sample_rate, x.device)
    from .._build import check, library

    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vm_log_mel(x.data_ptr(), c["cs"].data_ptr(), c["fbt"].data_ptr(),
                             c["bands"].data_ptr(), out.data_ptr(), B, T, F, win, hop,
                             cfg.n_mels, K, ctypes.c_float(cfg.log_eps), stream)
    # A hop and win whose frame tile does not fit a CTA's shared memory is
    # refused by the entry point (cudaErrorInvalidValue).
    check(err, f"log_mel at hop {hop}, win {win}")
    log_mel.launches += 1
    return out


log_mel.launches = 0  # kernel launches; the CPU path does not count


def log_mel_work(B: int, T: int, cfg: MelConfig, sample_rate: int) -> dict:
    """Work at these shapes.

    ``bytes``: the waveform read once, the log-mel written once. ``ops``:
    the least arithmetic of the function, by the rfft route a frame: the
    window (``win``), a real FFT of ``n_fft`` points (``2.5·n·log₂ n``, half
    the radix-2 count of a complex one), the power (``3K``), the mel product
    over the filterbank's nonzero bands (``2·Σ band``) and the log (``M``).
    ``dft_ops``: what this kernel's DFT-as-matmul algorithm does, the
    ``2·win·2K`` products a frame and the same mel bands.
    """
    F = melspec.num_frames(T, cfg)
    K = cfg.n_fft // 2 + 1
    bins = _constants(cfg, sample_rate, torch.device("cpu"))["band_bins"]
    mel_ops = 2.0 * bins
    fft_ops = cfg.win_length + 2.5 * cfg.n_fft * math.log2(cfg.n_fft) + 3.0 * K + cfg.n_mels
    return {"bytes": 4.0 * B * T + 4.0 * B * F * cfg.n_mels,
            "ops": B * F * (fft_ops + mel_ops),
            "dft_ops": B * F * (2.0 * cfg.win_length * 2 * K + mel_ops)}
