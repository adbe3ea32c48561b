"""B6: the fused log-mel frontend of config #4 (window, spectrum, power, mel,
log) in one kernel, chosen by n_fft between two routes.

Port of ``voicemap_tpu/ops/pallas_melspec.py :: pallas_log_mel``. The
kernels are in ``csrc/log_mel.cu``:

- the FFT route (``log_mel_fft_kernel``), for n_fft a power of two in
  [64, 1024] (config #4's 512): a real FFT in f32 on the CUDA cores, its
  tables and a plain model of its schedule in ``ops/mel_fft``;
- the DFT route (``log_mel_tc_kernel``), for any other n_fft ≤ 574: the
  DFT as a matmul, as the TPU kernel computes it, on the tensor cores
  (``wgmma``) in 3xTF32 (``csrc/tf32x3.cuh``), its packed bases, span
  layout and a plain model of its arithmetic in ``ops/mel_dft_tc``.

``log_mel_route`` picks one by the config's shape, never on a failure, and
raises for a shape neither takes. ``log_mel_reference`` is the plain PyTorch
version of both, the DFT-as-matmul function in f32:
``log(((F·C)² + (F·S)²)·fb + log_eps)`` with F the ``(B, n_frames, win)``
frame view, C and S the Hann-windowed cos and −sin bases of
``melspec.dft_bases`` and fb the Slaney filterbank. The CPU tests hold it
against ``pallas_log_mel(interpret=True)`` and the rfft reference; the GPU
smoke run holds each kernel against it.

Both kernels frame from the waveform at ``f·hop`` themselves, for any hop,
any ``win_length ≤ n_fft`` and any T ≥ win. The TPU's duplicate-row batch
padding and block-size search are not ported.

Dispatch is by the input's device: a CPU tensor takes the plain version, a
CUDA tensor launches a kernel, and a failed build or launch raises. Both
refuse a non-float32 input, T < win_length and win_length > n_fft.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..config import MelConfig
from . import mel_dft_tc, mel_fft, melspec

KERNEL_MAX_FREQS = mel_dft_tc.MAX_BINS  # the DFT kernel's bins: n_fft ≤ 574


@functools.lru_cache(maxsize=None)
def _constants(cfg: MelConfig, sample_rate: int, device: torch.device) -> dict:
    """The plain version's bases and filterbank on ``device``, built once per
    (config, rate, device) from the numpy copies, and the filterbank's
    nonzero entries (``band_bins``)."""
    C, S = melspec.dft_bases(cfg)
    fb = melspec.mel_filterbank(sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return {"C": put(C), "S": put(S), "fb": put(fb),
            "band_bins": int(mel_dft_tc.band_weights(cfg, sample_rate)["weights"].size)}


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


def log_mel_route(cfg: MelConfig, sample_rate: int) -> str:
    """The kernel that takes this config on the card: ``"fft"`` for n_fft
    a power of two in [64, 1024], ``"dft"`` for any other n_fft ≤ 574;
    ``ValueError`` for a shape neither takes or whose CTA does not fit the
    H100's shared memory."""
    n_fft, win, hop = cfg.n_fft, cfg.win_length, cfg.hop_length
    if mel_fft.takes(n_fft):
        need = mel_fft.smem_bytes(cfg, mel_fft.fft_tables(cfg, sample_rate)["weights"].size)
        route = "fft"
    elif n_fft & (n_fft - 1) and n_fft // 2 + 1 <= KERNEL_MAX_FREQS:
        need = mel_dft_tc.smem_bytes(
            cfg, mel_dft_tc.band_weights(cfg, sample_rate)["weights"].size)
        route = "dft"
    else:
        raise ValueError(f"log_mel: no kernel takes n_fft {n_fft}: the FFT kernel takes a "
                         f"power of two in [{mel_fft.FFT_MIN}, {mel_fft.FFT_MAX}], the DFT "
                         f"kernel any other n_fft up to {2 * KERNEL_MAX_FREQS - 2}")
    if need > mel_fft.SMEM_LIMIT:
        raise ValueError(f"log_mel: hop {hop} and win {win} need {need} bytes of shared "
                         f"memory a CTA on the {route} route, over {mel_fft.SMEM_LIMIT}")
    return route


@functools.lru_cache(maxsize=None)
def _fft_constants(cfg: MelConfig, sample_rate: int, device: torch.device) -> dict:
    t = mel_fft.fft_tables(cfg, sample_rate)
    return {k: torch.from_numpy(v).to(device) for k, v in t.items()}


@functools.lru_cache(maxsize=None)
def _dft_constants(cfg: MelConfig, sample_rate: int, device: torch.device) -> dict:
    """The DFT kernel's packed bases, column offsets and band weights on
    ``device``."""
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    bw = mel_dft_tc.band_weights(cfg, sample_rate)
    return {"frag": put(mel_dft_tc.tables(cfg)),
            "offs": put(mel_dft_tc.column_offsets(cfg.win_length, cfg.hop_length)),
            "weights": put(bw["weights"]), "bands": put(bw["bands"])}


def log_mel(x: torch.Tensor, cfg: MelConfig, sample_rate: int) -> torch.Tensor:
    """Fused log-mel: ``(B, T)`` or ``(B, T, 1)`` float32 waveform →
    ``(B, n_frames, n_mels)`` float32."""
    x = _waveform(x, cfg)
    if x.device.type == "cpu":
        return log_mel_reference(x, cfg, sample_rate)
    if x.device.type != "cuda":
        raise ValueError(f"log_mel: no kernel for device {x.device}")
    route = log_mel_route(cfg, sample_rate)
    B, T = x.shape
    win, hop = cfg.win_length, cfg.hop_length
    x = x.contiguous()
    F = melspec.num_frames(T, cfg)
    out = torch.empty((B, F, cfg.n_mels), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    from .._build import check, library

    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "fft":
            c = _fft_constants(cfg, sample_rate, x.device)
            err = lib.vm_log_mel_fft(x.data_ptr(), c["tables"].data_ptr(),
                                     c["weights"].data_ptr(), c["bands"].data_ptr(),
                                     out.data_ptr(), B, T, F, win, hop, cfg.n_mels,
                                     c["weights"].numel(), cfg.n_fft.bit_length() - 2,
                                     ctypes.c_float(cfg.log_eps), stream)
        else:
            d = _dft_constants(cfg, sample_rate, x.device)
            err = lib.vm_log_mel_tc(x.data_ptr(), d["frag"].data_ptr(), d["offs"].data_ptr(),
                                    d["weights"].data_ptr(), d["bands"].data_ptr(),
                                    out.data_ptr(), B, T, F, mel_dft_tc.rows(win) // 8, hop,
                                    cfg.n_mels, mel_dft_tc.passes(cfg.n_fft),
                                    d["weights"].numel(), ctypes.c_float(cfg.log_eps), stream)
    check(err, f"log_mel ({route} route) at n_fft {cfg.n_fft}, hop {hop}, win {win}")
    log_mel.launches += 1
    if route == "dft":
        log_mel.dft_launches += 1
    return out


log_mel.launches = 0  # kernel launches, both routes; the CPU path does not count
log_mel.dft_launches = 0  # of which the DFT route's


def log_mel_work(B: int, T: int, cfg: MelConfig, sample_rate: int) -> dict:
    """Work at these shapes.

    ``bytes``: the waveform read once, the log-mel written once. ``ops``:
    the least arithmetic of the function, by the rfft route a frame, which
    is the FFT kernel's own algorithm: the window (``win``), a real FFT of
    ``n_fft`` points (``2.5·n·log₂ n``, half the radix-2 count of a complex
    one), the power (``3K``), the mel product over the filterbank's nonzero
    bands (``2·Σ band``) and the log (``M``). ``dft_ops``: what the DFT
    route's DFT-as-matmul algorithm does, the ``2·win·2K`` products a frame
    and the same mel bands; the DFT kernel runs those products three times,
    in 3xTF32 (``dft_tf32x3_ops``).
    """
    F = melspec.num_frames(T, cfg)
    K = cfg.n_fft // 2 + 1
    bins = _constants(cfg, sample_rate, torch.device("cpu"))["band_bins"]
    mel_ops = 2.0 * bins
    fft_ops = cfg.win_length + 2.5 * cfg.n_fft * math.log2(cfg.n_fft) + 3.0 * K + cfg.n_mels
    return {"bytes": 4.0 * B * T + 4.0 * B * F * cfg.n_mels,
            "ops": B * F * (fft_ops + mel_ops),
            "dft_ops": B * F * (2.0 * cfg.win_length * 2 * K + mel_ops),
            "dft_tf32x3_ops": B * F * 3 * 2.0 * cfg.win_length * 2 * K}
