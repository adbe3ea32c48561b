"""Host side of B6's FFT route (``csrc/log_mel.cu :: log_mel_fft_kernel``).

What the wrapper hands the kernel and what the kernel computes from it,
each piece pinned by a CPU test (``tests/test_torch_mel_fft.py``):

- ``plan``: the radices of the complex FFT of ``nc = n_fft / 2`` points,
  one Stockham pass each, as the kernel runs them;
- ``fft_tables``: the window pairs, each pass's twiddles laid out by lane
  and the real split pass's ``W_N^k``, each computed in float64 and
  rounded once to f32, and each mel filter's band of nonzero bins with its
  weights packed;
- ``smem_bytes``: the kernel's shared memory at a geometry, the rule by
  which the wrapper refuses one that does not fit;
- ``rfft_model`` and ``log_mel_model``: a plain PyTorch model of the
  kernel's schedule built from those tables (the passes, their twiddles,
  the radix-8/4/2 butterflies, the split pass, the power, the mel bands,
  the log). The tests hold it against ``torch.fft.rfft`` and the JAX
  package's kernel; nothing on the serving path calls it.

The real FFT of N = n_fft samples is a complex FFT of nc = N/2 points,
``z[n] = x[2n] + i·x[2n+1]``, then the split pass
``X[k] = ½(Z[k] + Z*[nc−k]) − ½·i·W_N^k·(Z[k] − Z*[nc−k])``, k = 0 … nc,
with ``Z[nc] = Z[0]``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import MelConfig
from . import melspec

FFT_MIN, FFT_MAX = 64, 1024  # the n_fft the kernel takes: powers of two
THREADS = 256
WARPS = THREADS // 32
FRAMES_PER_WARP = 8
FRAME_TILE = WARPS * FRAMES_PER_WARP  # 64 frames a CTA
SMEM_LIMIT = 232448  # the H100's dynamic shared memory per block
# radices of each Stockham pass, by the complex FFT's size nc
_PLANS = {32: (8, 4), 64: (8, 8), 128: (8, 4, 4), 256: (8, 8, 4), 512: (8, 8, 8)}


def takes(n_fft: int) -> bool:
    """Whether the FFT kernel takes this n_fft: a power of two in
    [FFT_MIN, FFT_MAX]."""
    return FFT_MIN <= n_fft <= FFT_MAX and n_fft & (n_fft - 1) == 0


def plan(nc: int) -> tuple[int, ...]:
    """The radices of the kernel's passes over an ``nc``-point complex FFT."""
    return _PLANS[nc]


def twiddle_entries(nc: int) -> int:
    """Entries of the passes' twiddle tables: NS·(R − 1) for each pass
    after the first (the kernel's ``twiddle_entries``)."""
    n, ns = 0, 1
    for radix in plan(nc):
        n += ns * (radix - 1) if ns > 1 else 0
        ns *= radix
    return n


def padded(i):
    """The kernel's index into a warp's complex buffer: one pad slot after
    every 8, so the passes' strided exchanges miss each other's banks."""
    return i + (i >> 3)


@functools.lru_cache(maxsize=None)
def fft_tables(cfg: MelConfig, sample_rate: int) -> dict:
    """The kernel's constant operands, numpy f32 / int32.

    ``tables`` (2·nc + 1 + twiddle_entries(nc), 2): the window pairs
    ``(w[2n], w[2n+1])`` with zeros at and past ``win``; for each pass after
    the first (NS points already combined, radix R) ``W_{NS·R}^{t·r}`` at
    ``t·(R − 1) + r − 1``, t < NS, 1 ≤ r < R; then ``W_N^k`` for k ≤ nc; as
    (re, im), each from float64 rounded once. ``bands``
    (3, M): each filter's first and one-past-last nonzero bin and the
    offset of its weights in ``weights``, the filters' nonzero runs
    concatenated."""
    n_fft, win = cfg.n_fft, cfg.win_length
    nc = n_fft // 2
    w = np.zeros(n_fft, np.float32)
    w[:win] = melspec.hann_window(win)
    passes, ns = [], 1
    for radix in plan(nc):
        if ns > 1:
            t, r = np.meshgrid(np.arange(ns), np.arange(1, radix), indexing="ij")
            passes.append(np.exp(-2j * np.pi * (t * r).ravel() / (ns * radix)))
        ns *= radix
    tw = np.concatenate(passes)
    split = np.exp(-2j * np.pi * np.arange(nc + 1) / n_fft)
    tables = np.concatenate([w.reshape(nc, 2),
                             np.stack([tw.real, tw.imag], 1),
                             np.stack([split.real, split.imag], 1)]).astype(np.float32)
    fb = melspec.mel_filterbank(sample_rate, n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    nz = fb != 0
    lo = np.where(nz.any(0), nz.argmax(0), 0)
    hi = np.where(nz.any(0), nc + 1 - nz[::-1].argmax(0), 0)
    off = np.concatenate([[0], np.cumsum(hi - lo)[:-1]])
    weights = np.concatenate([fb[lo[j]:hi[j], j] for j in range(cfg.n_mels)] +
                             [np.zeros(0, np.float32)]).astype(np.float32)
    return {"tables": tables, "bands": np.stack([lo, hi, off]).astype(np.int32),
            "weights": weights}


def smem_bytes(cfg: MelConfig, n_weights: int) -> int:
    """Shared memory of one CTA: the tables, one padded complex buffer a
    warp, the waveform span of FRAME_TILE frames, the band weights and the
    bands."""
    nc = cfg.n_fft // 2
    span = (FRAME_TILE - 1) * cfg.hop_length + cfg.win_length
    span += span & 1
    return (8 * (2 * nc + 1 + twiddle_entries(nc)) + 8 * WARPS * padded(nc) + 4 * span
            + 4 * n_weights + 12 * cfg.n_mels)


def _butterfly(v: list) -> list:
    """The kernel's R-point DFT of ``v`` (R = 2, 4, 8), op for op: radix 8
    as two radix-4s of the even and odd points and one W_8 stage."""
    if len(v) == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if len(v) == 4:
        a0, a1 = v[0] + v[2], v[0] - v[2]
        a2, d = v[1] + v[3], v[1] - v[3]
        a3 = torch.complex(d.imag, -d.real)  # −i·d
        return [a0 + a2, a1 + a3, a0 - a2, a1 - a3]
    e, o = _butterfly(v[0::2]), _butterfly(v[1::2])
    r = 0.5 ** 0.5
    o1 = torch.complex((o[1].real + o[1].imag) * r, (o[1].imag - o[1].real) * r)  # W8
    o2 = torch.complex(o[2].imag, -o[2].real)  # W8² = −i
    o3 = torch.complex((o[3].imag - o[3].real) * r, -(o[3].real + o[3].imag) * r)  # W8³
    o = [o[0], o1, o2, o3]
    return [e[j] + o[j] for j in range(4)] + [e[j] - o[j] for j in range(4)]


def rfft_model(x: torch.Tensor, cfg: MelConfig, sample_rate: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's real FFT of frames ``x (F, win)`` → ``(F, nc + 1)``
    complex: window, pack even/odd samples, the Stockham passes of
    ``plan``, the split pass; in ``dtype`` (f32 as the kernel, f64 to test
    the schedule itself), from the f32 tables."""
    nc = cfg.n_fft // 2
    tab = torch.from_numpy(fft_tables(cfg, sample_rate)["tables"]).to(x.device, dtype)
    cplx = lambda t: torch.complex(t[..., 0], t[..., 1])  # noqa: E731
    n_tw = twiddle_entries(nc)
    wpair, tw, split = cplx(tab[:nc]), cplx(tab[nc:nc + n_tw]), cplx(tab[nc + n_tw:])
    xp = torch.zeros(x.shape[0], cfg.n_fft, dtype=dtype, device=x.device)
    xp[:, :cfg.win_length] = x.to(dtype)
    z = torch.complex(xp[:, 0::2] * wpair.real, xp[:, 1::2] * wpair.imag)
    ns, base = 1, 0
    for radix in plan(nc):
        nbf = nc // radix
        j = torch.arange(nbf, device=x.device)
        t = j % ns
        v = [z[:, j + r * nbf] for r in range(radix)]
        if ns > 1:
            v = [v[0]] + [v[r] * tw[base + t * (radix - 1) + r - 1] for r in range(1, radix)]
            base += ns * (radix - 1)
        v = _butterfly(v)
        out = torch.empty_like(z)
        dst = (j // ns) * ns * radix + t
        for r in range(radix):
            out[:, dst + r * ns] = v[r]
        z, ns = out, ns * radix
    k = torch.arange(nc + 1, device=x.device)
    a, b = z[:, k % nc], z[:, (nc - k) % nc].conj()
    fe = (a + b) * 0.5
    d = (a - b) * 0.5
    fo = torch.complex(d.imag, -d.real)  # −i·(a − b)/2
    return fe + split * fo


def log_mel_model(x: torch.Tensor, cfg: MelConfig, sample_rate: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's log-mel ``(B, T)`` → ``(B, n_frames, M)``: the frames
    through ``rfft_model``, the power, each filter's band in bin order, the
    log."""
    B = x.shape[0]
    frames = melspec.frame_signal(x.to(dtype), cfg.win_length, cfg.hop_length)
    F = frames.shape[1]
    spec = rfft_model(frames.reshape(B * F, cfg.win_length), cfg, sample_rate, dtype)
    power = spec.real * spec.real + spec.imag * spec.imag
    tab = fft_tables(cfg, sample_rate)
    wts = torch.from_numpy(tab["weights"]).to(x.device, dtype)
    out = torch.empty(B * F, cfg.n_mels, dtype=dtype, device=x.device)
    for m, (lo, hi, off) in enumerate(tab["bands"].T.tolist()):
        out[:, m] = power[:, lo:hi] @ wts[off:off + hi - lo]
    return torch.log(out + cfg.log_eps).reshape(B, F, cfg.n_mels)
