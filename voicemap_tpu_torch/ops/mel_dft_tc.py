"""Host side of B6's DFT route on the tensor cores (``csrc/log_mel.cu ::
log_mel_tc_kernel``), for an n_fft that is no power of two (the librosa
n_fft 400, for one).

The kernel computes the DFT as a matmul, frames (F × win) · bases (win ×
2K), in 3xTF32 (``csrc/tf32x3.cuh``, plain model ``ops/tf32x3``) on
``wgmma``: A, the frames, from registers; B, the bases, from shared memory.
What it takes from the host and what it derives from the launch's shape,
each piece pinned by a CPU test (``tests/test_torch_tf32x3.py``):

- ``interleaved``: the Hann-windowed cos and sin bases of ``melspec.dft_bases``
  with bin k's cos in column 2k and its sin in 2k + 1, so that an n8 tile's
  accumulator pair (2tq, 2tq + 1) is the real and imaginary part of one bin
  in one thread; K bins take ``columns`` = 2K rounded up to the n8 tile
  (402 → 408 at n_fft 400), the window rows ``rows`` = win rounded up to
  the k8 step, both padded with zeros;
- ``planes``: the big and small tf32 planes of those bases, split once;
  ``fragments``: the planes as ``wgmma`` reads B, K-major with no swizzle:
  for each pass of PASS_TILES n8 tiles (208 columns) and each k8 step, the
  big plane's then the small plane's 26 × 2 core matrices (8 columns × 4
  rows, 128 contiguous bytes; the two of a k8 step 128 bytes apart, n8
  groups 256), so a pass's slab of one k8 step is one contiguous run, one
  bulk copy into the CTA's ring of slabs; columns past the last n8 tile, up
  to a whole pass, are zero;
- ``span_pitch`` and ``column_offsets``: the CTA stages its frames' waveform
  span once, as rows of ``hop`` samples at a pitch of ``hop`` rounded up to
  4 mod 8, so frame f starts at row f and the eight frames of an A fragment
  (rows g = 0..7 of a tile) fall on eight different banks; sample n of a
  frame lies ``column_offsets[n]`` past its row's start;
- ``band_weights``: each filter's nonzero run of the filterbank, which the
  CTA keeps in shared memory, its first and one-past-last bin, and the run
  of filters whose bands reach each pass;
- ``smem_bytes``: a CTA's shared memory, by which the wrapper refuses a hop
  and win that do not fit;
- ``log_mel_model``: the kernel's arithmetic in plain PyTorch (the 3xTF32
  spectrum, the power, the bands in bin order, the log), for the CPU tests.

A CTA is one warpgroup and takes FRAME_TILE = 64 frames of one row, the
rows of ``wgmma``'s m64 tile (warp w: frames 16w + g and 16w + g + 8, A in
``mma.m16n8k8``'s layout). It walks the columns in passes of PASS_TILES n8
tiles (m64n208k8, 104 accumulators a thread); after each pass the power of
its bins lands in shared memory over the spent slabs and each filter's band
adds its share of bins, in bin order, to a per-(frame, filter) sum that the
last pass logs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import MelConfig
from . import melspec, tf32x3

FRAME_TILE = 64  # a warpgroup's m64 rows
PASS_TILES = 26  # n8 tiles of a pass: wgmma m64n208k8
PASS_BINS = 4 * PASS_TILES
POWER_PITCH = PASS_BINS + (4 - PASS_BINS % 8) % 8  # 4 mod 8: rows g = 0..7 on 8 bank groups
STAGES = 3  # slabs of one k8 step in flight
TILE_FLOATS = PASS_TILES * 64  # one plane's k8 step of a pass: 26 x 2 core matrices
SLAB_FLOATS = 2 * TILE_FLOATS  # the big and the small plane
MAX_BINS = 288  # n_fft ≤ 574


def columns(n_fft: int) -> int:
    """Interleaved cos/sin columns: 2K rounded up to the n8 tile."""
    return -(-2 * (n_fft // 2 + 1) // 8) * 8


def rows(win: int) -> int:
    """Window rows, rounded up to the k8 step."""
    return -(-win // 8) * 8


def interleaved(cfg: MelConfig) -> np.ndarray:
    """``(rows(win), columns(n_fft))`` f32: bin k's windowed cos in column
    2k, its windowed −sin in 2k + 1, zeros past win and past 2K."""
    C, S = melspec.dft_bases(cfg)
    win, K = C.shape
    out = np.zeros((rows(win), columns(cfg.n_fft)), np.float32)
    out[:win, 0:2 * K:2] = C
    out[:win, 1:2 * K:2] = S
    return out


def planes(cfg: MelConfig) -> tuple[np.ndarray, np.ndarray]:
    """The big and small tf32 planes of ``interleaved(cfg)``."""
    big, small = tf32x3.split(torch.from_numpy(interleaved(cfg)))
    return big.numpy(), small.numpy()


def passes(n_fft: int) -> int:
    """Passes of PASS_TILES n8 tiles over the columns."""
    return -(-columns(n_fft) // (8 * PASS_TILES))


def fragments(big: np.ndarray, small: np.ndarray) -> np.ndarray:
    """``(passes, k8 steps, plane, PASS_TILES n8 groups, 2 k halves, 8
    columns, 4 rows)`` f32: element ``[p, s, P, q, h, r, e]`` is plane P
    (big, small) at row ``8s + 4h + e``, column ``8·(PASS_TILES·p + q) + r``,
    zero past the last column: per (pass, k8 step) two K-major core-matrix
    tiles as ``wgmma`` reads them, n8 groups 256 bytes apart, k halves 128."""
    n_rows, n_cols = big.shape
    n_pass = -(-n_cols // (8 * PASS_TILES))
    width = 8 * PASS_TILES * n_pass
    stack = np.zeros((2, n_rows, width), np.float32)
    stack[0, :, :n_cols], stack[1, :, :n_cols] = big, small
    # (P, s, h, e, p, q, r) → (p, s, P, q, h, r, e)
    t = stack.reshape(2, n_rows // 8, 2, 4, n_pass, PASS_TILES, 8)
    return np.ascontiguousarray(t.transpose(4, 1, 0, 5, 2, 6, 3))


@functools.lru_cache(maxsize=None)
def tables(cfg: MelConfig) -> np.ndarray:
    """The packed bases of ``cfg``, built once."""
    return fragments(*planes(cfg))


def band_weights(cfg: MelConfig, sample_rate: int) -> dict:
    """``bands`` (3·M + 2·passes,) int32: each filter's first and
    one-past-last nonzero bin and the offset of its run in ``weights``, the
    filters' nonzero runs of the filterbank concatenated (f32); then for
    each pass the first and one-past-last filter whose band reaches the
    pass's PASS_BINS bins (the bands rise with the filter, so those filters
    are a run)."""
    K = cfg.n_fft // 2 + 1
    fb = melspec.mel_filterbank(sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    nz = fb != 0
    lo = np.where(nz.any(0), nz.argmax(0), 0)
    hi = np.where(nz.any(0), K - nz[::-1].argmax(0), 0)
    off = np.concatenate([[0], np.cumsum(hi - lo)[:-1]])
    weights = np.concatenate([fb[lo[m]:hi[m], m] for m in range(cfg.n_mels)]
                             + [np.zeros(0, np.float32)]).astype(np.float32)
    n_pass = passes(cfg.n_fft)
    p_lo = PASS_BINS * np.arange(n_pass)
    reach = (lo[None, :] < p_lo[:, None] + PASS_BINS) & (hi[None, :] > p_lo[:, None])
    ma = np.where(reach.any(1), reach.argmax(1), 0)
    mb = np.where(reach.any(1), cfg.n_mels - reach[:, ::-1].argmax(1), 0)
    if not all(reach[p, ma[p]:mb[p]].all() for p in range(n_pass)):
        raise ValueError("log_mel: the filters that reach a pass are no run")
    bands = np.concatenate([lo, hi, off, ma, mb]).astype(np.int32)
    return {"bands": bands, "weights": weights}


def span_pitch(hop: int) -> int:
    """The staged span's row pitch: ``hop`` rounded up to 4 mod 8. Rows g =
    0..7 then start on eight different multiples of 4 among the 32 banks,
    and with tq = 0..3 beside them a fragment load's 32 lanes hit 32 banks."""
    return hop + (4 - hop % 8) % 8


def span_rows(win: int, hop: int) -> int:
    """Rows of ``hop`` samples that FRAME_TILE frames reach, the k8 padding
    of the window included."""
    return FRAME_TILE + (rows(win) - 1) // hop


def column_offsets(win: int, hop: int) -> np.ndarray:
    """``(rows(win),)`` int32: sample n of a frame at ``(n // hop)`` rows and
    ``n % hop`` samples past the frame's row start."""
    n = np.arange(rows(win))
    return ((n // hop) * span_pitch(hop) + n % hop).astype(np.int32)


def smem_bytes(cfg: MelConfig, n_weights: int | None = None) -> int:
    """One CTA's shared memory: the slabs' barriers, the slabs (and, over
    them, a pass's power tile), the per-(frame, filter) band sums, the band weights and bands,
    the column offsets and the span. ``n_weights``: the filterbank's
    nonzero entries; at most 2K (each bin in at most two filters) when not
    given."""
    win, hop, M = cfg.win_length, cfg.hop_length, cfg.n_mels
    if n_weights is None:
        n_weights = 2 * (cfg.n_fft // 2 + 1)
    floats = (32 + STAGES * SLAB_FLOATS + FRAME_TILE * M + n_weights + 3 * M
              + 2 * passes(cfg.n_fft) + rows(win) + span_rows(win, hop) * span_pitch(hop))
    return 4 * floats


def log_mel_model(x: torch.Tensor, cfg: MelConfig, sample_rate: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch → ``(B, n_frames, n_mels)``
    f32: the frames times the interleaved bases in 3xTF32, the power
    ``re² + im²`` rounded op by op, each filter's band of bins summed in bin
    order, ``log(· + log_eps)``."""
    if x.dim() == 3:
        x = x[..., 0]
    frames = melspec.frame_signal(x.float(), cfg.win_length, cfg.hop_length)
    bases = torch.from_numpy(interleaved(cfg))[:cfg.win_length].to(x.device)
    spec = tf32x3.matmul(frames, bases)
    K = cfg.n_fft // 2 + 1
    re, im = spec[..., 0:2 * K:2], spec[..., 1:2 * K:2]
    power = re * re + im * im
    fb = torch.from_numpy(melspec.mel_filterbank(sample_rate, cfg.n_fft, cfg.n_mels,
                                                 cfg.fmin, cfg.fmax)).to(x.device)
    mel = torch.zeros(power.shape[:-1] + (cfg.n_mels,), dtype=torch.float32, device=x.device)
    for k in range(K):  # bin order, as each band sums
        mel = torch.addcmul(mel, power[..., k:k + 1], fb[k])
    return torch.log(mel + cfg.log_eps)
