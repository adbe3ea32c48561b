"""Host side of the Hopper main loop that B8 and B3 share (``csrc/conv_sm90.cuh``).

What the wrappers compute on the host for the kernels, and what the kernels
compute from the launch's shape, each piece pinned by a CPU test:

- ``pack_taps``: the weights ``(k, Cin, Cout)`` → ``(Cout, k·Kp)`` K-major,
  each tap's K run padded with zeros to ``Kp``, a multiple of 128 bytes
  (64 bf16, 128 int8), so no stage of the kernel straddles two taps;
- ``packed_conv_sums``: the plain GEMM the kernel's main loop computes over
  those packed weights, the SAME conv of dilation d's sums ``(B, T, Cout)``;
- ``box_rows``: the height of each TMA box of a tile's input slice, which
  follows the launch's reach ``d·(k − 1)``;
- ``wide_tiles`` and ``schedule``: the tile height (256 conv rows, or 128
  where 256 would leave SMs idle or its ring would hold fewer than 2
  stages) and the persistent grid's walk over work items (batch row, time
  tile, channel tile), the channel tile innermost, as the kernel decodes an
  item index;
- ``stages`` and ``smem_bytes``: the ring of stages the kernel sizes, beside
  an output tile of 128·mw / pool rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

TILE_N = 128  # output channels of a tile
RUN_BYTES = 64  # K bytes of one tap in a stage
PAD_BYTES = 128  # each tap's K run of the packed weights, padded to this
MAX_BOX_ROWS = 256  # TMA's largest box dimension
MAX_K = 9  # the widest kernel the ring holds a stage of
MAX_REACH = MAX_BOX_ROWS - 128  # d·(k − 1) at mw = 1: one box of 128 + reach rows
POOLS = (1, 2)
MAX_STAGES = 6
SMEM_LIMIT = 232448  # the H100's dynamic shared memory per block
_ALIGN = 1024
_AFF_BYTES = 2 * 3 * TILE_N * 4  # two tiles of the epilogue's three rows
_OUT_PAD = 16  # bytes after each row of the output tile
_BAR_BYTES = 32
H100_SMS = 132


def pack_taps(w: torch.Tensor) -> torch.Tensor:
    """``(k, Cin, Cout)`` → ``(Cout, k·Kp)`` K-major, ``Kp`` = Cin rounded
    up to PAD_BYTES of ``w``'s dtype (64 bf16, 128 int8):
    ``[co, j·Kp + ci] = w[j, ci, co]``, zeros at ``ci >= Cin``."""
    k, cin, cout = w.shape
    multiple = PAD_BYTES // w.element_size()
    kp = -(-cin // multiple) * multiple
    wt = w.permute(2, 0, 1)  # (Cout, k, Cin)
    if kp != cin:
        wt = F.pad(wt, (0, kp - cin))
    return wt.reshape(cout, k * kp).contiguous()


def packed_conv_sums(x: torch.Tensor, wp: torch.Tensor, k: int,
                     dilation: int = 1) -> torch.Tensor:
    """The SAME conv's sums ``(B, T, Cout)`` as the kernel's main loop forms
    them: rows of k·Kp shifted input (tap j from row ``t + j·d − h``, zeros
    at rows outside [0, T) and channels past Cin) times the packed weights,
    in ``x``'s dtype (the caller picks f32 or f64)."""
    B, T, cin = x.shape
    kp = wp.shape[1] // k
    h = dilation * (k - 1) // 2
    xp = F.pad(x, (0, kp - cin, h, h))  # (B, T + 2h, Kp)
    cols = torch.cat([xp[:, j * dilation:j * dilation + T] for j in range(k)], dim=-1)
    return cols @ wp.to(x.dtype).t()


def box_rows(mw: int, reach: int) -> int:
    """Rows of each of a tile's ``mw`` TMA boxes: together they hold its
    128·mw conv rows and the reach, each a multiple of 8 (a box starts on
    the 64-byte swizzle's 512-byte period)."""
    return -(-(-(-(128 * mw + reach) // mw)) // 8) * 8


def tiles(T: int, cout: int, mw: int, pool: int = 2) -> tuple[int, int]:
    """Time tiles of 128·mw conv rows per batch row (over the part of T the
    pool keeps) and channel tiles."""
    return -(-((T // pool) * pool) // (128 * mw)), -(-cout // TILE_N)


def wide_tiles(B: int, T: int, cout: int, sms: int = H100_SMS, k: int = 3, dilation: int = 1,
               pool: int = 2, out_bytes: int = 4) -> bool:
    """Whether the kernel takes tiles of 256 rows: unless their items would
    leave SMs idle or their ring would hold fewer than 2 stages."""
    per_row, n_tiles = tiles(T, cout, 2, pool)
    return (B * per_row * n_tiles >= sms
            and stages(k, 2, out_bytes, dilation * (k - 1), pool) >= 2)


def schedule(B: int, T: int, cout: int, n_ctas: int = H100_SMS,
             mw: int | None = None, pool: int = 2) -> list[list[tuple[int, int, int]]]:
    """The work items ``(b, t0, n0)`` of each CTA of a persistent grid of
    ``n_ctas``, in the order the kernel runs them: item ``cta + i·n_ctas``,
    channel tile innermost; ``mw`` as ``wide_tiles`` picks it by default
    (at k = 3, dilation 1, 4-byte outputs)."""
    if mw is None:
        mw = 2 if wide_tiles(B, T, cout, n_ctas, pool=pool) else 1
    per_row, n_tiles = tiles(T, cout, mw, pool)
    items = B * per_row * n_tiles
    out = []
    for cta in range(min(n_ctas, items)):
        mine = []
        for item in range(cta, items, n_ctas):
            r, n = divmod(item, n_tiles)
            b, t = divmod(r, per_row)
            mine.append((b, t * 128 * mw, n * TILE_N))
        out.append(mine)
    return out


def stage_bytes(k: int, mw: int, reach: int | None = None) -> int:
    """One stage: the input slice of mw boxes and k weight tiles, each 64
    bytes a row, rounded up to 1024 (``reach`` d·(k − 1), k − 1 by
    default)."""
    reach = k - 1 if reach is None else reach
    raw = mw * box_rows(mw, reach) * RUN_BYTES + k * TILE_N * RUN_BYTES
    return -(-raw // _ALIGN) * _ALIGN


def _fixed_bytes(mw: int, out_bytes: int, pool: int = 2) -> int:
    """Alignment slack, the barriers, the epilogue rows and the output tile
    (128·mw / pool output rows of TILE_N outputs, each row padded)."""
    return (_ALIGN + _BAR_BYTES + _AFF_BYTES
            + 128 * mw // pool * (TILE_N * out_bytes + _OUT_PAD))


def stages(k: int, mw: int, out_bytes: int = 4, reach: int | None = None,
           pool: int = 2) -> int:
    """Stages of the ring that fit the CTA's shared memory beside an output
    tile of ``out_bytes`` an output (0: none, or k or the reach wider than
    the kernel takes)."""
    reach = k - 1 if reach is None else reach
    if k > MAX_K or reach > MAX_REACH:
        return 0
    room = SMEM_LIMIT - _fixed_bytes(mw, out_bytes, pool) - 16 * MAX_STAGES
    return min(MAX_STAGES, room // stage_bytes(k, mw, reach))


def smem_bytes(k: int, mw: int, out_bytes: int = 4, reach: int | None = None,
               pool: int = 2) -> int:
    s = stages(k, mw, out_bytes, reach, pool)
    return _fixed_bytes(mw, out_bytes, pool) + s * stage_bytes(k, mw, reach) + 16 * s


def takes(k: int, dilation: int, pool: int) -> bool:
    """Whether the main loop takes a block: k odd, at most MAX_K, the reach
    d·(k − 1) at most MAX_REACH, pool 1 or 2 (and a ring of at least one
    stage at 128-row tiles and 4-byte outputs, the least the kernel picks)."""
    return (k % 2 == 1 and dilation >= 1 and pool in POOLS
            and stages(k, 1, 4, dilation * (k - 1), pool) >= 1)
