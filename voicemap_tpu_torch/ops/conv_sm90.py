"""Host side of the Hopper main loop that B8 and B3 share (``csrc/conv_sm90.cuh``).

What the wrappers compute on the host for the kernels, and what the kernels
compute from the launch's shape, each piece pinned by a CPU test:

- ``pack_taps``: the weights ``(k, Cin, Cout)`` → ``(Cout, k·Kp)`` K-major,
  each tap's K run padded with zeros to ``Kp``, a multiple of 128 bytes
  (64 bf16, 128 int8), so no stage of the kernel straddles two taps;
- ``packed_conv_sums``: the plain GEMM the kernel's main loop computes over
  those packed weights, the SAME conv's sums ``(B, T, Cout)``;
- ``wide_tiles`` and ``schedule``: the tile height (256 conv rows, or 128
  where 256 would leave SMs idle) and the persistent grid's walk over work
  items (batch row, time tile, channel tile), the channel tile innermost,
  as the kernel decodes an item index;
- ``stages`` and ``smem_bytes``: the ring of stages the kernel sizes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

TILE_N = 128  # output channels of a tile
RUN_BYTES = 64  # K bytes of one tap in a stage
PAD_BYTES = 128  # each tap's K run of the packed weights, padded to this
BOX_ROWS = 136  # input rows of one TMA box: 128 + k - 1, 8-aligned
MAX_K = BOX_ROWS - 128 + 1  # the widest odd kernel a box holds: 9
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


def packed_conv_sums(x: torch.Tensor, wp: torch.Tensor, k: int) -> torch.Tensor:
    """The SAME conv's sums ``(B, T, Cout)`` as the kernel's main loop forms
    them: rows of k·Kp shifted input (zeros at t < 0, t >= T and channels
    past Cin) times the packed weights, in ``x``'s dtype (the caller picks
    f32 or f64)."""
    B, T, cin = x.shape
    kp = wp.shape[1] // k
    h = (k - 1) // 2
    xp = F.pad(x, (0, kp - cin, h, h))  # (B, T + k - 1, Kp)
    cols = torch.cat([xp[:, j:j + T] for j in range(k)], dim=-1)  # (B, T, k·Kp)
    return cols @ wp.to(x.dtype).t()


def tiles(T: int, cout: int, mw: int) -> tuple[int, int]:
    """Time tiles of 128·mw conv rows per batch row (over the even part of
    T) and channel tiles."""
    return -(-((T // 2) * 2) // (128 * mw)), -(-cout // TILE_N)


def wide_tiles(B: int, T: int, cout: int, sms: int = H100_SMS) -> bool:
    """Whether the kernel takes tiles of 256 rows: unless their items would
    leave SMs idle."""
    per_row, n_tiles = tiles(T, cout, 2)
    return B * per_row * n_tiles >= sms


def schedule(B: int, T: int, cout: int, n_ctas: int = H100_SMS,
             mw: int | None = None) -> list[list[tuple[int, int, int]]]:
    """The work items ``(b, t0, n0)`` of each CTA of a persistent grid of
    ``n_ctas``, in the order the kernel runs them: item ``cta + i·n_ctas``,
    channel tile innermost; ``mw`` as ``wide_tiles`` picks it by default."""
    if mw is None:
        mw = 2 if wide_tiles(B, T, cout, n_ctas) else 1
    per_row, n_tiles = tiles(T, cout, mw)
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


def stage_bytes(k: int, mw: int) -> int:
    """One stage: the input slice of mw boxes and k weight tiles, each 64
    bytes a row, rounded up to 1024."""
    raw = mw * BOX_ROWS * RUN_BYTES + k * TILE_N * RUN_BYTES
    return -(-raw // _ALIGN) * _ALIGN


def _fixed_bytes(mw: int, out_bytes: int) -> int:
    """Alignment slack, the barriers, the epilogue rows and the output tile
    (64·mw pooled rows of TILE_N outputs, each row padded)."""
    return _ALIGN + _BAR_BYTES + _AFF_BYTES + 64 * mw * (TILE_N * out_bytes + _OUT_PAD)


def stages(k: int, mw: int, out_bytes: int = 4) -> int:
    """Stages of the ring that fit the CTA's shared memory beside an output
    tile of ``out_bytes`` an output (0: none, or k wider than a box holds)."""
    if k > MAX_K:
        return 0
    room = SMEM_LIMIT - _fixed_bytes(mw, out_bytes) - 16 * MAX_STAGES
    return min(MAX_STAGES, room // stage_bytes(k, mw))


def smem_bytes(k: int, mw: int, out_bytes: int = 4) -> int:
    s = stages(k, mw, out_bytes)
    return _fixed_bytes(mw, out_bytes) + s * stage_bytes(k, mw) + 16 * s
