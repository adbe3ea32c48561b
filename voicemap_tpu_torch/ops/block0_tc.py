"""Host side of B2's tensor-core route (``csrc/conv_block0.cu ::
conv_block0_tc_kernel``).

The kernel computes block 0's conv as ``mma.sync.m16n8k16`` bf16 products
summed in f32, in the direct form: M = full-rate conv rows, K = the 32
taps, N = the channels. What the wrapper hands it and what it computes from
the launch's shape, each piece pinned by a CPU test
(``tests/test_torch_conv_block0_tc.py``):

- ``pack_weights``: ``w (32, 1, C)`` → ``(C_pad, W_ROW)`` bf16, one row of
  taps a channel, padded with zeros to W_ROW taps (bank-conflict free
  B-fragment loads) and to C_pad, a multiple of SLICE channels;
- ``phase_rows``: which (pooled position, pool phase) each accumulator row
  of a warp's two m16 tiles holds, so that the four phases of a position
  land in one thread's registers and the max-pool runs there;
  ``fragment_sample``: the window sample each A fragment register starts at;
- ``hankel_sums``: the product the kernel's mma forms over those rows,
  the Hankel matrix of the window times the packed weights, in ``x``'s
  dtype (the tests take float64); ``pool_first``: its epilogue's order,
  the pool by the sign of ``mul`` before the affine;
- ``pick_tile`` and ``schedule``: the pooled positions of a work item and
  the persistent grid's walk over (row, tile) items;
- ``smem_bytes``: the shared memory of a CTA, the rule by which the wrapper
  refuses a width that does not fit;
- ``order_bound`` and ``requant_flips``: the per-output tolerance of the
  kernel against its plain version (the tensor cores' summation order
  cannot be pinned), and the rule that the int8 output may differ from
  the plain version's only where the f32 pooled value lies within that
  bound of a rounding half-integer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

TAPS = 32
POOL = 4
PAD_L = (TAPS - 1) // 2  # SAME padding of the even k: 15 left, 16 right
W_ROW = 40  # bf16 taps a channel row in shared memory: 32 + 8 of padding
SLICE = 32  # channels of a warp's unit: four n8 tiles
GROUP = 8  # pooled positions of a warp's unit: two m16 tiles of 4 phases
TILES = (64, 32, 16)  # pooled positions of a work item, widest first
THREADS = 128
SMEM_LIMIT = 232448  # the H100's dynamic shared memory per block
H100_SMS = 132
OUT_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
F32_UNIT_ROUNDOFF = 2.0 ** -24
TERM_ULPS = 4  # per product term: each f32 add of the tensor cores, up to 2u
EPILOGUE_ULPS = 4  # the epilogue's own roundings (+ bias, × mul, + add)


def c_pad(c: int) -> int:
    return -(-c // SLICE) * SLICE


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """``(32, 1, C)`` → ``(C_pad, W_ROW)`` bf16: ``[c, k] = bf16(w[k, 0, c])``,
    zeros at ``k >= 32`` and ``c >= C``."""
    k, cin, c = w.shape
    if (k, cin) != (TAPS, 1):
        raise ValueError(f"block-0 weights must be ({TAPS}, 1, C), got {tuple(w.shape)}")
    wp = torch.zeros((c_pad(c), W_ROW), dtype=torch.bfloat16, device=w.device)
    wp[:c, :TAPS] = w[:, 0, :].t().to(torch.bfloat16)
    return wp


def phase_rows() -> torch.Tensor:
    """``(2, 16, 2)`` int: for m16 tile ``mt`` and its row ``r``, the pooled
    position within the unit's GROUP (the row's fragment group, ``r % 8``)
    and the pool phase: rows g and g + 8 of tile 0 are phases 0 and 1 of
    position g, of tile 1 phases 2 and 3."""
    rows = torch.empty((2, 16, 2), dtype=torch.int64)
    for mt in range(2):
        for r in range(16):
            rows[mt, r] = torch.tensor([r % 8, 2 * mt + r // 8])
    return rows


def fragment_sample(lp: int, mt: int, s: int, tq: int, reg: int) -> int:
    """The window sample of the first of the two bf16 values in A fragment
    register ``reg`` (0–3) of m16 tile ``mt`` and k16 step ``s``, for the
    lane of quad ``tq`` whose group holds pooled position ``lp`` (within the
    item), as the kernel loads it: the word ``e = (4·lp + 2·mt + 16·s +
    2·tq) / 2`` (``+ 4`` for registers 2 and 3) of the window as read
    (registers 0, 2) or of the window shifted by one sample (1, 3)."""
    e = (4 * lp + 2 * mt + 16 * s + 2 * tq) // 2 + (4 if reg >= 2 else 0)
    return 2 * e + (reg & 1)


def hankel_sums(x: torch.Tensor, wp: torch.Tensor, c: int) -> torch.Tensor:
    """The kernel's conv sums ``(B, T // 4, 4, C)`` (position, phase,
    channel): for every unit of GROUP positions, the two m16 tiles' rows of
    ``phase_rows``, each the 32 window samples at time ``4p + j − 15`` (zeros
    outside [0, T)), times the packed weights, in ``x``'s dtype."""
    B, T = x.shape
    t_out = T // POOL
    xp = F.pad(x, (PAD_L, TAPS - 1 - PAD_L))  # (B, T + 31)
    rows = phase_rows()
    n_groups = -(-t_out // GROUP)
    out = torch.zeros((B, n_groups * GROUP, POOL, c), dtype=x.dtype, device=x.device)
    w = wp[:c, :TAPS].to(x.dtype).t()  # (32, C)
    for mt in range(2):
        for r in range(16):
            g, j = rows[mt, r].tolist()
            p = torch.arange(g, t_out, GROUP, device=x.device)
            t = POOL * p + j
            a = torch.stack([xp[:, t + k] for k in range(TAPS)], dim=-1)  # (B, n, 32)
            out[:, p, j] = a @ w
    return out[:, :t_out]


def epilogue(y: torch.Tensor, bias: torch.Tensor, mul: torch.Tensor,
             add: torch.Tensor) -> torch.Tensor:
    """``(B, t_out, 4, C)`` f32 sums → the pooled ``(B, t_out, C)`` f32 value,
    op by op as the kernel: + bias, relu, × mul, + add, max over phases."""
    return (torch.relu(y + bias) * mul + add).amax(dim=2)


def pool_first(y: torch.Tensor, bias: torch.Tensor, mul: torch.Tensor,
               add: torch.Tensor) -> torch.Tensor:
    """The kernel's epilogue order: the max of the 4 phases where
    ``mul >= 0``, their min where not, then the affine once; bit for bit
    ``epilogue``, each rounded op of the affine being monotone in y."""
    y = torch.where(mul >= 0, y.amax(dim=2), y.amin(dim=2))
    return torch.relu(y + bias) * mul + add


def pick_tile(B: int, T: int, sms: int = H100_SMS) -> int:
    """Pooled positions of a work item: the widest tile whose items still
    give every SM one (as at B = 1, 3000 positions: 188 items of 16)."""
    t_out = T // POOL
    for tile in TILES:
        if B * -(-t_out // tile) >= sms:
            return tile
    return TILES[-1]


def schedule(B: int, T: int, tile: int, n_ctas: int) -> list[list[tuple[int, int]]]:
    """The items ``(b, p0)`` of each CTA of a persistent grid of ``n_ctas``,
    in the order the kernel runs them: item ``cta + i·n_ctas``, the tile
    innermost."""
    n_tiles = -(-(T // POOL) // tile)
    return [[(item // n_tiles, (item % n_tiles) * tile)
             for item in range(cta, B * n_tiles, n_ctas)] for cta in range(n_ctas)]


def smem_bytes(c: int, tile: int, out_bytes: int) -> int:
    """Shared memory of one CTA: the packed weights, the epilogue's four
    rows, the window twice in bf16 (as read and shifted by one sample) and
    the output tile, each row padded by 16 bytes."""
    window = POOL * tile + TAPS
    row = -(-c * out_bytes // 16) * 16 + 16
    return c_pad(c) * W_ROW * 2 + 4 * c_pad(c) * 4 + 2 * window * 2 + tile * row


def order_bound(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, mul: torch.Tensor,
                add: torch.Tensor, ref: torch.Tensor, gemm_dtype=torch.bfloat16,
                unit: float = F32_UNIT_ROUNDOFF) -> torch.Tensor:
    """The per-output bound of the f32 pooled value against the plain
    version ``ref`` (f32, ``(B, T // 4, C)``), in float64:
    ``u·(4·K·|mul|·(S + |bias|) + 4·(|ref| + |add|))``, u = ``unit``
    (2⁻²⁴), S the largest over the four phases of ``Σ|x·w|`` over the K =
    32 taps of the operands rounded to ``gemm_dtype``. Both sides multiply
    the same bf16 values, exact in f32; only the order of the f32 sums
    differs, each order within (K − 1)·u·S of the exact sum, and the tensor
    cores' additions need not round to nearest (up to 2u each); the second
    term covers the epilogue's own roundings. (B4's f32 route passes f32
    and a unit that also covers its products: ``block0_train_tc.tf32x3_unit``.)"""
    if x.dim() == 3:
        x = x[..., 0]
    B, T = x.shape
    xa = F.pad(x.to(gemm_dtype).double().abs(), (PAD_L, TAPS - 1 - PAD_L))
    wa = w[:, 0, :].to(gemm_dtype).double().abs()  # (32, C)
    s = torch.zeros((B, wa.shape[1], T), dtype=torch.float64, device=x.device)
    for k in range(TAPS):
        s += xa[:, None, k:k + T] * wa[k][:, None]
    s = F.max_pool1d(s, POOL, POOL).transpose(1, 2)  # (B, T // 4, C)
    u = unit
    return u * (TERM_ULPS * TAPS * mul.double().abs() * (s + bias.double().abs())
                + EPILOGUE_ULPS * (ref.double().abs() + add.double().abs()))


def requant_flips(q: torch.Tensor, q_ref: torch.Tensor, ref: torch.Tensor,
                  inv_s0: torch.Tensor, bound: torch.Tensor) -> int:
    """The int8 outputs ``q`` against the plain version's ``q_ref``: the
    count of entries that differ, each by 1 and only where the plain f32
    pooled value ``ref`` times ``inv_s0`` lies within ``bound·|inv_s0|``
    (and the product's own rounding) of a half-integer, where a pooled value
    within ``bound`` of ``ref`` may round the other way. Raises
    ``AssertionError`` for any other difference."""
    diff = (q.to(torch.int32) - q_ref.to(torch.int32)).abs()
    if diff.numel() == 0:
        return 0
    if int(diff.max()) > 1:
        raise AssertionError(f"int8 output differs from the plain version by {int(diff.max())}")
    flipped = diff == 1
    v = ref.double() * inv_s0.double()
    to_half = (v - torch.floor(v) - 0.5).abs()
    reach = bound.double() * inv_s0.double().abs() + 2 * F32_UNIT_ROUNDOFF * v.abs()
    bad = flipped & (to_half > reach)
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} int8 outputs differ from the plain version "
                             f"where the pooled value is no rounding tie within its bound")
    return int(flipped.sum())
