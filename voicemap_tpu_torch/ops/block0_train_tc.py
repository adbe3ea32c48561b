"""Host side of B4's and B5's tensor-core routes (``csrc/conv_block0_train.cu
:: block0_train_tc``, bf16 on B2's main loop ``csrc/block0_mma.cuh``, and
``block0_train_tc32``, f32 in 3xTF32 on ``csrc/tf32x3.cuh``).

Both kernels compute block 0's conv as B2's ``mma.sync`` direct form
(``ops/block0_tc``); B5 adds the weight gradient as a second product. The
two GEMM dtypes share the plan and differ in the kind a function takes:
``fwd``/``bwd`` for bf16, ``fwd_f32``/``bwd_f32`` for f32. What the wrapper
hands them and what they compute from the launch's shape, each piece pinned
by a CPU test (``tests/test_torch_block0_train_tc.py``):

- ``grid`` and ``schedule``: a fixed grid for each shape. A CTA keeps one
  group of up to GROUP_CHANNELS channels for its life and walks (row, tile)
  items of that group; ``warp_plan``: each warp keeps one 32-channel slice
  and a fixed share of a tile's 8-position groups, so its sums stay in
  registers over all its items;
- ``smem_bytes``: a CTA's shared memory, the rule by which the wrapper
  refuses a width that does not fit;
- ``x4_pairs``, ``dw_fragment_sample`` and ``movmatrix_trans``: the
  operands of B5's weight-gradient product, ``dW (taps × channels) = X
  (taps × positions) · dZ (positions × channels)`` with K = a unit's 32
  full-rate positions, phase-major within each k16 step: X's A fragment
  registers pair samples 4 apart, read from the window staged as
  ``(x[i], x[i + 4])``; dZ's B fragments are the forward accumulator's dz
  (a position's phases in one thread) transposed by ``movmatrix``;
  ``unit_dw`` builds the unit's product fragment by fragment as the lanes
  do, ``dw_product`` sums every unit's product;
- the f32 route's operands: ``conv_fragment_sample`` and
  ``dw_fragment_sample_f32`` (the window samples of the conv's and the dW
  product's A fragments, the Toeplitz view), ``w_tile_word``,
  ``pack_weights_f32`` and ``kmajor_tile`` (the slice's split weights as
  the conv's ``wgmma`` reads them, B), ``dz_row`` (B5's dz rows,
  phase-major), ``conv_products_f32`` and ``unit_dw_f32`` (a unit's conv
  sums and dW from those operands in 3xTF32, as ``ops/tf32x3`` models the
  split);
- ``sel_bound``, ``relu_flips`` and ``route_flips``: the tolerance of the
  kernels against their plain versions. The tensor cores' f32 summation
  order cannot be pinned, so ``a_sel`` agrees to B2's order bound (K = 32,
  the bias, no affine), and #(a > 0) and B5's routing may differ only where
  a pre-activation lies within its bound of 0, or two phases' ``s·a_j``
  within their bounds of each other. The f32 route's bound takes its own
  unit, ``tf32x3_unit``: the split's error and three products' f32 sums a
  tap, against a plain version that rounds each product and sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import block0_tc, tf32x3

TAPS, POOL, PAD_L = block0_tc.TAPS, block0_tc.POOL, block0_tc.PAD_L
SLICE, GROUP = block0_tc.SLICE, block0_tc.GROUP
GROUP_CHANNELS = 4 * SLICE  # channels of a CTA
WARPS = 4
KINDS = ("fwd", "bwd", "fwd_f32", "bwd_f32")  # B4, B5; bf16 GEMM, then f32
# Channels of a CTA: four slices on the bf16 route, one on the f32 route,
# whose four warps share the slice's weights as wgmma's B.
GROUP_CHANNELS_F32 = SLICE
# Pooled positions of an item, widest first. B5 stops at 32: on the H100 it
# ran faster with 32 than with 64, B4 slower.
TILES = {"fwd": block0_tc.TILES, "bwd": block0_tc.TILES[1:]}
TILES.update(fwd_f32=TILES["fwd"], bwd_f32=TILES["bwd"])
H100_SMS = block0_tc.H100_SMS
SMEM_LIMIT = block0_tc.SMEM_LIMIT
SMEM_PER_SM = 228 * 1024  # the H100's shared memory an SM, 1 KB of it reserved a CTA
# A persistent grid's CTAs on each SM, as the kernels' launch bounds say: 4
# for bf16; 3 for f32, whose split weights, window and dz rows take twice
# the bytes.
CTAS_PER_SM = 4
CTAS_PER_SM_F32 = 3
VALS = {"fwd": 3, "bwd": TAPS + 1}  # rows of a CTA's partial sums
VECS = {"fwd": 2, "bwd": 5}  # per-channel rows: bias, sgn (, c0, c1, c2)
F32_UNIT_ROUNDOFF = block0_tc.F32_UNIT_ROUNDOFF
# The f32 route's layout (csrc/conv_block0_train.cu): the slice's split
# weights as 8 tiles (4 k8 steps x big, small) of W_TILE_F32 words in
# wgmma's K-major layout (w_tile_word); B5's dz rows, DZ_ROWS full-rate
# positions of DZ_PITCH f32 channels a warp.
W_TILE_F32 = SLICE * 8
DZ_ROWS = POOL * GROUP
DZ_PITCH = 40
MMA_K = 8  # the products one m16n8k8 adds to its accumulator
# What 3xTF32 drops of each |x·w| (csrc/tf32x3.cuh): small·small and the
# roundings of the two smalls, each at most 2^-22.
TF32X3_DROPPED = 3 * 2.0 ** -22


def base_kind(kind: str) -> str:
    """``fwd`` or ``bwd``: B4 or B5, whatever the GEMM dtype."""
    return kind.split("_")[0]


def ctas_per_sm(kind: str) -> int:
    return CTAS_PER_SM_F32 if kind.endswith("_f32") else CTAS_PER_SM


def group_channels(kind: str) -> int:
    return GROUP_CHANNELS_F32 if kind.endswith("_f32") else GROUP_CHANNELS


def channel_groups(c: int, kind: str = "fwd") -> int:
    return -(-c // group_channels(kind))


def warp_plan(cg: int) -> list:
    """For a group of ``cg`` channels, each warp's ``(slice, share, step)``
    (it takes the tile's 8-position groups share, share + step, …), or None
    for a warp with nothing to do (3 slices: warp 3)."""
    n_s = -(-cg // SLICE)
    step = 1 if n_s == 3 else WARPS // n_s
    return [(w % n_s, w // n_s, step) if w < n_s * step else None for w in range(WARPS)]


def pick_tile(B: int, T: int, c: int, kind: str, sms: int = H100_SMS) -> int:
    """Pooled positions of an item: the widest of TILES[kind] whose items
    (over the channel groups) still give every SM one."""
    t_out = T // POOL
    for tile in TILES[kind]:
        if channel_groups(c, kind) * B * -(-t_out // tile) >= sms:
            return tile
    return TILES[kind][-1]


def grid(B: int, T: int, c: int, kind: str, sms: int = H100_SMS) -> tuple[int, int]:
    """``(tile, n_cps)``: the item's tile and the CTAs of each channel group,
    ``min(items, sms·ctas_per_sm(kind) // groups)``; the grid is
    ``n_cps·groups`` CTAs, each writing one partial row."""
    tile = pick_tile(B, T, c, kind, sms)
    items = B * -(-(T // POOL) // tile)
    return tile, min(items, max(1, sms * ctas_per_sm(kind) // channel_groups(c, kind)))


def schedule(B: int, T: int, c: int, tile: int, n_cps: int,
             kind: str = "fwd") -> list[list[tuple[int, int, int]]]:
    """The items ``(b, p0, group)`` of each CTA in the order it runs them:
    CTA ``k`` keeps group ``k % groups`` and takes items ``k // groups + i·n_cps``."""
    n_sg = channel_groups(c, kind)
    n_tiles = -(-(T // POOL) // tile)
    out = []
    for cta in range(n_cps * n_sg):
        sg, first = cta % n_sg, cta // n_sg
        out.append([(item // n_tiles, (item % n_tiles) * tile, sg)
                    for item in range(first, B * n_tiles, n_cps)])
    return out


def unit_cover(cg: int, tile: int, n_p: int) -> list[tuple[int, int, int]]:
    """Every ``(warp, slice, pooled position)`` an item of ``n_p`` valid
    positions computes for a group of ``cg`` channels, as the warps walk
    their shares (whole 8-position groups, positions past n_p masked)."""
    out = []
    for w, plan in enumerate(warp_plan(cg)):
        if plan is None:
            continue
        sl, share, step = plan
        for grp in range(share, tile // GROUP, step):
            if grp * GROUP >= n_p:
                break
            out += [(w, sl, p) for p in range(grp * GROUP, min(grp * GROUP + GROUP, n_p))]
    return out


def smem_bytes(c: int, tile: int, kind: str, out_bytes: int = 2) -> int:
    """Shared memory of one CTA: the group's weights and per-channel rows
    and the warps' fold rows. bf16: the weights packed as
    ``block0_tc.pack_weights``, the window as read and shifted by one sample
    (bf16), B4 the output tile (rows padded by 16 bytes), B5 the window
    staged as sample pairs 4 apart. f32 (one 32-channel slice whatever C):
    the weight tiles, the window split into (big, small) pairs, B5's fold
    rows in the place of its dz rows (the larger); B4 writes from registers,
    with no output tile."""
    kb = base_kind(kind)
    cgp = min(block0_tc.c_pad(c), GROUP_CHANNELS)
    window = POOL * tile + TAPS
    if kind.endswith("_f32"):
        rows = WARPS * (DZ_ROWS * DZ_PITCH if kb == "bwd" else VALS[kb] * SLICE)
        return 8 * W_TILE_F32 * 4 + VECS[kb] * SLICE * 4 + rows * 4 + 8 * window
    row = -(-min(c, GROUP_CHANNELS) * out_bytes // 16) * 16 + 16
    return (cgp * block0_tc.W_ROW * 2 + (tile * row if kind == "fwd" else 0)
            + VECS[kind] * cgp * 4 + WARPS * VALS[kind] * SLICE * 4
            + (4 * window if kind == "bwd" else 0) + 4 * window)


# ---------------------------------------------------------------------------
# B5's weight-gradient product
# ---------------------------------------------------------------------------

def x4_pairs(win: torch.Tensor) -> torch.Tensor:
    """``(W,)`` window → ``(W − 4, 2)``: entry i is ``(win[i], win[i + 4])``,
    one 32-bit word of the kernel's third copy of the window."""
    return torch.stack([win[:-4], win[4:]], dim=-1)


def dw_fragment_sample(grp: int, mt: int, s: int, tq: int, g: int, reg: int) -> int:
    """The x4 word of register ``reg`` (0–3) of X's A fragment, m16 tile
    ``mt`` (taps 16·mt …), k16 step ``s``, lane (g, tq), unit ``grp``:
    row g (+ 8 for registers 1, 3), k pair 2tq of phase 2s (registers 0, 1)
    or 2s + 1 (2, 3): ``4·(8·grp + 2tq) + 2s + 16·mt + g``, + 8 for the
    row, + 1 for the phase."""
    return 4 * (GROUP * grp + 2 * tq) + 2 * s + 16 * mt + g + 8 * (reg & 1) + (reg >> 1)


def fragments(m: torch.Tensor) -> torch.Tensor:
    """An 8×8 matrix in ``movmatrix``'s fragment layout: ``(32, 2)``, lane
    ``4g + tq`` holding row g, columns 2tq and 2tq + 1."""
    return m.reshape(8, 4, 2).reshape(32, 2)


def movmatrix_trans(frag: torch.Tensor) -> torch.Tensor:
    """``movmatrix.sync.aligned.m8n8.trans.b16`` on ``(32, 2)`` fragments:
    every lane gets the pair its lane holds of the transposed matrix."""
    return fragments(frag.reshape(8, 8).t())


def unit_dw(win: torch.Tensor, dz: torch.Tensor, grp: int) -> torch.Tensor:
    """The ``(32 taps, 32 channels)`` dW product of one unit, built as the
    lanes build it: ``win`` the item's window (float64, 4·tile + 32
    samples), ``dz`` the unit's ``(8 positions, 4 phases, 32 channels)``.
    For each n8 tile the B fragments are ``movmatrix_trans`` of the
    accumulator's dz, each A register is the x4 word
    ``dw_fragment_sample`` names, and the m16n8k16 product sums
    A[row][k]·B[k][col] over the fragments' k indices."""
    x4 = x4_pairs(win)
    out = torch.zeros((TAPS, SLICE), dtype=win.dtype)
    for nt in range(4):
        # accumulator layout: lane (g, tq) holds dz of position g, channels
        # nt·8 + 2tq (+1), for each phase j
        bz = [movmatrix_trans(fragments(dz[:, j, nt * 8:nt * 8 + 8])) for j in range(POOL)]
        for mt in range(2):
            for s in range(2):
                a = torch.zeros((16, 16), dtype=win.dtype)  # A[row][k]
                b = torch.zeros((16, 8), dtype=win.dtype)  # B[k][col]
                for lane in range(32):
                    g, tq = divmod(lane, 4)
                    for reg in range(4):
                        lo, hi = x4[dw_fragment_sample(grp, mt, s, tq, g, reg)]
                        row, k = g + 8 * (reg & 1), 2 * tq + 8 * (reg >> 1)
                        a[row, k], a[row, k + 1] = lo, hi
                    for reg in range(2):  # b0 = phase 2s, b1 = phase 2s + 1
                        b[2 * tq + 8 * reg, g], b[2 * tq + 8 * reg + 1, g] = bz[2 * s + reg][lane]
                out[16 * mt:16 * mt + 16, nt * 8:nt * 8 + 8] += a @ b
    return out


def dw_product(x: torch.Tensor, dz: torch.Tensor, tile: int) -> torch.Tensor:
    """``(32, C)`` dW of the whole batch as the kernel sums it: for every
    item and unit, X's rows (taps) times dZ's columns over the unit's 32
    positions in the kernel's K order (phase-major, then position), in
    ``x``'s dtype; ``x (B, T)``, ``dz (B, C, T)``."""
    B, T = x.shape
    c = dz.shape[1]
    t_out = T // POOL
    xp = F.pad(x, (PAD_L, TAPS - 1 - PAD_L + 4 * tile))
    dzp = F.pad(dz, (0, POOL * tile))
    out = torch.zeros((TAPS, c), dtype=x.dtype)
    k_phase = torch.arange(POOL).repeat_interleave(GROUP)  # K order of the two k16 steps
    k_pos = torch.arange(GROUP).repeat(POOL)
    for p0 in range(0, t_out, tile):
        for grp in range(tile // GROUP):
            t = POOL * (p0 + GROUP * grp + k_pos) + k_phase  # (32,) full-rate times, K order
            valid = (p0 + GROUP * grp + k_pos) < t_out
            a = torch.stack([xp[:, t + k] for k in range(TAPS)], dim=1)  # (B, 32 taps, 32)
            bz = dzp[:, :, t] * valid  # (B, C, 32)
            out += torch.einsum("bkt,bct->kc", a, bz)
    return out


# ---------------------------------------------------------------------------
# The f32 route's operands (block0_train_tc32)
# ---------------------------------------------------------------------------

def conv_fragment_sample(g: int, tq: int, mt: int, s: int, reg: int) -> int:
    """The window sample, from the unit's first (32·grp), of register
    ``reg`` (0–3) of the conv's A fragment, m16 tile ``mt``, k8 step ``s``,
    lane (g, tq): row g is phase 2mt of position g, row g + 8 phase 2mt + 1
    (registers 1, 3); k is tap 8s + tq, + 4 for registers 2, 3:
    ``4g + 2mt + 8s + tq``, + 1 for the row, + 4 for the tap."""
    return 4 * g + 2 * mt + 8 * s + tq + (reg & 1) + 4 * (reg >> 1)


def dw_fragment_sample_f32(g: int, tq: int, mt: int, ks: int, reg: int) -> int:
    """The window sample, from the unit's first, of register ``reg`` of the
    dW product's A fragment (X, the Toeplitz view: rows taps, k the dz rows
    of phase ``ks``): row g is tap 16mt + g (+ 8 for registers 1, 3), k is
    position tq (+ 4 for registers 2, 3) of the phase: ``ks + 16mt + g +
    4tq``, + 8 for the row, + 16 for the position."""
    return ks + 16 * mt + g + 4 * tq + 8 * (reg & 1) + 16 * (reg >> 1)


def w_tile_word(n: int, k: int, plane: int) -> int:
    """The word of weight (channel ``n``, tap ``k``) of the f32 route's
    weight tiles: tile ``2·(k // 8) + plane`` (plane 0 big, 1 small) of
    W_TILE_F32 words, in it wgmma's K-major layout without swizzle: n8
    group ``n // 8`` every 64 words, taps 4–7 of the step 32 words after
    0–3, the core matrix's row ``n % 8`` every 4 words."""
    return ((2 * (k // 8) + plane) * W_TILE_F32 + (n // 8) * 64 + ((k // 4) % 2) * 32
            + (n % 8) * 4 + k % 4)


def kmajor_tile(tile: torch.Tensor) -> torch.Tensor:
    """The ``(8 taps, 32 channels)`` matrix B that wgmma reads from one
    tile of W_TILE_F32 words through ``csrc/tf32x3.cuh :: desc_kmajor``
    (core matrices of 8 rows × 16 bytes, 128 bytes apart along K, n8
    groups 256 bytes apart): element (k, n) at word (n // 8)·64 + (k // 4)
    ·32 + (n % 8)·4 + k % 4."""
    b = torch.empty((8, SLICE), dtype=tile.dtype)
    for k in range(8):
        for n in range(SLICE):
            b[k, n] = tile[(n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4 + k % 4]
    return b


def pack_weights_f32(w: torch.Tensor) -> torch.Tensor:
    """The slice's ``(32 taps, 32 channels)`` f32 weights as the kernel lays
    them out: split (``ops/tf32x3``), each word at ``w_tile_word``;
    ``(8·W_TILE_F32,)`` f32 (the bit patterns of the tf32 planes)."""
    big, small = tf32x3.split(w)
    out = torch.zeros(8 * W_TILE_F32, dtype=torch.float32)
    for n in range(SLICE):
        for k in range(TAPS):
            out[w_tile_word(n, k, 0)] = big[k, n]
            out[w_tile_word(n, k, 1)] = small[k, n]
    return out


def dz_row(j: int, p: int) -> int:
    """B5's dz row of phase ``j`` of the unit's position ``p``: phase-major,
    so a k8 step of the dW product is one phase, and a thread's two
    channels of one row are one 64-bit store whose lanes miss each other's
    banks."""
    return GROUP * j + p


def _lanes():
    return [(lane // 4, lane % 4) for lane in range(32)]


def _mma3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One 3xTF32 step of the model: the three exact products of the split
    planes, summed in float64."""
    ab, as_ = (t.double() for t in tf32x3.split(a.float()))
    bb, bs = (t.double() for t in tf32x3.split(b.float()))
    return as_ @ bb + ab @ bs + ab @ bb


def conv_products_f32(win: torch.Tensor, w: torch.Tensor, grp: int) -> torch.Tensor:
    """A unit's conv sums ``(8 positions, 4 phases, 32 channels)`` as one
    warp's share of the wgmma forms them: ``win`` the item's window (f32),
    ``w (32, 32)`` the slice's weights (tap, channel). For each k8 step the
    warp's 16 A rows are the registers ``conv_fragment_sample`` names, split
    as ``ops/tf32x3`` models it, and B is read back from the packed tiles
    (``pack_weights_f32`` through ``kmajor_tile``); the three products
    summed in float64."""
    u = POOL * GROUP * grp
    packed = pack_weights_f32(w)
    out = torch.zeros((GROUP, POOL, SLICE), dtype=torch.float64)
    for mt in range(2):
        acc = torch.zeros((16, SLICE), dtype=torch.float64)
        for s in range(4):
            a = torch.zeros((16, 8))
            for g, tq in _lanes():
                for reg in range(4):
                    row, k = g + 8 * (reg & 1), tq + 4 * (reg >> 1)
                    a[row, k] = win[u + conv_fragment_sample(g, tq, mt, s, reg)]
            ab, as_ = (t.double() for t in tf32x3.split(a))
            bb, bs = (kmajor_tile(packed[(2 * s + p) * W_TILE_F32:(2 * s + p + 1) * W_TILE_F32])
                      .double() for p in (0, 1))
            acc += as_ @ bb + ab @ bs + ab @ bb
        for r in range(16):  # row g: phase 2mt, row g + 8: phase 2mt + 1
            out[r % 8, 2 * mt + r // 8] = acc[r]
    return out


def unit_dw_f32(win: torch.Tensor, dz: torch.Tensor, grp: int) -> torch.Tensor:
    """The ``(32 taps, 32 channels)`` dW product of one unit as the lanes
    form it: ``dz (8 positions, 4 phases, 32 channels)`` written to the
    rows ``dz_row`` names, X's A registers the window samples
    ``dw_fragment_sample_f32`` names, dZ's B (row tq (+ 4) of the step,
    channel g) from the rows; 3xTF32 as ``ops/tf32x3`` models it."""
    u = POOL * GROUP * grp
    rows = torch.zeros((DZ_ROWS, SLICE))
    for p in range(GROUP):
        for j in range(POOL):
            rows[dz_row(j, p)] = dz[p, j]
    out = torch.zeros((TAPS, SLICE), dtype=torch.float64)
    for mt in range(2):
        for nt in range(4):
            for ks in range(POOL):
                a = torch.zeros((16, 8))
                b = torch.zeros((8, 8))
                for g, tq in _lanes():
                    for reg in range(4):
                        row, k = g + 8 * (reg & 1), tq + 4 * (reg >> 1)
                        a[row, k] = win[u + dw_fragment_sample_f32(g, tq, mt, ks, reg)]
                    for reg in range(2):
                        b[tq + 4 * reg, g] = rows[8 * ks + tq + 4 * reg, nt * 8 + g]
                out[16 * mt:16 * mt + 16, nt * 8:nt * 8 + 8] += _mma3(a, b)
    return out


# ---------------------------------------------------------------------------
# Tolerances against the plain versions
# ---------------------------------------------------------------------------

def tf32x3_unit(taps: int = TAPS) -> float:
    """The u of ``sel_bound``'s form, ``u·(4·K·(S + |bias|) + 4·|ref|)``,
    for the f32 route: how far each tap may move the kernel's sum from the
    plain version's, as a share of S, over the form's 4 (TERM_ULPS). A tap:
    - the kernel's f32 sums: a k8 step's three ``mma`` each add MMA_K
      products and the accumulator, each addend off by up to one f32 ulp
      of the largest (2u of S: the tensor cores need not round to nearest),
      3·(MMA_K + 1)·2u / MMA_K;
    - the plain version's: its product and its add, each rounded, 2u;
    - the split (``csrc/tf32x3.cuh``'s account): TF32X3_DROPPED of each
      |x·w|, at most TF32X3_DROPPED·S over the K taps.
    u = 2⁻²⁴. The bf16 route's u (2⁻²⁴ itself) needs no split term: its
    products are exact in f32."""
    u = F32_UNIT_ROUNDOFF
    kernel = 3 * (MMA_K + 1) * 2 * u / MMA_K
    plain = 2 * u
    return (kernel + plain + TF32X3_DROPPED / taps) / block0_tc.TERM_ULPS


def _unit(gemm_dtype) -> float:
    return tf32x3_unit() if gemm_dtype == torch.float32 else F32_UNIT_ROUNDOFF


def sel_bound(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              ref: torch.Tensor, gemm_dtype=torch.bfloat16) -> torch.Tensor:
    """The per-output bound of the f32 ``a_sel`` against the plain
    version's f32 ``ref`` ``(B, T // 4, C)``: ``block0_tc.order_bound``
    with the affine taken away (mul = 1, add = 0), ``u·(4·K·(S + |bias|) +
    4·|ref|)``, S the largest over the four phases of Σ|x·w| of the
    operands in ``gemm_dtype``; u = 2⁻²⁴ for bf16, ``tf32x3_unit()`` for
    f32. relu and the select are 1-Lipschitz, so they move no value farther
    than its sum."""
    ones = torch.ones_like(bias, dtype=torch.float32)
    return block0_tc.order_bound(x, w, bias.float(), ones, torch.zeros_like(ones), ref,
                                 gemm_dtype, _unit(gemm_dtype))


def preactivation(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  gemm_dtype=torch.bfloat16):
    """The plain version's pre-activation ``z = y + bias (B, C, T)`` f32
    (taps in order, operands in ``gemm_dtype``) and its bound
    ``u·(4·K·(S + |bias|) + 4·|z|)`` per full-rate value in float64, u as
    ``sel_bound``'s."""
    if x.dim() == 3:
        x = x[..., 0]
    B, T = x.shape
    xp = F.pad(x.to(gemm_dtype).float(), (PAD_L, TAPS - 1 - PAD_L))
    wq = w[:, 0, :].to(gemm_dtype).float()
    y = torch.zeros((B, wq.shape[1], T), dtype=torch.float32, device=x.device)
    s = torch.zeros((B, wq.shape[1], T), dtype=torch.float64, device=x.device)
    for k in range(TAPS):
        y += xp[:, None, k:k + T] * wq[k][:, None]
        s += (xp[:, None, k:k + T].double() * wq[k][:, None].double()).abs()
    z = y + bias.float()[:, None]
    u = _unit(gemm_dtype)
    bnd = u * (block0_tc.TERM_ULPS * TAPS * (s + bias.double().abs()[:, None])
               + block0_tc.EPILOGUE_ULPS * z.double().abs())
    return z, bnd


def relu_flips(cnt: torch.Tensor, cnt_ref: torch.Tensor, z: torch.Tensor,
               bound: torch.Tensor) -> int:
    """#(a > 0) per channel against the plain version's: a channel's count
    may differ only by as many full-rate pre-activations ``z`` (B, C, T) as
    lie within their ``bound`` of 0, where the kernel's value may fall on
    the other side. Returns the total difference; raises
    ``AssertionError`` for any other."""
    diff = (cnt.double() - cnt_ref.double()).abs()
    reach = (z.double().abs() <= bound).sum((0, 2)).double()
    if bool((diff > reach).any()):
        c = int((diff - reach).argmax())
        raise AssertionError(f"#(a > 0) differs by {float(diff[c])} at channel {c}, where only "
                             f"{float(reach[c])} pre-activations lie within their bound of 0")
    return int(diff.sum())


def route_flips(route: torch.Tensor, z: torch.Tensor, bound: torch.Tensor,
                sgn: torch.Tensor) -> int:
    """B5's routed phase ``route (B, T // 4, C)`` against the plain
    version's (the first phase in time order whose ``s·a_j`` is the max):
    a position may route elsewhere only where the phase it took and the
    plain version's lie within their bounds of each other in ``s·a``
    (relu moves no value farther than its pre-activation's bound). Returns
    the count of such positions; raises ``AssertionError`` for any other."""
    B, c, T = z.shape
    sa = (torch.relu(z) * sgn.float()[None, :, None]).view(B, c, T // POOL, POOL)
    bnd = bound.view(B, c, T // POOL, POOL)
    eq = sa == sa.amax(-1, keepdim=True)
    ref = (eq & (eq.cumsum(-1) == 1)).float().argmax(-1)  # (B, C, T/4)
    got = route.permute(0, 2, 1).long()
    moved = got != ref
    if not bool(moved.any()):
        return 0
    pick = lambda t, i: t.gather(-1, i[..., None])[..., 0]  # noqa: E731
    gap = (pick(sa, got) - pick(sa, ref)).double().abs()
    bad = moved & (gap > pick(bnd, got) + pick(bnd, ref))
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} positions route to another phase than the "
                             f"plain version's where no two phases tie within their bounds")
    return int(moved.sum())
