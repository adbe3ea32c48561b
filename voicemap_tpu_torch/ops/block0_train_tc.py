"""Host side of B4's and B5's tensor-core route (``csrc/conv_block0_train.cu
:: block0_train_tc``, on B2's main loop ``csrc/block0_mma.cuh``).

Both kernels compute block 0's conv as B2's ``mma.sync`` direct form
(``ops/block0_tc``); B5 adds the weight gradient as a second product. What
the wrapper hands them and what they compute from the launch's shape, each
piece pinned by a CPU test (``tests/test_torch_block0_train_tc.py``):

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
- ``sel_bound``, ``relu_flips`` and ``route_flips``: the tolerance of the
  kernels against their plain versions. The tensor cores' f32 summation
  order cannot be pinned, so ``a_sel`` agrees to B2's order bound (K = 32,
  the bias, no affine), and #(a > 0) and B5's routing may differ only where
  a pre-activation lies within its bound of 0, or two phases' ``s·a_j``
  within their bounds of each other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import block0_tc

TAPS, POOL, PAD_L = block0_tc.TAPS, block0_tc.POOL, block0_tc.PAD_L
SLICE, GROUP = block0_tc.SLICE, block0_tc.GROUP
GROUP_CHANNELS = 4 * SLICE  # channels of a CTA
WARPS = 4
# Pooled positions of an item, widest first. B5 stops at 32: on the H100 it
# ran faster with 32 than with 64, B4 slower.
TILES = {"fwd": block0_tc.TILES, "bwd": block0_tc.TILES[1:]}
H100_SMS = block0_tc.H100_SMS
SMEM_LIMIT = block0_tc.SMEM_LIMIT
CTAS_PER_SM = 4  # a persistent grid's CTAs on each SM, as the kernels' launch bounds say
VALS = {"fwd": 3, "bwd": TAPS + 1}  # rows of a CTA's partial sums
VECS = {"fwd": 2, "bwd": 5}  # per-channel rows: bias, sgn (, c0, c1, c2)
F32_UNIT_ROUNDOFF = block0_tc.F32_UNIT_ROUNDOFF


def channel_groups(c: int) -> int:
    return -(-c // GROUP_CHANNELS)


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
        if channel_groups(c) * B * -(-t_out // tile) >= sms:
            return tile
    return TILES[kind][-1]


def grid(B: int, T: int, c: int, kind: str, sms: int = H100_SMS) -> tuple[int, int]:
    """``(tile, n_cps)``: the item's tile and the CTAs of each channel group,
    ``min(items, sms·CTAS_PER_SM // groups)``; the grid is ``n_cps·groups``
    CTAs, each writing one partial row."""
    tile = pick_tile(B, T, c, kind, sms)
    items = B * -(-(T // POOL) // tile)
    return tile, min(items, max(1, sms * CTAS_PER_SM // channel_groups(c)))


def schedule(B: int, T: int, c: int, tile: int, n_cps: int) -> list[list[tuple[int, int, int]]]:
    """The items ``(b, p0, group)`` of each CTA in the order it runs them:
    CTA ``k`` keeps group ``k % groups`` and takes items ``k // groups + i·n_cps``."""
    n_sg = channel_groups(c)
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
    """Shared memory of one CTA: the group's packed weights and per-channel
    rows, the warps' fold rows, the window as read and shifted by one sample
    (bf16); B4 the output tile (rows padded by 16 bytes), B5 the window
    staged as sample pairs 4 apart."""
    cgp = min(block0_tc.c_pad(c), GROUP_CHANNELS)
    window = POOL * tile + TAPS
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
# Tolerances against the plain versions
# ---------------------------------------------------------------------------

def sel_bound(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              ref: torch.Tensor) -> torch.Tensor:
    """The per-output bound of the f32 ``a_sel`` against the plain
    version's f32 ``ref`` ``(B, T // 4, C)``: ``block0_tc.order_bound``
    with the affine taken away (mul = 1, add = 0), ``u·(4·K·(S + |bias|) +
    4·|ref|)``, S the largest over the four phases of Σ|x·w|. relu and the
    select are 1-Lipschitz, so they move no value farther than its sum."""
    ones = torch.ones_like(bias, dtype=torch.float32)
    return block0_tc.order_bound(x, w, bias.float(), ones, torch.zeros_like(ones), ref)


def preactivation(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """The plain version's pre-activation ``z = y + bias (B, C, T)`` f32
    (taps in order, bf16 operands) and its bound ``u·(4·K·(S + |bias|) +
    4·|z|)`` per full-rate value in float64."""
    if x.dim() == 3:
        x = x[..., 0]
    B, T = x.shape
    xp = F.pad(x.to(torch.bfloat16).float(), (PAD_L, TAPS - 1 - PAD_L))
    wq = w[:, 0, :].to(torch.bfloat16).float()
    y = torch.zeros((B, wq.shape[1], T), dtype=torch.float32, device=x.device)
    s = torch.zeros((B, wq.shape[1], T), dtype=torch.float64, device=x.device)
    for k in range(TAPS):
        y += xp[:, None, k:k + T] * wq[k][:, None]
        s += (xp[:, None, k:k + T] * wq[k][:, None]).double().abs()
    z = y + bias.float()[:, None]
    u = F32_UNIT_ROUNDOFF
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
