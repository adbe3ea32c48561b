"""What B4's and B5's tensor-core kernels take from the host, on the CPU.

``ops/block0_train_tc.py`` holds the layouts and the schedule that the
wrappers and ``csrc/conv_block0_train.cu :: block0_train_tc`` agree on; the
kernels run only on the card. Here:

- B5's weight-gradient product built as the lanes build it (X's A
  fragments from the window staged as pairs 4 apart, dZ's B fragments the
  forward accumulator transposed by ``movmatrix``) equals, in float64, the
  dW of ``conv_block0_train_bwd_reference`` from the same dz, and so the
  TPU kernel's ``pallas_bwd_core`` through the plain version's own tests;
- the product summed over every unit of every item, at B = 1, T/4 = 250
  (no multiple of the tile), C = 16, 72, 128 and 256, and on a coarse grid
  where phases tie, gives the plain version's dW to float64 rounding;
- the grid is fixed by the shape, its schedule covers every (row, tile,
  channel group) item once, every warp's share covers every (position,
  channel) of an item once, and B = 1 still gives every SM an item;
- a CTA's shared memory fits the H100 up to C = 256;
- the packed tensor-core sums give the plain ``a_sel`` within the order
  bound; the flip rules for #(a > 0) and for the routing accept only what
  lies within the bound and reject the rest.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.ops.pallas_conv_train import pallas_bwd_core, pallas_fwd_core
from voicemap_tpu_torch.ops import block0_tc, block0_train_tc as tc, tf32x3
from voicemap_tpu_torch.ops.cuda_conv_train import (
    _activation, conv_block0_train_bwd_reference, conv_block0_train_bwd_routed_reference,
    conv_block0_train_bwd_stage, conv_block0_train_reference,
)


def inputs(seed, B, T, c, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T)) * 0.3
    if ties:
        x = np.round(x * 4) / 4  # a coarse grid: phases tie exactly
    w = rng.standard_normal((32, 1, c)) * 32 ** -0.5
    if ties:
        w = np.round(w * 8) / 8
    b = rng.standard_normal(c) * (0.0 if ties else 0.05)
    sgn = np.where(np.arange(c) % 3 == 1, -1.0, 1.0)
    g = rng.standard_normal((B, T // 4, c))
    cs = [rng.standard_normal(c) * s for s in (1.0, 0.1, 0.05)]
    return tuple(torch.from_numpy(np.asarray(a, np.float32)) for a in (x, w, b, sgn, g, *cs))


def plain_dz(x, w, b, sgn, g, c0, c1, c2):
    """The plain version's dz (B, C, T) f32, before its rounding."""
    a, _ = _activation(x, w, b, torch.bfloat16)
    B, c, T = a.shape
    ar = a.view(B, c, T // 4, 4)
    sa = ar * sgn[None, :, None, None]
    eq = sa == sa.amax(-1, keepdim=True)
    first = eq & (eq.cumsum(-1) == 1)
    gj = torch.where(first, g.to(torch.bfloat16).float().transpose(1, 2)[..., None], 0.0)
    col = lambda v: v[None, :, None, None]  # noqa: E731
    dz = torch.where(ar > 0, col(c0) * gj + col(c1) + col(c2) * ar, 0.0)
    return dz.view(B, c, T)


def test_movmatrix_trans_hands_each_lane_its_pair_of_the_transpose():
    m = torch.arange(64.0).reshape(8, 8)
    frag = tc.fragments(m)
    assert frag[4 * 3 + 2].tolist() == [m[3, 4].item(), m[3, 5].item()]  # row g, cols 2tq, +1
    t = tc.movmatrix_trans(frag)
    for lane in range(32):
        g, tq = divmod(lane, 4)
        assert t[lane].tolist() == [m[2 * tq, g].item(), m[2 * tq + 1, g].item()]


def test_dw_fragments_pair_samples_four_apart_of_one_phase():
    """Register reg of lane (g, tq): rows tap 16mt + g (+8), k pair 2tq of
    phase 2s (+1): window samples 4·(8·grp + pos) + phase + tap for pos =
    2tq and 2tq + 1."""
    for grp in (0, 3, 7):
        for mt in range(2):
            for s in range(2):
                for lane in range(32):
                    g, tq = divmod(lane, 4)
                    for reg in range(4):
                        tap = 16 * mt + g + 8 * (reg & 1)
                        phase = 2 * s + (reg >> 1)
                        i = tc.dw_fragment_sample(grp, mt, s, tq, g, reg)
                        assert i == 4 * (8 * grp + 2 * tq) + phase + tap
    win = torch.arange(100.0)
    assert tc.x4_pairs(win)[17].tolist() == [17.0, 21.0]


@pytest.mark.parametrize("grp", [0, 5])
def test_unit_product_is_the_units_weight_gradient(grp):
    """One unit built lane by lane: X (taps × 32 positions) · dZ (positions
    × channels) = Σ over the unit's positions and phases of x[4p + j + k]
    · dz[p, j, c], in float64."""
    rng = np.random.default_rng(grp)
    tile = 64
    win = torch.from_numpy(rng.standard_normal(4 * tile + 32))
    dz = torch.from_numpy(rng.standard_normal((8, 4, 32)))
    got = tc.unit_dw(win, dz, grp)
    want = torch.zeros(32, 32, dtype=torch.float64)
    for p in range(8):
        for j in range(4):
            t = 4 * (8 * grp + p) + j
            want += win[t:t + 32, None] * dz[p, j][None, :]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("B,T,c,ties", [(1, 1000, 16, False), (1, 1000, 72, False),
                                        (2, 512, 128, False), (1, 1000, 256, False),
                                        (2, 1000, 72, True)])
def test_product_over_every_unit_is_the_plain_weight_gradient(B, T, c, ties):
    x, w, b, sgn, g, c0, c1, c2 = inputs(B + T + c, B, T, c, ties)
    dz = plain_dz(x, w, b, sgn, g, c0, c1, c2)
    if ties:  # the coarse grid ties phases: the routing is to the first
        assert int((dz != 0).sum()) > 0
    tile = tc.pick_tile(B, T, c, "bwd")
    got = tc.dw_product(x.to(torch.bfloat16).double(), dz.to(torch.bfloat16).double(), tile)
    want, _ = conv_block0_train_bwd_reference(x, w, b, sgn, g, c0, c1, c2)
    torch.testing.assert_close(got.float(), want[:, 0, :], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,T,c", [(1, 12000, 128), (3, 1000, 72), (32, 12000, 128),
                                   (2048, 12000, 128), (1, 1000, 256), (5, 1000, 16),
                                   (2, 1000, 200)])
@pytest.mark.parametrize("kind", tc.KINDS)
def test_schedule_covers_every_item_and_group_once(B, T, c, kind):
    tile, n_cps = tc.grid(B, T, c, kind)
    assert (tile, n_cps) == tc.grid(B, T, c, kind)  # a fixed function of the shape
    t_out = T // 4
    items = B * -(-t_out // tile)
    assert 1 <= n_cps <= items
    n_sg = tc.channel_groups(c, kind)
    assert n_sg == -(-c // (32 if kind.endswith("_f32") else 128))
    assert n_cps * n_sg <= tc.H100_SMS * tc.ctas_per_sm(kind)
    got = [it for cta in tc.schedule(B, T, c, tile, n_cps, kind) for it in cta]
    want = [(b, p0, sg) for b in range(B) for p0 in range(0, t_out, tile) for sg in range(n_sg)]
    assert sorted(got) == sorted(want)
    # a CTA keeps one channel group for its life
    assert all(len({sg for _, _, sg in cta}) == 1
               for cta in tc.schedule(B, T, c, tile, n_cps, kind))


@pytest.mark.parametrize("cg", [16, 32, 72, 100, 128])
@pytest.mark.parametrize("tile,n_p", [(64, 64), (64, 58), (16, 10), (32, 32)])
def test_warps_cover_every_position_and_slice_of_an_item_once(cg, tile, n_p):
    cover = tc.unit_cover(cg, tile, n_p)
    n_s = -(-cg // 32)
    assert sorted((sl, p) for _, sl, p in cover) == [(sl, p) for sl in range(n_s)
                                                     for p in range(n_p)]
    # a warp keeps one slice
    assert all(len({sl for w_, sl, _ in cover if w_ == w}) <= 1 for w in range(4))


@pytest.mark.parametrize("kind", tc.KINDS)
def test_batch_one_still_gives_every_sm_an_item(kind):
    tile = tc.pick_tile(1, 12000, 128, kind)
    groups = tc.channel_groups(128, kind)
    assert groups * -(-3000 // tile) >= tc.H100_SMS
    # the widest tile that does: 16 on one bf16 group; on four f32 slices
    # the widest there is
    assert tile == (tc.TILES[kind][0] if kind.endswith("_f32") else 16)
    assert tc.pick_tile(2048, 12000, 128, kind) == tc.TILES[kind][0]
    assert tc.pick_tile(1, 1000, 256, kind) == 16  # 250 positions: as wide as it gets


def test_shared_memory_fits_up_to_the_kernels_widest_channels():
    for c in (16, 72, 128, 200, 256):
        for kind in tc.KINDS:
            for tile in tc.TILES[kind]:
                for ob in (2, 4):
                    assert tc.smem_bytes(c, tile, kind, ob) <= tc.SMEM_LIMIT
    # small enough for the resident CTAs the launch bounds ask for
    for kind in ("fwd", "bwd"):
        assert tc.smem_bytes(128, 64, kind) * tc.CTAS_PER_SM <= 228 * 1024
    # the f32 route at its widest tile, with the 1 KB an SM keeps for each
    # CTA; one 32-channel slice a CTA, whatever C
    for kind in ("fwd_f32", "bwd_f32"):
        need = tc.smem_bytes(128, tc.TILES[kind][0], kind, 4) + 1024
        assert need * tc.CTAS_PER_SM_F32 <= tc.SMEM_PER_SM
        assert tc.smem_bytes(16, 32, kind) == tc.smem_bytes(256, 32, kind)
    # B5's fold rows fit in the place of its dz rows
    assert tc.WARPS * tc.VALS["bwd"] * tc.SLICE <= tc.WARPS * tc.DZ_ROWS * tc.DZ_PITCH


@pytest.mark.parametrize("B,T,c", [(1, 1000, 16), (2, 1000, 72), (1, 640, 256)])
def test_packed_sums_give_the_plain_a_sel_within_the_order_bound(B, T, c):
    x, w, b, sgn = inputs(c, B, T, c)[:4]
    ref = conv_block0_train_reference(x, w, b, sgn, sel_dtype=torch.float32)[0]
    y = block0_tc.hankel_sums(x.to(torch.bfloat16).double(), block0_tc.pack_weights(w), c)
    a = torch.relu(y.float() + b)  # (B, t_out, 4, C)
    got = torch.where(sgn > 0, a.amax(2), a.amin(2))
    bound = tc.sel_bound(x, w, b, ref)
    assert got.shape == ref.shape == bound.shape
    assert bool(((got - ref).abs() <= bound).all())
    assert float(bound.max()) < 1e-4 * float(ref.abs().max())


def test_relu_flip_rule_takes_only_values_near_zero():
    z = torch.tensor([[[1e-9, 0.5, -2.0], [-1e-9, 3.0, 0.0]]])  # (1, 2, 3)
    bound = torch.full(z.shape, 1e-6, dtype=torch.float64)
    cnt_ref = (z > 0).float().sum((0, 2))
    assert tc.relu_flips(cnt_ref.clone(), cnt_ref, z, bound) == 0
    near = cnt_ref.clone()
    near[0] -= 1  # 1e-9 may read as <= 0
    near[1] += 2  # -1e-9 and 0.0 may read as > 0
    assert tc.relu_flips(near, cnt_ref, z, bound) == 3
    far = cnt_ref.clone()
    far[0] -= 2  # only one value of channel 0 lies near 0
    with pytest.raises(AssertionError, match="channel 0"):
        tc.relu_flips(far, cnt_ref, z, bound)


def test_route_flip_rule_takes_only_phases_that_tie_within_their_bounds():
    z = torch.tensor([[[1.0, 1.0 + 1e-6, 0.2, 0.3, 2.0, 1.0, 0.5, 0.1]]])  # (1, 1, 8)
    bound = torch.full(z.shape, 1e-6, dtype=torch.float64)
    sgn = torch.tensor([1.0])
    ref = torch.tensor([[[1], [0]]], dtype=torch.uint8)  # (B, T/4, C)
    assert tc.route_flips(ref, z, bound, sgn) == 0
    near = torch.tensor([[[0], [0]]], dtype=torch.uint8)  # 1.0 against 1.0 + 1e-6
    assert tc.route_flips(near, z, bound, sgn) == 1
    far = torch.tensor([[[1], [1]]], dtype=torch.uint8)  # 1.0 against 2.0
    with pytest.raises(AssertionError, match="no two phases tie"):
        tc.route_flips(far, z, bound, sgn)
    # s = −1: the min is selected, the first of equal minima
    zt = torch.tensor([[[0.0, 0.0, 0.4, 0.0]]])
    first = torch.tensor([[[0]]], dtype=torch.uint8)
    assert tc.route_flips(first, zt, bound[..., :4], torch.tensor([-1.0])) == 0


def test_plain_stage_recomputes_b4s_selection():
    x, w, b, sgn, g, c0, c1, c2 = inputs(3, 2, 1000, 72, ties=True)
    dw, db, sel, route, relu = conv_block0_train_bwd_stage(x, w, b, sgn, g, c0, c1, c2)
    want = conv_block0_train_reference(x, w, b, sgn, sel_dtype=torch.float32)[0]
    assert torch.equal(sel, want) and route.dtype == torch.uint8 and route.shape == want.shape
    dw_ref, db_ref = conv_block0_train_bwd_reference(x, w, b, sgn, g, c0, c1, c2)
    assert torch.equal(dw, dw_ref) and torch.equal(db, db_ref)
    # relu bit j: phase j's a_j > 0; on its own routes and masks the routed
    # plain dW is the plain dW bit for bit
    a = _activation(x, w, b, torch.bfloat16)[0]
    B, C, T = a.shape
    bits = torch.stack([(relu >> j) & 1 for j in range(4)], -1).bool()
    assert relu.dtype == torch.uint8 and torch.equal(
        bits, (a.view(B, C, T // 4, 4) > 0).transpose(1, 2))
    routed = conv_block0_train_bwd_routed_reference(x, w, b, sgn, g, c0, c1, c2, route, relu)
    assert torch.equal(routed[0], dw_ref) and torch.equal(routed[1], db_ref)
    z, bound = tc.preactivation(x, w, b)
    assert tc.route_flips(route, z, bound, sgn) == 0
    # on the coarse grid phases tie: the route is the first of them
    assert int((route == 0).sum()) > int((route == 3).sum())


def test_kernel_products_against_the_tpu_kernels_in_interpret_mode():
    """B5's product over every unit (from the plain dz, rounded to bf16)
    against ``pallas_bwd_core``'s dW, and B4's packed sums through its
    epilogue against ``pallas_fwd_core``'s a_sel, both in bf16: dW to 1e-5
    of its largest magnitude (sum order), a_sel within 1 bf16 ulp."""
    B, T, c = 2, 256, 16
    x, w, b, sgn, g, c0, c1, c2 = inputs(7, B, T, c)
    j = lambda *a: [jnp.asarray(v.numpy()) for v in a]  # noqa: E731
    want_dw, _ = pallas_bwd_core(*j(x[..., None], w, b, sgn, g, c0, c1, c2), pool=4,
                                 gemm_dtype=jnp.bfloat16, t_chunk=32, interpret=True)
    dz = plain_dz(x, w, b, sgn, g, c0, c1, c2)
    got = tc.dw_product(x.to(torch.bfloat16).double(), dz.to(torch.bfloat16).double(),
                        tc.pick_tile(B, T, c, "bwd"))
    want_dw = np.asarray(want_dw, np.float64)[:, 0, :]
    assert np.abs(got.numpy() - want_dw).max() <= 1e-5 * np.abs(want_dw).max()
    want_sel = pallas_fwd_core(*j(x[..., None], w, b, sgn), pool=4, gemm_dtype=jnp.bfloat16,
                               sel_dtype=jnp.float32, t_chunk=32, block_rows=2,
                               interpret=True)[0]
    y = block0_tc.hankel_sums(x.to(torch.bfloat16).double(), block0_tc.pack_weights(w), c)
    a = torch.relu(y.float() + b)
    sel = torch.where(sgn > 0, a.amax(2), a.amin(2)).to(torch.bfloat16)
    want_sel = torch.from_numpy(np.array(want_sel, np.float32)).to(torch.bfloat16)
    diff = (sel.view(torch.int16).int() - want_sel.view(torch.int16).int()).abs()
    assert int(diff.max()) <= 1


# ---------------------------------------------------------------------------
# The f32 route (block0_train_tc32): 3xTF32 on the tensor cores
# ---------------------------------------------------------------------------

def test_f32_conv_fragments_are_the_toeplitz_view_of_the_window():
    """Register reg of lane (g, tq), m-tile mt, k8 step s holds window
    sample 4g + 2mt + 8s + tq (+ 1 for row g + 8, the next phase; + 4 for
    taps + 4): the element (position g, phase 2mt (+1), tap 8s + tq (+4))
    of the conv's Toeplitz view; the dW product's X holds (tap 16mt + g
    (+8), position tq (+4) of phase ks) at ks + 16mt + g + 4tq (+8, +16)."""
    for lane in range(32):
        g, tq = divmod(lane, 4)
        for mt in range(2):
            for s in range(4):
                for reg in range(4):
                    phase, tap = 2 * mt + (reg & 1), 8 * s + tq + 4 * (reg >> 1)
                    assert tc.conv_fragment_sample(g, tq, mt, s, reg) == 4 * g + phase + tap
                    pos, ks = tq + 4 * (reg >> 1), s
                    tap = 16 * mt + g + 8 * (reg & 1)
                    assert tc.dw_fragment_sample_f32(g, tq, mt, ks, reg) == 4 * pos + ks + tap
    # the dz rows are phase-major: row 8j + p; a k8 step reads one phase
    assert [tc.dz_row(j, p) for j in range(4) for p in range(8)] == list(range(tc.DZ_ROWS))


def test_f32_weight_tiles_are_wgmmas_kmajor_b_of_each_step_and_plane():
    """Every (channel, tap, plane) has its own word of the 8 tiles, and a
    tile read back in wgmma's K-major layout is that k8 step's (8 taps, 32
    channels) block of the split weights."""
    words = [tc.w_tile_word(n, k, p) for n in range(32) for k in range(32) for p in (0, 1)]
    assert sorted(words) == list(range(8 * tc.W_TILE_F32))
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32))
    big, small = tf32x3.split(w)
    packed = tc.pack_weights_f32(w)
    for s in range(4):
        for p, plane in enumerate((big, small)):
            tile = packed[(2 * s + p) * tc.W_TILE_F32:(2 * s + p + 1) * tc.W_TILE_F32]
            assert torch.equal(tc.kmajor_tile(tile), plane[8 * s:8 * s + 8])


@pytest.mark.parametrize("grp", [0, 3])
def test_f32_unit_sums_from_the_fragments_are_the_3xtf32_conv(grp):
    """A unit's conv sums built as a warp's share of the wgmma forms them (A
    fragment by fragment from the window, B read back from the packed
    tiles) equal the split planes' three products of the Toeplitz rows and
    the weights (both summed in float64), and lie within the split's
    3·2^-22 of Σ|x·w| of the exact conv."""
    rng = np.random.default_rng(grp)
    tile = 32
    win = torch.from_numpy(rng.standard_normal(4 * tile + 32).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((32, 32)) * 32 ** -0.5).astype(np.float32))
    got = tc.conv_products_f32(win, w, grp)
    u = 32 * grp
    rows = torch.stack([win[u + 4 * p + j:u + 4 * p + j + 32] for p in range(8)
                        for j in range(4)])  # (32 = position·4 + phase, 32 taps)
    ab, as_ = (t.double() for t in tf32x3.split(rows))
    wb, ws = (t.double() for t in tf32x3.split(w))
    want = (as_ @ wb + ab @ ws + ab @ wb).view(8, 4, 32)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    exact = (rows.double() @ w.double()).view(8, 4, 32)
    scale = (rows.double().abs() @ w.double().abs()).view(8, 4, 32)
    assert bool(((got - exact).abs() <= tc.TF32X3_DROPPED * scale).all())


@pytest.mark.parametrize("grp", [0, 2])
def test_f32_unit_dw_from_the_fragments_is_the_units_weight_gradient(grp):
    """B5's f32 dW product of one unit, dz written to its phase-major rows
    and read back as B fragments, X from the window: within 3·2^-22 of Σ|·|
    of the unit's exact X·dZ."""
    rng = np.random.default_rng(10 + grp)
    tile = 32
    win = torch.from_numpy(rng.standard_normal(4 * tile + 32).astype(np.float32))
    dz = torch.from_numpy(rng.standard_normal((8, 4, 32)).astype(np.float32))
    got = tc.unit_dw_f32(win, dz, grp)
    want = torch.zeros(32, 32, dtype=torch.float64)
    scale = torch.zeros(32, 32, dtype=torch.float64)
    for p in range(8):
        for j in range(4):
            t = 4 * (8 * grp + p) + j
            term = win[t:t + 32, None].double() * dz[p, j][None, :].double()
            want += term
            scale += term.abs()
    assert bool(((got - want).abs() <= tc.TF32X3_DROPPED * scale).all())
    assert float((got - want).abs().max()) > 0  # the split does drop something


def test_tf32x3_unit_is_derived_from_the_split_and_the_sums():
    """u = (3·(8 + 1)·2u/8 + 2u + 3·2^-22/32) / 4 with u = 2^-24: the three
    mma of a k8 step, the plain version's rounded product and add, and the
    split, a tap, over the form's 4."""
    u = 2.0 ** -24
    assert tc.tf32x3_unit() == pytest.approx((6.75 * u + 2 * u + 3 * 2.0 ** -22 / 32) / 4,
                                             rel=1e-15)
    assert tc.tf32x3_unit() > tc.F32_UNIT_ROUNDOFF  # looser than the bf16 route's


def _kernel_model_a_sel(x, w, b, sgn):
    """B4's f32 a_sel as the kernel forms it, modelled: each k8 step's three
    exact products of the split planes added to an f32 accumulator in 3xTF32's
    order (small·big, big·small, big·big), steps in order; + bias, relu, the
    select. The tensor cores' own additions are taken as rounded to nearest."""
    B, T = x.shape
    xp = torch.nn.functional.pad(x, (15, 16))
    rows = xp.unfold(1, 32, 1)[:, :T]  # (B, T, 32): row t is x[t − 15 ..]
    wq = w[:, 0, :]
    xb, xs = tf32x3.split(rows)
    wb, ws = tf32x3.split(wq)
    acc = torch.zeros((B, T, wq.shape[1]), dtype=torch.float32)
    for s in range(4):
        k = slice(8 * s, 8 * s + 8)
        for pa, pb in ((xs, wb), (xb, ws), (xb, wb)):
            acc = (acc.double() + pa[..., k].double() @ pb[k].double()).float()
    a = torch.relu(acc + b).view(B, T // 4, 4, -1)
    return torch.where(sgn > 0, a.amax(2), a.amin(2))


def test_f32_sel_bound_holds_where_the_split_loses_the_most():
    """The bound at tf32x3_unit on the case where the kernel's value and the
    plain version's differ the most as a share of S: x constant at 1 + 2^-11
    − 2^-23, whose split drops the most (big = 1, small rounds up by 2^-23),
    w alternating that value and −(1 + 2^-10) (exact in tf32), times powers
    of two, so that every tap's split error has one sign while the sums
    nearly cancel. There the model of the kernel lies farther from the plain
    a_sel than 2^-24·S, and within the bound; and on random rows, scaled
    rows and the ties grid as well."""
    c = 12
    B, T = 2, 256
    x = torch.full((B, T), 1.0 + 2.0 ** -11 - 2.0 ** -23)
    x[1] *= -3.0
    wpat = torch.tensor([1.0 + 2.0 ** -11 - 2.0 ** -23, -(1.0 + 2.0 ** -10)] * 16)
    w = (wpat[:, None] * torch.tensor([0.5, 1.0, 2.0] * 4)[None, :])[:, None, :]
    b = torch.full((c,), 0.01)
    sgn = torch.where(torch.arange(c) % 3 == 1, -1.0, 1.0)
    cases = [(x, w, b, sgn)]
    for seed, ties in ((1, False), (2, True)):
        xr, wr, br, sr = inputs(seed, 2, 512, 24, ties)[:4]
        cases.append((xr, wr, br, sr))
        cases.append((xr * torch.tensor([[1e3], [1e-3]]), wr, br, sr))
    worst = 0.0
    for xi, wi, bi, si in cases:
        ref = conv_block0_train_reference(xi, wi, bi, si, gemm_dtype=torch.float32,
                                          sel_dtype=torch.float32)[0]
        got = _kernel_model_a_sel(xi, wi, bi, si)
        bound = tc.sel_bound(xi, wi, bi, ref, torch.float32)
        diff = (got.double() - ref.double()).abs()
        assert bool((diff <= bound).all())
        worst = max(worst, float((diff / bound.clamp(min=1e-300)).max()))
    # the adversarial case: off by more than 2^-24 of S, but inside the bound
    ref = conv_block0_train_reference(x, w, b, sgn, gemm_dtype=torch.float32,
                                      sel_dtype=torch.float32)[0]
    got = _kernel_model_a_sel(x, w, b, sgn)
    s_max = (x.abs().max() * w.abs().sum(0).max()).item()
    assert float((got - ref).abs().max()) > 2.0 ** -24 * s_max
    assert 0 < worst <= 1.0


def test_f32_preactivation_bound_is_the_f32_operands_at_the_3xtf32_unit():
    x, w, b = inputs(4, 1, 400, 8)[:3]
    z, bound = tc.preactivation(x, w, b, torch.float32)
    a = _activation(x, w, b, torch.float32)[0]
    assert torch.equal(torch.relu(z), a)  # the plain version's own sum, f32 operands
    zb, bound_b = tc.preactivation(x, w, b)
    assert not torch.equal(z, zb)  # bf16 operands differ
    assert bool((bound > bound_b * (tc.tf32x3_unit() / tc.F32_UNIT_ROUNDOFF) * 0.5).all())
