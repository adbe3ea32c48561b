"""What the Hopper main loop of B8 and B3 takes from the host, on the CPU.

``ops/conv_sm90.py`` holds the layouts and the schedule that the wrappers
and ``csrc/conv_sm90.cuh`` agree on; the kernel itself runs only on the card.
Here:

- the per-tap padded weight pack unpacks back to ``w``, with zero pads;
- the plain GEMM over the packed weights (``packed_conv_sums``) is the SAME
  conv: against ``quant_block_reference`` exactly (int8, accumulated in
  float64), against ``conv_blockn_reference`` to the bound of
  ``tests/test_torch_conv_blockn.py`` (bf16 operands, f32 sums in another
  order), and in float64 against XLA's conv;
- B8's pooling by the sign of ``mul`` before the affine, the order the
  kernel takes, equals the plain version's affine-then-max bit for bit;
- the persistent schedule covers every (row, time tile, channel tile)
  exactly once, at B = 1, odd T and Couts 24, 72 and 384, with both tile
  heights and the one the kernel picks, at pool 2 and at pool 1;
- the ring of stages fits the H100's shared memory for every k the kernel
  takes, and the wrappers refuse the rest;
- config #3's (``dilated_4khz``) dilations: the packed GEMM at reaches 2–32
  against both plain versions (B3 exactly), the input box's height at each
  reach, and a ring of at least 2 stages at every block shape of config #3,
  both tile heights and every output width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_conv_blockn import assert_within, make_case
from test_torch_quant_block import NAMES, rand_qblk
from voicemap_tpu_torch.ops import conv_sm90
from voicemap_tpu_torch.ops.cuda_conv import (
    bn_affine, check_blockn_launch, conv_blockn_reference,
)
from voicemap_tpu_torch.ops.cuda_quant_block import (
    MAX_CIN, check_quant_launch, pack_weights, pairs, quant_block_reference,
)

EPS = 1e-3


def unpack_taps(wp: torch.Tensor, k: int, cin: int) -> torch.Tensor:
    """The inverse of ``pack_taps``: ``(Cout, k·Kp)`` → ``(k, Cin, Cout)``."""
    return wp.reshape(wp.shape[0], k, -1)[:, :, :cin].permute(1, 2, 0)


@pytest.mark.parametrize("k,cin,cout,elem", [
    (3, 40, 24, 2), (5, 128, 72, 2), (3, 384, 512, 2),
    (3, 96, 40, 1), (3, 128, 256, 1), (3, 480, 72, 1), (3, 512, 8, 1),
])
def test_pack_taps_pads_each_tap_and_unpacks(k, cin, cout, elem):
    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy(rng.integers(-127, 128, (k, cin, cout)).astype(np.int8))
    if elem == 2:
        w = w.to(torch.bfloat16)
    wp = conv_sm90.pack_taps(w)
    multiple = conv_sm90.PAD_BYTES // elem
    kp = -(-cin // multiple) * multiple
    assert wp.shape == (cout, k * kp) and wp.is_contiguous() and wp.dtype == w.dtype
    assert torch.equal(unpack_taps(wp, k, cin), w)
    pads = wp.reshape(cout, k, kp)[:, :, cin:]
    assert pads.numel() == cout * k * (kp - cin) and not pads.float().abs().any()
    if elem == 1:  # B3's wrapper packs through pack_weights
        assert torch.equal(pack_weights(w), wp)


def b3_from_packed_sums(cin, cout, T, last, pool=2, d=1):
    """B3's output formed as the kernel forms it, from the packed GEMM's
    sums pooled by the sign of alpha, against its plain version: equal."""
    rng = np.random.default_rng(cin * T + d)
    x = torch.from_numpy(rng.integers(-127, 128, (2, T, cin)).astype(np.int8))
    q = rand_qblk(rng, cin, cout, realistic=True)
    t = [torch.from_numpy(q[n]) for n in NAMES]
    wp = pack_weights(t[0])
    acc = conv_sm90.packed_conv_sums(x.double(), wp, 3, d).to(torch.int32)
    alpha, beta, gamma = t[1:]
    p = pairs(acc, pool)  # the kernel pools the raw sums by the sign of alpha
    sel = torch.where(alpha > 0, p.amax(dim=2), p.amin(dim=2))
    z = torch.relu(sel.float() + beta) * alpha + gamma
    got = z.to(torch.bfloat16) if last else torch.round(z).clamp(-127, 127).to(torch.int8)
    want = quant_block_reference(x, *t, last=last, pool=pool, dilation=d)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("cin,cout,T,last", [
    (32, 40, 61, False), (96, 24, 30, True), (128, 72, 2, False), (64, 8, 3, True),
])
def test_packed_sums_give_b3_exactly(cin, cout, T, last):
    b3_from_packed_sums(cin, cout, T, last)


@pytest.mark.parametrize("cin,cout,T,last,pool,d", [
    (32, 40, 61, False, 1, 2), (64, 24, 45, True, 1, 4), (32, 8, 33, False, 1, 8),
    (64, 72, 50, True, 1, 16), (32, 40, 61, False, 2, 4), (96, 24, 7, False, 1, 16),
])
def test_packed_sums_give_b3_exactly_dilated(cin, cout, T, last, pool, d):
    """Reaches 4-32, T below the reach at d = 16 and T = 7."""
    b3_from_packed_sums(cin, cout, T, last, pool, d)


def b8_from_packed_sums(k, cin, cout, T, pool=2, d=1):
    """B8's f32 output formed from the packed GEMM's sums against its plain
    version, within the order bound (bf16 operands, f32 sums)."""
    x, params = make_case(k + T + d, 2, T, k, cin, cout)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(params[0]).to(torch.bfloat16)
    wp = conv_sm90.pack_taps(wb)
    y = conv_sm90.packed_conv_sums(xb.float(), wp, k, d)  # (B, T, Cout), f32
    bias, mul, add = bn_affine(*map(torch.from_numpy, params[1:]), EPS)
    z = torch.relu(y + bias) * mul + add
    got = pairs(z, pool).amax(dim=2)
    want = conv_blockn_reference(xb, *map(torch.from_numpy, params), EPS, pool,
                                 out_dtype=torch.float32, dilation=d)
    return got, want, xb, params


@pytest.mark.parametrize("k,cin,cout,T", [(3, 40, 24, 257), (5, 16, 72, 64), (3, 64, 8, 3)])
def test_packed_sums_give_b8_within_the_order_bound(k, cin, cout, T):
    got, want, xb, params = b8_from_packed_sums(k, cin, cout, T)
    assert_within(got.numpy(), want.numpy(), xb.float().numpy(), params, "bfloat16")


@pytest.mark.parametrize("k,cin,cout,T,pool,d", [
    (3, 40, 24, 257, 1, 2), (3, 16, 72, 64, 2, 4), (5, 16, 8, 40, 1, 8), (3, 64, 8, 31, 1, 16),
])
def test_packed_sums_give_b8_within_the_order_bound_dilated(k, cin, cout, T, pool, d):
    got, want, xb, params = b8_from_packed_sums(k, cin, cout, T, pool, d)
    bound = order_bound_dilated(xb.float(), params, want, pool, d)
    assert got.shape == want.shape and bool(((got - want).abs() <= bound).all())


def order_bound_dilated(xb, params, out, pool, d):
    """The bound of ``assert_within`` at (pool, d): K = k·Cin products."""
    w = torch.from_numpy(params[0]).to(torch.bfloat16).float()
    k, cin, cout = w.shape
    zeros, ones = torch.zeros(cout), torch.ones(cout)
    s = conv_blockn_reference(xb.abs(), w.abs(), zeros, ones, zeros, zeros, ones, 0.0, pool,
                              out_dtype=torch.float32, dilation=d)
    bias, mul, add = bn_affine(*map(torch.from_numpy, params[1:]), EPS)
    return 2.0 ** -24 * ((2 * k * cin + 4) * mul.abs() * (s + bias.abs())
                         + 4 * (out.abs() + add.abs()))


def xla_sums_float64(x, w, d):
    jax.config.update("jax_enable_x64", True)
    try:
        return np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (1,), "SAME", rhs_dilation=(d,),
            dimension_numbers=("NWC", "WIO", "NWC")))
    finally:
        jax.config.update("jax_enable_x64", False)


def test_packed_sums_are_xlas_conv_in_float64():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 33, 24))
    w = rng.standard_normal((5, 24, 16))
    want = xla_sums_float64(x, w, 1)
    wp = conv_sm90.pack_taps(torch.from_numpy(w))
    got = conv_sm90.packed_conv_sums(torch.from_numpy(x), wp, 5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("k,d", [(3, 2), (3, 4), (3, 8), (3, 16), (5, 8), (9, 4)])
def test_packed_sums_are_xlas_dilated_conv_in_float64(k, d):
    """Reaches 4-32: tap j reads rows t + j·d − d·(k − 1)/2, as XLA's SAME
    conv with rhs_dilation does."""
    rng = np.random.default_rng(k * d)
    x = rng.standard_normal((2, 37, 24))
    w = rng.standard_normal((k, 24, 16))
    want = xla_sums_float64(x, w, d)
    wp = conv_sm90.pack_taps(torch.from_numpy(w))
    got = conv_sm90.packed_conv_sums(torch.from_numpy(x), wp, k, d).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_b8_pool_by_the_sign_of_mul_equals_affine_then_max(seed):
    """The kernel keeps, of each pair, the max where mul > 0 and the min
    elsewhere, then applies the affine once; the plain version applies it to
    both and takes the max. Op by op in f32, with mul of both signs and
    zero, sums on both sides of -bias: equal bit for bit."""
    rng = np.random.default_rng(seed)
    c = 64
    y = torch.from_numpy(rng.standard_normal((3, 40, c)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    mul = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    mul[::7] = 0.0
    mul[1::11] = -0.0
    add = torch.from_numpy(rng.standard_normal(c).astype(np.float32))

    def affine(v):
        return torch.relu(v + bias) * mul + add

    p = pairs(y)
    want = torch.maximum(affine(p[:, :, 0]), affine(p[:, :, 1]))
    got = affine(torch.where(mul > 0, p.amax(dim=2), p.amin(dim=2)))
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,T,cout", [
    (1, 3000, 256), (1, 1500, 384), (1, 750, 512), (3, 1001, 24), (2, 257, 72),
    (1, 3, 384), (5, 2, 24), (2, 513, 200),
])
@pytest.mark.parametrize("mw", [1, 2, None])
def test_schedule_covers_every_item_once(B, T, cout, mw):
    sched = conv_sm90.schedule(B, T, cout, n_ctas=conv_sm90.H100_SMS, mw=mw)
    wide = conv_sm90.wide_tiles(B, T, cout) if mw is None else mw == 2
    tile_m = 256 if wide else 128
    t_even = (T // 2) * 2
    want = {(b, t0, n0) for b in range(B) for t0 in range(0, t_even, tile_m)
            for n0 in range(0, cout, conv_sm90.TILE_N)}
    got = [item for cta in sched for item in cta]
    assert len(got) == len(set(got)) and set(got) == want
    assert len(sched) == min(conv_sm90.H100_SMS, len(want))
    # CTA i runs items i, i + n_ctas, ... of the order with the channel tile innermost
    ordered = sorted(want)
    assert all(cta == ordered[i::conv_sm90.H100_SMS] for i, cta in enumerate(sched))


# config #3's blocks 1-7: (T in, Cin, Cout, pool, dilation)
DILATED_BLOCKS = ((3000, 128, 128, 1, 2), (3000, 128, 256, 2, 1), (1500, 256, 256, 1, 4),
                  (1500, 256, 384, 2, 1), (750, 384, 384, 1, 8), (750, 384, 512, 2, 1),
                  (375, 512, 512, 1, 16))


@pytest.mark.parametrize("pool", [1, 2])
@pytest.mark.parametrize("B,T,cout", [
    (1, 3000, 128), (2, 375, 512), (3, 1001, 24), (2, 257, 72), (1, 3, 384), (5, 2, 24),
    (16, 750, 384),
])
@pytest.mark.parametrize("mw", [1, 2, None])
def test_schedule_covers_every_output_row_once_at_each_pool(B, T, cout, pool, mw):
    """Each conv row whose output the pool keeps (all T at pool 1, the even
    part at pool 2) lies in exactly one item's tile."""
    sched = conv_sm90.schedule(B, T, cout, n_ctas=conv_sm90.H100_SMS, mw=mw, pool=pool)
    wide = (conv_sm90.wide_tiles(B, T, cout, pool=pool) if mw is None else mw == 2)
    tile_m = 256 if wide else 128
    items = [item for cta in sched for item in cta]
    assert len(items) == len(set(items))
    rows = sorted((b, t, n0) for b, t0, n0 in items for t in range(t0, t0 + tile_m))
    kept = (T // pool) * pool
    want = [(b, t, n0) for b in range(B) for t in range(kept)
            for n0 in range(0, cout, conv_sm90.TILE_N)]
    assert [r for r in rows if r[1] < kept] == sorted(want)
    # no tile lies wholly past the kept rows
    assert all(t0 < kept for _, t0, _ in items)


def test_box_rows_hold_each_tile_and_its_reach():
    """A tile's mw boxes hold its 128·mw rows and the reach, 8-row aligned
    and within TMA's 256: config #1's k = 3 keeps its 136 rows; config #3's
    reach of 32 takes 160 rows at mw = 1 and 144 a box at mw = 2."""
    assert conv_sm90.box_rows(1, 2) == conv_sm90.box_rows(2, 2) == 136
    assert (conv_sm90.box_rows(1, 32), conv_sm90.box_rows(2, 32)) == (160, 144)
    for mw in (1, 2):
        for reach in range(0, conv_sm90.MAX_REACH + 1, 2):
            rows = conv_sm90.box_rows(mw, reach)
            assert rows % 8 == 0 and mw * rows >= 128 * mw + reach
            assert rows <= conv_sm90.MAX_BOX_ROWS and rows - 8 < 128 + -(-reach // mw)


@pytest.mark.parametrize("T,cin,cout,pool,d", DILATED_BLOCKS)
@pytest.mark.parametrize("out_bytes", [1, 2, 4])
def test_the_ring_holds_two_stages_at_config_3s_blocks(T, cin, cout, pool, d, out_bytes):
    """Every block of config #3 at both tile heights and every output width
    (int8, bf16, f32) keeps at least 2 stages in flight; at pool 1 and f32
    out the doubled output tile leaves 2 at mw = 2 (3 at pool 2)."""
    for mw in (1, 2):
        s = conv_sm90.stages(3, mw, out_bytes, 2 * d, pool)
        assert 2 <= s <= conv_sm90.MAX_STAGES
        assert conv_sm90.smem_bytes(3, mw, out_bytes, 2 * d, pool) <= conv_sm90.SMEM_LIMIT
    assert conv_sm90.takes(3, d, pool)
    assert conv_sm90.wide_tiles(2048, T, cout, pool=pool, dilation=d, out_bytes=out_bytes)
    assert conv_sm90.stages(3, 2, 4, 2 * d, 1) == 2 and conv_sm90.stages(3, 2, 4, 2 * d, 2) == 3


def test_batch_one_fills_more_sms_than_its_wide_tiles():
    """At B = 1 the kernel takes 128-row tiles: block 1 of config #1 has 48
    items (24 time tiles x 2 channel tiles), not 24."""
    assert not conv_sm90.wide_tiles(1, 3000, 256)
    assert len(conv_sm90.schedule(1, 3000, 256)) == 48
    assert conv_sm90.wide_tiles(2048, 3000, 256) and conv_sm90.wide_tiles(2048, 750, 512)


@pytest.mark.parametrize("mw", [1, 2])
@pytest.mark.parametrize("out_bytes", [1, 2, 4])
def test_the_ring_fits_the_h100_for_every_k_the_kernel_takes(mw, out_bytes):
    for k in range(1, conv_sm90.MAX_K + 1, 2):
        s = conv_sm90.stages(k, mw, out_bytes)
        assert 1 <= s <= conv_sm90.MAX_STAGES
        assert conv_sm90.smem_bytes(k, mw, out_bytes) <= conv_sm90.SMEM_LIMIT
        # a narrower output leaves at least as many stages
        assert s >= conv_sm90.stages(k, mw, 4)
    assert conv_sm90.stages(3, mw, out_bytes) >= 3  # config #1's k: loads stay in flight
    assert conv_sm90.stages(conv_sm90.MAX_K + 2, mw, out_bytes) == 0


def test_b8_refuses_a_k_wider_than_the_kernel_takes():
    k = conv_sm90.MAX_K + 2
    x = torch.zeros(2, 10, 16, dtype=torch.bfloat16)
    vecs = tuple(torch.zeros(8) for _ in range(5))
    with pytest.raises(ValueError, match="k="):
        check_blockn_launch(x, torch.zeros(k, 16, 8), vecs, 2, torch.bfloat16, torch.bfloat16)
    check_blockn_launch(x, torch.zeros(conv_sm90.MAX_K, 16, 8), vecs, 2, torch.bfloat16,
                        torch.bfloat16)
    # the reach, not k alone: k = 9 at the widest dilation the box holds, and past it
    d = conv_sm90.MAX_REACH // (conv_sm90.MAX_K - 1)
    check_blockn_launch(x, torch.zeros(conv_sm90.MAX_K, 16, 8), vecs, 1, torch.bfloat16,
                        torch.bfloat16, d)
    with pytest.raises(ValueError, match="reach"):
        check_blockn_launch(x, torch.zeros(conv_sm90.MAX_K, 16, 8), vecs, 1, torch.bfloat16,
                            torch.bfloat16, d + 1)


def quant_cases():
    x = torch.zeros(2, 10, 32, dtype=torch.int8)
    w = torch.zeros(3, 32, 8, dtype=torch.int8)
    vecs = tuple(torch.zeros(8) for _ in range(3))
    ok = dict(x_q=x, w_q=w, vecs=vecs)
    wide = MAX_CIN + 32
    return [
        ("f32 input", dict(ok, x_q=x.float())),
        ("strided input", dict(ok, x_q=torch.zeros(2, 32, 10, dtype=torch.int8).transpose(1, 2))),
        ("Cin mismatch", dict(ok, w_q=torch.zeros(3, 64, 8, dtype=torch.int8))),
        ("k 5", dict(ok, w_q=torch.zeros(5, 32, 8, dtype=torch.int8))),
        ("Cin 48", dict(ok, x_q=torch.zeros(2, 10, 48, dtype=torch.int8),
                        w_q=torch.zeros(3, 48, 8, dtype=torch.int8))),
        ("Cin past MAX_CIN", dict(ok, x_q=torch.zeros(1, 2, wide, dtype=torch.int8),
                                  w_q=torch.zeros(3, wide, 8, dtype=torch.int8))),
        ("vector shape", dict(ok, vecs=vecs[:2] + (torch.zeros(9),))),
        ("vector device", dict(ok, vecs=vecs[:2] + (torch.zeros(8, device="meta"),))),
    ]


@pytest.mark.parametrize("name,kw", quant_cases(), ids=[c[0] for c in quant_cases()])
def test_b3_launch_refuses_what_the_kernel_does_not_take(name, kw):
    with pytest.raises(ValueError):
        check_quant_launch("quant_block", **kw)


def test_b3_takes_a_cin_past_the_old_shared_memory_cap():
    """The weights stream, so Cin = 512 (past the first design's 480) is
    taken; MAX_CIN keeps the int32 sum from overflowing."""
    for cin in (480, 512, MAX_CIN):
        check_quant_launch("quant_block", torch.zeros(1, 2, cin, dtype=torch.int8),
                           torch.zeros(3, cin, 8, dtype=torch.int8),
                           tuple(torch.zeros(8) for _ in range(3)))
    assert 3 * MAX_CIN * 128 * 128 < 2 ** 31
