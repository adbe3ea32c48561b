"""What B2's tensor-core kernel takes from the host, on the CPU.

``ops/block0_tc.py`` holds the layouts and the schedule that the wrapper
and ``csrc/conv_block0.cu :: conv_block0_tc_kernel`` agree on; the kernel
itself runs only on the card. Here:

- the packed weights are ``w``'s taps, one bf16 row a channel, zero pads;
- the kernel's direct form (M = full-rate rows, K = 32 taps) computes the
  TPU kernel's product: in float64 its sums equal the pooled frames times
  JAX's ``stacked_weights`` (``voicemap_tpu/ops/pallas_conv.py:69``);
- the phase→row map puts every (pooled position, phase) of a unit in
  exactly one accumulator row, and every A fragment register starts at the
  window sample that row and tap need (the PTX m16n8k16 layout);
- the packed product in float64, then the kernel's pool-first epilogue,
  gives ``conv_block0_reference`` within the stated order bound, and the
  pool by the sign of ``mul`` is the plain version's affine-then-max bit
  for bit;
- the int8 flip rule accepts a difference only within the bound of a
  half-integer and rejects a difference of 2;
- the persistent schedule covers every (row, tile) item once, B = 1 fills
  the SMs, and the shared memory fits the H100 at the widths the configs
  use.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.ops.pallas_conv import stacked_weights
from voicemap_tpu_torch.ops import block0_tc
from voicemap_tpu_torch.ops.cuda_conv import bn_affine, conv_block0_reference

EPS = 1e-3


def params(seed, c):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((32, 1, c)) * 32 ** -0.5).astype(np.float32)
    b = (rng.standard_normal(c) * 0.05).astype(np.float32)
    scale = (rng.uniform(0.5, 1.5, c) * np.where(np.arange(c) % 2, 1, -1)).astype(np.float32)
    bias, mean = (rng.standard_normal((2, c)) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (w, b, scale, bias, mean, var))


def wave(seed, B, T, scale=0.3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((B, T)) * scale).astype(np.float32))


@pytest.mark.parametrize("c", [16, 40, 128, 160])
def test_pack_weights_holds_each_channels_taps_with_zero_pads(c):
    w = params(c, c)[0]
    wp = block0_tc.pack_weights(w)
    assert wp.dtype == torch.bfloat16 and wp.shape == (block0_tc.c_pad(c), block0_tc.W_ROW)
    assert wp.shape[0] % block0_tc.SLICE == 0 and wp.shape[0] >= c
    assert torch.equal(wp[:c, :32], w[:, 0, :].t().to(torch.bfloat16))
    assert not wp[c:].any() and not wp[:, 32:].any()
    with pytest.raises(ValueError):
        block0_tc.pack_weights(torch.zeros(31, 1, c))


@pytest.mark.parametrize("T", [64, 1001, 1027])
def test_direct_form_is_the_tpu_kernels_stacked_product(T):
    """Hankel rows × packed taps (the kernel) = pooled frames × stacked
    weights (the TPU kernel), in float64."""
    c = 24
    x = wave(T, 2, T).to(torch.bfloat16).double()
    w = params(3, c)[0]
    got = block0_tc.hankel_sums(x, block0_tc.pack_weights(w), c)  # (B, t_out, 4, C)
    w4, win, _ = stacked_weights(jnp.asarray(w.to(torch.bfloat16).float().numpy()), 4)
    w4 = torch.from_numpy(np.asarray(w4, np.float64))[:win]  # (35, 4C)
    t_out = T // 4
    xp = torch.nn.functional.pad(x, (15, 16 + 3))
    frames = torch.stack([xp[:, 4 * p:4 * p + win] for p in range(t_out)], dim=1)
    want = (frames @ w4).reshape(2, t_out, 4, c)  # column j·C + c is phase j
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_phase_rows_cover_every_position_and_phase_once():
    rows = block0_tc.phase_rows()
    pairs = [tuple(rows[mt, r].tolist()) for mt in range(2) for r in range(16)]
    assert sorted(pairs) == [(g, j) for g in range(block0_tc.GROUP) for j in range(4)]
    # rows g and g + 8 of one tile: one position, so one thread holds all 4 phases
    for g in range(8):
        assert {tuple(rows[mt, r].tolist())[0] for mt in range(2) for r in (g, g + 8)} == {g}


def test_a_fragments_start_where_the_row_and_tap_need():
    """PTX m16n8k16 A layout: register 0 is (row g, k 2tq), 1 (g + 8, 2tq),
    2 (g, 2tq + 8), 3 (g + 8, 2tq + 8); the pair starts at window sample
    4·lp + phase + k."""
    rows = block0_tc.phase_rows()
    for lp in (0, 5, 13):
        g = lp % 8
        for mt in range(2):
            for s in range(2):
                for tq in range(4):
                    for reg in range(4):
                        r = g + 8 * (reg & 1)
                        k = 16 * s + 2 * tq + 8 * (reg >> 1)
                        phase = int(rows[mt, r, 1])
                        assert block0_tc.fragment_sample(lp, mt, s, tq, reg) == \
                            4 * lp + phase + k


@pytest.mark.parametrize("B,T,c", [(3, 1001, 16), (2, 4098, 160), (1, 640, 128)])
def test_packed_product_gives_the_plain_version_within_the_order_bound(B, T, c):
    x = wave(B + T, B, T)
    p = params(T, c)
    ref = conv_block0_reference(x, *p, EPS, out_dtype=torch.float32)
    bias, mul, add = bn_affine(*p[1:], EPS)
    y = block0_tc.hankel_sums(x.to(torch.bfloat16).double(), block0_tc.pack_weights(p[0]), c)
    got = block0_tc.pool_first(y.float(), bias, mul, add)
    bound = block0_tc.order_bound(x, p[0], bias, mul, add, ref)
    assert got.shape == ref.shape == bound.shape == (B, T // 4, c)
    assert bool(((got - ref).abs() <= bound).all())
    # the bound is a bound, not slack everywhere: it is far below the values
    assert float(bound.max()) < 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("seed", [0, 1])
def test_pool_by_the_sign_of_mul_is_affine_then_max_bit_for_bit(seed):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(4, 50, 4, 64, generator=g)
    y[:, :, 1] = y[:, :, 0]  # ties
    bias, add = torch.randn(64, generator=g), torch.randn(64, generator=g)
    mul = torch.randn(64, generator=g)
    mul[:8] = -1e-3
    assert torch.equal(block0_tc.pool_first(y, bias, mul, add),
                       block0_tc.epilogue(y, bias, mul, add))


def test_int8_flip_rule_takes_only_near_ties():
    inv = torch.tensor([1.0, 1.0, 1.0, 1.0])
    ref = torch.tensor([[[2.5 + 1e-9, 7.2, 3.0, -4.5]]])
    bound = torch.full_like(ref, 1e-6, dtype=torch.float64)
    q_ref = torch.round(ref * inv).to(torch.int8)  # 2, 7, 3, -4: half to even
    assert block0_tc.requant_flips(q_ref.clone(), q_ref, ref, inv, bound) == 0
    near = q_ref.clone()
    near[0, 0, 0] -= 1  # 1: the tie at 2.5 itself (f32 holds no 2.5 + 1e-9)
    near[0, 0, 3] -= 1  # -5: a tie itself
    assert block0_tc.requant_flips(near, q_ref, ref, inv, bound) == 2
    far = q_ref.clone()
    far[0, 0, 1] += 1  # 8 for 7.2: no tie within the bound
    with pytest.raises(AssertionError, match="no rounding tie"):
        block0_tc.requant_flips(far, q_ref, ref, inv, bound)
    two = q_ref.clone()
    two[0, 0, 0] += 2
    with pytest.raises(AssertionError, match="by 2"):
        block0_tc.requant_flips(two, q_ref, ref, inv, bound)
    # a wider bound reaches farther, and no farther than it says
    assert block0_tc.requant_flips(far, q_ref, ref, inv, torch.full_like(bound, 0.31)) == 1
    with pytest.raises(AssertionError):
        block0_tc.requant_flips(far, q_ref, ref, inv, torch.full_like(bound, 0.29))


@pytest.mark.parametrize("B,T", [(1, 12000), (3, 1001), (2048, 12000), (70000, 64)])
def test_schedule_covers_every_item_once(B, T):
    tile = block0_tc.pick_tile(B, T)
    n_ctas = min(264, B * -(-(T // 4) // tile))
    items = [it for cta in block0_tc.schedule(B, T, tile, n_ctas) for it in cta]
    t_out = T // 4
    want = [(b, p0) for b in range(B) for p0 in range(0, t_out, tile)]
    assert sorted(items) == want


def test_tiles_narrow_until_batch_one_fills_the_sms():
    assert block0_tc.pick_tile(2048, 12000) == block0_tc.TILES[0]
    tile = block0_tc.pick_tile(1, 12000)
    assert tile == 16 and -(-3000 // tile) >= block0_tc.H100_SMS
    assert block0_tc.pick_tile(1, 64) == block0_tc.TILES[-1]


def test_shared_memory_fits_the_widths_the_configs_use():
    for c in (16, 32, 64, 128, 160, 256):
        for tile in block0_tc.TILES:
            for ob in (1, 2, 4):
                assert block0_tc.smem_bytes(c, tile, ob) <= block0_tc.SMEM_LIMIT
    assert block0_tc.smem_bytes(1024, 128, 4) > block0_tc.SMEM_LIMIT
