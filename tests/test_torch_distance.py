"""B9 (``ops/cuda_distance``) and the siamese distances of ``ops/distance``,
on the CPU.

B9's plain version against the Pallas kernel in interpret mode and against
the JAX package's ``head_scores``, at 1e-5 (another f32 summation order over
64 terms, and the operands scaled by |w| before the difference); its pinned
order (sign(w)·|q·|w| − s·|w||, in d order) against a numpy loop, bit for
bit, with zero weights and after w changes in place;
``merge_features`` for the five metrics at 1e-6; the two routes to the
weighted-L1 scores (per-task ``head_scores`` and ``pairwise_weighted_l1``)
against each other; the wrapper's checks and its launch count on CPU tensors.
The kernel itself runs only on the card (``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.ops import distance as jdist
from voicemap_tpu.ops.pallas_distance import pallas_weighted_l1
from voicemap_tpu_torch.ops import cuda_distance
from voicemap_tpu_torch.ops import distance as tdist
from voicemap_tpu_torch.ops.cuda_distance import (
    MAX_D, weighted_l1, weighted_l1_reference, weighted_l1_work,
)

TOL = 1e-5  # f32, another summation order over 64 terms
MERGE_TOL = 1e-6


def _inputs(seed, T, nq, ns, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((T, nq, D)).astype(np.float32)
    s = rng.standard_normal((T, ns, D)).astype(np.float32)
    w = rng.standard_normal(D).astype(np.float32)  # both signs
    return q, s, w


@pytest.mark.parametrize("nq,ns", [(33, 41), (1, 5)])
def test_plain_version_matches_the_pallas_kernel_in_interpret_mode(nq, ns):
    q, s, w = _inputs(nq + ns, 1, nq, ns, 64)
    b = -0.375
    want = pallas_weighted_l1(jnp.asarray(q[0]), jnp.asarray(s[0]), jnp.asarray(w), b,
                              block_q=16, block_s=16, rows_per_step=8, interpret=True)
    got = weighted_l1_reference(torch.from_numpy(q), torch.from_numpy(s),
                                torch.from_numpy(w), b)
    assert got.shape == (1, nq, ns) and got.dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T,P", [(7, 5), (12, 1)])
def test_batched_form_matches_jax_head_scores(T, P):
    """The n-shot form ``(T, 1, P)`` and the verification form ``(P, 1, 1)``."""
    q, s, w = _inputs(T * P, T, 1, P, 64)
    want = jdist.head_scores(jnp.asarray(q[:, 0]), jnp.asarray(s), jnp.asarray(w[:, None]),
                             0.5, "weighted_l1")
    got = weighted_l1(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(w[:, None]),
                      torch.tensor(0.5))
    assert got.shape == (T, 1, P)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _numpy_order(q, s, w, b):
    """The kernel's order in numpy f32: q and s scaled by |w_d| (one rounding
    each), the magnitude of their difference (one rounding) added with the
    sign of w_d (one rounding), in d order from 0, then + b."""
    acc = np.zeros((q.shape[0], q.shape[1], s.shape[1]), np.float32)
    for d in range(q.shape[2]):
        wa = np.abs(w[d])
        term = np.abs(q[:, :, None, d] * wa - s[:, None, :, d] * wa)
        acc = acc - term if w[d] < 0 else acc + term
    return acc + np.float32(b)


@pytest.mark.parametrize("shape", [(1, 33, 41, 64), (3, 7, 130, 17), (2, 1, 3, 5)])
def test_plain_version_sums_in_d_order_bit_for_bit(shape):
    """The order the kernel pins: a term sign(w)·|q·|w| − s·|w||, each
    product, the difference and the sum rounded, added in d order from 0,
    then + b; a numpy f32 loop in that order gives the same bits."""
    T, nq, ns, D = shape
    q, s, w = _inputs(D, T, nq, ns, D)
    assert (w < 0).any() and (w > 0).any()
    b = np.float32(0.8125)
    got = weighted_l1_reference(torch.from_numpy(q), torch.from_numpy(s),
                                torch.from_numpy(w), float(b))
    np.testing.assert_array_equal(got.numpy(), _numpy_order(q, s, w, b))


def test_plain_version_takes_zero_and_signed_zero_weights_as_no_term():
    """A zero weight (either sign) scales both operands to zero: its term is
    +0 and moves no sum; the other dims keep their order, bit for bit."""
    q, s, w = _inputs(11, 2, 3, 4, 9)
    w[[1, 4]] = 0.0
    w[6] = -0.0
    got = weighted_l1_reference(torch.from_numpy(q), torch.from_numpy(s),
                                torch.from_numpy(w), 0.25)
    np.testing.assert_array_equal(got.numpy(), _numpy_order(q, s, w, 0.25))
    keep = np.ones(9, bool)
    keep[[1, 4, 6]] = False
    want = weighted_l1_reference(torch.from_numpy(q[..., keep]), torch.from_numpy(s[..., keep]),
                                 torch.from_numpy(w[keep]), 0.25)
    assert torch.equal(got, want)


def test_plain_version_reads_w_as_it_is_at_the_call():
    """Nothing of w is kept between calls: an in-place change to w (a
    weight's sign flipped, as an optimizer step may) changes the next
    scores as the new order says."""
    q, s, w = _inputs(12, 1, 4, 5, 16)
    wt = torch.from_numpy(w.copy())
    first = weighted_l1_reference(torch.from_numpy(q), torch.from_numpy(s), wt, 0.0)
    wt[3] = -wt[3]
    wt[7] *= 2.0
    second = weighted_l1_reference(torch.from_numpy(q), torch.from_numpy(s), wt, 0.0)
    assert not torch.equal(first, second)
    np.testing.assert_array_equal(second.numpy(), _numpy_order(q, s, wt.numpy(), 0.0))


@pytest.mark.parametrize("metric", jdist.SIAMESE_METRICS)
def test_merge_features_match_jax(metric):
    rng = np.random.default_rng(5)
    e1 = rng.standard_normal((6, 16)).astype(np.float32)
    e2 = rng.standard_normal((6, 16)).astype(np.float32)
    got = tdist.merge_features(torch.from_numpy(e1), torch.from_numpy(e2), metric)
    want = np.asarray(jdist.merge_features(jnp.asarray(e1), jnp.asarray(e2), metric))
    assert got.shape == want.shape == ((6, 16) if metric == "weighted_l1" else (6, 1))
    np.testing.assert_allclose(got.numpy(), want, rtol=MERGE_TOL, atol=MERGE_TOL)


def test_merge_features_refuse_an_unknown_metric():
    with pytest.raises(ValueError):
        tdist.merge_features(torch.zeros(2, 3), torch.zeros(2, 3), "manhattan")


def test_head_scores_and_pairwise_weighted_l1_agree():
    """Both routes reach B9 (here its plain version) and give the same bits:
    the per-task scores of each query against a shared support set equal
    the rows of the pairwise score matrix."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((9, 64)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal((11, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 1)).astype(np.float32))
    b = torch.tensor(-0.25)
    pair = tdist.pairwise_weighted_l1(q, s, w, b)
    task = tdist.head_scores(q, s[None].expand(9, -1, -1), w, b, "weighted_l1")
    assert pair.shape == task.shape == (9, 11)
    assert torch.equal(pair, task)


def test_the_wrapper_counts_no_launch_on_the_cpu():
    q, s, w = (torch.from_numpy(a) for a in _inputs(7, 2, 3, 4, 8))
    before = weighted_l1.launches
    out = weighted_l1(q, s, w, 0.0)
    assert weighted_l1.launches == before
    assert torch.equal(out, weighted_l1_reference(q, s, w, 0.0))
    assert torch.equal(tdist.pairwise_weighted_l1(q[0], s[0], w, 0.0), out[0])
    assert weighted_l1.launches == before


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    ok = (torch.zeros(1, 2, 8), torch.zeros(1, 3, 8), torch.zeros(8))
    cuda_distance._check(*ok)
    with pytest.raises(ValueError, match=f"maximum D={MAX_D}"):
        cuda_distance._check(torch.zeros(1, 2, MAX_D + 1), torch.zeros(1, 3, MAX_D + 1),
                             torch.zeros(MAX_D + 1))
    cuda_distance._check(torch.zeros(1, 1, MAX_D), torch.zeros(1, 1, MAX_D), torch.zeros(MAX_D))
    for bad in ((torch.zeros(2, 8), ok[1], ok[2]),  # not (T, n, D)
                (ok[0], torch.zeros(2, 3, 8), ok[2]),  # T differs
                (ok[0], ok[1], torch.zeros(7)),  # w is not D long
                (ok[0], torch.zeros(1, 0, 8), ok[2]),  # an empty extent
                (ok[0].long(), ok[1], ok[2])):  # not floating point
        with pytest.raises(ValueError):
            cuda_distance._check(*bad)
    with pytest.raises(ValueError, match="no kernel"):
        weighted_l1(*(t.to("meta") for t in ok), 0.0)


def test_work_at_the_timing_shape_is_bound_by_operations():
    """(1, 4096, 4096, 64): 2 instructions a term; the 67 MB output and the
    inputs move in less time than the card's f32 lanes take."""
    work = weighted_l1_work(1, 4096, 4096, 64)
    assert work["terms"] == 4096 * 4096 * 64
    assert work["ops"] == 2 * work["terms"]
    assert work["bytes"] == 4 * (2 * 4096 * 64 + 64 + 1 + 4096 * 4096)
    f32_instructions_per_s, bytes_per_s = 67e12 / 2, 3.35e12
    assert work["ops"] / f32_instructions_per_s > work["bytes"] / bytes_per_s
    nshot = weighted_l1_work(500, 1, 5, 64)
    assert nshot["ops"] / f32_instructions_per_s < nshot["bytes"] / bytes_per_s


def test_the_wrapper_casts_and_copies_only_what_needs_it():
    """f32 contiguous operands go to the kernel as they are; any other dtype
    or layout is cast or copied once; a scalar f32 b on the operands' device
    is read in place, anything else becomes one."""
    t = torch.zeros(2, 3, 4)
    assert cuda_distance._f32_contiguous(t) is t
    strided = torch.arange(12.0).reshape(4, 3).t()
    got = cuda_distance._f32_contiguous(strided)
    assert got.is_contiguous() and torch.equal(got, strided)
    half = torch.ones(5, dtype=torch.bfloat16)
    assert cuda_distance._f32_contiguous(half).dtype == torch.float32
    assert cuda_distance._is_f32(torch.tensor(0.5)) and not cuda_distance._is_f32(0.5)
    assert not cuda_distance._is_f32(torch.tensor(0.5, dtype=torch.float64))
    assert cuda_distance._bias(0.5, "cpu").dtype == torch.float32
