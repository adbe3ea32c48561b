"""``voicemap_tpu_torch/ops/jax_random`` against ``jax.random`` and the JAX
package's samplers: the key stream bit for bit, the protocol's tasks and
pairs index for index."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.ops import sampling as jax_sampling
from voicemap_tpu_torch.ops import jax_random as jr
from voicemap_tpu_torch.ops import sampling

SEEDS = (0, 1, 42, 1906, 7919, 2 ** 31 - 1, -1, -123456)


def _equal(a, b):
    a = np.asarray(a)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_the_stream_is_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable
    assert jax.random.key_impl(jax.random.key(0)) == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_and_fold_in_bit_for_bit(seed):
    key, mine = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    _equal(key, mine)
    for num in (1, 2, 5, 500, 1001):
        _equal(jax.random.split(key, num), jr.split(mine, num))
    for data in (0, 1, 1013, 5 * 1009 + 10, 2 ** 32 - 1):
        _equal(jax.random.fold_in(key, data), jr.fold_in(mine, data))
    # a split of a split, and a batch of keys at once (vmap's order)
    sub = jax.random.split(key, 7)
    _equal(jax.vmap(lambda k: jax.random.split(k, 3))(sub), jr.split(jr.split(mine, 7), 3))


def test_a_seed_outside_int32_is_refused():
    with pytest.raises(ValueError):
        jr.PRNGKey(2 ** 31)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (1,), (3, 7), (40,), (2, 3, 5), (1000,)])
def test_uniform_bit_for_bit(seed, shape):
    key = jax.random.PRNGKey(seed)
    got = jr.uniform(jr.PRNGKey(seed), shape)
    _equal(jax.random.uniform(key, shape), got)
    assert (got >= 0).all() and (got < 1).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0, 40), (0, 39), (0, 1), (3, 3), (7, 2), (5, 70_000),
                                   (-100, 100), (0, 2 ** 31 - 1)])
def test_randint_bit_for_bit(seed, lo, hi):
    key = jax.random.PRNGKey(seed)
    for shape in ((4, 9), (250,)):
        _equal(jax.random.randint(key, shape, lo, hi), jr.randint(jr.PRNGKey(seed), shape, lo, hi))


def test_batched_draws_are_vmaps_draws():
    keys = jax.random.split(jax.random.PRNGKey(3), 11)
    mine = jr.split(jr.PRNGKey(3), 11)
    _equal(jax.vmap(lambda k: jax.random.uniform(k, (6,)))(keys), jr.uniform(mine, (6,)))
    _equal(jax.vmap(lambda k: jax.random.randint(k, (6,), 0, 9))(keys), jr.randint(mine, (6,), 0, 9))


def _corpus(seed, n_speakers, max_utt, min_utt):
    """speaker_utts and counts of a corpus with uneven utterance counts
    (ids numbered speaker after speaker, the rest of each row 0)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(min_utt, max_utt + 1, n_speakers).astype(np.int32)
    counts[0] = max_utt
    utts = np.zeros((n_speakers, max_utt), np.int32)
    start = 0
    for s, c in enumerate(counts):
        utts[s, :c] = np.arange(start, start + c)
        start += c
    return utts, counts


# The manifest's own settings (task seed 1906: 500 tasks at 1/5-shot and
# 5/10-way; pair seed 7919: 2,000 pairs), on even and uneven corpora.
CORPORA = {"even 40x8": (_corpus(0, 40, 8, 8)), "uneven 40x(6..60)": _corpus(1, 40, 60, 6),
           "uneven 12x(7..9)": _corpus(2, 12, 9, 7)}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("n,k", [(1, 5), (5, 5), (1, 10)])
def test_nshot_tasks_index_for_index(corpus, n, k):
    utts, counts = CORPORA[corpus]
    want = jax_sampling.sample_nshot_tasks(jax.random.PRNGKey(1906), jnp.asarray(utts),
                                           jnp.asarray(counts), 500, n, k)
    got = jr.nshot_tasks(jr.PRNGKey(1906), utts, counts, 500, n, k)
    _equal(want.query_idx, got.query_idx)
    _equal(want.support_idx, got.support_idx)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("num_pairs,same_label", [(2000, 0), (2000, 1), (7, 0)])
def test_verification_pairs_index_for_index(corpus, num_pairs, same_label):
    utts, counts = CORPORA[corpus]
    want = jax_sampling.sample_verification_batch(jax.random.PRNGKey(7919), jnp.asarray(utts),
                                                  jnp.asarray(counts), num_pairs, same_label)
    got = jr.verification_pairs(jr.PRNGKey(7919), utts, counts, num_pairs, same_label)
    for a, b in zip(want, got):
        _equal(a, b)


def test_the_samplers_take_a_key_and_move_the_indices_to_the_store():
    """``ops/sampling`` with a replayed key in the generator's place: the
    JAX samplers' indices as int32 tensors on the store's device; a torch
    generator still draws its own."""
    utts, counts = CORPORA["uneven 12x(7..9)"]
    t_utts, t_counts = torch.from_numpy(utts), torch.from_numpy(counts)
    tasks = sampling.sample_nshot_tasks(jr.PRNGKey(5), t_utts, t_counts, 50, 1, 5)
    want = jax_sampling.sample_nshot_tasks(jax.random.PRNGKey(5), jnp.asarray(utts),
                                           jnp.asarray(counts), 50, 1, 5)
    assert tasks.query_idx.dtype == torch.int32 and tasks.query_idx.device == t_utts.device
    _equal(want.support_idx, tasks.support_idx.numpy())
    pairs = sampling.sample_verification_batch(jr.PRNGKey(5), t_utts, t_counts, 64, 0)
    want = jax_sampling.sample_verification_batch(jax.random.PRNGKey(5), jnp.asarray(utts),
                                                  jnp.asarray(counts), 64, 0)
    for a, b in zip(want, pairs):
        _equal(a, b.numpy())
    gen = torch.Generator().manual_seed(5)
    drawn = sampling.sample_nshot_tasks(gen, t_utts, t_counts, 50, 1, 5)
    assert drawn.support_idx.shape == (50, 5, 1) and drawn.query_idx.dtype == torch.int32
    assert jr.is_key(jr.PRNGKey(0)) and not jr.is_key(gen) and not jr.is_key(None)


def test_the_sampler_refusals_are_the_jax_packages():
    utts, counts = CORPORA["uneven 12x(7..9)"]
    with pytest.raises(ValueError, match="exceeds the 12 available speakers"):
        jr.nshot_tasks(jr.PRNGKey(0), utts, counts, 5, 1, 13)
    with pytest.raises(ValueError, match="exceeds max utterances"):
        jr.nshot_tasks(jr.PRNGKey(0), utts, counts, 5, 9, 5)
