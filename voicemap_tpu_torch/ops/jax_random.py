"""JAX's default PRNG key stream, replayed in numpy on the host.

The frozen eval protocol (``EVAL_PROTOCOL.json``) pins its n-shot tasks to
``jax.random.PRNGKey(task_seed)`` drawn as
``voicemap_tpu/ops/sampling.py :: sample_nshot_tasks`` draws them, and its
verification pairs to ``PRNGKey(pair_seed)`` drawn as
``sample_verification_batch`` draws them. A torch generator cannot replay
that stream; this module does, bit for bit, without JAX, so that the port's
protocol scores the very tasks and pairs the JAX package scores.

What it replays is jax 0.9's default implementation: threefry2x32 under
``jax_threefry_partitionable = True`` (the default since jax 0.5). There a
draw of ``shape`` hashes the flat iota of ``shape`` split into a high and a
low 32-bit word, and 32 random bits are the two output words XORed; a split
into ``num`` keys hashes ``(0, i)`` for i < num and keeps both words.
A JAX running the non-partitionable scheme draws other tasks; the protocol's
records name the stream they used (``KEY_STREAM``).

A key is a ``uint32`` array whose last axis holds the two words (``(2,)``
for one key, as ``jax.random.PRNGKey`` returns it raw). Every function takes
keys with any leading shape and draws for all of them at once, as ``vmap``
would: the samplers at the end draw all tasks of a batch in one pass.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

KEY_STREAM = "threefry2x32-partitionable (numpy replay)"

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _u32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.uint32)


def threefry2x32(k1, k2, x1, x2) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the counter pairs ``(x1, x2)`` under the
    key ``(k1, k2)`` (20 rounds, the key injected every 4); all four
    broadcast together; uint32 arithmetic wraps."""
    k1, k2, x0, x1 = _u32(k1), _u32(k2), _u32(x1), _u32(x2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 = x0 ^ x1
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return _u32(x0), _u32(x1)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as its raw ``(2,)`` uint32 words, for a
    seed in int32's range (JAX without x64 takes the seed as an int32: the
    high word is 0 and the low word is the seed's two's complement)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside int32's range")
    return np.array([0, seed & 0xFFFFFFFF], dtype=np.uint32)


def _hash(keys: np.ndarray, shape: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """Both output words of the hash of the flat iota of ``shape`` (high and
    low counter words) under every key: ``(*keys.shape[:-1], *shape)``."""
    keys = _u32(keys)
    n = int(np.prod(shape, dtype=np.int64))
    iota = np.arange(n, dtype=np.uint64)
    hi, lo = _u32(iota >> np.uint64(32)), _u32(iota & np.uint64(0xFFFFFFFF))
    lead = keys.shape[:-1]
    k1 = keys[..., 0].reshape(lead + (1,))
    k2 = keys[..., 1].reshape(lead + (1,))
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1.reshape(lead + tuple(shape)), b2.reshape(lead + tuple(shape))


def split(keys: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` for every key: ``(..., num, 2)``."""
    b1, b2 = _hash(keys, (int(num),))
    return np.stack([b1, b2], axis=-1)


def fold_in(keys: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the counter
    ``(0, uint32(data))`` under the key, both words kept."""
    keys = _u32(keys)
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], 0, int(data) & 0xFFFFFFFF)
    return np.stack([b1, b2], axis=-1)


def random_bits(keys: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """32 random bits an element, ``(..., *shape)`` uint32: the two words XORed."""
    b1, b2 = _hash(keys, tuple(shape))
    return b1 ^ b2


def uniform(keys: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in float32, [0, 1): the top 23 bits
    as the mantissa of a float in [1, 2), minus 1."""
    bits = (random_bits(keys, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return np.maximum(np.float32(0.0), bits.view(np.float32) - np.float32(1.0))


def randint(keys: np.ndarray, shape: Tuple[int, ...], minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` in int32: two
    draws of 32 bits (from a split of the key) reduced modulo the span as
    JAX reduces them, in wrapping uint32 arithmetic."""
    k = split(keys, 2)
    higher, lower = random_bits(k[..., 0, :], shape), random_bits(k[..., 1, :], shape)
    lo, hi = int(minval), int(maxval)
    span = np.uint32(hi - lo if hi > lo else 1)
    with np.errstate(over="ignore"):
        mult = np.uint32(2 ** 16) % span
        mult = _u32(mult * mult) % span
        offset = _u32(higher % span * mult + lower % span) % span
    return (np.int64(lo) + offset.astype(np.int64)).astype(np.int32)


def _randint_scaled(keys: np.ndarray, maxval: np.ndarray) -> np.ndarray:
    """``voicemap_tpu/ops/sampling.py :: _randint``: a uniform draw of
    ``maxval``'s shape times ``maxval`` in float32, truncated, capped at
    ``maxval − 1``."""
    maxval = np.asarray(maxval, np.int32)
    u = uniform(keys, maxval.shape)
    return np.minimum((u * maxval.astype(np.float32)).astype(np.int32), maxval - 1)


class NShotTasks(NamedTuple):
    query_idx: np.ndarray  # (tasks,) utterance ids
    support_idx: np.ndarray  # (tasks, k, n) utterance ids; true class is 0


def nshot_tasks(key: np.ndarray, speaker_utts, counts, num_tasks: int, n: int,
                k: int) -> NShotTasks:
    """``sample_nshot_tasks(key, speaker_utts, counts, num_tasks, n, k)``
    index for index: one key a task from ``split(key, num_tasks)``; a task's
    key splits into the speakers' key (a stable argsort of S uniforms, the
    first k) and the utterances' key, which splits into k + 1: class 0 takes
    the first (n + 1 slots: the query, then its n supports), class c ≥ 1 the
    (c + 1)-th (n slots); the slots are a stable argsort of max_utt uniforms
    with the slots past the speaker's count set to inf."""
    speaker_utts = np.asarray(speaker_utts)
    counts = np.asarray(counts)
    S, max_utt = speaker_utts.shape
    if k > S:
        raise ValueError(f"k={k} exceeds the {S} available speakers")
    if n + 1 > max_utt:
        raise ValueError(f"n+1={n + 1} exceeds max utterances/speaker ({max_utt})")
    task_keys = split(split(key, num_tasks), 2)  # (tasks, 2, 2)
    speakers = np.argsort(uniform(task_keys[:, 0], (S,)), axis=-1, kind="stable")[:, :k]
    ukeys = split(task_keys[:, 1], k + 1)  # (tasks, k + 1, 2); ukeys[:, 1] goes unused
    class_keys = np.concatenate([ukeys[:, :1], ukeys[:, 2:]], axis=1)  # (tasks, k, 2)
    scores = uniform(class_keys, (max_utt,))  # (tasks, k, max_utt)
    valid = np.arange(max_utt) < counts[speakers][..., None]
    scores = np.where(valid, scores, np.float32(np.inf))
    slots = np.argsort(scores, axis=-1, kind="stable")[..., : n + 1]
    utts = speaker_utts[speakers[..., None], slots]  # (tasks, k, n + 1)
    query = utts[:, 0, 0]
    support = np.concatenate([utts[:, :1, 1:], utts[:, 1:, :n]], axis=1)
    return NShotTasks(query, support)


class VerificationPairs(NamedTuple):
    idx_1: np.ndarray  # (P,) utterance ids
    idx_2: np.ndarray  # (P,)
    labels: np.ndarray  # (P,) float32: same_label for the alike half


def verification_pairs(key: np.ndarray, speaker_utts, counts, num_pairs: int,
                       same_label: int = 0) -> VerificationPairs:
    """``sample_verification_batch(key, speaker_utts, counts, num_pairs,
    same_label)`` index for index: ``split(key, 5)`` gives the alike
    speakers (``randint``), their two distinct utterances (a split: slot a,
    then a shift below count − 1), the differing speakers (a split: s1, then
    a shift below S − 1) and each one's utterance."""
    speaker_utts = np.asarray(speaker_utts)
    counts = np.asarray(counts)
    S = speaker_utts.shape[0]
    half = num_pairs // 2
    rest = num_pairs - half
    k_alike_s, k_alike_u, k_diff_s, k_diff_u1, k_diff_u2 = split(key, 5)

    alike = randint(k_alike_s, (half,), 0, S)
    ka1, ka2 = split(k_alike_u, 2)
    c = counts[alike]
    a = _randint_scaled(ka1, c)
    b = (a + 1 + _randint_scaled(ka2, c - 1)) % c

    kd1, kd2 = split(k_diff_s, 2)
    s1 = randint(kd1, (rest,), 0, S)
    s2 = (s1 + 1 + randint(kd2, (rest,), 0, S - 1)) % S
    d1 = speaker_utts[s1, _randint_scaled(k_diff_u1, counts[s1])]
    d2 = speaker_utts[s2, _randint_scaled(k_diff_u2, counts[s2])]

    idx_1 = np.concatenate([speaker_utts[alike, a], d1])
    idx_2 = np.concatenate([speaker_utts[alike, b], d2])
    labels = np.concatenate([np.full(half, same_label, np.float32),
                             np.full(rest, 1 - same_label, np.float32)])
    return VerificationPairs(idx_1, idx_2, labels)


def is_key(rng) -> bool:
    """Whether ``rng`` is a replayed key (a uint32 array of 2 words), as
    opposed to a ``torch.Generator``."""
    return isinstance(rng, np.ndarray) and rng.dtype == np.uint32 and rng.shape[-1:] == (2,)
