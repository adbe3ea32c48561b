"""Batch, pair and n-shot task samplers.

Port of ``voicemap_tpu/ops/sampling.py :: sample_classifier_batch``,
``sample_verification_batch`` (with ``sample_distinct_speakers``,
``_pick_utterance`` and ``_pick_two_distinct``) and ``sample_nshot_tasks``
on an explicit ``torch.Generator``. They keep the reference's invariants:
an alike pair is one speaker and two distinct utterances, a differing pair
two distinct speakers; a task has k distinct speakers, n distinct support
utterances each and one more distinct query utterance of class 0, the true
class. A torch generator cannot replay the JAX package's threefry stream, so
the same seed draws other batches, pairs and tasks there; ``fit`` draws so.

``sample_verification_batch`` and ``sample_nshot_tasks`` also take, in the
generator's place, a key of ``ops/jax_random`` (``jax_random.PRNGKey(seed)``):
they then draw on the host through its replay of the JAX stream, index for
index the JAX samplers' pairs and tasks (what the frozen eval protocol pins),
and move the indices to the store's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from . import jax_random

# A torch generator (or None: torch's default one), or a replayed JAX key.
Rng = Union[Optional[torch.Generator], np.ndarray]


def _draw_device(generator: Optional[torch.Generator], device):
    return generator.device if generator is not None else device


def _randint(generator: Optional[torch.Generator], maxval: torch.Tensor) -> torch.Tensor:
    """Uniform ints in ``[0, maxval)``, one for each element of ``maxval``."""
    u = torch.rand(maxval.shape, generator=generator,
                   device=_draw_device(generator, maxval.device)).to(maxval.device)
    return torch.minimum((u * maxval.float()).long(), maxval.long() - 1)


def sample_distinct_speakers(generator: Optional[torch.Generator], num_speakers: int,
                             shape: Tuple[int, ...], device=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairs of distinct speaker ids: ``s2 = (s1 + 1 + r) mod S``, r < S − 1."""
    if num_speakers < 2:
        raise ValueError(f"distinct speakers need at least 2, got {num_speakers}")
    gdev = _draw_device(generator, device)
    s1 = torch.randint(0, num_speakers, shape, generator=generator, device=gdev)
    shift = torch.randint(0, num_speakers - 1, shape, generator=generator, device=gdev)
    s2 = (s1 + 1 + shift) % num_speakers
    return (s1.to(device), s2.to(device)) if device is not None else (s1, s2)


def _pick_utterance(generator: Optional[torch.Generator], speaker_utts: torch.Tensor,
                    counts: torch.Tensor, speakers: torch.Tensor) -> torch.Tensor:
    """One uniform utterance id for each speaker in ``speakers`` (any shape)."""
    slot = _randint(generator, counts[speakers])
    return speaker_utts[speakers, slot]


def _pick_two_distinct(generator: Optional[torch.Generator], speaker_utts: torch.Tensor,
                       counts: torch.Tensor, speakers: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two distinct utterance ids for each speaker (every count ≥ 2)."""
    c = counts[speakers]
    a = _randint(generator, c)
    b = (a + 1 + _randint(generator, c - 1)) % c
    return speaker_utts[speakers, a], speaker_utts[speakers, b]


class VerificationBatch(NamedTuple):
    idx_1: torch.Tensor  # (B,) utterance ids
    idx_2: torch.Tensor  # (B,)
    labels: torch.Tensor  # (B,) float32: same_label for alike pairs


def _on_host(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy()


def sample_verification_batch(generator: Rng, speaker_utts: torch.Tensor,
                              counts: torch.Tensor, batch_size: int,
                              same_label: int = 0) -> VerificationBatch:
    """``batch_size // 2`` alike pairs, then the rest differing, labelled
    ``same_label`` and ``1 − same_label`` in f32. Every speaker needs ≥ 2
    utterances and there must be ≥ 2 speakers. ``generator`` may be a
    ``jax_random`` key (the JAX sampler's pairs)."""
    S = speaker_utts.shape[0]
    dev = speaker_utts.device
    if jax_random.is_key(generator):
        pairs = jax_random.verification_pairs(generator, _on_host(speaker_utts),
                                              _on_host(counts), batch_size, same_label)
        return VerificationBatch(*(torch.from_numpy(a).to(dev) for a in pairs))
    half = batch_size // 2
    gdev = _draw_device(generator, dev)
    alike = torch.randint(0, S, (half,), generator=generator, device=gdev).to(dev)
    a1, a2 = _pick_two_distinct(generator, speaker_utts, counts, alike)
    d_s1, d_s2 = sample_distinct_speakers(generator, S, (batch_size - half,), dev)
    d1 = _pick_utterance(generator, speaker_utts, counts, d_s1)
    d2 = _pick_utterance(generator, speaker_utts, counts, d_s2)
    labels = torch.cat([torch.full((half,), float(same_label), device=dev),
                        torch.full((batch_size - half,), float(1 - same_label), device=dev)])
    return VerificationBatch(torch.cat([a1, d1]), torch.cat([a2, d2]), labels)


def sample_classifier_batch(generator: Optional[torch.Generator], num_utterances: int,
                            batch_size: int, device=None) -> torch.Tensor:
    """``batch_size`` uniform utterance ids in ``[0, num_utterances)``, int64,
    drawn on the generator's device and moved to ``device``."""
    idx = torch.randint(0, num_utterances, (batch_size,), generator=generator,
                        device=_draw_device(generator, device))
    return idx.to(device) if device is not None else idx


class NShotTasks(NamedTuple):
    query_idx: torch.Tensor  # (tasks,) utterance ids
    support_idx: torch.Tensor  # (tasks, k, n) utterance ids; true class is 0


def sample_nshot_tasks(generator: Rng, speaker_utts: torch.Tensor, counts: torch.Tensor,
                       num_tasks: int, n: int, k: int) -> NShotTasks:
    """A batch of n-shot k-way tasks; every speaker needs ≥ n+1 utterances.

    Speakers and slots are the top of a random ordering (an argsort of
    uniform scores), so they are distinct without rejection. ``generator``
    may be a ``jax_random`` key (the JAX sampler's tasks).
    """
    S, max_utt = speaker_utts.shape
    if k > S:
        raise ValueError(f"k={k} exceeds the {S} available speakers")
    if n + 1 > max_utt:
        raise ValueError(f"n+1={n + 1} exceeds max utterances/speaker ({max_utt})")
    dev = speaker_utts.device
    if jax_random.is_key(generator):
        tasks = jax_random.nshot_tasks(generator, _on_host(speaker_utts), _on_host(counts),
                                       num_tasks, n, k)
        return NShotTasks(*(torch.from_numpy(a).to(dev) for a in tasks))
    gdev = _draw_device(generator, dev)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=gdev).to(dev)

    speakers = uniform(num_tasks, S).argsort(dim=1)[:, :k]  # (tasks, k)
    scores = uniform(num_tasks, k, max_utt)
    valid = torch.arange(max_utt, device=dev) < counts[speakers][..., None]
    scores = torch.where(valid, scores, torch.inf)
    slots = scores.argsort(dim=-1)[..., : n + 1]  # (tasks, k, n+1) distinct
    utts = speaker_utts[speakers[..., None], slots]
    query = utts[:, 0, 0]
    support = torch.cat([utts[:, :1, 1:], utts[:, 1:, :n]], dim=1)
    return NShotTasks(query, support)
