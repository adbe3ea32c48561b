"""Batch and n-shot task samplers.

Port of ``voicemap_tpu/ops/sampling.py :: sample_classifier_batch`` and
``sample_nshot_tasks`` on an explicit ``torch.Generator``. The task sampler
keeps the reference's invariants: k distinct speakers a task, n distinct
support utterances each, one more distinct query utterance of class 0, the
true class. A torch generator cannot replay the JAX package's threefry
stream, so the same seed draws other batches and tasks there.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def sample_classifier_batch(generator: Optional[torch.Generator], num_utterances: int,
                            batch_size: int, device=None) -> torch.Tensor:
    """``batch_size`` uniform utterance ids in ``[0, num_utterances)``, int64,
    drawn on the generator's device and moved to ``device``."""
    gdev = generator.device if generator is not None else device
    idx = torch.randint(0, num_utterances, (batch_size,), generator=generator, device=gdev)
    return idx.to(device) if device is not None else idx


class NShotTasks(NamedTuple):
    query_idx: torch.Tensor  # (tasks,) utterance ids
    support_idx: torch.Tensor  # (tasks, k, n) utterance ids; true class is 0


def sample_nshot_tasks(generator: Optional[torch.Generator],
                       speaker_utts: torch.Tensor, counts: torch.Tensor,
                       num_tasks: int, n: int, k: int) -> NShotTasks:
    """A batch of n-shot k-way tasks; every speaker needs ≥ n+1 utterances.

    Speakers and slots are the top of a random ordering (an argsort of
    uniform scores), so they are distinct without rejection.
    """
    S, max_utt = speaker_utts.shape
    if k > S:
        raise ValueError(f"k={k} exceeds the {S} available speakers")
    if n + 1 > max_utt:
        raise ValueError(f"n+1={n + 1} exceeds max utterances/speaker ({max_utt})")
    dev = speaker_utts.device
    gdev = generator.device if generator is not None else dev

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
