"""n-shot task sampler.

Port of ``voicemap_tpu/ops/sampling.py :: sample_nshot_tasks`` on an explicit
``torch.Generator``. It keeps the reference's invariants: k distinct speakers
a task, n distinct support utterances each, one more distinct query utterance
of class 0, the true class. A torch generator cannot replay the JAX package's
threefry stream, so the same seed draws other tasks there.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


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
