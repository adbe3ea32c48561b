"""Faults planted in the program under test, to show that the comparison that
decides ``correct`` catches them (``run.py --variant``; the benchmark's own
runs plant none).

- ``frozen_state``: a train step that returns its state unchanged (no
  update is applied);
- ``half_batch``: a train step that leaves out half of its batch and takes
  the mean over the rest;
- ``altered_answer``: an answer altered where it is produced: the first
  embedding of every batch negated, and every predicted class moved to the
  next.
"""

from __future__ import annotations

from voicemap_tpu_torch.eval import nshot
from voicemap_tpu_torch.train import steps

FAULTS = ("frozen_state", "half_batch", "altered_answer")


def plant(fault: str) -> None:
    if fault == "frozen_state":
        steps.apply_updates = lambda state: state
    elif fault == "half_batch":
        train_on_batch = steps.train_on_batch

        def half(state, x, y, *args, **kw):
            n = x.shape[0] // 2
            return train_on_batch(state, x[:n], y[:n], *args, **kw)

        steps.train_on_batch = half
    elif fault == "altered_answer":
        fast_embed, predictions = nshot.fast_embed, nshot.classifier_nshot_predictions

        def negated(encoder, x):
            out = fast_embed(encoder, x).clone()
            out[0] = -out[0]
            return out

        def moved(table, query_idx, support_idx):
            return (predictions(table, query_idx, support_idx) + 1) % support_idx.shape[1]

        nshot.fast_embed = negated
        nshot.classifier_nshot_predictions = moved
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
