"""JSONL metrics writer and the plateau learning-rate schedule.

The port's own copy of ``voicemap_tpu/train/metrics.py`` (that module imports
no JAX; the port keeps a copy all the same): the metric names loss,
accuracy, ``val_{n}-shot_acc``, lr, one JSON object a logging event with
wall-clock and step fields. ``PlateauScheduler`` gains ``state_dict`` and
``load_state_dict`` so that a checkpoint brings the schedule back.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Optional


class JSONLWriter:
    def __init__(self, path: Optional[str]):
        self.path = path
        self._f: Optional[IO] = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
        self._t0 = time.time()

    def write(self, step: int, **metrics) -> dict:
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        return rec

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


class PlateauScheduler:
    """Host-side ReduceLROnPlateau equivalent.

    Reference: Keras ``ReduceLROnPlateau`` monitoring ``val_{n}-shot_acc``
    (the reference's siamese script callbacks). ``mode='max'`` semantics:
    when the monitored metric fails to improve for ``patience`` evaluations,
    multiply the lr by ``factor`` down to ``min_lr``.
    """

    def __init__(
        self,
        initial_lr: float,
        factor: float = 0.5,
        patience: int = 3,
        min_lr: float = 1e-5,
        mode: str = "max",
    ):
        self.lr = float(initial_lr)
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.mode = mode
        self.best: Optional[float] = None
        self.bad_count = 0

    def update(self, metric: float) -> float:
        improved = (
            self.best is None
            or (self.mode == "max" and metric > self.best)
            or (self.mode == "min" and metric < self.best)
        )
        if improved:
            self.best = metric
            self.bad_count = 0
        else:
            self.bad_count += 1
            # Keras ReduceLROnPlateau semantics: reduce once `patience`
            # non-improving evaluations have accumulated.
            if self.bad_count >= self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_count = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "bad_count": self.bad_count}

    def load_state_dict(self, sd: dict) -> None:
        self.lr, self.best, self.bad_count = float(sd["lr"]), sd["best"], int(sd["bad_count"])
