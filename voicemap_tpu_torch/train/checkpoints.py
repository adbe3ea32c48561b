"""Checkpoints over ``torch.save``: latest and best-by-n-shot, with resume.

Port of ``voicemap_tpu/train/checkpoints.py`` (Orbax there). A checkpoint
holds the model's ``state_dict`` (parameters and BatchNorm buffers), the
optimizer's state, the step, the learning rate and the plateau schedule's
state (``restore_latest`` loads it on request; ``fit`` does not ask, and
builds a fresh schedule from the restored lr, as the reference does).
``latest/<step>.pt`` keeps the newest ``max_to_keep``; ``best/`` keeps the
one with the highest n-shot accuracy, whose value persists in
``best_metric.json`` so that a resumed run cannot overwrite it with a worse
one. Batch sampling is a function of (seed, step), so restoring the step
resumes the data stream. The state may be a classifier's or a siamese net's
(whose Dense(1) head, width 1, :meth:`CheckpointManager.head_num_classes`
does not read as a class count).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import torch

from .metrics import PlateauScheduler
from .state import TrainState


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = Path(directory).resolve()
        self.max_to_keep = max_to_keep
        for sub in ("latest", "best"):
            (self.directory / sub).mkdir(parents=True, exist_ok=True)
        self._best_metric_path = self.directory / "best_metric.json"
        self.best_metric: Optional[float] = None
        if self._best_metric_path.exists():
            try:
                self.best_metric = float(json.loads(self._best_metric_path.read_text())["metric"])
            except (ValueError, KeyError, json.JSONDecodeError):
                self.best_metric = None

    def _steps(self, which: str) -> list[int]:
        return sorted(int(p.stem) for p in (self.directory / which).glob("*.pt"))

    def _write(self, which: str, state: TrainState, plateau: Optional[PlateauScheduler],
               keep: int) -> None:
        blob = {"step": state.step, "lr": state.lr, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "plateau": plateau.state_dict() if plateau is not None else None}
        path = self.directory / which / f"{state.step}.pt"
        tmp = path.with_suffix(".tmp")
        torch.save(blob, tmp)
        os.replace(tmp, path)  # a reader never sees a half-written file
        for old in self._steps(which)[:-keep]:
            (self.directory / which / f"{old}.pt").unlink()

    def save(self, state: TrainState, plateau: Optional[PlateauScheduler] = None) -> None:
        self._write("latest", state, plateau, self.max_to_keep)

    def save_best(self, state: TrainState, metric: float,
                  plateau: Optional[PlateauScheduler] = None) -> bool:
        """Keep only the best-by-metric state (higher is better). True if saved."""
        if self.best_metric is not None and not metric > self.best_metric:
            return False
        self.best_metric = float(metric)
        self._write("best", state, plateau, 1)
        self._best_metric_path.write_text(json.dumps({"metric": float(metric),
                                                      "step": state.step}))
        return True

    def load(self, which: str = "latest") -> Optional[dict]:
        steps = self._steps(which)
        if not steps:
            return None
        return torch.load(self.directory / which / f"{steps[-1]}.pt", map_location="cpu",
                          weights_only=True)

    def restore_latest(self, state: TrainState,
                       plateau: Optional[PlateauScheduler] = None) -> Optional[TrainState]:
        """Load the newest checkpoint into ``state`` (and ``plateau``); None if there is none."""
        blob = self.load("latest")
        if blob is None:
            return None
        state.model.load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        state.step, state.lr = int(blob["step"]), float(blob["lr"])
        if plateau is not None and blob["plateau"] is not None:
            plateau.load_state_dict(blob["plateau"])
        return state

    def head_num_classes(self, which: str = "best") -> Optional[int]:
        """Width of the stored classifier head, or None when it does not
        constrain the class count (no checkpoint, no head, a Dense(1) head)."""
        blob = self.load(which)
        if blob is None or "head.weight" not in blob["model"]:
            return None
        width = int(blob["model"]["head.weight"].shape[0])
        return width if width > 1 else None
