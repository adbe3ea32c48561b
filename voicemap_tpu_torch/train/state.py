"""Train state and optimizer.

Port of ``voicemap_tpu/train/state.py``. The JAX package chains optax's
``clip_by_global_norm(clipnorm) → scale_by_adam() → scale by −lr``, with the
learning rate a runtime value that the plateau schedule anneals. Here:

- the clip is optax's form, written out: when the global norm ``n`` of all
  gradients is at least ``clipnorm``, each gradient becomes
  ``(g / n) · clipnorm``, else it is left as it is
  (``torch.nn.utils.clip_grad_norm_`` differs: it always scales, by
  ``clipnorm / (n + 1e-6)``);
- Adam is ``torch.optim.Adam`` with optax's defaults, b1 0.9, b2 0.999,
  eps 1e-8 (added to √v̂, eps_root 0), which is optax's update;
- :func:`apply_updates` sets the param group's ``lr`` from ``state.lr``
  before each update.

The state holds the model (parameters and BatchNorm buffers), the optimizer,
the step count and the learning rate; it is updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import torch


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: "ClippedAdam"
    lr: float  # current learning rate (annealed on plateau)


class ClippedAdam:
    """Clip by global norm (optax's form), then Adam."""

    def __init__(self, params: Iterable[torch.nn.Parameter], clipnorm: float = 1.0):
        self.params = [p for p in params if p.requires_grad]
        self.clipnorm = float(clipnorm)
        self.adam = torch.optim.Adam(self.params, lr=1.0, betas=(0.9, 0.999), eps=1e-8)

    @torch.no_grad()
    def clip(self) -> torch.Tensor:
        """Clip the gradients in place; returns their global norm before."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        keep = norm < self.clipnorm
        for g in grads:
            g.copy_(torch.where(keep, g, (g / norm) * self.clipnorm))
        return norm

    def step(self, lr: float) -> None:
        self.clip()
        for group in self.adam.param_groups:
            group["lr"] = float(lr)
        self.adam.step()

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, sd: dict) -> None:
        self.adam.load_state_dict(sd)


def make_optimizer(params: Iterable[torch.nn.Parameter], clipnorm: float = 1.0) -> ClippedAdam:
    return ClippedAdam(params, clipnorm)


def init_state(model: torch.nn.Module, clipnorm: float, learning_rate: float) -> TrainState:
    return TrainState(step=0, model=model, optimizer=make_optimizer(model.parameters(), clipnorm),
                      lr=float(learning_rate))


def apply_updates(state: TrainState) -> TrainState:
    """Clip the model's gradients, take one Adam step at ``state.lr``, count it."""
    state.optimizer.step(state.lr)
    state.step += 1
    return state
