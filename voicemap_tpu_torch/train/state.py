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
  eps 1e-8 (added to √v̂, eps_root 0), which is optax's update; its
  ``weight_decay`` (default 0, the JAX package's configs) adds the L2 term
  ``wd·θ`` to the clipped gradient, as ``torch.optim.Adam`` does (ECAPA-TDNN's
  recipe);
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

    def __init__(self, params: Iterable[torch.nn.Parameter], clipnorm: float = 1.0,
                 weight_decay: float = 0.0):
        self.params = [p for p in params if p.requires_grad]
        self.clipnorm = float(clipnorm)
        self.adam = torch.optim.Adam(self.params, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=float(weight_decay))

    @torch.no_grad()
    def clip(self) -> torch.Tensor:
        """Clip the gradients in place; returns their global norm before.
        Each gradient becomes ``(g / d) · c``: ``d`` the norm and ``c`` the
        clip norm where the norm reaches it, else 1 and 1 (``g`` exactly).
        Foreach kernels, a few launches for any number of leaves: a loop of
        three launches a leaf set the pace of a step whose leaves are many
        (ECAPA-TDNN's 139) and left the card idle while the host launched them."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)).float())
        keep = norm < self.clipnorm
        torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(keep, 1.0, self.clipnorm))
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


def make_optimizer(params: Iterable[torch.nn.Parameter], clipnorm: float = 1.0,
                   weight_decay: float = 0.0) -> ClippedAdam:
    return ClippedAdam(params, clipnorm, weight_decay)


def init_state(model: torch.nn.Module, clipnorm: float, learning_rate: float,
               weight_decay: float = 0.0) -> TrainState:
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model.parameters(), clipnorm, weight_decay),
                      lr=float(learning_rate))


def apply_updates(state: TrainState) -> TrainState:
    """Clip the model's gradients, take one Adam step at ``state.lr``, count it."""
    state.optimizer.step(state.lr)
    state.step += 1
    return state
