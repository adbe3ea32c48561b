"""The kinds of work a traffic mix can ask for, one module each, found by the
``kind`` a traffic file names (``portbench/traffic/<mix>.json``).

A kind's module defines ``Job(ctx)`` with:

- ``set_up()``: build the program's state from the seed and warm every shape
  the mix uses (counted in ``setup_s``);
- ``window(seconds)``: the measured window: units of work for ``seconds``
  as the mix offers them (back to back, or at its rate), ending in a
  synchronise → the window's seconds;
- ``end_to_end(window_s)``: the end-to-end metrics it can report;
- ``work()``: what it counted since set-up (``attempted``, ``failed`` and the
  counts the per-layer metrics read);
- ``release()``: keep what the check needs and free the program's state;
- ``check()``: the numbers compared with the plain reference, by name.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Context:
    config: dict  # the configuration's file
    traffic: dict  # the mix's file
    seed: int
    device: torch.device
    variant: str  # "" for the program as it runs; see run.py's --variant


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(unit, seconds: float, device: torch.device) -> float:
    """``unit()`` back to back until ``seconds`` have passed on the host's
    clock, then a synchronise → the window's seconds, the wait for the
    device's queue included."""
    t0 = time.perf_counter()
    while True:
        unit()
        if time.perf_counter() - t0 >= seconds:
            break
    synchronize(device)
    return time.perf_counter() - t0


def free(device: torch.device) -> None:
    """Return the program's freed blocks to the card before the reference runs."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
