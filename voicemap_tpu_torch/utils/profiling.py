"""Steady-state timing on CUDA events.

Port of ``time_fn`` and ``throughput`` from ``voicemap_tpu/utils/profiling.py``.
PyTorch returns before the device finishes, so times come from CUDA events
recorded on the current stream around the calls, read after a synchronize.
Timing needs a GPU: without one these functions raise instead of timing the
CPU.
"""

from __future__ import annotations

import statistics
from typing import Callable, Dict

import torch


def _event() -> torch.cuda.Event:
    return torch.cuda.Event(enable_timing=True)


def _mean_seconds(fn: Callable, args, kw, iters: int, warmup: int) -> float:
    """Device seconds per call over ``iters`` back-to-back calls, after warm-up."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA-event timing needs a CUDA device")
    for _ in range(warmup):
        fn(*args, **kw)
    torch.cuda.synchronize()
    start, end = _event(), _event()
    start.record()
    for _ in range(iters):
        fn(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def time_fn(fn: Callable, *args, iters: int = 30, warmup: int = 5,
            **kw) -> Dict[str, float]:
    """Seconds per call of ``fn(*args, **kw)`` on the device.

    ``mean_s`` is the span of ``iters`` back-to-back calls over ``iters``;
    ``p50_s``, ``p95_s`` and ``min_s`` come from ``iters`` calls timed one at
    a time, each waited for before the next starts.
    """
    mean = _mean_seconds(fn, args, kw, iters, warmup)
    samples = []
    for _ in range(iters):
        s, e = _event(), _event()
        s.record()
        fn(*args, **kw)
        e.record()
        e.synchronize()
        samples.append(s.elapsed_time(e) / 1e3)
    samples.sort()
    return {
        "mean_s": mean,
        "p50_s": statistics.median(samples),
        "p95_s": samples[min(len(samples) - 1, int(0.95 * len(samples)))],
        "min_s": samples[0],
    }


def throughput(fn: Callable, *args, items_per_call: int, iters: int = 30,
               warmup: int = 5, **kw) -> Dict[str, float]:
    """items/s of ``fn`` over ``iters`` back-to-back calls on the device."""
    sec_per_call = _mean_seconds(fn, args, kw, iters, warmup)
    return {"items_per_sec": items_per_call / sec_per_call, "sec_per_call": sec_per_call}
