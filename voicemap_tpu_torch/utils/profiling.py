"""Steady-state timing on CUDA events, request latency, traces, step times.

Port of ``time_fn``, ``throughput``, ``single_request_latency``, ``trace``
and ``StepTimer`` from ``voicemap_tpu/utils/profiling.py``. PyTorch returns
before the device finishes, so times come from CUDA events recorded on the
current stream around the calls, read after a synchronize. Timing needs a
GPU: without one these functions raise instead of timing the CPU. The JAX
package's ``device_fetch_sync`` and ``null_fetch_rtt`` serve a remote TPU
platform on which only a value fetch waits for the device; the card has no
such transport, so they have no counterpart.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, Dict, Optional

import torch


# A queued timing holds the stream this long a call (at ~2 GHz) before its
# start event, longer than the host takes to enqueue one.
HOLD_CYCLES_PER_CALL = 400_000


def _event() -> torch.cuda.Event:
    return torch.cuda.Event(enable_timing=True)


def _mean_seconds(fn: Callable, args, kw, iters: int, warmup: int,
                  queued: bool = False) -> float:
    """Device seconds per call over ``iters`` back-to-back calls, after warm-up.

    ``queued``: the stream first sleeps while the host enqueues every call,
    so that the span is the device's alone even for calls shorter than their
    host overhead (without it such calls time the host)."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA-event timing needs a CUDA device")
    for _ in range(warmup):
        fn(*args, **kw)
    torch.cuda.synchronize()
    start, end = _event(), _event()
    if queued:
        torch.cuda._sleep(HOLD_CYCLES_PER_CALL * iters)
    start.record()
    for _ in range(iters):
        fn(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def time_fn(fn: Callable, *args, iters: int = 30, warmup: int = 5, queued: bool = False,
            **kw) -> Dict[str, float]:
    """Seconds per call of ``fn(*args, **kw)`` on the device.

    ``mean_s`` is the span of ``iters`` back-to-back calls over ``iters``
    (with ``queued``, all enqueued before the first starts: see
    ``_mean_seconds``);
    ``p50_s``, ``p95_s`` and ``min_s`` come from ``iters`` calls timed one at
    a time, each waited for before the next starts.
    """
    mean = _mean_seconds(fn, args, kw, iters, warmup, queued)
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


def _first_tensor(out) -> torch.Tensor:
    """The first tensor of ``out`` (a tensor, or nested tuples, lists or dicts
    of them)."""
    while not isinstance(out, torch.Tensor):
        out = next(iter(out.values() if isinstance(out, dict) else out))
    return out


def _percentiles(ts: list, prefix: str = "") -> Dict[str, float]:
    ts = sorted(ts)
    return {f"{prefix}p50_s": statistics.median(ts),
            f"{prefix}p95_s": ts[min(len(ts) - 1, int(0.95 * len(ts)))],
            f"{prefix}min_s": ts[0], f"{prefix}mean_s": sum(ts) / len(ts)}


def single_request_latency(fn: Callable, *args, samples: int = 20, warmup: int = 3,
                           **kw) -> Dict[str, float]:
    """What a client waits for one request: each sample, on the host's clock,
    from the call to its result in host memory (the first tensor of the
    output copied to the host, which waits for the device), one request at a
    time; ``p50_s``, ``p95_s``, ``min_s``, ``mean_s``. Beside them
    ``device_*``: the device's span of the same calls on CUDA events."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA-event timing needs a CUDA device")
    for _ in range(warmup + 1):
        _first_tensor(fn(*args, **kw)).cpu()
    host, device = [], []
    for _ in range(samples):
        s, e = _event(), _event()
        t0 = time.perf_counter()
        s.record()
        out = fn(*args, **kw)
        e.record()
        _first_tensor(out).cpu()
        host.append(time.perf_counter() - t0)
        e.synchronize()
        device.append(s.elapsed_time(e) / 1e3)
    return {**_percentiles(host), **_percentiles(device, "device_")}


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """``torch.profiler`` over the block (the host's ops and, with a card,
    its kernels), written as a Chrome trace to ``<logdir>/trace.json``; a
    no-op for ``logdir=None``."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Rolling step times of a train loop on the host's clock: ``tick()``
    once a step, ``stats()`` over the last ``window`` intervals."""

    def __init__(self, window: int = 100):
        self.window = window
        self.samples: list = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.samples.append(now - self._last)
            if len(self.samples) > self.window:
                self.samples.pop(0)
        self._last = now

    def stats(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        return {
            "step_p50_s": statistics.median(s),
            "step_p95_s": s[min(len(s) - 1, int(0.95 * len(s)))],
            "steps_per_sec": 1.0 / (sum(s) / len(s)),
        }
