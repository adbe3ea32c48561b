"""Steady-state timing on CUDA events, request latency, traces and the
program's spans.

Port of ``time_fn``, ``throughput``, ``single_request_latency`` and
``trace`` from ``voicemap_tpu/utils/profiling.py``. PyTorch returns
before the device finishes, so times come from CUDA events recorded on the
current stream around the calls, read after a synchronize. Timing needs a
GPU: without one these functions raise instead of timing the CPU. The JAX
package's ``device_fetch_sync`` and ``null_fetch_rtt`` serve a remote TPU
platform on which only a value fetch waits for the device; the card has no
such transport, so they have no counterpart.

The program's spans (:func:`span`, the port's own) mark its layer
boundaries. They are on exactly while a ``torch.profiler`` records (the
CLIs' ``--profile``, the benchmark's traced window), and cost one check a
call otherwise.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

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
    try:
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    finally:
        clear_spans()  # the trace holds the spans; their records have no reader here


SPAN_PREFIX = "voicemap."  # the spans' names on the profiler's timeline
# Past this many spans whose CUDA events are unresolved, a closing span
# resolves those that have finished (a long ``--profile`` run keeps no more
# events than the device has in flight).
PENDING_EVENTS_CAP = 4096


@dataclass
class SpanRecord:
    """One span entered while a profiler recorded: its ``name``, the span
    open around it on the same thread (``parent``, ``None`` at the top),
    the work count at the boundary (``rows``), and the milliseconds between
    its edges (``ms``): on the card, two CUDA events on the current stream,
    resolved once finished; on the CPU, the host's clock."""

    name: str
    parent: Optional[str]
    rows: Optional[int]
    ms: Optional[float] = None
    events: Optional[tuple] = field(default=None, repr=False)


_records: List[SpanRecord] = []
_pending: List[SpanRecord] = []  # records whose events are not yet resolved
_open = threading.local()  # .stack: the spans open on this thread
_OFF = contextlib.nullcontext()


def _resolve(record: SpanRecord, wait: bool) -> bool:
    """Read ``record``'s events into its ``ms`` and drop them; without
    ``wait``, only if its end event has finished."""
    start, end = record.events
    if wait:
        end.synchronize()
    elif not end.query():
        return False
    record.ms, record.events = start.elapsed_time(end), None
    return True


class _Span:
    __slots__ = ("record", "annotation", "start")

    def __init__(self, name: str, rows: Optional[int]):
        self.record = SpanRecord(name, None, rows)

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.record.parent = stack[-1].name if stack else None
        stack.append(self.record)
        _records.append(self.record)
        # The events lie outside the host scope, so that its interval holds
        # the program's work and not the cost of timing it.
        if torch.cuda.is_initialized():
            # torch.Event records on the current stream from C++: half the
            # host time of torch.cuda.Event, which looks the stream up in Python
            self.start = torch.Event(enable_timing=True)
            self.start.record()
        else:
            self.start = time.perf_counter()
        # PyTorch's C++ scope: ~0.9 µs a span under a profiler with CUDA
        # activity against record_function's ~9.7 on an H100's host
        # (PERF.md), and no shadow on the device's timeline.
        self.annotation = torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + self.record.name)
        self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        self.annotation.__exit__(*exc)
        if isinstance(self.start, float):
            self.record.ms = (time.perf_counter() - self.start) * 1e3
        else:
            end = torch.Event(enable_timing=True)
            end.record()
            self.record.events = (self.start, end)
            _pending.append(self.record)
            if len(_pending) >= PENDING_EVENTS_CAP:
                _pending[:] = [r for r in _pending if r.events and not _resolve(r, wait=False)]
        _open.stack.pop()
        return False


def span(name: str, rows: Optional[int] = None):
    """A context manager around one of the program's layer boundaries.

    While a ``torch.profiler`` records, it opens a host scope named
    ``"voicemap." + name`` (the host interval, on the profiler's clock) and
    keeps a :class:`SpanRecord` (see :func:`spans`); otherwise it is one
    shared null context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, rows)


def spans() -> List[SpanRecord]:
    """The records of every span entered while a profiler recorded, in the
    order they opened; each closed span's ``ms`` resolved (on the card, this
    waits for its end event)."""
    for r in _records:
        if r.events is not None:
            _resolve(r, wait=True)
    _pending.clear()
    return list(_records)


def clear_spans() -> None:
    """Drop every span record."""
    _records.clear()
    _pending.clear()
