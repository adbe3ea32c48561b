"""The traced window: ``torch.profiler`` over a fixed amount of work, kept in
memory and reduced to what the per-layer metrics read.

The busy time is the union of the device's operation intervals, a frozen
copy of the arithmetic of ``voicemap_tpu_torch/utils/stage_profile.py ::
profile`` (sort the intervals, merge the overlapping ones, sum); the idle
share is one less busy over the window. The window is the benchmark's own
``portbench.window`` span, on the profiler's clock.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from dataclasses import dataclass, field

import torch

SPAN_PREFIX = "portbench."  # the benchmark's own spans
WINDOW_SPAN = SPAN_PREFIX + "window"
NAME_CHARS = 120  # a kernel's name in the breakdown, cut to this many characters
TOP = 10
LOOKBACK = 5000  # host operations searched back from a gap for the one running in it
COPY = re.compile(r"^(Memcpy|Memset)", re.I)


@dataclass
class Trace:
    """What the traced window left: device operations and host operations as
    ``(name, start_us, end_us)`` within the window, the window on the
    profiler's clock, and the work the harness counted in it."""

    device: list
    host: list
    window_us: tuple
    work: dict
    config: dict
    traffic: dict
    busy: list = field(default_factory=list)  # merged device intervals

    def __post_init__(self):
        self.busy = merge([(s, e) for _, s, e in self.device])

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def idle_share(self):
        """Percent of the window in which no device operation ran."""
        if not self.device or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernels(self):
        """The device operations that are kernels (not copies or fills)."""
        return [d for d in self.device if not COPY.match(d[0])]

    def seconds_of(self, pattern: str, exclude: bool = False) -> float:
        """Summed device seconds of the operations whose name matches (or,
        with ``exclude``, does not match) ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.device if bool(rx.search(n)) != exclude) / 1e6


def merge(spans: list) -> list:
    """Sorted, non-overlapping union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


@contextlib.contextmanager
def traced(device: torch.device):
    """Profile the block (host and, on the card, device); yields a list that
    holds the profiler once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    box = []
    with profile(activities=activities) as prof:
        yield box
    box.append(prof)


def read(prof, work: dict, config: dict, traffic: dict) -> Trace:
    """The profiler's events, clipped to the ``portbench.window`` span."""
    device, host, window = [], [], None
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if on_device and (getattr(e, "is_user_annotation", False)
                          or e.name.startswith(SPAN_PREFIX)):
            continue  # a span's shadow on the device's timeline, not an operation
        if on_device:
            device.append(span)
        elif e.name == WINDOW_SPAN:
            window = span[1:]
        else:
            host.append(span)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    lo, hi = window

    def clip(spans):
        return [(n, max(s, lo), min(e, hi)) for n, s, e in spans if e > lo and s < hi]

    return Trace(clip(device), clip(host), window, work, config, traffic)


def breakdown(t: Trace) -> dict:
    """The device operations that took most time, and the longest idle gaps
    summed by the innermost host operation running at each gap's middle."""
    by_op = {}
    for n, s, e in t.device:
        key = n[:NAME_CHARS]
        by_op[key] = by_op.get(key, 0.0) + (e - s) / 1e6
    gaps, at = [], t.window_us[0]
    for s, e in t.busy + [(t.window_us[1], t.window_us[1])]:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    host = sorted(t.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    by_host = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        name = "host: outside any traced operation"
        k = bisect.bisect_right(starts, mid)
        for j in range(k - 1, max(-1, k - 1 - LOOKBACK), -1):
            if host[j][2] >= mid:  # the latest-started operation still running
                name = host[j][0][:NAME_CHARS]
                break
        by_host[name] = by_host.get(name, 0.0) + (e - s) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}
