"""The device trace of a traced window, reduced to plain intervals.

``capture`` runs a window under ``torch.profiler`` (CPU and CUDA
activities) inside a range named ``WINDOW``; ``extract`` reads the raw
profiler events once into a ``Trace``: the device operations (kernels,
copies, memsets) as (name, start, end) in microseconds, the device-side
span of each named ``record_function`` range, the host's operations on
every thread (autograd's backward runs on a thread of its own), and
the window's own interval. The
readers under ``portbench/metrics`` take everything else from a
``Trace``; ``busy``, ``within``, ``top_ops`` and ``idle_gaps`` are the
interval arithmetic they share (the union of intervals over all streams,
as the busy share has always been taken here).
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

WINDOW = "portbench.window"

Interval = Tuple[float, float]


@dataclasses.dataclass
class Trace:
    ops: List[Tuple[str, float, float]]            # device operations
    ranges: Dict[str, List[Interval]]              # device side of ranges
    host: List[Tuple[str, float, float]]           # host ops, all threads
    window: Interval

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[Interval] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def clip(intervals: Iterable[Interval], window: Interval) -> List[Interval]:
    lo, hi = window
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def length(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in intervals)


def busy(t: Trace) -> List[Interval]:
    """The union of every device operation's interval inside the window."""
    return union(clip(((a, b) for _, a, b in t.ops), t.window))


def within(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """The length of the intersection of two unions of intervals."""
    a, b = union(a), union(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def top_ops(t: Trace, n: int = 10) -> List[Tuple[str, float]]:
    """The ``n`` device operations (by name) with the most time in the
    window, in seconds."""
    per: Dict[str, float] = {}
    for name, a, b in t.ops:
        for lo, hi in clip([(a, b)], t.window):
            per[name] = per.get(name, 0.0) + hi - lo
    return [(k, v / 1e6) for k, v in
            sorted(per.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(t: Trace, n: int = 10) -> List[Tuple[str, float]]:
    """The device's idle time in the window, summed by what the host was
    doing at the middle of each gap (the host operation, on any thread,
    that started last before it and was still running), the ``n``
    largest, in seconds."""
    gaps, at = [], t.window[0]
    for lo, hi in busy(t) + [(t.window[1], t.window[1])]:
        if lo > at:
            gaps.append((at, lo))
        at = max(at, hi)
    host = sorted(t.host, key=lambda e: e[1])
    starts = [e[1] for e in host]
    per: Dict[str, float] = {}
    for lo, hi in gaps:
        mid = (lo + hi) / 2
        name = "host: between operations"
        for k in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 4000), -1):
            if host[k][2] >= mid:
                name = host[k][0]
                break
        per[name] = per.get(name, 0.0) + hi - lo
    return [(k, v / 1e6) for k, v in
            sorted(per.items(), key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def capture(box: list):
    """Profile the body inside a ``WINDOW`` range; appends the ``Trace``
    to ``box`` when the body ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield
        torch.cuda.synchronize()
    box.append(extract(prof))


def extract(prof) -> Trace:
    """The profiler's raw events: a ``record_function`` range is a user
    annotation, on the host and again on the device, where it spans the
    operations launched inside it."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ops, ranges, host, window = [], {}, [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns() / 1e3
        span = (start, start + e.duration_ns() / 1e3)
        on_device = e.device_type() == cuda
        if e.is_user_annotation():
            if on_device:
                ranges.setdefault(name, []).append(span)
            elif name == WINDOW:
                window = span
        elif on_device:
            ops.append((name, *span))
        else:
            host.append((name, *span))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW} range")
    return Trace(ops, ranges, host, window)
