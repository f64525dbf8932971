"""Stage-span tracer: per-batch spans over the pipeline's stage seams,
exportable as Chrome-trace/Perfetto JSON.

The enable/disable seam copies ``durability.faults``'s ``NULL_INJECTOR``
pattern exactly: every instrumented component holds a ``tracer``
attribute defaulting to the module singleton ``NULL_TRACER``, whose
``span()`` returns one shared, stateless no-op context manager — the
disabled hot path costs two attribute lookups and a call, allocates
NOTHING persistent, and needs no ``if tracing:`` branches at the call
sites. Swap in a ``StageTracer`` and the same call sites emit real
spans.

Span seams (the six stage boundaries plus repartition phases):

    ingest.fetch        broker poll -> hand-off      (per worker, per poll)
    transform.dispatch  device transform dispatch    (per batch)
    load.commit         warehouse load + offset commit
    serving.fold        materialized-view delta fold (per epoch advance)
    query.batch         batched report plan execute  (per coalesced batch)
    checkpoint.step     durability journal append
    repartition.*       plan / reroute / migrate phases

Lanes: a span lands in the lane (Chrome ``tid``) named after its thread
(worker stage threads are named ``w0.ingest`` etc.), so the Perfetto
view shows one swimlane per worker stage. Export with
``tracer.export_chrome_trace(path)`` and open the file at
https://ui.perfetto.dev — see docs/OBSERVABILITY.md for a worked run.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional


class _NullSpan:
    """The shared no-op span. Stateless (``__slots__ = ()``): entering,
    exiting, annotating and dropping it all do nothing, so ONE instance
    serves every disabled call site forever — zero allocation."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def put(self, key, value) -> None:
        pass

    def drop(self) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _NullTracer:
    """Disabled tracer: ``span()``/``instant()`` are allocation-free
    no-ops (pinned by a tracemalloc test). Default for every component's
    ``tracer`` attribute — the same seam as ``NULL_INJECTOR``."""

    __slots__ = ()
    enabled = False

    def span(self, name: str, lane: Optional[str] = None) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, lane: Optional[str] = None) -> None:
        return None


NULL_TRACER = _NullTracer()


class _Span(object):
    """One live span: context manager capturing wall interval + optional
    args; appended to the tracer's event list (under its lock) on exit.
    ``drop()`` cancels recording — used to skip empty broker polls so
    idle traces stay readable."""

    __slots__ = ("_tracer", "name", "lane", "_t0", "_args", "_dropped")

    def __init__(self, tracer: "StageTracer", name: str,
                 lane: Optional[str]):
        self._tracer = tracer
        self.name = name
        self.lane = lane
        self._t0 = 0.0
        self._args: Optional[Dict[str, object]] = None
        self._dropped = False

    def put(self, key: str, value) -> None:
        """Attach one argument (shown in the Perfetto detail pane)."""
        if self._args is None:
            self._args = {}
        self._args[key] = value

    def drop(self) -> None:
        self._dropped = True

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc) -> bool:
        if not self._dropped:
            t1 = self._tracer._clock()
            self._tracer._record(
                self.name, self.lane or threading.current_thread().name,
                self._t0, t1 - self._t0, self._args)
        return False


class StageTracer:
    """Collects spans from every pipeline thread; lock guards only the
    event-list append (the measured interval is computed outside it).
    Export with ``to_chrome()`` / ``export_chrome_trace()``."""

    enabled = True

    def __init__(self, clock=time.perf_counter, max_events: int = 1 << 20):
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._events: List[tuple] = []   # (ph, name, lane, t_start, dur, args)
        self.max_events = max_events
        self.dropped_events = 0

    # ------------------------------------------------------------ write side
    def span(self, name: str, lane: Optional[str] = None) -> _Span:
        return _Span(self, name, lane)

    def instant(self, name: str, lane: Optional[str] = None) -> None:
        self._record(name, lane or threading.current_thread().name,
                     self._clock(), None, None, ph="i")

    def _record(self, name, lane, t_start, dur, args, ph="X") -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped_events += 1
                return
            self._events.append((ph, name, lane, t_start, dur, args))

    # ------------------------------------------------------------- read side
    def events(self) -> List[tuple]:
        with self._lock:
            return list(self._events)

    def span_names(self) -> List[str]:
        names: List[str] = []
        for ev in self.events():
            if ev[1] not in names:
                names.append(ev[1])
        return names

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self.dropped_events = 0

    def to_chrome(self) -> Dict[str, object]:
        """Chrome-trace JSON object (Perfetto/chrome://tracing loadable):
        complete ("X") events with microsecond timestamps relative to
        tracer start, one ``tid`` per lane plus ``thread_name`` metadata
        so lanes are labeled swimlanes."""
        events = self.events()
        lanes: Dict[str, int] = {}
        out: List[Dict[str, object]] = [
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": "dod-etl"}}]
        for ev in events:
            lane = ev[2]
            if lane not in lanes:
                lanes[lane] = len(lanes) + 1
                out.append({"name": "thread_name", "ph": "M", "pid": 1,
                            "tid": lanes[lane], "args": {"name": lane}})
        for ph, name, lane, t_start, dur, args in events:
            rec: Dict[str, object] = {
                "name": name, "cat": name.split(".", 1)[0], "ph": ph,
                "ts": round((t_start - self._t0) * 1e6, 3),
                "pid": 1, "tid": lanes[lane]}
            if ph == "X":
                rec["dur"] = round((dur or 0.0) * 1e6, 3)
            if args:
                rec["args"] = args
            elif ph == "i":
                rec["s"] = "t"
            out.append(rec)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped_events}}

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


__all__ = ["NULL_TRACER", "StageTracer"]
