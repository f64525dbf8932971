"""Lock-sharded metrics registry: one read path for every pipeline signal.

The write side follows ``LatencyRecorder``'s lock-the-list-never-the-math
discipline, taken one step further: each hot-path actor (a worker stage
thread, a backend instance, a broker topic) owns a private
``MetricsShard`` and increments plain Python ints on instrument handles
it resolved ONCE — no lock, no dict lookup, no contention on the hot
path. Locks guard only instrument-table mutation (first resolution of a
name) and shard-table mutation (first resolution of a shard); reads
merge shards on demand, summing same-named counters across shards, so
``registry.counters()["worker.cache_hits"]`` is the cluster total while
``per_shard()`` still shows each worker's share.

Instruments:

* ``Counter``   — monotone int, single-writer per shard (the shard owner
                  increments; cross-thread readers see a GIL-atomic int).
* ``Gauge``     — last-write-wins level, either pushed (``set``) or
                  pulled (``gauge_fn`` registers a zero-state callback
                  evaluated at read time — queue depths, buffer
                  occupancy, routing epochs cost nothing until read).
* histograms    — bounded-reservoir ``LatencyRecorder``s (capped memory,
                  deterministic down-sampling); same-named reservoirs
                  merge their samples on read so per-worker freshness
                  recorders aggregate to one cluster percentile.

Naming convention: instrument names are globally meaningful dotted paths
(``backend.jax.op_dispatches``, ``broker.production.published``); shards
exist purely for write-side contention isolation and carry the actor's
identity (``w0``, ``backend.jax#2``).

``GLOBAL_REGISTRY`` serves process-wide singletons (compute backends);
each ``DODETLPipeline`` owns its own registry so concurrent pipelines
and tests never cross-count.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import numpy as np

if False:  # typing only — the runtime import is deferred (see _metrics)
    from repro_torch.core.metrics import LatencyRecorder


def _metrics():
    """Deferred import of ``repro.core.metrics``: ``repro.core``'s package
    init pulls in the backend module, which imports THIS module for its
    dispatch counters — a module-level import here would be circular.
    Instrument creation happens long after both modules settle."""
    from repro_torch.core import metrics
    return metrics


class Counter:
    """Monotone counter handle. Single-writer discipline: the owning
    shard's thread increments; anyone may read (int reads/writes are
    GIL-atomic, never torn)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Level instrument: either pushed via ``set`` or backed by a
    read-time callback (``fn``) so idle gauges cost nothing."""

    __slots__ = ("name", "value", "fn")

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.value = 0.0
        self.fn = fn

    def set(self, v: float) -> None:
        self.value = v

    def read(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:
                return float("nan")
        return self.value


class MetricsShard:
    """One actor's private instrument table. Resolution (``counter``,
    ``gauge`` ...) is memoized and lock-guarded; the returned handles are
    then incremented lock-free by the owning thread."""

    def __init__(self, name: str, histogram_capacity: int = 1 << 16):
        self.name = name
        self._histogram_capacity = histogram_capacity
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, "LatencyRecorder"] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def gauge_fn(self, name: str, fn: Callable[[], float]) -> Gauge:
        """Register (or retarget) a pull-mode gauge evaluated at read
        time — the hot path never touches it."""
        g = self.gauge(name)
        g.fn = fn
        return g

    def histogram(self, name: str,
                  capacity: Optional[int] = None) -> "LatencyRecorder":
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.get(name)
                if h is None:
                    h = _metrics().LatencyRecorder(
                        capacity or self._histogram_capacity)
                    self._histograms[name] = h
        return h

    def register_histogram(self, name: str,
                           recorder: "LatencyRecorder") -> "LatencyRecorder":
        """Adopt an EXISTING recorder (e.g. a worker's freshness
        ``LatencyRecorder``) so the registry read path sees it without a
        second copy of the samples."""
        with self._lock:
            self._histograms[name] = recorder
        return recorder

    # ------------------------------------------------------------- read side
    def counter_values(self) -> Dict[str, int]:
        with self._lock:
            items = list(self._counters.items())
        return {name: c.value for name, c in items}

    def gauge_values(self) -> Dict[str, float]:
        with self._lock:
            items = list(self._gauges.items())
        return {name: g.read() for name, g in items}

    def histogram_items(self) -> List:
        with self._lock:
            return list(self._histograms.items())


class MetricsRegistry:
    """Shard table + merged read path. ``shard(name)`` hands an actor its
    private write surface; the read methods merge every shard on demand
    (sum for counters, sample-union for histograms, per-shard for
    gauges)."""

    def __init__(self, histogram_capacity: int = 1 << 16):
        self._histogram_capacity = histogram_capacity
        self._lock = threading.Lock()
        self._shards: Dict[str, MetricsShard] = {}

    def shard(self, name: str) -> MetricsShard:
        s = self._shards.get(name)
        if s is None:
            with self._lock:
                s = self._shards.get(name)
                if s is None:
                    s = MetricsShard(name, self._histogram_capacity)
                    self._shards[name] = s
        return s

    def shards(self) -> List[MetricsShard]:
        with self._lock:
            return list(self._shards.values())

    # ------------------------------------------------------------- read side
    def counters(self) -> Dict[str, int]:
        """Same-named counters summed across every shard — the cluster
        totals."""
        out: Dict[str, int] = {}
        for s in self.shards():
            for name, v in s.counter_values().items():
                out[name] = out.get(name, 0) + v
        return out

    def gauges(self) -> Dict[str, Dict[str, float]]:
        """Per-shard gauge values: ``{shard: {name: value}}`` (levels do
        not sum meaningfully across actors)."""
        return {s.name: s.gauge_values() for s in self.shards()
                if s.gauge_values()}

    def histogram_percentiles(self, name: str) -> Dict[str, float]:
        """p50/p95/p99 over the union of every shard's samples for one
        histogram name (non-draining)."""
        parts = [h.merged(drain=False)
                 for s in self.shards()
                 for hname, h in s.histogram_items() if hname == name]
        parts = [p for p in parts if len(p)]
        pm = _metrics().percentiles_ms
        if not parts:
            return pm(np.zeros(0, np.float64))
        return pm(np.concatenate(parts))

    def histogram_names(self) -> List[str]:
        names: List[str] = []
        for s in self.shards():
            for hname, _ in s.histogram_items():
                if hname not in names:
                    names.append(hname)
        return names

    def per_shard(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        out: Dict[str, Dict[str, Dict[str, float]]] = {}
        for s in self.shards():
            out[s.name] = {"counters": s.counter_values(),
                           "gauges": s.gauge_values()}
        return out

    def snapshot(self) -> Dict[str, object]:
        """The one-read-path view: merged counters, per-shard gauges and
        merged histogram percentiles in a single JSON-able dict."""
        hists = {name: self.histogram_percentiles(name)
                 for name in self.histogram_names()}
        return {"counters": self.counters(), "gauges": self.gauges(),
                "histograms": hists, "per_shard": self.per_shard()}


# Process-wide registry: compute backends are process singletons, so their
# dispatch counters live here; per-pipeline signals live on the pipeline's
# own registry.
GLOBAL_REGISTRY = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return GLOBAL_REGISTRY


__all__ = ["Counter", "Gauge", "MetricsShard", "MetricsRegistry",
           "GLOBAL_REGISTRY", "global_registry"]
