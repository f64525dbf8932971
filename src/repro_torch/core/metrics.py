"""Shared latency instrumentation: thread-safe sample recording and the
percentile summary used by both the write path (end-to-end load freshness,
``repro.runtime.cluster``) and the read path (report staleness,
``repro.serving.engine``). One definition so the two metrics stay
comparable — the serving layer's staleness is measured on the same clock
and aggregated by the same estimator as the pipeline's freshness.

``LatencyRecorder`` is a BOUNDED reservoir: under sustained load an
undrained recorder no longer grows without limit. Up to ``capacity``
samples are kept verbatim (the non-overflow path is byte-identical to
the old concatenate-everything behavior); past that, the reservoir
down-samples DETERMINISTICALLY — it keeps every ``stride``-th sample of
the arrival sequence, doubling the stride each time the store would
overflow — so two identical runs summarize identical sample subsets (no
RNG), the kept subset stays uniformly spread over the whole recording
window, and memory is O(capacity) forever.
"""
from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np


def percentiles_ms(samples: np.ndarray) -> Dict[str, float]:
    """p50/p95/p99 of latency samples given in SECONDS, reported in ms."""
    if not len(samples):
        return {"p50_ms": float("nan"), "p95_ms": float("nan"),
                "p99_ms": float("nan"), "n": 0}
    p50, p95, p99 = np.percentile(samples, [50, 95, 99])
    return {"p50_ms": round(float(p50) * 1e3, 3),
            "p95_ms": round(float(p95) * 1e3, 3),
            "p99_ms": round(float(p99) * 1e3, 3), "n": int(len(samples))}


class LatencyRecorder:
    """Latency samples appended by one or more hot-path threads and read by
    a coordinator — a lock guards the chunk list, never the numpy math.

    Bounded: at most ~``capacity`` samples are stored. While the lifetime
    sample count stays at or under ``capacity`` every sample is kept and
    ``merged()``/``percentiles()`` are exact (the pinned legacy behavior);
    beyond that the estimator runs over a deterministic every-``stride``-th
    subsample of the arrival sequence. ``total_seen`` counts every sample
    ever offered; ``percentiles()['n']`` counts the samples the estimate
    was computed from.
    """

    def __init__(self, capacity: int = 1 << 16):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.capacity = int(capacity)
        self.total_seen = 0
        self._chunks: List[np.ndarray] = []
        self._stored = 0
        self._stride = 1          # keep arrivals whose global index % stride == 0
        self._phase = 0           # arrival index modulo stride of the next sample
        self._lock = threading.Lock()

    def add(self, samples: np.ndarray) -> None:
        if not len(samples):
            return
        arr = np.asarray(samples, np.float64).ravel()
        with self._lock:
            self.total_seen += len(arr)
            if self._stride > 1:
                first = (-self._phase) % self._stride
                self._phase = (self._phase + len(arr)) % self._stride
                arr = arr[first::self._stride]
            if len(arr):
                self._chunks.append(arr)
                self._stored += len(arr)
            while self._stored > self.capacity:
                self._halve_locked()

    def _halve_locked(self) -> None:
        # Stored samples sit at arrival indices 0, s, 2s, ...; keeping
        # every 2nd leaves exactly the indices divisible by 2s, so the
        # invariant "kept == arrivals with index % stride == 0" is exact.
        merged = np.concatenate(self._chunks)
        kept = np.ascontiguousarray(merged[::2])
        self._chunks = [kept]
        self._stored = len(kept)
        self._stride *= 2
        self._phase = self.total_seen % self._stride

    def merged(self, drain: bool = False) -> np.ndarray:
        with self._lock:
            chunks = self._chunks
            if drain:
                self._chunks = []
                self._stored = 0
                self._stride = 1
                self._phase = 0
            else:
                chunks = list(chunks)
        if not chunks:
            return np.zeros(0, np.float64)
        return np.concatenate(chunks)

    def percentiles(self, drain: bool = False) -> Dict[str, float]:
        return percentiles_ms(self.merged(drain))

    @property
    def stored(self) -> int:
        """Samples currently held (<= capacity)."""
        with self._lock:
            return self._stored


__all__ = ["LatencyRecorder", "percentiles_ms"]
