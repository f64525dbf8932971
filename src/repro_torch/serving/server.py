"""Near-real-time report API over the materialized-view engine.

``ReportServer`` is what a BI dashboard talks to: every query is served
from a pinned ``EpochSnapshot`` — O(n_segments) reads of precomputed
aggregate tables, no fact-table scan, no locking against the loading
cluster — and every response carries its epoch and a staleness stamp
(how old the answer's data is, on the CDC event-time clock).

Use ``server.snapshot()`` to pin ONE epoch across several queries (a
multi-query report is then internally consistent: every number comes from
the same point of the delta stream); the convenience methods pin a fresh
epoch per call.

Read-path economics: report payloads are READ-ONLY VIEWS of the epoch's
immutable tables (never per-query copies), and derivations every reader
of an epoch shares — per-view means, the downtime ranking, cumulative
window folds — are computed once per epoch via ``EpochSnapshot.shared``.
A thousand concurrent queries against one epoch allocate next to nothing.
For thousands of queries at once, see ``repro.serving.batch``: the packed
query plan answers a whole heterogeneous batch in one backend dispatch
per view.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.backend import get_backend
from repro_torch.serving.engine import (EpochSnapshot, MaterializedViewEngine,
                                  serving_clock)


@dataclasses.dataclass(frozen=True)
class Report:
    """One query response: data + provenance (epoch, staleness)."""

    view: str
    epoch: int
    staleness_ms: float                      # age of the data served
    rows: int                                # fact rows folded into the
    data: dict                               # epoch (incl. invalid-flagged
                                             # rows dropped from view state)


def _frozen(arr: np.ndarray) -> np.ndarray:
    arr.flags.writeable = False
    return arr


def downtime_rank_keys(down: np.ndarray) -> np.ndarray:
    """uint64 ranking keys for the top-downtime report: ascending key
    order == (downtime DESC, unit ASC) — exactly the order
    ``np.lexsort((arange, -down))`` produces (the pre-batching oracle,
    still asserted in tests).

    The high 32 bits are the downtime as a descending total-order key
    (IEEE-754 bit trick: flip the sign bit of non-negatives, complement
    negatives — float order becomes unsigned integer order — then invert
    for descending); the low 32 bits are the unit id, so every key is
    UNIQUE and any selection algorithm — ``argpartition`` included —
    breaks ties identically. -0.0 is normalized to +0.0 first (the float
    sort treats them equal; their bit patterns are not)."""
    d = down.astype(np.float32) + np.float32(0.0)        # -0.0 -> +0.0
    b = np.ascontiguousarray(d).view(np.uint32).astype(np.uint64)
    asc = np.where(d >= 0, b ^ np.uint64(0x80000000),
                   ~b & np.uint64(0xFFFFFFFF))
    desc = np.uint64(0xFFFFFFFF) - asc
    return (desc << np.uint64(32)) | np.arange(len(d), dtype=np.uint64)


class ReportSnapshot:
    """Query helpers bound to ONE pinned epoch (snapshot isolation: the
    answers cannot change, tear, or block while you hold this).

    All report payload arrays are read-only views of the epoch's
    immutable state (or of per-epoch memoized derivations) — copy before
    mutating."""

    def __init__(self, snap: EpochSnapshot, backend=None):
        self.snap = snap
        self.backend = get_backend(backend)

    @property
    def epoch(self) -> int:
        return self.snap.epoch

    def _report(self, view: str, data: dict) -> Report:
        return Report(view=view, epoch=self.snap.epoch,
                      staleness_ms=self.snap.staleness_ms(),
                      rows=self.snap.rows_folded, data=data)

    # --------------------------------------------- shared epoch derivations
    def _means(self, view: str) -> np.ndarray:
        st = self.snap.view(view)
        return self.snap.shared(("means", view),
                                lambda: _frozen(st.means()))

    def _downtime_rank(self) -> Tuple[np.ndarray, np.ndarray]:
        """(downtime lane, uint64 ranking keys) — once per epoch."""
        st = self.snap.view("downtime_by_equipment")

        def compute():
            down = st.sums[:, 0]
            return down, _frozen(downtime_rank_keys(down))

        return self.snap.shared(("downtime_rank",), compute)

    def _curve(self, view: str) -> np.ndarray:
        """Cumulative windowed fold [S, 1+3L] (row w aggregates windows
        [0, w]) — ONE prefix_fold dispatch per epoch, shared by every
        reader and every batched curve query."""
        st = self.snap.view(view)
        if not st.spec.windowed:
            raise ValueError(f"view {view!r} is not windowed")
        return self.snap.shared(
            ("curve", view),
            lambda: _frozen(self.backend.prefix_fold(st.table)))

    # ------------------------------------------------------- standard reports
    def query(self, view: str) -> Report:
        """Generic per-segment report: count / sum / mean / min / max for
        every lane of ``view``."""
        st = self.snap.view(view)
        data = {"count": st.count, "lanes": st.spec.lanes,
                "sum": st.sums, "mean": self._means(view),
                "min": st.mins, "max": st.maxs}
        return self._report(view, data)

    def kpi_rollup(self) -> np.ndarray:
        """[n_units, 5] KPI sums + count — the exact shape and semantics of
        ``Warehouse.kpi_rollup``, served from the view state in O(n_units)."""
        st = self.snap.view("oee_by_equipment")
        return self.snap.shared(
            ("kpi_rollup",),
            lambda: _frozen(np.concatenate(
                [st.sums, st.count[:, None]], axis=1).astype(np.float32)))

    def oee(self, equipment_id: Optional[int] = None) -> Report:
        """``Warehouse.query_oee`` served incrementally: mean KPIs for one
        unit, or across all units when ``equipment_id`` is None."""
        st = self.snap.view("oee_by_equipment")
        if equipment_id is not None:
            cnt = float(st.count[equipment_id])
            means = (st.sums[equipment_id] / cnt if cnt
                     else np.full(st.spec.n_lanes, np.nan))
        else:
            def all_units():
                c = float(st.count.sum())
                m = (st.sums.sum(axis=0) / c if c
                     else np.full(st.spec.n_lanes, np.nan))
                return c, m
            cnt, means = self.snap.shared(("oee_all",), all_units)
        data = dict(zip(st.spec.lanes, (float(m) for m in means)))
        data["rows"] = cnt
        return self._report("oee_by_equipment", data)

    def top_downtime(self, k: int = 5) -> Report:
        """Top-k downtime causes: units ranked by summed off-segment
        seconds (ties broken by unit id for determinism). Selection is
        ``argpartition`` top-k over the epoch's memoized unique ranking
        keys — O(n + k log k) per query, same order as the old full
        ``lexsort``."""
        down, keys = self._downtime_rank()
        st = self.snap.view("downtime_by_equipment")
        n = len(keys)
        kk = min(k, n)
        if kk < n:
            part = np.argpartition(keys, kk)[:kk]
            order = part[np.argsort(keys[part])]
        else:
            order = np.argsort(keys)
        data = {"unit": order.astype(np.int64),
                "downtime_s": down[order].astype(np.float64),
                "uptime_s": st.sums[order, 1].astype(np.float64)}
        return self._report("downtime_by_equipment", data)

    def production_rate(self) -> Report:
        """Per-window production report: facts/window, summed runtime and
        the window's min/max OEE."""
        st = self.snap.view("production_rate_windows")
        data = {"facts": st.count,
                "runtime_s": st.sums[:, 0],
                "oee_min": st.mins[:, 1],
                "oee_max": st.maxs[:, 1]}
        return self._report("production_rate_windows", data)

    def production_curve(self, view: str = "production_rate_windows"
                         ) -> Report:
        """Cumulative windowed report: row w aggregates windows [0, w] —
        running fact count, runtime, min/max per lane. All S prefixes come
        from ONE associative-scan dispatch per epoch (see
        ``ComputeBackend.prefix_fold``), not S per-window refolds."""
        st = self.snap.view(view)
        cum = self._curve(view)
        L = st.spec.n_lanes
        data = {"count": cum[:, 0], "lanes": st.spec.lanes,
                "sum": cum[:, 1:1 + L],
                "min": cum[:, 1 + L:1 + 2 * L],
                "max": cum[:, 1 + 2 * L:]}
        return self._report(view, data)

    def shift_report(self) -> Report:
        """Per (unit, shift) mean KPIs — the paper's shift report."""
        st = self.snap.view("kpi_by_unit_shift")
        return self._report("kpi_by_unit_shift",
                            {"count": st.count,
                             "mean": self._means("kpi_by_unit_shift"),
                             "lanes": st.spec.lanes})


class ReportServer:
    """The BI front door: pins an epoch per query (or hands out pinned
    ``ReportSnapshot``s for multi-query consistency)."""

    def __init__(self, engine: MaterializedViewEngine):
        self.engine = engine

    def snapshot(self) -> ReportSnapshot:
        return ReportSnapshot(self.engine.snapshot(), self.engine.backend)

    # per-call conveniences (each pins a fresh epoch)
    def query(self, view: str) -> Report:
        return self.snapshot().query(view)

    def kpi_rollup(self) -> np.ndarray:
        return self.snapshot().kpi_rollup()

    def oee(self, equipment_id: Optional[int] = None) -> Report:
        return self.snapshot().oee(equipment_id)

    def top_downtime(self, k: int = 5) -> Report:
        return self.snapshot().top_downtime(k)

    def production_rate(self) -> Report:
        return self.snapshot().production_rate()

    def production_curve(self) -> Report:
        return self.snapshot().production_curve()

    def serve_batch(self, queries) -> "List[Report]":
        """Answer a heterogeneous query batch against ONE pinned epoch in
        one vectorized dispatch per view (see ``repro.serving.batch``)."""
        from repro_torch.serving.batch import compile_queries
        return compile_queries(queries).execute(self.snapshot()).reports()


__all__ = ["Report", "ReportSnapshot", "ReportServer", "downtime_rank_keys"]
