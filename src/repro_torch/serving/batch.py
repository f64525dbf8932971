"""Batched query plane: thousands of heterogeneous report queries per
backend dispatch (the read-side analogue of the write path's 3→1 dispatch
coalescing).

The serving plane tops out when every report is a separate
Python-dispatched read. This module splits querying into the classic
plan/execute shape:

  * ``ReportQuery``    — one query as data (kind + view + args).
  * ``compile_queries``— encode a batch into a ``QueryPlan`` of PACKED
                         descriptors (int32 kind/view/arg columns) and
                         vectorized group indices. Compiling is the only
                         per-query Python work and is paid ONCE — a
                         dashboard re-issuing the same query set every
                         refresh reuses its plan across epochs.
  * ``QueryPlan.execute`` — answer the whole batch against one pinned
                         ``ReportSnapshot``: all per-unit point queries
                         against a view become ONE ``batch_gather_stats``
                         dispatch, every distinct shared report (view
                         read, top-k, windowed rate, curve, shift,
                         rollup) is computed once via the snapshot's
                         per-epoch memo, and the result is a columnar
                         ``BatchResult``. No per-query Python on the
                         execute path.
  * ``BatchResult.reports`` — materialize per-query ``Report`` objects in
                         submission order (the byte-parity surface with
                         the per-query loop); columnar consumers read the
                         packed arrays directly and skip it.
  * ``BatchedReportServer`` — the admission front (idiom:
                         examples/serve_lm.py request batching): callers
                         ``submit()`` single queries from any thread, the
                         dispatcher coalesces them (``max_batch`` /
                         ``max_wait_ms``) and answers each coalesced
                         group per PINNED snapshot — a query's epoch is
                         fixed at admission, so a batch spanning an epoch
                         swap stamps each query with its own epoch.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.engine import serving_clock
from repro_torch.serving.server import Report, ReportSnapshot, ReportServer

# kind codes of the packed descriptor encoding (stable wire format)
KIND_CODES: Dict[str, int] = {
    "view": 0,              # generic per-segment table read
    "oee": 1,               # per-unit OEE means (arg = unit; -1 = fleet)
    "top_downtime": 2,      # top-k downtime ranking (arg = k)
    "production_rate": 3,   # per-window production report
    "shift_report": 4,      # per (unit, shift) means
    "kpi_rollup": 5,        # [n_units, 5] warehouse-shaped rollup
    "production_curve": 6,  # cumulative windowed fold (prefix_fold)
}
_CODE_KINDS = {v: k for k, v in KIND_CODES.items()}
_OEE = KIND_CODES["oee"]

# default view per kind (kind "view"/"production_curve" take an explicit
# view name; the rest address their canonical steelworks view)
_DEFAULT_VIEW = {
    "oee": "oee_by_equipment",
    "top_downtime": "downtime_by_equipment",
    "production_rate": "production_rate_windows",
    "production_curve": "production_rate_windows",
    "shift_report": "kpi_by_unit_shift",
    "kpi_rollup": "oee_by_equipment",
}


@dataclasses.dataclass(frozen=True)
class ReportQuery:
    """One report query as data. ``kind`` is a ``KIND_CODES`` key;
    ``view`` is required for kind "view" (optional override for
    "production_curve"); ``unit`` selects a single unit for kind "oee"
    (None = fleet-wide); ``k`` is the top-downtime depth."""

    kind: str
    view: Optional[str] = None
    unit: Optional[int] = None
    k: int = 5


class QueryPlan:
    """A compiled query batch: packed int32 descriptor columns + the
    vectorized group indices ``execute`` dispatches from. Immutable;
    reusable across any number of epochs/snapshots."""

    def __init__(self, codes: np.ndarray, view_ids: np.ndarray,
                 args: np.ndarray, views: Tuple[str, ...]):
        codes = np.ascontiguousarray(codes, np.int32)
        view_ids = np.ascontiguousarray(view_ids, np.int32)
        args = np.ascontiguousarray(args, np.int32)
        if not (len(codes) == len(view_ids) == len(args)):
            raise ValueError("descriptor columns must share one length")
        bad = ~np.isin(codes, list(_CODE_KINDS))
        if bad.any():
            raise ValueError(f"unknown kind codes {np.unique(codes[bad])}")
        if len(codes) and (view_ids.min() < 0
                           or view_ids.max() >= max(len(views), 1)):
            raise ValueError("view_id out of range")
        for arr in (codes, view_ids, args):
            arr.flags.writeable = False
        self.codes = codes
        self.view_ids = view_ids
        self.args = args
        self.views = tuple(views)

        # ---- vectorized grouping (once per plan, reused every execute)
        point = (codes == _OEE) & (args >= 0)
        # point groups: one gather dispatch per distinct view
        self.point_groups: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._point_row = np.full(len(codes), -1, np.int64)
        for vid in np.unique(view_ids[point]):
            pos = np.flatnonzero(point & (view_ids == vid))
            self.point_groups[int(vid)] = (pos, args[pos].astype(np.int64))
            self._point_row[pos] = np.arange(len(pos))
        # shared groups: one computation per distinct (code, view, arg)
        srows = np.stack([np.where(point, -1, codes), view_ids,
                          np.where(point, 0, args)], axis=1)
        skeys, sinv = np.unique(srows, axis=0, return_inverse=True)
        self.shared_keys: List[Tuple[int, int, int]] = [
            tuple(int(x) for x in row) for row in skeys if row[0] >= 0]
        self._shared_idx = np.where(point, -1, sinv)
        self._shared_map = {tuple(int(x) for x in row): i
                            for i, row in enumerate(skeys)}

    def __len__(self) -> int:
        return len(self.codes)

    def descriptors(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The packed wire format: (codes, view_ids, args) int32 columns."""
        return self.codes, self.view_ids, self.args

    # ------------------------------------------------------------- execute
    def execute(self, rsnap: ReportSnapshot) -> "BatchResult":
        """Answer every query against ONE pinned snapshot: one
        ``batch_gather_stats`` dispatch per point-query view, one shared
        computation per distinct report (epoch-memoized, so a second
        batch on the same epoch recomputes nothing). Columnar out."""
        snap = rsnap.snap
        # sharded serving plane: when the snapshot carries shard-local
        # tables (ShardedEpochSnapshot), each query descriptor routes to
        # its segment's OWNING shard — one gather dispatch per shard with
        # resident queries, against that shard's local table. Owned rows
        # are bitwise-identical to the merged table's, so the scattered
        # answers are bitwise the unsharded dispatch (duck-typed: no
        # runtime import, plain snapshots take the single-dispatch path).
        shard_states = getattr(snap, "shard_states", None)
        seg_owners = getattr(snap, "seg_owners", None)
        point_stats: Dict[int, np.ndarray] = {}
        for vid, (pos, units) in self.point_groups.items():
            name = self.views[vid]
            st = snap.view(name)
            if len(units) and (units.min() < 0
                               or units.max() >= st.spec.n_segments):
                raise ValueError(
                    f"unit ids out of range for view {name!r}")
            if shard_states and name in shard_states and len(units):
                tabs = shard_states[name]
                owner_u = np.asarray(seg_owners[name],
                                     np.int64)[units]
                out = np.empty((len(units), 1 + 4 * st.spec.n_lanes),
                               np.float32)
                for k in np.unique(owner_u):
                    mask = owner_u == k
                    out[mask] = rsnap.backend.batch_gather_stats(
                        tabs[int(k)], units[mask])
                point_stats[vid] = out
            else:
                point_stats[vid] = rsnap.backend.batch_gather_stats(
                    st.table, units)
        shared: List[object] = [None] * (max(self._shared_map.values()) + 1
                                         if self._shared_map else 0)
        for code, vid, arg in self.shared_keys:
            shared[self._shared_map[(code, vid, arg)]] = \
                self._run_shared(rsnap, code, vid, arg)
        return BatchResult(plan=self, snap=snap,
                           staleness_ms=snap.staleness_ms(),
                           served_at=serving_clock(),
                           point_stats=point_stats, shared=shared)

    def _run_shared(self, rsnap: ReportSnapshot, code: int, vid: int,
                    arg: int):
        kind = _CODE_KINDS[code]
        view = self.views[vid]
        if kind == "view":
            return rsnap.query(view)
        if kind == "oee":
            return rsnap.oee(None)
        if kind == "top_downtime":
            return rsnap.top_downtime(arg)
        if kind == "production_rate":
            return rsnap.production_rate()
        if kind == "shift_report":
            return rsnap.shift_report()
        if kind == "production_curve":
            return rsnap.production_curve(view)
        # kpi_rollup: ndarray payload, wrapped for a uniform Report surface
        return Report(view=view, epoch=rsnap.epoch,
                      staleness_ms=rsnap.snap.staleness_ms(),
                      rows=rsnap.snap.rows_folded,
                      data={"kpi_rollup": rsnap.kpi_rollup()})


class BatchResult:
    """Columnar batch answer bound to one epoch.

    ``point_stats`` holds, per point-query view, the packed
    [B_g, 1 + 4L] gather output ([count | sums | mins | maxs | means])
    aligned with the plan's group positions; ``shared`` holds each
    distinct shared ``Report`` exactly once. ``reports()`` fans these out
    into per-query ``Report`` objects in submission order."""

    def __init__(self, plan: QueryPlan, snap, staleness_ms: float,
                 served_at: float, point_stats: Dict[int, np.ndarray],
                 shared: List[object]):
        self.plan = plan
        self.snap = snap
        self.epoch = snap.epoch
        self.rows = snap.rows_folded
        self.staleness_ms = staleness_ms
        self.served_at = served_at
        self.point_stats = point_stats
        self.shared = shared

    def __len__(self) -> int:
        return len(self.plan)

    def point_positions(self, view: str) -> np.ndarray:
        vid = self.plan.views.index(view)
        return self.plan.point_groups[vid][0]

    def reports(self) -> List[Report]:
        """Per-query ``Report``s in submission order. Shared kinds reuse
        ONE Report object across every query that asked for it; point
        queries materialize a small dict each (only this path pays
        per-query Python — columnar consumers read the arrays)."""
        plan = self.plan
        out: List[Optional[Report]] = [None] * len(plan)
        sidx = plan._shared_idx
        for i in np.flatnonzero(sidx >= 0):
            out[i] = self.shared[sidx[i]]
        for vid, (pos, _units) in plan.point_groups.items():
            view = plan.views[vid]
            st = self.snap.view(view)
            lanes = st.spec.lanes
            L = len(lanes)
            stats = self.point_stats[vid]
            means = stats[:, 1 + 3 * L:]
            cnts = stats[:, 0]
            for row, i in enumerate(pos):
                data = dict(zip(lanes, (float(m) for m in means[row])))
                data["rows"] = float(cnts[row])
                out[i] = Report(view=view, epoch=self.epoch,
                                staleness_ms=self.staleness_ms,
                                rows=self.rows, data=data)
        return out  # type: ignore[return-value]


def compile_queries(queries: Sequence[ReportQuery]) -> QueryPlan:
    """Encode a query batch into packed descriptors + a ``QueryPlan``.
    The one place per-query Python runs; everything downstream is
    vectorized."""
    qs = list(queries)
    n = len(qs)
    codes = np.empty(n, np.int32)
    view_ids = np.empty(n, np.int32)
    args = np.zeros(n, np.int32)
    view_idx: Dict[str, int] = {}
    for i, q in enumerate(qs):
        code = KIND_CODES.get(q.kind)
        if code is None:
            raise ValueError(f"unknown query kind {q.kind!r}")
        view = q.view or _DEFAULT_VIEW.get(q.kind)
        if view is None:
            raise ValueError(f"kind {q.kind!r} requires an explicit view")
        codes[i] = code
        view_ids[i] = view_idx.setdefault(view, len(view_idx))
        if q.kind == "oee":
            if q.unit is not None and q.unit < 0:
                raise ValueError(f"negative unit {q.unit}")
            args[i] = -1 if q.unit is None else int(q.unit)
        elif q.kind == "top_downtime":
            if q.k < 1:
                raise ValueError(f"top_downtime needs k >= 1, got {q.k}")
            args[i] = int(q.k)
    return QueryPlan(codes, view_ids, args,
                     tuple(sorted(view_idx, key=view_idx.get)))


class BatchTicket:
    """One submitted query's future. ``result()`` blocks until the
    dispatcher answers; the query's epoch was pinned at submission."""

    __slots__ = ("query", "snapshot", "admitted_at", "_event", "_report",
                 "_error")

    def __init__(self, query: ReportQuery, snapshot):
        self.query = query
        self.snapshot = snapshot          # EpochSnapshot pinned at admission
        self.admitted_at = serving_clock()
        self._event = threading.Event()
        self._report: Optional[Report] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Report:
        if not self._event.wait(timeout):
            raise TimeoutError("batched query not answered in time")
        if self._error is not None:
            raise self._error
        return self._report

    def _fulfill(self, report: Report) -> None:
        self._report = report
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()


class BatchedReportServer:
    """Admission/batching front over a ``ReportServer`` (idiom:
    examples/serve_lm.py): any thread ``submit()``s single queries; a
    dispatcher thread coalesces them into batches of up to ``max_batch``
    (waiting at most ``max_wait_ms`` after the first admission), then
    answers each batch per pinned snapshot via the compiled plan. A
    query's epoch is fixed the moment it is admitted — batches that span
    an epoch swap stamp each query with its own epoch and staleness."""

    def __init__(self, server, max_batch: int = 4096,
                 max_wait_ms: float = 2.0):
        if not isinstance(server, ReportServer):
            server = ReportServer(server)     # accept a bare engine
        self.server = server
        self.engine = server.engine
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) * 1e-3
        self._queue: List[BatchTicket] = []
        self._cv = threading.Condition()
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        self._stats_lock = threading.Lock()
        self._batches = 0
        self._queries = 0
        self._max_batch_seen = 0
        self._multi_epoch_batches = 0

    # ---------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stopping = False
        self._thread = threading.Thread(target=self._dispatch, daemon=True,
                                        name="serving.batch")
        self._thread.start()

    def stop(self) -> None:
        """Stop the dispatcher after draining every admitted query."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        self._drain()                      # leftovers answered inline

    # ---------------------------------------------------------- admission
    def submit(self, query: ReportQuery) -> BatchTicket:
        """Admit one query: pins the CURRENT epoch and returns a ticket.
        Cheap — a snapshot reference grab and a list append."""
        ticket = BatchTicket(query, self.engine.snapshot())
        with self._cv:
            if self._thread is None and not self._stopping:
                # no dispatcher running: answer synchronously (degraded
                # but correct — used by tests and teardown races)
                pass
            self._queue.append(ticket)
            self._cv.notify()
        if self._thread is None:
            self._drain()
        return ticket

    def stats(self) -> Dict[str, float]:
        with self._stats_lock:
            b, q = self._batches, self._queries
            return {"batches": b, "queries": q,
                    "mean_batch": (q / b) if b else 0.0,
                    "max_batch": self._max_batch_seen,
                    "multi_epoch_batches": self._multi_epoch_batches}

    # --------------------------------------------------------- dispatcher
    def _dispatch(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopping:
                    self._cv.wait()
                if not self._queue and self._stopping:
                    return
                # coalesce: wait (bounded) for the batch to fill
                deadline = serving_clock() + self.max_wait_s
                while (len(self._queue) < self.max_batch
                       and not self._stopping):
                    left = deadline - serving_clock()
                    if left <= 0 or not self._cv.wait(left):
                        break
                batch = self._queue[:self.max_batch]
                del self._queue[:self.max_batch]
            self._answer(batch)

    def _drain(self) -> None:
        while True:
            with self._cv:
                batch = self._queue[:self.max_batch]
                del self._queue[:self.max_batch]
            if not batch:
                return
            self._answer(batch)

    def _answer(self, batch: List[BatchTicket]) -> None:
        # group by pinned epoch: one plan-execute per snapshot generation
        groups: Dict[int, List[BatchTicket]] = {}
        for t in batch:
            groups.setdefault(t.snapshot.epoch, []).append(t)
        for tickets in groups.values():
            snap = tickets[0].snapshot
            try:
                with self.engine.tracer.span("query.batch") as sp:
                    plan = compile_queries([t.query for t in tickets])
                    rsnap = ReportSnapshot(snap, self.engine.backend)
                    for t, rep in zip(tickets,
                                      plan.execute(rsnap).reports()):
                        t._fulfill(rep)
                    sp.put("queries", len(tickets))
                    sp.put("epoch", snap.epoch)
            except BaseException as exc:   # answer, never wedge a caller
                for t in tickets:
                    if not t.done():
                        t._fail(exc)
        with self._stats_lock:
            self._batches += 1
            self._queries += len(batch)
            self._max_batch_seen = max(self._max_batch_seen, len(batch))
            if len(groups) > 1:
                self._multi_epoch_batches += 1


__all__ = ["KIND_CODES", "ReportQuery", "QueryPlan", "BatchResult",
           "compile_queries", "BatchTicket", "BatchedReportServer"]
