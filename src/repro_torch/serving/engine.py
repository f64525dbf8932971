"""Incremental materialized-view engine — the BI serving layer's core.

Write side: every warehouse load publishes its fact block as a
``FactDelta`` (``StarSchemaWarehouse.attach_serving`` wires the hook). The
maintenance stage drains pending deltas in publication order and folds
each one into every registered view's aggregate state through the compute
backend's ``fold_segments_many`` op — one fused count/sum/min/max dispatch
per fold cycle, covering every (delta, view) of the drain, O(delta) work,
never O(history).

Read side: **snapshot isolation via epoch publication.** View states are
immutable once published: a fold cycle builds NEW state tables
(``combine_fold`` allocates, the old tables are never written), assembles
them into an ``EpochSnapshot``, and swaps one reference. Readers pin an
epoch by grabbing that reference — thousands of concurrent report queries
never block the fold and can never observe a torn or half-folded state,
no matter how long they hold the snapshot. (The classic double-buffer
mutate-the-back-buffer scheme would tear for readers that out-live two
swaps; since view state is tiny — [n_segments, 1+3L] per view — building
fresh tables per fold costs microseconds and makes every epoch a durable
snapshot.)

Staleness: each delta carries the CDC append event-time stamps of its
records (the same clock the cluster's load-freshness metric uses). When
the fold cycle that makes a record visible swaps its epoch, the engine
records ``swap_time - event_time`` per record — end-to-end *report
staleness*: CDC append -> extract -> transform -> load -> fold -> visible
to queries. Every epoch also carries a watermark event time, so a query
response can stamp how old its data is right now.

Determinism: folds replay bit-for-bit. Segment/value extraction is host
numpy, the per-delta fold is the backend's deterministic halving tree
(the numpy oracle and the torch backend's fold kernel produce
bitwise-identical tables; the kernel folds a cycle's items at once, but
each item's table is what its own fold gives), and deltas are combined
strictly in publication order with block boundaries fixed by delta
length. Folds are segment-COMPACTED — the tree runs over only the
delta's live segments and scatters into the packed table — which leaves
every per-segment op order unchanged (see ``backend._fold_blocks``), so
compaction is invisible to the determinism contract. ``rebuild`` therefore reproduces the incremental state
byte-identically from the warehouse's committed chunk log — the
recompute-from-scratch oracle the equivalence tests assert against.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.backend import (combine_fold, empty_fold_state, fold_width,
                                get_backend, new_stream)
from repro_torch.core.metrics import LatencyRecorder
from repro_torch.observability.tracer import NULL_TRACER
from repro_torch.serving.views import ViewSpec


def serving_clock() -> float:
    """The serving layer's clock — the SAME monotonic clock CDC event
    times are stamped on (``ChangeLog.clock``), so staleness and load
    freshness are directly comparable."""
    return time.perf_counter()


_MISS = object()   # memo sentinel (cached values may legitimately be falsy)


@dataclasses.dataclass(frozen=True)
class FactDelta:
    """One published fact block: the unit of incremental maintenance.

    ``routing_epoch`` stamps which key→partition routing epoch the block
    was processed under — observability only. View *segment* ids derive
    from fact columns alone (equipment unit, shift, time window), never
    from partition ids, and the loader's chunk layout uses the stable
    static hash: both are partition-stable by construction, which is what
    lets materialized views fold identically across repartitions."""

    facts: np.ndarray                        # [n, N_FACT] f32
    event_times: Optional[np.ndarray]        # [n] f64 CDC append stamps
    published_at: float                      # serving_clock at publication
    seq: int                                 # warehouse commit sequence
    routing_epoch: Optional[int] = None      # routing epoch stamp (or None)


@dataclasses.dataclass(frozen=True)
class ViewState:
    """One view's aggregate table at one epoch (immutable)."""

    spec: ViewSpec
    table: np.ndarray                        # [S, 1 + 3L] packed, read-only

    @property
    def count(self) -> np.ndarray:
        return self.table[:, 0]

    @property
    def sums(self) -> np.ndarray:
        return self.table[:, 1:1 + self.spec.n_lanes]

    @property
    def mins(self) -> np.ndarray:
        L = self.spec.n_lanes
        return self.table[:, 1 + L:1 + 2 * L]

    @property
    def maxs(self) -> np.ndarray:
        return self.table[:, 1 + 2 * self.spec.n_lanes:]

    def means(self) -> np.ndarray:
        """Per-segment lane means; NaN for empty segments."""
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(self.count[:, None] > 0,
                            self.sums / self.count[:, None], np.nan)


@dataclasses.dataclass(frozen=True)
class EpochSnapshot:
    """One published epoch: every view's state at a single consistent
    point of the delta stream. Immutable — pinning it IS the isolation."""

    epoch: int
    states: Mapping[str, ViewState]
    published_at: float                      # swap time (serving clock)
    watermark_event_time: float              # newest CDC event time folded
    rows_folded: int                         # fact rows folded so far
    deltas_folded: int
    # per-epoch memo for derivations every reader of this epoch shares
    # (per-view means, downtime ranking, cumulative window folds): the
    # aggregate state is immutable, so a derivation computed once is valid
    # for the epoch's whole lifetime. Excluded from equality/repr — the
    # cache is an optimization, not state.
    _memo: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)
    _memo_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def view(self, name: str) -> ViewState:
        return self.states[name]

    def shared(self, key, compute):
        """Compute-once derivation shared by every reader pinning this
        epoch: first caller under ``key`` runs ``compute()``, everyone
        else gets the cached value (double-checked under the epoch's
        lock, so concurrent readers never duplicate the work)."""
        memo = self._memo
        hit = memo.get(key, _MISS)
        if hit is not _MISS:
            return hit
        with self._memo_lock:
            hit = memo.get(key, _MISS)
            if hit is _MISS:
                memo[key] = hit = compute()
            return hit

    def staleness_ms(self, now: Optional[float] = None) -> float:
        """Age of this epoch's data: clock-now minus the newest CDC event
        time visible in it. NaN before anything has been folded."""
        if not np.isfinite(self.watermark_event_time):
            return float("nan")
        return ((now if now is not None else serving_clock())
                - self.watermark_event_time) * 1e3


class MaterializedViewEngine:
    """Registry + maintenance + epoch publication for a set of views.

    Usage::

        engine = MaterializedViewEngine(steelworks_views(20))
        warehouse.attach_serving(engine)      # loads now publish deltas
        engine.start()                        # background maintenance
        snap = engine.snapshot()              # pinned epoch, never tears
        ... engine.stop()                     # folds the remaining backlog
    """

    def __init__(self, specs: Sequence[ViewSpec], backend=None,
                 idle_backoff_s: float = 0.001, scan_fold: bool = False,
                 device: str = "cuda"):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate view names: {names}")
        self.specs: Tuple[ViewSpec, ...] = tuple(specs)
        # device places the torch backend ("cuda" unless the caller asks
        # for the CPU; absent CUDA raises rather than falling back)
        self.backend = get_backend(backend, device=device)
        self.idle_backoff_s = idle_backoff_s
        # scan_fold: fold WINDOWED views through the backend's
        # associative-scan form instead of the unrolled halving tree.
        # Bitwise-identical output (so every determinism/rebuild oracle
        # still holds) but measured slower on CPU hosts — off by default;
        # see docs/BENCHMARKS.md "scan fold" for the numbers.
        self.scan_fold = bool(scan_fold)
        self.staleness_recorder = LatencyRecorder()
        # observability seam: fold/query spans go here (NULL_TRACER until a
        # cluster wires a live StageTracer through); attach_metrics adopts
        # the staleness reservoir into a registry shard
        self.tracer = NULL_TRACER
        self._pending: "deque[FactDelta]" = deque()
        self._q_lock = threading.Lock()      # guards the pending deque
        self._fold_lock = threading.Lock()   # serializes fold cycles
        self._front = EpochSnapshot(
            epoch=0, states={s.name: _frozen_state(s) for s in specs},
            published_at=serving_clock(), watermark_event_time=-np.inf,
            rows_folded=0, deltas_folded=0)
        self._seq = 0
        self._routing_epoch = 0          # newest routing epoch stamped
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -------------------------------------------------------------- write side
    def publish(self, facts: np.ndarray,
                event_times: Optional[np.ndarray] = None,
                routing_epoch: Optional[int] = None) -> int:
        """Enqueue one fact delta (called by the warehouse under its load
        lock, so queue order == commit order). Cheap: a deque append."""
        if not len(facts):
            return self._seq
        with self._q_lock:
            self._seq += 1
            if routing_epoch is not None:
                self._routing_epoch = max(self._routing_epoch, routing_epoch)
            self._pending.append(FactDelta(
                facts=facts,
                event_times=(np.asarray(event_times, np.float64)
                             if event_times is not None else None),
                published_at=serving_clock(), seq=self._seq,
                routing_epoch=routing_epoch))
            return self._seq

    def pending(self) -> int:
        with self._q_lock:
            return len(self._pending)

    # --------------------------------------------------------------- fold cycle
    def fold_pending(self, max_deltas: Optional[int] = None) -> int:
        """Drain pending deltas (publication order) into every view and
        publish ONE new epoch covering all of them. Returns rows folded.
        Serialized: concurrent callers fold disjoint delta batches."""
        with self._fold_lock:
            with self._q_lock:
                take = len(self._pending) if max_deltas is None \
                    else min(max_deltas, len(self._pending))
                deltas = [self._pending.popleft() for _ in range(take)]
            if not deltas:
                return 0
            with self.tracer.span("serving.fold") as sp:
                front = self._front
                tables = {name: st.table
                          for name, st in front.states.items()}
                watermark = front.watermark_event_time
                rows = sum(len(d.facts) for d in deltas)
                valid = [d.facts[d.facts[:, 9] > 0.5] for d in deltas]
                scan = [self.scan_fold and spec.windowed
                        for spec in self.specs]
                # every (delta, tree-folded view) of the drain in one
                # backend call (one launch on a card), in the loop's order
                aggs = iter(self.backend.fold_segments_many([
                    (spec.segments(vf), spec.values(vf), spec.n_segments)
                    for vf in valid
                    for spec, sc in zip(self.specs, scan) if not sc]))
                for d, vf in zip(deltas, valid):
                    for spec, sc in zip(self.specs, scan):
                        agg = (self.backend.fold_segments_scan(
                                   spec.segments(vf), spec.values(vf),
                                   spec.n_segments)
                               if sc else next(aggs))
                        tables[spec.name] = combine_fold(
                            tables[spec.name], agg)
                    watermark = max(watermark,
                                    float(d.event_times.max())
                                    if d.event_times is not None
                                    and len(d.event_times)
                                    else d.published_at)
                states = {}
                for spec in self.specs:
                    t = tables[spec.name]
                    t.flags.writeable = False
                    states[spec.name] = ViewState(spec, t)
                snap = EpochSnapshot(
                    epoch=front.epoch + 1, states=states,
                    published_at=serving_clock(),
                    watermark_event_time=watermark,
                    rows_folded=front.rows_folded + rows,
                    deltas_folded=front.deltas_folded + len(deltas))
                self._front = snap       # the atomic epoch swap
                # visibility staleness: the swap made these records
                # queryable
                for d in deltas:
                    if d.event_times is not None:
                        self.staleness_recorder.add(
                            snap.published_at - d.event_times)
                sp.put("deltas", len(deltas))
                sp.put("rows", rows)
                sp.put("epoch", snap.epoch)
            return rows

    # --------------------------------------------------------------- read side
    def snapshot(self) -> EpochSnapshot:
        """Pin the current epoch. Never blocks, never tears: the returned
        snapshot is immutable and survives any number of later folds."""
        return self._front

    def staleness(self, drain: bool = False) -> Dict[str, float]:
        """p50/p95/p99 of per-record visibility staleness (CDC append ->
        queryable), measured on the same clock as load freshness."""
        return self.staleness_recorder.percentiles(drain)

    def attach_metrics(self, shard) -> None:
        """Join a registry: the staleness reservoir is adopted (not
        copied) so ``registry.histogram_percentiles("staleness")`` reads
        the live recorder, and the delta backlog becomes a pull gauge."""
        shard.register_histogram("staleness", self.staleness_recorder)
        shard.gauge_fn("pending_deltas", self.pending)
        shard.gauge_fn("serving_epoch", lambda: self._front.epoch)

    def prewarm(self) -> None:
        """Warm the fold path before measuring or serving live traffic:
        one ``fold_segments_many`` call over the shapes a delta can hit —
        every row bucket at full coverage (which sweeps the compacted
        width ladder as the bucket grows) plus the narrow widths at the
        largest bucket — so the kernel library is built and loaded and the
        pinned staging buffers are allocated before the first live fold
        (the kernel itself takes any shape without recompiling). With
        ``scan_fold`` the windowed views' scan-form fold is warmed too. A
        no-op for host backends."""
        if not self.backend.device:
            return
        from repro_torch.core.backend import FOLD_BLOCK
        items = []
        for n_segments, n_lanes in {(s.n_segments, s.n_lanes)
                                    for s in self.specs}:
            m = 8
            while m <= FOLD_BLOCK:
                # full coverage: n_active = min(m, n_segments)
                items.append((np.arange(m, dtype=np.int64) % n_segments,
                              np.zeros((m, n_lanes), np.float32),
                              n_segments))
                m *= 2
            width = 8
            while width < n_segments:      # sparse widths, largest bucket
                items.append((np.arange(FOLD_BLOCK, dtype=np.int64) % width,
                              np.zeros((FOLD_BLOCK, n_lanes), np.float32),
                              n_segments))
                width *= 2
        self.backend.fold_segments_many(items)
        if self.scan_fold:                 # scan-form fold, windowed views
            for spec in self.specs:
                if not spec.windowed:
                    continue
                m = 8
                while m <= FOLD_BLOCK:
                    self.backend.fold_segments_scan(
                        np.arange(m, dtype=np.int64) % spec.n_segments,
                        np.zeros((m, spec.n_lanes), np.float32),
                        spec.n_segments)
                    m *= 2

    def prewarm_read(self, batch_buckets: Sequence[int] = (8, 256, 1024,
                                                           4096)) -> None:
        """Compile the batched read path's dispatch shapes: one
        ``batch_gather_stats`` compile per (view shape, batch bucket) and
        one ``prefix_fold`` compile per windowed view, so the first live
        query batch never stalls behind jit. No-op for host backends."""
        if not self.backend.device:
            return
        for spec in self.specs:
            table = empty_fold_state(spec.n_segments, spec.n_lanes)
            for b in batch_buckets:
                self.backend.batch_gather_stats(
                    table, np.zeros(b, np.int64))
            if spec.windowed:
                self.backend.prefix_fold(table)

    # -------------------------------------------------------------- maintenance
    def start(self) -> None:
        """Run the view-maintenance stage: a daemon thread folding deltas
        as they arrive (the serving analogue of a worker's load stage)."""
        if self._thread is not None:
            return
        self._stop.clear()
        # its own CUDA stream (none on the CPU): the folds' uploads,
        # launches and frees never interleave with a worker's stream
        stream = new_stream(self.backend)
        self._thread = threading.Thread(target=self._maintain,
                                        args=(stream,), daemon=True,
                                        name="serving.fold")
        self._thread.start()

    def _maintain(self, stream) -> None:
        with torch.cuda.stream(stream):
            while not self._stop.is_set():
                if self.fold_pending() == 0:
                    time.sleep(self.idle_backoff_s)

    def stop(self) -> None:
        """Stop maintenance and fold any remaining backlog (so the final
        epoch covers every published delta)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        self.fold_pending()

    def abort(self) -> None:
        """Crash-drill teardown: stop maintenance WITHOUT folding the
        pending backlog — a killed process folds nothing on the way
        down. The abandoned engine's front stays wherever the last
        completed fold left it."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def report(self) -> Dict[str, float]:
        snap = self._front
        out = {"epoch": snap.epoch, "views": len(self.specs),
               "rows_folded": snap.rows_folded,
               "deltas_folded": snap.deltas_folded,
               "pending_deltas": self.pending(),
               "routing_epoch": self._routing_epoch,
               "data_age_ms": round(snap.staleness_ms(), 3)}
        out.update({f"staleness_{k}": v
                    for k, v in self.staleness().items()})
        return out

    # -------------------------------------------------------------- durability
    def export_fold_state(self) -> Dict:
        """Checkpoint capture of the published front: per-view aggregate
        tables + fold counters. Lock-free — ``_front`` is an immutable
        snapshot, and the capture protocol guarantees the front's
        ``deltas_folded`` never exceeds the warehouse commit seq captured
        in the same checkpoint (folds only consume published commits)."""
        front = self._front
        return {
            "tables": {name: np.asarray(st.table)
                       for name, st in front.states.items()},
            "epoch": int(front.epoch),
            "rows_folded": int(front.rows_folded),
            "deltas_folded": int(front.deltas_folded),
            "watermark_event_time": float(front.watermark_event_time),
        }

    def restore_fold_state(self, state: Dict) -> None:
        """Cold-restart restore, before ``attach_serving``/``start``: the
        front becomes the checkpointed epoch and the delta sequence
        resumes at ``deltas_folded`` — the warehouse then replays only
        the chunk-log suffix past it. The restored watermark is a
        previous process's monotonic clock only when event times were
        absent; folded CDC event times (the normal case) carry over
        exactly."""
        states = {}
        for spec in self.specs:
            t = np.ascontiguousarray(np.asarray(state["tables"][spec.name]))
            t.flags.writeable = False
            states[spec.name] = ViewState(spec, t)
        with self._fold_lock:
            with self._q_lock:
                assert not self._pending and self._front.deltas_folded == 0, \
                    "restore_fold_state requires a fresh engine"
                self._front = EpochSnapshot(
                    epoch=int(state["epoch"]), states=states,
                    published_at=serving_clock(),
                    watermark_event_time=float(
                        state["watermark_event_time"]),
                    rows_folded=int(state["rows_folded"]),
                    deltas_folded=int(state["deltas_folded"]))
                self._seq = int(state["deltas_folded"])

    # ------------------------------------------------------------------ oracle
    @classmethod
    def rebuild(cls, specs: Sequence[ViewSpec],
                chunks: Iterable[np.ndarray], backend=None,
                scan_fold: bool = False) -> EpochSnapshot:
        """Recompute-from-scratch oracle: replay a committed chunk log
        (e.g. ``StarSchemaWarehouse.read_view().chunks``) through a fresh
        engine. Same per-delta fold path, same order — the result is
        byte-identical to the incrementally maintained state (with either
        fold form: scan and tree are bitwise-identical)."""
        eng = cls(specs, backend=backend, scan_fold=scan_fold)
        for chunk in chunks:
            eng.publish(chunk)
            eng.fold_pending()
        return eng.snapshot()


def _frozen_state(spec: ViewSpec) -> ViewState:
    table = empty_fold_state(spec.n_segments, spec.n_lanes)
    table.flags.writeable = False
    return ViewState(spec, table)


__all__ = ["FactDelta", "ViewState", "EpochSnapshot",
           "MaterializedViewEngine", "serving_clock", "fold_width"]
