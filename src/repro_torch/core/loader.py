"""Target Database Updater (paper §3.1.2): partition-parallel load of
transformed facts into the star-schema warehouse.

``StarSchemaWarehouse`` holds one fact table (OEE fact grains) plus the
equipment dimension; loads are per-partition appends (each partition
'executes its query statements independently'). Two read paths:

* the ad-hoc OLAP path (``query_oee`` / ``kpi_rollup`` / ``fact_table``)
  — full-rescan aggregates. All three read a pinned per-partition view of
  COMMITTED state (``read_view``): a load appends its chunks and bumps the
  commit sequence under one lock acquisition, and a view pins the chunk
  log at a commit boundary — so a report that issues several queries
  against one view can never observe a partition mid-``load`` from a
  concurrent worker (the torn-report race the serving layer also closes);

* the serving path — every load publishes its fact block (plus the
  records' CDC event-time stamps) as a delta to an attached
  ``repro.serving.MaterializedViewEngine``, which maintains report views
  incrementally in O(delta). ``attach_serving`` replays the committed
  chunk log first, so views cover history loaded before attachment.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.partitioning import partition_bounds
from repro_torch.core.transformer import FACT_COLUMNS


@dataclasses.dataclass(frozen=True)
class WarehouseView:
    """A pinned, immutable view of committed warehouse state: the chunk
    log as of one commit boundary. Everything a reader computes from one
    view is mutually consistent no matter how many concurrent loads land
    while it is held."""

    chunks: Tuple[np.ndarray, ...]           # committed fact blocks, in
    seq: int                                 # commit order
    rows: int


class StarSchemaWarehouse:
    """Loads are thread-safe: the concurrent runtime's load stages append
    from one thread per worker, so the chunk log, commit sequence and
    delta publication are guarded by a single lock (the numpy split work
    stays outside it)."""

    def __init__(self, backend=None):
        self._chunk_log: List[np.ndarray] = []   # committed blocks, in order
        self._lock = threading.Lock()
        self._serving = None                 # MaterializedViewEngine (opt.)
        self._shards = None                  # ShardOwnership (opt.)
        # per-shard chunk sub-logs, chunk-aligned: _shard_logs[k][i] holds
        # chunk i's rows whose business key the ownership routes to shard
        # k — maintained incrementally at commit time (the write path
        # never moves rows across shards)
        self._shard_logs: List[List[np.ndarray]] = []
        self.backend = backend       # pipeline's ComputeBackend (or None)
        self.rows_loaded = 0
        self.load_calls = 0
        self.commit_seq = 0
        # running per-unit KPI aggregate fed by the fused
        # transform_and_rollup dispatches (an O(1) read path next to the
        # kpi_rollup full rescan); rows loaded WITHOUT a rollup — legacy
        # per-partition loops, the record-at-a-time baseline — gap it
        self._kpi_running: Optional[np.ndarray] = None
        self._kpi_gap_rows = 0

    # ------------------------------------------------------------ serving hook
    def attach_serving(self, engine, replay_from: int = 0):
        """Wire a view engine: every committed load is published as one
        fact delta, in commit order (the publish happens under the load
        lock, so delta order == chunk-log order — what makes the engine's
        ``rebuild`` oracle byte-identical). History already loaded is
        replayed first, starting at chunk ``replay_from`` — recovery
        passes the engine's restored ``deltas_folded`` so only the
        post-checkpoint suffix replays (every committed chunk is
        non-empty, so chunk indices and delta sequence align 1:1).
        Idempotent for an already-attached engine (the recovery path
        attaches before handing the pipeline to a cluster whose
        constructor attaches again — a second full replay would
        double-fold history). Returns the engine for chaining."""
        with self._lock:
            if engine is self._serving:
                return engine
            for chunk in self._chunk_log[replay_from:]:
                engine.publish(chunk)
            self._serving = engine
        return engine

    # ------------------------------------------------------------- shard plane
    def _split_chunk(self, block: np.ndarray) -> None:
        """Lock-held: append one committed chunk's rows to the per-shard
        sub-logs (business key = fact col 0, routed through the attached
        ``ShardOwnership``). Row order within each shard's slice follows
        the chunk's order, so concatenating every shard's slices and
        canonical-sorting reproduces the chunk log byte-for-byte."""
        owner = self._shards.shard_of_keys(block[:, 0].astype(np.int64))
        for k in range(self._shards.n_shards):
            self._shard_logs[k].append(block[owner == k])

    def attach_shards(self, ownership) -> None:
        """Wire a ``repro.runtime.shard_plane.ShardOwnership``: every
        committed chunk is (and history retroactively gets) split into
        per-shard sub-logs, so each mesh shard holds only the fact rows
        of its owned business-key ranges. The primary chunk log — the
        commit/durability source of truth — is untouched; the split is a
        derived placement, which is what keeps the warehouse
        byte-identical to the unsharded one by construction."""
        with self._lock:
            self._shards = ownership
            self._shard_logs = [[] for _ in range(ownership.n_shards)]
            for chunk in self._chunk_log:
                self._split_chunk(chunk)

    def reown_shards(self, ownership) -> Dict:
        """Surgical re-split for a new routing epoch (the warehouse twin
        of ``ShardedViewEngine.reown``): chunks whose rows all keep their
        owner are left alone — only chunks containing a moved key have
        their per-shard slices rebuilt. Returns {chunks_resplit,
        rows_moved}. No-op unless shards are attached."""
        with self._lock:
            old = self._shards
            if old is None:
                return {"chunks_resplit": 0, "rows_moved": 0}
            K = ownership.n_shards
            if K != old.n_shards:
                raise ValueError(
                    f"reown_shards: shard count is fixed for the plane's "
                    f"lifetime ({old.n_shards} != {K}); detach and "
                    f"attach_shards to resize")
            resplit = 0
            moved_rows = 0
            for i, chunk in enumerate(self._chunk_log):
                keys = chunk[:, 0].astype(np.int64)
                ow_new = ownership.shard_of_keys(keys)
                moved = int((old.shard_of_keys(keys) != ow_new).sum())
                if not moved:
                    continue
                resplit += 1
                moved_rows += moved
                for k in range(K):
                    self._shard_logs[k][i] = chunk[ow_new == k]
            self._shards = ownership
            return {"chunks_resplit": resplit, "rows_moved": moved_rows}

    def shard_fact_table(self, shard: int) -> np.ndarray:
        """One shard's resident fact rows (its owned business-key ranges
        only), in commit order."""
        with self._lock:
            chunks = [c for c in self._shard_logs[shard] if len(c)]
            if not chunks:
                return np.zeros((0, len(FACT_COLUMNS)), np.float32)
            return np.concatenate(chunks)

    def shard_rows(self) -> List[int]:
        """[n_shards] resident row counts — the warehouse-side imbalance
        signal."""
        with self._lock:
            return [int(sum(len(c) for c in log))
                    for log in self._shard_logs]

    # ------------------------------------------------------------- durability
    def export_state(self, from_seq: int = 0) -> Dict:
        """Journal capture at a commit boundary: the chunk-log SUFFIX
        past ``from_seq`` (``commit_seq == len(_chunk_log)`` — one
        committed chunk per commit) plus the full counter state."""
        with self._lock:
            return {
                "chunks": list(self._chunk_log[from_seq:]),
                "seq": int(self.commit_seq),
                "rows": int(self.rows_loaded),
                "load_calls": int(self.load_calls),
                "kpi_running": (None if self._kpi_running is None
                                else self._kpi_running.copy()),
                "kpi_gap_rows": int(self._kpi_gap_rows),
            }

    def restore_state(self, state: Dict) -> None:
        """Cold-restart restore into an empty warehouse. ``state`` is the
        journal-accumulated form (chunks = the FULL committed log). Must
        run before ``attach_serving``: the chunks land silently, and the
        serving replay decides separately how much suffix to re-publish."""
        with self._lock:
            assert not self._chunk_log and self._serving is None, \
                "restore_state requires a fresh warehouse"
            chunks = [np.asarray(c, np.float32) for c in state["chunks"]]
            if len(chunks) != int(state["seq"]):
                raise IOError(
                    f"warehouse restore: {len(chunks)} chunks for commit "
                    f"seq {state['seq']}")
            self._chunk_log = chunks
            self.commit_seq = int(state["seq"])
            self.rows_loaded = int(state["rows"])
            self.load_calls = int(state["load_calls"])
            self._kpi_running = (None if state["kpi_running"] is None
                                 else np.asarray(state["kpi_running"]))
            self._kpi_gap_rows = int(state["kpi_gap_rows"])

    def _commit(self, block: np.ndarray,
                event_times: Optional[np.ndarray],
                rollup: Optional[np.ndarray] = None,
                routing_epoch: Optional[int] = None) -> None:
        """Lock-held: record the block in the committed chunk log, bump the
        commit sequence, fold the fused rollup into the running KPI
        aggregate, publish the delta (stamped with the routing epoch the
        records were processed under, for migration observability)."""
        self._chunk_log.append(block)
        if self._shards is not None:
            self._split_chunk(block)
        self.commit_seq += 1
        if rollup is not None:
            if self._kpi_running is None:
                self._kpi_running = np.zeros_like(rollup)
            if self._kpi_running.shape == rollup.shape:
                self._kpi_running = self._kpi_running + rollup
            else:                     # mixed n_units producers: no O(1) path
                self._kpi_gap_rows += len(block)
        else:
            self._kpi_gap_rows += len(block)
        if self._serving is not None:
            self._serving.publish(block, event_times,
                                  routing_epoch=routing_epoch)

    # -------------------------------------------------------------- load paths
    def load(self, partition: int, facts: np.ndarray,
             event_times: Optional[np.ndarray] = None,
             rollup: Optional[np.ndarray] = None,
             routing_epoch: Optional[int] = None) -> None:
        """Per-partition append (the caller already split by partition)."""
        if len(facts) == 0:
            return
        facts = np.asarray(facts)
        with self._lock:
            self.rows_loaded += len(facts)
            self.load_calls += 1
            self._commit(facts, event_times, rollup, routing_epoch)

    def load_partitioned(self, facts: np.ndarray, n_partitions: int,
                         event_times: Optional[np.ndarray] = None,
                         rollup: Optional[np.ndarray] = None,
                         routing_epoch: Optional[int] = None) -> int:
        """Group a coalesced fact block by business-key partition (fact
        col 0 IS the business key — each partition's rows land contiguous,
        'executing its query statements independently') and commit it as
        ONE block. The numpy sort happens outside the lock; the append,
        commit-sequence bump and serving delta land under ONE acquisition
        (concurrent workers' load stages share this lock, so per-partition
        locking would contend ~n_partitions times per dispatch — and a
        reader pinning a view can never see half a load).

        The chunk layout deliberately uses the STABLE static hash, never
        the queue's adaptive routing table: the grouping of one fact set
        is then invariant to routing epochs, so serving-view folds (whose
        segment ids come from fact columns alone — partition-stable by
        construction) and the chunk log replay stay byte-identical across
        repartitions. ``routing_epoch`` is carried as a stamp for
        observability only; it never influences the layout."""
        n = len(facts)
        if n == 0:
            return 0
        order, bounds = partition_bounds(facts[:, 0].astype(np.int64),
                                         n_partitions)
        sorted_facts = facts[order]
        sorted_times = (np.asarray(event_times, np.float64)[order]
                        if event_times is not None else None)
        n_hit = sum(1 for p in range(n_partitions)
                    if bounds[p + 1] > bounds[p])
        with self._lock:
            self.rows_loaded += n
            self.load_calls += n_hit     # one logical append per partition
            self._commit(sorted_facts, sorted_times, rollup, routing_epoch)
        return n

    # -------------------------------------------------------------- read paths
    def read_view(self) -> WarehouseView:
        """Pin the committed state at the current commit boundary. The
        returned chunks are the loaded arrays themselves (append-only, by
        convention never mutated) — pinning costs one tuple copy."""
        with self._lock:
            return WarehouseView(chunks=tuple(self._chunk_log),
                                 seq=self.commit_seq, rows=self.rows_loaded)

    def kpi_running(self) -> Optional[np.ndarray]:
        """The running per-unit KPI aggregate [n_units, 5] accumulated from
        the fused ``transform_and_rollup`` dispatches at load time — an
        O(1) read that never rescans the fact table. Returns None when any
        committed rows arrived without a rollup (legacy per-partition
        loops, the baseline), because the aggregate would under-count;
        ``kpi_rollup`` below remains the full-rescan oracle it is
        parity-tested against."""
        with self._lock:
            if self._kpi_running is None or self._kpi_gap_rows:
                return None
            return self._kpi_running.copy()

    def kpi_rollup(self, n_units: int, backend=None,
                   view: Optional[WarehouseView] = None) -> np.ndarray:
        """Per-equipment KPI sums [n_units, 5] (availability, performance,
        quality, oee, count) via the compute backend's segmented reduce —
        the full-rescan reference the serving layer's incremental views
        are parity-tested against. Selection: explicit arg > the
        pipeline's configured backend > env/default."""
        from repro_torch.core.backend import get_backend
        be = get_backend(backend or self.backend)
        return be.segment_reduce(self.fact_table(view), n_units)

    def fact_table(self, view: Optional[WarehouseView] = None) -> np.ndarray:
        if view is None:
            view = self.read_view()
        if not view.chunks:
            return np.zeros((0, len(FACT_COLUMNS)), np.float32)
        return np.concatenate(view.chunks)

    def canonical_fact_table(self, view: Optional[WarehouseView] = None
                             ) -> np.ndarray:
        """Fact table in a load-order-independent canonical order (full-row
        lexicographic sort). Two runs produced the same warehouse iff their
        canonical tables are byte-identical — the concurrency test's
        equality oracle, immune to thread interleaving of loads."""
        t = self.fact_table(view)
        if not len(t):
            return t
        return t[np.lexsort(t.T[::-1])]

    def query_oee(self, equipment_id: Optional[int] = None,
                  view: Optional[WarehouseView] = None) -> Dict[str, float]:
        """OLAP aggregate: mean KPI per (optionally one) equipment unit.
        Pass one ``read_view()`` across several calls to make a multi-query
        report consistent under concurrent loads."""
        t = self.fact_table(view)
        if equipment_id is not None:
            t = t[t[:, 0].astype(np.int64) == equipment_id]
        if len(t) == 0:
            return {k: float("nan") for k in
                    ("availability", "performance", "quality", "oee", "rows")}
        return {
            "availability": float(t[:, 3].mean()),
            "performance": float(t[:, 4].mean()),
            "quality": float(t[:, 5].mean()),
            "oee": float(t[:, 6].mean()),
            "rows": float(len(t)),
        }
