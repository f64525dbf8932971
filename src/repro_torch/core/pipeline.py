"""DOD-ETL pipeline orchestration (paper Fig. 2).

Wires Change Tracker -> Message Queue -> Stream Processor (In-memory Table
Updater + Data Transformer + Target Database Updater) for one worker set,
with the paper's fault-tolerance semantics: restartable consumption
(committed offsets), compacted-snapshot cache recovery, replicated late
buffer, and the cache-reset trigger on partition reassignment.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.dod_etl import ETLConfig
from repro_torch.core.backend import get_backend
from repro_torch.core.buffer import DeadLetterBuffer, OperationalMessageBuffer
from repro_torch.core.cache import InMemoryTable
from repro_torch.core.cdc import SourceDatabase
from repro_torch.core.listener import ChangeTracker
from repro_torch.core.message_queue import MessageQueue
from repro_torch.core.loader import StarSchemaWarehouse
from repro_torch.core.partitioning import (PartitionAssignment, RoutingTable,
                                     get_strategy, isin_sorted, partition_of)
from repro_torch.core.records import RecordBatch
from repro_torch.core.transformer import DataTransformer
from repro_torch.durability.faults import (COMMIT_POST, INGEST_FETCH,
                                     LOAD_PRE_COMMIT, NULL_INJECTOR,
                                     REPARTITION_MID, TRANSFORM_DONE)
from repro_torch.observability.health import build_pipeline_health
from repro_torch.observability.registry import MetricsRegistry, MetricsShard
from repro_torch.observability.tracer import NULL_TRACER


@dataclasses.dataclass
class StageMetrics:
    records: int = 0
    wall_s: float = 0.0

    @property
    def rate(self) -> float:
        return self.records / self.wall_s if self.wall_s > 0 else 0.0


@dataclasses.dataclass
class CacheMigrationStats:
    """One surgical cache migration: what survived, what moved, what the
    (now gained-keys-only) snapshot dump cost."""

    retained_rows: int = 0       # master rows kept across the migration
    dropped_rows: int = 0        # rows of moved-away key ranges
    gained_rows: int = 0         # rows dumped for newly owned keys
    dump_s: float = 0.0
    prev_keys: int = 0
    new_keys: int = 0
    gained_keys: int = 0

    @property
    def retention(self) -> float:
        """Fraction of pre-migration cache rows retained (1.0 when the
        cache was empty — nothing to lose)."""
        total = self.retained_rows + self.dropped_rows
        return self.retained_rows / total if total else 1.0

    def merge(self, other: "CacheMigrationStats") -> "CacheMigrationStats":
        return CacheMigrationStats(
            self.retained_rows + other.retained_rows,
            self.dropped_rows + other.dropped_rows,
            self.gained_rows + other.gained_rows,
            self.dump_s + other.dump_s,
            self.prev_keys + other.prev_keys,
            self.new_keys + other.new_keys,
            self.gained_keys + other.gained_keys)


def migration_summary(epoch: int, moved_key_fraction: float,
                      stats: CacheMigrationStats,
                      initial_rows: int) -> Dict[str, float]:
    """One migration's user-facing stats dict, shared by the sequential
    and concurrent coordinators. ``cache_retention`` is computed against
    the PRE-migration row count: a multi-phase migration (reroute, then
    ownership rebalance) runs ``migrate_caches`` more than once per
    worker, and summing the per-phase ``retained_rows`` would count every
    surviving row once per phase — only the drops are additive."""
    retained = max(initial_rows - stats.dropped_rows, 0)
    retention = retained / initial_rows if initial_rows else 1.0
    return {"epoch": epoch,
            "moved_key_fraction": round(moved_key_fraction, 4),
            "cache_retention": round(retention, 4),
            "retained_rows": retained,
            "dropped_rows": stats.dropped_rows,
            "gained_rows": stats.gained_rows,
            "dump_s": round(stats.dump_s, 6)}


class StreamProcessorWorker:
    """One Stream Processor node: assigned business-key partitions, local
    in-memory caches (filtered by assigned keys), transformer + loader.

    Hot path is COALESCED: every step consumes all assigned partitions into
    one columnar batch and issues ONE device dispatch through the compute
    backend; facts split back per partition only at ``warehouse.load`` time.
    """

    def __init__(self, name: str, cfg: ETLConfig, queue: MessageQueue,
                 warehouse: StarSchemaWarehouse, join_depth: int = 1,
                 backend=None):
        self.name = name
        self.cfg = cfg
        self.queue = queue
        self.warehouse = warehouse
        self.backend = get_backend(backend or cfg.backend or None)
        self._partitions: List[int] = []
        self._bkeys_memo: Dict[int, tuple] = {}   # n_keys -> (sig, keys)
        # routing-epoch awareness: the pipeline points these at its
        # operational topics so the worker's business-key filter covers the
        # UNION of live routing epochs (records published under a draining
        # old epoch keep finding their master rows). None = legacy static.
        self._routing_topics: Optional[List[str]] = None
        self._pending_tables: tuple = ()   # tables acked but not yet switched
        self.equipment = InMemoryTable(cfg.cache_slots, cfg.cache_row_width,
                                       backend=self.backend)
        self.quality = InMemoryTable(cfg.cache_slots, cfg.cache_row_width,
                                     backend=self.backend)
        self.buffer = OperationalMessageBuffer(cfg.buffer_capacity)
        # poison-record quarantine: records whose transform deterministically
        # raises are parked here (offsets committed) instead of crash-looping
        self.dead_letter = DeadLetterBuffer()
        # n_units wires the fused transform_and_rollup: every transform
        # dispatch also carries the per-unit KPI aggregate (equipment ids
        # ARE the business keys), feeding warehouse.kpi_running in O(1)
        self.transformer = DataTransformer(self.equipment, self.quality,
                                           self.buffer, join_depth,
                                           backend=self.backend,
                                           n_units=cfg.n_business_keys)
        self.metrics = StageMetrics()
        self.group = f"sp.{name}"
        # fault seams (tests): the pipeline points this at its injector;
        # the default never trips (one dict get per seam)
        self.fault = NULL_INJECTOR
        # observability seams, same pattern: the pipeline swaps in its
        # tracer/registry shard; the defaults are free-standing no-ops
        self.tracer = NULL_TRACER
        self.mshard: MetricsShard = MetricsShard(name)
        self._bind_instruments()

    def attach_metrics(self, shard: MetricsShard) -> None:
        """Point this worker's instruments at the pipeline registry's
        shard (one read path for cluster-wide totals)."""
        self.mshard = shard
        self._bind_instruments()

    def _bind_instruments(self) -> None:
        shard = self.mshard
        self._c_hits = shard.counter("worker.cache_hits")
        self._c_misses = shard.counter("worker.cache_misses")
        self._c_dead = shard.counter("worker.dead_lettered")
        shard.gauge_fn("buffer_occupancy", lambda: len(self.buffer))
        shard.gauge_fn("dead_letter_occupancy", lambda: len(self.dead_letter))
        shard.gauge_fn("cache_rows",
                       lambda: self.equipment.n_rows + self.quality.n_rows)

    # ----------------------------------------------------------- cache mgmt
    @property
    def partitions(self) -> tuple:
        # a copy: in-place mutation would bypass the setter and leave the
        # business-key memo stale
        return tuple(self._partitions)

    @partitions.setter
    def partitions(self, value) -> None:
        self._partitions = list(value)
        self._bkeys_memo.clear()     # reassignment invalidates the key memo

    def set_pending_tables(self, tables) -> None:
        """Routing tables the coordinator has announced but not yet
        switched publishers to (phase 1 of an epoch migration): the
        business-key filter covers them so the worker is ready before the
        first record routed by the new epoch exists."""
        self._pending_tables = tuple(tables)

    def _routing_sig(self):
        """Memo key: changes whenever a routing epoch advances/retires or
        a pending (acked-but-unswitched) table appears."""
        if self._routing_topics is None:
            return None
        return (tuple(self.queue.topics[t].routing_signature()
                      for t in self._routing_topics),
                tuple(t.epoch for t in self._pending_tables))

    def _live_tables(self) -> List[RoutingTable]:
        """Routing tables whose records this worker may still encounter:
        every operational topic's live epochs plus any pending table the
        coordinator has announced but not yet switched to (operational
        topics share one routing timeline, so tables dedupe by epoch)."""
        tables: Dict[int, RoutingTable] = {}
        for t in self._routing_topics:
            for tab in self.queue.topics[t].live_tables():
                tables[tab.epoch] = tab
        for tab in self._pending_tables:
            tables[tab.epoch] = tab
        return list(tables.values())

    def assigned_business_keys(self, n_business_keys: int) -> np.ndarray:
        """Sorted i64 array of this worker's business keys — every key any
        LIVE routing epoch maps into an owned partition — memoized until
        the partition assignment or a routing epoch changes (no per-pump
        set rebuilds)."""
        sig = self._routing_sig()
        entry = self._bkeys_memo.get(n_business_keys)
        if entry is not None and entry[0] == sig:
            return entry[1]
        keys = np.arange(n_business_keys, dtype=np.int64)
        if self._routing_topics is None:     # legacy static fallback
            parts = partition_of(keys, self.cfg.n_partitions)
            mask = np.isin(parts, np.asarray(self._partitions, np.int32))
        else:
            mask = np.zeros(n_business_keys, bool)
            owned = np.asarray(sorted(self._partitions), np.int64)
            for tab in self._live_tables():
                mask |= isin_sorted(owned,
                                    tab.partition_of(keys).astype(np.int64))
        memo = keys[mask]            # arange slice => already sorted
        self._bkeys_memo[n_business_keys] = (sig, memo)
        return memo

    def _filter_assigned(self, batch: RecordBatch) -> RecordBatch:
        """Vectorized business-key membership via binary search against the
        memoized sorted key array (replaces per-pump ``np.isin`` on a
        freshly rebuilt Python set)."""
        bkeys = self.assigned_business_keys(self.cfg.n_business_keys)
        if not len(bkeys):
            return RecordBatch.empty()
        return batch.filter(isin_sorted(bkeys, batch.business_key))

    def reset_caches(self, master_topics: Dict[str, str],
                     n_business_keys: int) -> float:
        """The paper's trigger: on (re)assignment, dump compacted snapshots
        filtered by assigned business keys. Returns dump seconds (Fig. 4)."""
        bkeys = self.assigned_business_keys(n_business_keys)
        total = 0.0
        for cache, topic_name in (
                (self.equipment, master_topics["equipment"]),
                (self.quality, master_topics["quality"])):
            topic = self.queue.topics[topic_name]
            rks, pls, tts = topic.snapshot(bkeys)
            # quality cache joins by prod_id (payload col 3); equipment by
            # business key (payload col 1)
            if cache is self.quality and len(rks):
                join_keys = pls[:, 3].astype(np.int64)
            elif len(rks):
                join_keys = pls[:, 1].astype(np.int64)
            else:
                join_keys = rks
            total += cache.reset_from_snapshot(join_keys, pls, tts)
        return total

    def migrate_caches(self, master_topics: Dict[str, str],
                       n_business_keys: int,
                       prev_bkeys: np.ndarray) -> CacheMigrationStats:
        """SURGICAL replacement for the reset-everything trigger: retain
        cached master rows for business keys still owned under any live
        routing epoch, drop only the moved-away ranges, and dump from the
        compacted master topics ONLY the keys gained since ``prev_bkeys``
        — so a survivor that merely gains (or loses) a slice of the key
        space keeps its cache warm instead of re-dumping the world (the
        post-rebalance throughput crater PR 2 measured)."""
        t0 = time.perf_counter()
        new_bkeys = self.assigned_business_keys(n_business_keys)
        gained = np.setdiff1d(new_bkeys, prev_bkeys)
        stats = CacheMigrationStats(prev_keys=len(prev_bkeys),
                                    new_keys=len(new_bkeys),
                                    gained_keys=len(gained))
        for cache, topic_name in (
                (self.equipment, master_topics["equipment"]),
                (self.quality, master_topics["quality"])):
            kept, dropped = cache.retain_only(new_bkeys)
            stats.retained_rows += kept
            stats.dropped_rows += dropped
            if len(gained):
                rks, pls, tts = self.queue.topics[topic_name].snapshot(gained)
                if len(rks):
                    if cache is self.quality:
                        join_keys = pls[:, 3].astype(np.int64)
                    else:
                        join_keys = pls[:, 1].astype(np.int64)
                    cache.upsert(join_keys, pls, tts)
                    stats.gained_rows += len(rks)
        stats.dump_s = time.perf_counter() - t0
        return stats

    # ----------------------------------------------------- master ingestion
    def pump_master(self, topic: str, cache: InMemoryTable,
                    max_records: Optional[int] = None) -> int:
        """In-memory Table Updater: consume ALL master partitions as one
        coalesced batch, filter by assigned business keys (vectorized),
        upsert into the local cache in one pass."""
        batch, counts = self.queue.consume_many(
            self.group, topic, self.partitions_for_master(topic), max_records)
        for p, c in counts.items():
            self.queue.commit(self.group, topic, p, c)
        if not len(batch):
            return 0
        mine = self._filter_assigned(batch)
        if not len(mine):
            return 0
        if cache is self.quality:
            join_keys = mine.payload[:, 3].astype(np.int64)
        else:
            join_keys = mine.payload[:, 1].astype(np.int64)
        cache.upsert(join_keys, mine.payload, mine.txn_time)
        return len(mine)

    def partitions_for_master(self, topic: str) -> List[int]:
        # master topics are row-key partitioned: a worker's business keys can
        # live in any partition, so every worker consumes all partitions and
        # filters (exactly the paper's design — the filter is the key step)
        return list(range(self.queue.topics[topic].cfg.n_partitions))

    # ------------------------------------------------------------ transform
    def fetch_operational(self, topic: str, max_records: Optional[int] = None
                          ) -> Tuple[RecordBatch, Dict[int, int]]:
        """Position-advancing coalesced read of this worker's partitions,
        WITHOUT committing (the concurrent runtime's ingest stage; commits
        happen after warehouse load in its load stage). Returns
        (batch, {partition: records_read})."""
        return self.queue.fetch_many(self.group, topic, self.partitions,
                                     max_records)

    def process_operational(self, topic: str, max_records: Optional[int] = None
                            ) -> int:
        """One micro-batch step over this worker's partitions: coalesced
        consume -> ONE fused transform+rollup dispatch (device-resident
        ``FactBlock``) -> materialize at the warehouse-load boundary ->
        split facts per partition at load time, folding the fused per-unit
        KPI rollup into the warehouse's running aggregate. ``max_records``
        still bounds each partition's read so offset/rebalance semantics
        are unchanged."""
        t0 = time.perf_counter()
        with self.tracer.span("ingest.fetch") as sp:
            batch, counts = self.queue.consume_many(
                self.group, topic, self.partitions, max_records)
            if not len(batch):
                sp.drop()                # keep idle polls out of the trace
        self.fault.trip(INGEST_FETCH)
        buffered0 = self.buffer.total_buffered
        with self.tracer.span("transform.dispatch") as sp:
            block, merged = self.transformer.process_block(batch)
            if block is None:
                sp.drop()
        if block is None:                # counts is empty on this path
            self.metrics.wall_s += time.perf_counter() - t0
            return 0
        self.fault.trip(TRANSFORM_DONE)
        block.start_host_copy()          # D2H rides behind the compute
        with self.tracer.span("load.commit") as sp:
            facts, _ = self.transformer.finish(block, merged)
            done = self.warehouse.load_partitioned(
                facts, self.cfg.n_partitions, rollup=block.rollup_host(),
                routing_epoch=self.queue.topics[topic].routing.epoch)
            self.fault.trip(LOAD_PRE_COMMIT)
            # commit AFTER the warehouse load (crash-consistency: a death
            # between load and commit re-serves the records, but recovery
            # rolls the warehouse back to its checkpoint first, so nothing
            # double-loads; committing first would LOSE records instead —
            # same order the concurrent runtime's load stage has always
            # used)
            for p, c in counts.items():
                self.queue.commit(self.group, topic, p, c)
            sp.put("records", done)
        self.fault.trip(COMMIT_POST)
        # join-level cache accounting: a loaded fact's probes all hit; a
        # record deferred to the late buffer missed its master rows
        self._c_hits.inc(done)
        self._c_misses.inc(self.buffer.total_buffered - buffered0)
        self.metrics.records += done
        self.metrics.wall_s += time.perf_counter() - t0
        return done


class DODETLPipeline:
    """Single-process pipeline over a worker set (the distributed runtime in
    ``repro.runtime`` schedules the same workers with failures/elasticity)."""

    def __init__(self, cfg: ETLConfig, source: SourceDatabase,
                 n_workers: int = 1, join_depth: int = 1, backend=None,
                 fault=None, tracer=None, metrics=None,
                 device: str = "cuda"):
        self.cfg = cfg
        self.source = source
        # device places the torch backend ("cuda" unless the caller asks
        # for the CPU; absent CUDA raises rather than falling back)
        self.backend = get_backend(backend or cfg.backend or None,
                                   device=device)
        # deterministic fault injection (tests): shared by every worker and
        # the repartition coordinator; the default injector never trips
        self.fault = fault or NULL_INJECTOR
        # observability plane: one registry per pipeline (workers, broker
        # topics and the coordinator all shard off it) and one tracer
        # shared by every stage seam — both default to free no-ops
        self.tracer = tracer or NULL_TRACER
        self.metrics = metrics or MetricsRegistry()
        self._coord_shard = self.metrics.shard("coordinator")
        self._c_repartitions = self._coord_shard.counter(
            "pipeline.repartitions")
        self._c_rebalances = self._coord_shard.counter("pipeline.rebalances")
        self._coord_shard.gauge_fn(
            "routing_epoch", lambda: self.current_routing().epoch)
        self.queue = MessageQueue(metrics=self.metrics)
        self.tracker = ChangeTracker(cfg, source.log, self.queue)
        self.warehouse = StarSchemaWarehouse(backend=self.backend)
        self.operational_topics = [self.tracker.topic_of(t.name)
                                   for t in cfg.operational_tables]
        self.master_topic_map = self._master_topics()
        # pluggable partitioning: operational topics share ONE routing
        # timeline produced by the configured strategy ("static" keeps the
        # exact legacy hash%n behavior at epoch 0)
        self.strategy = get_strategy(cfg.partition_strategy)
        table = self.strategy.initial_table(cfg.n_partitions)
        for t in self.operational_topics:
            self.queue.topics[t].set_routing(table)
        self.workers = [self._new_worker(f"w{i}", join_depth)
                        for i in range(n_workers)]
        self.assignment = PartitionAssignment(
            cfg.n_partitions, [w.name for w in self.workers])
        self._apply_assignment()

    def _new_worker(self, name: str,
                    join_depth: int = 1) -> StreamProcessorWorker:
        w = StreamProcessorWorker(name, self.cfg, self.queue, self.warehouse,
                                  join_depth, backend=self.backend)
        w._routing_topics = self.operational_topics
        w.fault = self.fault
        w.tracer = self.tracer
        w.attach_metrics(self.metrics.shard(name))
        return w

    def _master_topics(self) -> Dict[str, str]:
        """Logical master role -> topic. The simple schema has 'equipment'
        and 'quality'; the ISA-95 complex schema maps its first two master
        tables onto those roles (extra tables exercise join_depth)."""
        masters = [t for t in self.cfg.tables if t.nature == "master"]
        eq = next((t for t in masters if "equipment" in t.name), masters[0])
        qu = next((t for t in masters if "quality" in t.name), masters[-1])
        return {"equipment": self.tracker.topic_of(eq.name),
                "quality": self.tracker.topic_of(qu.name)}

    def _apply_assignment(self):
        for w in self.workers:
            w.partitions = self.assignment.partitions_of(w.name)

    # ------------------------------------------------------------- running
    def extract(self, limit_per_table: Optional[int] = None) -> int:
        return self.tracker.poll_all(limit_per_table)

    def bootstrap_caches(self) -> float:
        """Initial snapshot dump for every worker (Fig. 4 overhead)."""
        total = 0.0
        for w in self.workers:
            total += w.reset_caches(self.master_topic_map,
                                    self.cfg.n_business_keys)
        return total

    def step(self, max_records_per_partition: Optional[int] = None) -> int:
        """One streaming micro-batch across all workers: pump master topics
        into caches, then transform operational partitions."""
        done = 0
        for w in self.workers:
            w.pump_master(self.master_topic_map["equipment"], w.equipment)
            w.pump_master(self.master_topic_map["quality"], w.quality)
        for w in self.workers:
            for topic in self.operational_topics:
                done += w.process_operational(topic,
                                              max_records_per_partition)
        return done

    def run_to_completion(self, max_steps: int = 1000) -> int:
        total = 0
        stalls = 0
        for _ in range(max_steps):
            n = self.step()
            total += n
            buffered = sum(len(w.buffer) for w in self.workers)
            if n == 0 and buffered == 0:
                break
            # stall: buffered records whose master data never arrives keep
            # waiting on the watermark (paper semantics); don't spin
            stalls = stalls + 1 if n == 0 else 0
            if stalls >= 3:
                break
        return total

    # ---------------------------------------------------- routing epochs
    def current_routing(self) -> RoutingTable:
        """The operational topics' shared routing table (current epoch)."""
        return self.queue.topics[self.operational_topics[0]].routing

    def _committed_by_partition(self, topic: str) -> Dict[int, int]:
        group_of = {w.name: w.group for w in self.workers}
        out: Dict[int, int] = {}
        for p, owner in self.assignment.assignment.items():
            g = group_of.get(owner)
            out[p] = self.queue.committed(g, topic, p) if g else 0
        return out

    def retire_routing(self) -> bool:
        """Drop routing epochs whose records are fully committed; when any
        retire, buffered late records are re-homed so none starves at a
        worker about to release the retired epoch's key ranges."""
        retired = False
        for t in self.operational_topics:
            retired |= self.queue.topics[t].retire_epochs(
                self._committed_by_partition(t))
        if retired:
            self._rehome_buffers()
        return retired

    def _rehome_buffers(self) -> None:
        """Re-home every buffered late record to its business key's owner
        under the CURRENT routing epoch (replicated-store semantics)."""
        merged = RecordBatch.concat([w.buffer.drain() for w in self.workers])
        if not len(merged):
            return
        parts = self.current_routing().partition_of(
            merged.business_key).astype(np.int64)
        owner_of = self.assignment.assignment
        for w in self.workers:
            owned = np.asarray(sorted(
                p for p, o in owner_of.items() if o == w.name), np.int64)
            w.buffer.push(merged.filter(isin_sorted(owned, parts)))

    def backlog_weights(self) -> np.ndarray:
        """Per-partition UNDRAINED record counts (high watermark minus the
        owner's committed offset, summed over operational topics). The
        backlog sits wherever its publication epoch routed it — a
        load-aware reassignment must weigh it in, or the old hot
        partitions' drain work lands on one worker."""
        w = np.zeros(self.assignment.n_partitions)
        for t in self.operational_topics:
            committed = self._committed_by_partition(t)
            parts = self.queue.topics[t].partitions
            for p in range(min(len(parts), len(w))):
                w[p] += max(0, parts[p].length - committed.get(p, 0))
        return w

    def observed_loads(self):
        """(per-partition publish counts, business keys, per-key counts)
        aggregated over the operational topics — the skew strategy's
        input, straight from the broker's publish counters."""
        part_loads = np.zeros(self.assignment.n_partitions, np.int64)
        key_tot: Dict[int, int] = {}
        for t in self.operational_topics:
            pl, ks, cs = self.queue.topics[t].load_stats()
            part_loads[:len(pl)] += pl
            for k, c in zip(ks.tolist(), cs.tolist()):
                key_tot[k] = key_tot.get(k, 0) + c
        keys = np.fromiter(key_tot.keys(), np.int64, len(key_tot))
        counts = np.fromiter(key_tot.values(), np.int64, len(key_tot))
        return part_loads, keys, counts

    def repartition(self) -> Dict[str, float]:
        """Adaptive repartition (sequential runtime): observe load → new
        routing epoch from the strategy → workers pre-migrate caches
        surgically for the superset of live epochs → topics switch →
        load-aware sticky partition reassignment with exactly-once offset
        transfer → buffers re-homed. Returns migration stats."""
        self.retire_routing()
        initial_rows = sum(w.equipment.n_rows + w.quality.n_rows
                           for w in self.workers)
        part_loads, keys, counts = self.observed_loads()
        cur = self.current_routing()
        new_table = self.strategy.rebalanced_table(cur, part_loads,
                                                   (keys, counts))
        stats = CacheMigrationStats()
        moved = 0.0
        if new_table.epoch != cur.epoch:
            # phase 1: workers prepare — their key filter grows to the
            # union of live + pending epochs and caches migrate surgically
            with self.tracer.span("repartition.prepare"):
                for w in self.workers:
                    prev = w.assigned_business_keys(self.cfg.n_business_keys)
                    w.set_pending_tables((new_table,))
                    stats = stats.merge(w.migrate_caches(
                        self.master_topic_map, self.cfg.n_business_keys,
                        prev))
            # phase 2: atomically switch the publish epoch
            with self.tracer.span("repartition.epoch_switch"):
                for t in self.operational_topics:
                    self.queue.topics[t].set_routing(new_table)
                for w in self.workers:
                    w.set_pending_tables(())
            # sharded serving plane: shard ownership follows the routing
            # epoch — only moved segments/warehouse chunks migrate (the
            # mesh twin of the workers' surgical cache migration)
            srv = self.warehouse._serving
            if srv is not None and hasattr(srv, "reown"):
                with self.tracer.span("repartition.shard_reown"):
                    srv.reown(new_table)
                    self.warehouse.reown_shards(srv.ownership)
            # mid-repartition crash seam: new epoch published, ownership
            # not yet rebalanced — the hardest recovery window (a restart
            # must resume with the new epoch live AND re-run the rebalance)
            self.fault.trip(REPARTITION_MID)
            moved = cur.moved_fraction(
                new_table, np.arange(self.cfg.n_business_keys))
        # phase 3: rebalance partition ownership, transferring offsets
        # exactly-once. Weight = undrained backlog (sitting wherever its
        # publication epoch routed it) + expected future arrivals (the
        # observed key rates mapped through the NEW table)
        weights = self.backlog_weights()
        if len(keys):
            np.add.at(weights,
                      self.current_routing().partition_of(keys), counts)
        with self.tracer.span("repartition.rebalance"):
            stats = stats.merge(self._rebalance_and_transfer(
                list(self.workers), weights=weights, surgical=True))
            self._rehome_buffers()
        self._c_repartitions.inc()
        return migration_summary(self.current_routing().epoch, moved,
                                 stats, initial_rows)

    # ------------------------------------------------------ fault tolerance
    def _rebalance_and_transfer(self, prior_workers, weights=None,
                                surgical: bool = False) -> CacheMigrationStats:
        """Reassign partitions across the current worker set; every
        partition whose owner changed transfers its committed offset to the
        new owner's consumer group (exactly-once handoff) and the new owner
        fires the cache-migration trigger (paper §3.2): the legacy full
        snapshot re-dump by default, the surgical retain+gained-only dump
        when ``surgical``. Returns aggregated migration stats (``dump_s``
        is the Fig. 4 re-dump cost)."""
        nbk = self.cfg.n_business_keys
        prev_bkeys = {w.name: w.assigned_business_keys(nbk)
                      for w in self.workers} if surgical else {}
        old_owner = {p: w for p, w in self.assignment.assignment.items()}
        old_groups = {w.name: w.group for w in prior_workers}
        self.assignment.rebalance([w.name for w in self.workers], weights)
        self._apply_assignment()
        self._c_rebalances.inc()
        for topic in self.operational_topics:
            for p, new_name in self.assignment.assignment.items():
                old_name = old_owner.get(p)
                if old_name is None or old_name == new_name:
                    continue
                old_group = old_groups.get(old_name)
                if old_group is None:
                    continue
                new_w = next(w for w in self.workers if w.name == new_name)
                committed = self.queue.committed(old_group, topic, p)
                own = self.queue.committed(new_w.group, topic, p)
                if committed > own:
                    self.queue.commit(new_w.group, topic, p, committed - own)
        stats = CacheMigrationStats()
        for w in self.workers:
            if surgical:
                stats = stats.merge(w.migrate_caches(
                    self.master_topic_map, nbk,
                    prev_bkeys.get(w.name, np.zeros(0, np.int64))))
            else:
                stats = stats.merge(CacheMigrationStats(
                    dump_s=w.reset_caches(self.master_topic_map, nbk)))
        return stats

    def fail_workers(self, names: List[str]) -> float:
        """Kill workers; coordinator reassigns; survivors adopt offsets and
        the failed workers' late buffers (replicated store)."""
        prior = list(self.workers)
        dead = [w for w in self.workers if w.name in names]
        self.workers = [w for w in self.workers if w.name not in names]
        if not self.workers:
            raise RuntimeError("all workers failed")
        redump = self._rebalance_and_transfer(prior).dump_s
        for d in dead:
            self.workers[0].buffer.push(d.buffer.drain())
        return redump

    def add_workers(self, n: int, join_depth: int = 1) -> float:
        """Elastic scale-up: new Stream Processor nodes join, partitions
        rebalance, caches re-dump filtered by the new key sets."""
        prior = list(self.workers)
        start = len(self.workers)
        for i in range(n):
            self.workers.append(self._new_worker(f"w{start + i}", join_depth))
        return self._rebalance_and_transfer(prior).dump_s

    # -------------------------------------------------------- observability
    def health(self) -> Dict:
        """One structured health snapshot (see
        ``repro.observability.health`` for the schema): per-worker
        throughput and cache state, commit lag per topic/partition,
        routing epoch, and the registry's merged counters."""
        return build_pipeline_health(self)

    def checkpoint(self) -> Dict:
        return {
            "offsets": self.queue.export_offsets(),
            "buffers": {w.name: w.buffer.export_state()
                        for w in self.workers},
            "listener_offsets": {l.table.name: l.offset
                                 for l in self.tracker.listeners},
        }

    def restore(self, state: Dict) -> None:
        self.queue.restore_offsets(state["offsets"])
        for w in self.workers:
            if w.name in state["buffers"]:
                w.buffer = OperationalMessageBuffer.restore(
                    state["buffers"][w.name], self.cfg.buffer_capacity)
                w.transformer.buffer = w.buffer
        for l in self.tracker.listeners:
            if l.table.name in state["listener_offsets"]:
                l.offset = state["listener_offsets"][l.table.name]
