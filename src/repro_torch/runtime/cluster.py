"""Cluster runtimes for the paper's distributed experiments (§3.1
"distributed, parallel"; §4.1.3 fault tolerance).

Two runtimes share the same Stream Processor workers:

``ConcurrentCluster`` — the real one. Every worker runs on its own executor
threads, with the per-worker ingest -> transform -> load stages decoupled
by bounded hand-off queues. Worker steps overlap where they wait on the
card or run native code that releases the interpreter lock (ctypes
launches, torch copies, numpy's bulk ops); their Python work is
serialized by that lock. On a card each worker
owns one CUDA stream, which all three of its stage threads enter: its
cache-mirror uploads, launches and frees stay ordered on that stream, and
no worker's launches queue behind another's. The serving engine's fold
thread and the batched query front have a stream each. Nothing on the
path waits on the whole device: a worker waits on its own ``FactBlock``
event or on a copy issued on its own stream. A coordinator owns the
``PartitionAssignment`` and performs *incremental* rebalances: only moved
partitions quiesce; healthy workers keep processing their retained
partitions throughout a failover or elastic resize. Exactly-once handoff
comes from the broker's position/commit split (fetch advances read
positions; commits land after warehouse load, under the worker's commit
lock), and §4.1.3's failure injection — kill workers mid-run under load —
loses no records and duplicates none. Every loaded record reports its
end-to-end freshness (load time minus the CDC append event-time stamp),
aggregated as p50/p95/p99.

``SimulatedCluster`` — the legacy modeled runtime: one thread executes all
workers serially per round and cluster time-per-round = max over workers
(a barrier model), with straggler/backup-task injection. Kept for the
deterministic round-based experiments; consistency results in both
runtimes are REAL (facts re-validated against a single-worker oracle).

Failure injection reproduces §4.1.3: killed workers trigger coordinator
rebalance -> cache-reset dumps on survivors -> throughput drop larger than
the node loss (the paper's observed 57% vs 40%).
"""
from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
import time
import warnings
from typing import Dict, Iterable, List, Optional, Set, Union

import numpy as np
import torch

from repro_torch.configs.dod_etl import ETLConfig
from repro_torch.core.backend import new_stream
from repro_torch.core.cdc import ChangeLog, SourceDatabase
from repro_torch.core.metrics import LatencyRecorder, percentiles_ms
from repro_torch.core.pipeline import DODETLPipeline, StreamProcessorWorker
from repro_torch.core.records import RecordBatch
from repro_torch.durability.faults import (COMMIT_POST, HEARTBEAT_MISS,
                                           INGEST_FETCH, LOAD_PRE_COMMIT,
                                           REPARTITION_MID, TRANSFORM_DONE,
                                           InjectedCrash)
from repro_torch.observability.health import build_cluster_health
from repro_torch.runtime.control import (ControlConfig, ControlPlane,
                                         CreditLedger, QuiesceTimeout,
                                         QuiesceTimeoutWarning)


@dataclasses.dataclass
class RoundStats:
    round_idx: int
    records: int
    worker_wall_s: Dict[str, float]
    cluster_wall_s: float          # max worker time (barrier model)
    cache_redump_s: float = 0.0
    n_workers: int = 0

    @property
    def rate(self) -> float:
        return self.records / self.cluster_wall_s if self.cluster_wall_s else 0.0


class SimulatedCluster:
    def __init__(self, pipeline: DODETLPipeline, *,
                 straggler_prob: float = 0.0,
                 straggler_slowdown: float = 3.0,
                 backup_tasks: bool = True,
                 seed: int = 0):
        self.pipe = pipeline
        self.rng = np.random.default_rng(seed)
        self.straggler_prob = straggler_prob
        self.straggler_slowdown = straggler_slowdown
        self.backup_tasks = backup_tasks
        self.history: List[RoundStats] = []
        self.stragglers_mitigated = 0

    def run_round(self, max_records_per_partition: Optional[int] = None
                  ) -> RoundStats:
        pipe = self.pipe
        for w in pipe.workers:
            w.pump_master(pipe.master_topic_map["equipment"], w.equipment)
            w.pump_master(pipe.master_topic_map["quality"], w.quality)
        walls: Dict[str, float] = {}
        records = 0
        for w in pipe.workers:
            t0 = time.perf_counter()
            for topic in pipe.operational_topics:
                records += w.process_operational(topic,
                                                 max_records_per_partition)
            wall = time.perf_counter() - t0
            # straggler model: occasionally a worker runs slow (paper's
            # 'low latency' requirement -> mitigation via backup execution)
            if self.rng.random() < self.straggler_prob:
                slow = wall * self.straggler_slowdown
                if self.backup_tasks:
                    # speculative backup on the least-loaded peer: pay the
                    # duplicate work, bound the tail at ~2x median
                    wall = min(slow, 2.0 * wall + 1e-9)
                    self.stragglers_mitigated += 1
                else:
                    wall = slow
            walls[w.name] = wall
        stats = RoundStats(
            round_idx=len(self.history), records=records,
            worker_wall_s=walls,
            cluster_wall_s=max(walls.values()) if walls else 0.0,
            n_workers=len(pipe.workers))
        self.history.append(stats)
        return stats

    def fail_workers(self, names: List[str]) -> float:
        """Inject §4.1.3's mid-run failure. Returns cache re-dump seconds
        (charged to the next round's wall time)."""
        redump = self.pipe.fail_workers(names)
        if self.history:
            self.history[-1].cache_redump_s += redump
        return redump

    def scale_to(self, n_workers: int) -> float:
        """Elastic resize (paper §3.2 'cluster scales up or down')."""
        pipe = self.pipe
        cur = len(pipe.workers)
        if n_workers < cur:
            return self.fail_workers(
                [w.name for w in pipe.workers[n_workers:]])
        if n_workers > cur:
            return pipe.add_workers(n_workers - cur)
        return 0.0

    def throughput(self, last_n: int = 5) -> float:
        h = self.history[-last_n:]
        rec = sum(s.records for s in h)
        wall = sum(s.cluster_wall_s + s.cache_redump_s for s in h)
        return rec / wall if wall else 0.0


# ===================================================================== real
# concurrency below: the genuinely parallel runtime (ConcurrentCluster)

# shared with the serving layer so freshness and report staleness are the
# same estimator on the same clock (repro.core.metrics)
_percentiles_ms = percentiles_ms


@dataclasses.dataclass
class _Work:
    """Ingest -> transform hand-off: one coalesced fetch (uncommitted)."""
    topic: str
    batch: RecordBatch
    counts: Dict[int, int]


@dataclasses.dataclass
class _Transformed:
    """Transform -> load hand-off: a device-resident ``FactBlock`` awaiting
    the atomic load+commit. The transform stage never blocks on the
    dispatch — the block materializes to host in the LOAD stage (the
    step's single device sync), so device compute and the async D2H copy
    overlap this worker's load-side host work (queue commits, partition
    split, buffer accounting) instead of serializing behind it.

    ``batch``/``block`` carry only the transformable records; ``dead``
    (usually None) carries poison records the transform stage isolated —
    the load stage quarantines them to the worker's dead-letter buffer
    and still commits their offsets (quarantined == handled)."""
    topic: str
    batch: RecordBatch
    counts: Dict[int, int]
    block: object                   # repro.core.backend.FactBlock (or None
                                    # when every record in the batch was
                                    # poison)
    dead: object = None             # RecordBatch of quarantined records


@dataclasses.dataclass
class _Control:
    """Coordinator -> worker control-plane message (applied by the ingest
    stage at its loop head, never mid-fetch)."""
    kind: str                       # "revoke" | "grant" | "reroute"
    partitions: Set[int]
    ack: threading.Event = dataclasses.field(default_factory=threading.Event)
    fetched_at_ack: int = 0         # revoke: in-flight quiesce horizon
    redump_s: float = 0.0           # grant/reroute: cache-migration cost
    tables: tuple = ()              # reroute: incoming routing tables
    stats: object = None            # grant/reroute: CacheMigrationStats


class WorkerRuntime:
    """One Stream Processor node's executor: three stage threads (ingest,
    transform, load) around a ``StreamProcessorWorker``, decoupled by
    bounded hand-off queues.

      ingest    pumps master topics into the worker caches, then fetches
                operational partitions (advancing broker READ positions,
                committing nothing) and hands each coalesced batch off;
      transform one backend dispatch per hand-off batch (GIL released in
                the numeric core, so transforms of different workers
                genuinely overlap);
      load      the ONLY mutating stage: under the worker's commit lock it
                buffers late records, loads facts, commits offsets and
                records freshness samples — one atomic unit, so a kill
                (which takes the same lock) can never observe a record
                half-accounted.

    Retry of buffered late records runs in the load stage too (pop -> probe
    -> load -> re-buffer under the commit lock), preserving the same
    atomicity for the §3.2 unsynchronized-consistency path.

    ``stream``: the worker's CUDA stream (None off the card), entered by
    all three stage threads. The transform stage and the load stage's
    retry sweep both pin cache snapshots, which may upload new device
    mirrors on the current stream, and both launch kernels that read
    them; on one stream every upload precedes the kernels that read it,
    and a freed mirror is reused only behind them.
    """

    _QUEUE_POLL_S = 0.05
    _YIELD_S = 0.02              # longest a load stage waits for a capture

    def __init__(self, worker: StreamProcessorWorker, pipe: DODETLPipeline,
                 max_records_per_partition: Optional[int] = None,
                 captures: Optional["PendingCaptures"] = None):
        self.worker = worker
        self.pipe = pipe
        self.cap = max_records_per_partition
        self.captures = captures or PendingCaptures()
        self.stream = new_stream(worker.backend)
        depth = max(1, pipe.cfg.handoff_depth)
        self.transform_q: "queue_mod.Queue[_Work]" = queue_mod.Queue(depth)
        self.load_q: "queue_mod.Queue[_Transformed]" = queue_mod.Queue(depth)
        self.control: "queue_mod.Queue[_Control]" = queue_mod.Queue()
        self.commit_lock = threading.Lock()
        self.cache_lock = threading.Lock()
        self.stop = threading.Event()
        self.dead = False
        self.fetched = 0             # hand-offs produced (ingest thread)
        self.completed = 0           # hand-offs retired  (load thread)
        self.records_done = 0
        # record-level flow accounting, one writer per field: the ingest
        # stage bounds every fetch by the late buffer's *headroom*
        # (capacity - buffered - in-flight), so even a 100%-late cold-start
        # backlog can never overflow the buffer and drop records
        self.records_fetched = 0     # ingest thread
        self.records_retired = 0     # load thread
        self.retry_inflight = 0      # load thread: records popped by a
                                     # retry sweep, not yet re-buffered
        self.records_dropped_ingest = 0      # shutdown-path drops only
        self.records_dropped_transform = 0
        self.items_dropped_ingest = 0        # ditto, item granularity
        self.items_dropped_transform = 0
        self.latency = LatencyRecorder()
        # credit-based backpressure: ingest takes before every fetch,
        # load refunds at retire time. Non-blocking by construction.
        self.credits = CreditLedger(pipe.cfg.credit_capacity)
        # stage heartbeats (perf_counter of each loop's last iteration):
        # the control plane's failure-detection input. Plain dict writes
        # (GIL-atomic) — ages surface as pull-mode gauges below.
        self.hb: Dict[str, float] = {}
        self.started_at: Optional[float] = None
        self._threads: List[threading.Thread] = []
        # observability: spans go to the pipeline's tracer (NULL_TRACER by
        # default — zero-overhead seam); the runtime shares the worker's
        # metrics shard, registers its freshness reservoir there (one read
        # path, no second sample copy) and exposes queue depths as
        # pull-mode gauges the hot path never touches
        self.tracer = pipe.tracer
        shard = pipe.metrics.shard(worker.name)
        self.mshard = shard
        shard.register_histogram("freshness", self.latency)
        shard.gauge_fn("transform_q_depth", self.transform_q.qsize)
        shard.gauge_fn("load_q_depth", self.load_q.qsize)
        shard.gauge_fn("in_flight", self.in_flight)
        shard.gauge_fn("credits_available", lambda: self.credits.available)
        for stage in ("ingest", "transform", "load"):
            shard.gauge_fn(f"heartbeat_age.{stage}",
                           lambda s=stage: self.heartbeat_age(s))

    # ---------------------------------------------------------------- state
    @property
    def alive(self) -> bool:
        return bool(self._threads) and not self.dead and not self.stop.is_set()

    def in_flight(self) -> int:
        return (self.fetched - self.completed - self.items_dropped_ingest
                - self.items_dropped_transform)

    def beat(self, stage: str) -> None:
        """Stage-loop heartbeat: every loop iterates at poll cadence even
        when idle, so a silent stage is hung or dead, never just bored.
        Also a fault seam — a ``hang`` scheduled at ``heartbeat.miss``
        freezes whichever stage thread reaches the ordinal (the grey
        failure the supervisor exists to detect)."""
        self.hb[stage] = time.perf_counter()
        self.pipe.fault.trip(HEARTBEAT_MISS)

    def heartbeat_age(self, stage: str) -> float:
        t = self.hb.get(stage)
        return time.perf_counter() - t if t is not None else -1.0

    def start(self) -> None:
        self.started_at = time.perf_counter()
        for stage in ("ingest", "transform", "load"):
            self.hb[stage] = self.started_at
        for fn, tag in ((self._ingest_loop, "ingest"),
                        (self._transform_loop, "transform"),
                        (self._load_loop, "load")):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"{self.worker.name}.{tag}")
            t.start()
            self._threads.append(t)

    def join(self, timeout: float = 5.0) -> List[str]:
        """Join the stage threads within one shared ``timeout`` budget.
        Threads still alive afterwards are *wedged* (hung in a fetch, a
        dispatch, or a fault-injected freeze): their names are returned,
        a ``QuiesceTimeoutWarning`` is emitted and ``worker.join_timeouts``
        counts them — a stop that strands a thread must never read as a
        clean success. The thread list is cleared either way; a wedged
        daemon thread can only no-op from here (its runtime is flagged
        dead and its consumer group is fenced by forced eviction)."""
        deadline = time.perf_counter() + timeout
        wedged: List[str] = []
        for t in self._threads:
            t.join(max(0.0, deadline - time.perf_counter()))
            if t.is_alive():
                wedged.append(t.name)
        self._threads = []
        if wedged:
            self.mshard.counter("worker.join_timeouts").inc(len(wedged))
            warnings.warn(
                f"{self.worker.name}: stage thread(s) still alive after "
                f"{timeout:.1f}s join: {', '.join(wedged)}",
                QuiesceTimeoutWarning, stacklevel=2)
        return wedged

    # ---------------------------------------------------------- stage plumbing
    def _put(self, q: "queue_mod.Queue", item) -> bool:
        while not self.stop.is_set():
            try:
                q.put(item, timeout=self._QUEUE_POLL_S)
                return True
            except queue_mod.Full:
                continue
        return False

    def _get(self, q: "queue_mod.Queue"):
        try:
            return q.get(timeout=self._QUEUE_POLL_S)
        except queue_mod.Empty:
            return None

    # ----------------------------------------------------------- stage: ingest
    def _apply_control(self) -> None:
        while True:
            try:
                msg = self.control.get_nowait()
            except queue_mod.Empty:
                return
            w = self.worker
            nbk = self.pipe.cfg.n_business_keys
            if msg.kind == "ping":
                # supervisor liveness probe: an ack proves the ingest
                # loop still drains controls (heartbeat freshness proves
                # the rest — see ControlPlane._supervise)
                msg.ack.set()
            elif msg.kind == "revoke":
                w.partitions = [p for p in w.partitions
                                if p not in msg.partitions]
                msg.fetched_at_ack = self.fetched
                msg.ack.set()
            elif msg.kind == "grant":
                with self.cache_lock:
                    # SURGICAL cache migration (replaces the reset-
                    # everything trigger): retain rows for still-owned
                    # keys, dump only the gained key ranges. In-flight
                    # work for just-revoked partitions may still probe the
                    # cache, so moved-away rows are dropped lazily — here,
                    # at the next key-set change, never mid-revoke.
                    prev = w.assigned_business_keys(nbk)
                    w.partitions = sorted(set(w.partitions) | msg.partitions)
                    msg.stats = w.migrate_caches(
                        self.pipe.master_topic_map, nbk, prev)
                    msg.redump_s = msg.stats.dump_s
                msg.ack.set()
            elif msg.kind == "reroute":
                with self.cache_lock:
                    # routing-epoch migration, phase 1: grow the key
                    # filter to the union of live + incoming epochs and
                    # migrate the caches surgically BEFORE the coordinator
                    # switches publishers to the new epoch, so no record
                    # ever arrives at a worker missing its master rows
                    prev = w.assigned_business_keys(nbk)
                    w.set_pending_tables(msg.tables)
                    msg.stats = w.migrate_caches(
                        self.pipe.master_topic_map, nbk, prev)
                    msg.redump_s = msg.stats.dump_s
                msg.ack.set()

    def _buffer_headroom(self) -> int:
        """Records we may still fetch without risking a late-buffer drop
        even if EVERY in-flight record turns out late."""
        in_flight = (self.records_fetched - self.records_retired
                     - self.records_dropped_ingest
                     - self.records_dropped_transform)
        return (self.pipe.cfg.buffer_capacity - len(self.worker.buffer)
                - in_flight - self.retry_inflight)

    def _ingest_loop(self) -> None:
        # InjectedCrash (a BaseException) kills just this stage thread —
        # the in-process analogue of the node dying mid-stage; the drill
        # waits on fault.tripped and abandons the cluster
        try:
            with torch.cuda.stream(self.stream):
                self._ingest_body()
        except InjectedCrash:
            return

    def _ingest_body(self) -> None:
        pipe, w = self.pipe, self.worker
        while not self.stop.is_set():
            self.beat("ingest")
            self._apply_control()
            with self.cache_lock:
                w.pump_master(pipe.master_topic_map["equipment"], w.equipment)
                w.pump_master(pipe.master_topic_map["quality"], w.quality)
            got = 0
            for topic in pipe.operational_topics:
                if self.stop.is_set():
                    break
                # backpressure, two ledgers: a fetch may return up to cap
                # records from EVERY owned partition, so the per-partition
                # cap must keep the worst case within the late buffer's
                # headroom — flooring it at 1 here would over-fetch and
                # let a 100%-late batch overflow the buffer (dropping
                # committed records for good). On top of that sits the
                # explicit credit ledger: credits are TAKEN here (never
                # blocking) and refunded by the load stage at retire time,
                # so a stalled downstream drains the ledger and ingest
                # simply stops fetching (and the extractor backs off).
                nparts = max(1, len(w.partitions))
                cap = self._buffer_headroom() // nparts
                if cap < 1:
                    break            # let retries drain the buffer first
                if self.cap is not None:
                    cap = min(cap, self.cap)
                grant = self.credits.take(cap * nparts)
                per_cap = grant // nparts
                if per_cap < 1:
                    self.credits.refund(grant)
                    break            # starved: wait for load-side refunds
                with self.tracer.span("ingest.fetch") as sp:
                    batch, counts = w.fetch_operational(topic, per_cap)
                    if not counts:
                        sp.drop()        # keep idle polling out of traces
                    else:
                        sp.put("records", len(batch))
                self.credits.refund(grant - len(batch))  # unused grant
                if counts:
                    self.records_fetched += len(batch)
                    pipe.fault.trip(INGEST_FETCH)   # fetched, uncommitted
                    self.fetched += 1
                    if not self._put(self.transform_q,
                                     _Work(topic, batch, counts)):
                        self.items_dropped_ingest += 1   # shutdown only
                        self.records_dropped_ingest += len(batch)
                        self.credits.refund(len(batch))
                    got += len(batch)
            if not got:
                time.sleep(pipe.cfg.idle_backoff_s)

    # -------------------------------------------------------- stage: transform
    def _transform_loop(self) -> None:
        try:
            with torch.cuda.stream(self.stream):
                self._transform_body()
        except InjectedCrash:
            return

    def _transform_body(self) -> None:
        device = self.worker.backend.device
        while True:
            self.beat("transform")
            item = self._get(self.transform_q)
            if item is None:
                if self.stop.is_set():
                    return
                continue
            # hold the cache lock only long enough to pin an immutable
            # snapshot; the dispatch itself runs lock-free, so the ingest
            # stage's master pumps overlap the numeric core instead of
            # queueing behind every dispatch
            with self.tracer.span("transform.dispatch") as sp:
                with self.cache_lock:
                    eq = self.worker.equipment.snapshot_view(device)
                    qu = self.worker.quality.snapshot_view(device)
                good, block, dead = self._transform_quarantine(
                    item.batch, eq, qu)
                sp.put("records", len(item.batch))
            self.pipe.fault.trip(TRANSFORM_DONE)   # transformed, unloaded
            if not self._put(self.load_q,
                             _Transformed(item.topic, good, item.counts,
                                          block, dead=dead)):
                self.items_dropped_transform += 1        # shutdown only
                self.records_dropped_transform += len(item.batch)
                self.credits.refund(len(item.batch))

    def _transform_quarantine(self, batch: RecordBatch, eq, qu):
        """ONE fused transform+rollup dispatch, NO host sync: the block
        is handed to the load stage device-resident, with the D2H copy
        enqueued asynchronously behind the compute.

        Poison handling: a transform that raises a plain ``Exception``
        (never ``InjectedCrash`` — drills must still kill the thread) is
        re-probed by bisection to isolate the records that
        deterministically fail. Good records keep their original order
        and proceed; poison records ride the hand-off in ``dead`` and
        are quarantined (offsets still committed) by the load stage —
        the worker never crash-loops on a bad record. Returns
        ``(good_batch, block_or_None, dead_batch_or_None)``."""
        tf = self.worker.transformer
        try:
            return batch, tf.transform_block(batch, eq, qu
                                             ).start_host_copy(), None
        except InjectedCrash:
            raise
        except Exception:
            pass
        good_idx: List[np.ndarray] = []
        dead_idx: List[np.ndarray] = []
        stack = [np.arange(len(batch))]
        while stack:
            idx = stack.pop()
            try:
                tf.transform_block(batch.take(idx), eq, qu)   # probe
                good_idx.append(idx)
            except InjectedCrash:
                raise
            except Exception:
                if len(idx) == 1:
                    dead_idx.append(idx)
                else:
                    mid = len(idx) // 2
                    stack.append(idx[mid:])
                    stack.append(idx[:mid])
        gsel = (np.sort(np.concatenate(good_idx)) if good_idx
                else np.zeros(0, np.int64))
        dsel = (np.sort(np.concatenate(dead_idx)) if dead_idx
                else np.zeros(0, np.int64))
        good = batch.take(gsel)
        dead = batch.take(dsel)
        block = (tf.transform_block(good, eq, qu).start_host_copy()
                 if len(good) else None)
        return good, block, (dead if len(dead) else None)

    # ------------------------------------------------------------- stage: load
    def _load_and_record(self, batch: RecordBatch, block) -> int:
        """Commit-lock-held helper: materialize the device block (the
        step's ONE host↔device round trip — the async copy started at
        dispatch time has usually landed by now), buffer lates, load
        facts + fused rollup, sample freshness. Returns records loaded."""
        w = self.worker
        facts, found = block.to_host()
        w.buffer.push(batch.filter(~found))
        good = facts[found]
        # join-level cache accounting (same counters the sequential worker
        # feeds): hits joined now, misses went to the late buffer. Counted
        # from the already-materialized host mask — no extra device sync.
        w._c_hits.inc(len(good))
        w._c_misses.inc(len(batch) - len(good))
        if not len(good):
            return 0
        log = self.pipe.source.log
        ev = log.event_times(batch.lsn[found])
        # event times ride into the warehouse so an attached serving layer
        # can stamp per-record report staleness on the same CDC clock
        w.warehouse.load_partitioned(
            good, self.pipe.cfg.n_partitions, event_times=ev,
            rollup=block.rollup_host(),
            routing_epoch=self.pipe.current_routing().epoch)
        self.latency.add(log.clock() - ev)
        self.records_done += len(good)
        return len(good)

    def _yield_to_capture(self) -> None:
        """Let a waiting checkpoint capture take this worker's commit lock
        first; bounded, so a capture stuck behind another worker's hung
        stage never stalls this one."""
        deadline = time.perf_counter() + self._YIELD_S
        while self.captures.waiting() and not self.stop.is_set() \
                and time.perf_counter() < deadline:
            time.sleep(0.0005)

    def _retry_sweep(self) -> None:
        w = self.worker
        self._yield_to_capture()
        with self.commit_lock:
            if self.dead or not len(w.buffer):
                return
            # publish the pop to the ingest stage's headroom accounting
            # BEFORE shrinking the buffer, so a concurrent fetch can't
            # claim the slots these records still occupy logically
            self.retry_inflight = len(w.buffer)
            limit = (self.cap * max(1, len(w.partitions))
                     if self.cap else None)
            ready = w.buffer.pop_ready(w.transformer.watermark(), limit)
            if len(ready):
                device = w.backend.device
                with self.cache_lock:
                    eq = w.equipment.snapshot_view(device)
                    qu = w.quality.snapshot_view(device)
                # the retry path meets poison records too (a poison
                # record that was merely *late* first) — same quarantine
                good, block, dead = self._transform_quarantine(
                    ready, eq, qu)
                if dead is not None:
                    w.dead_letter.push(dead, reason="transform-poison")
                    w._c_dead.inc(len(dead))
                if block is not None:
                    self._load_and_record(good, block)
            self.retry_inflight = 0

    def _load_loop(self) -> None:
        try:
            with torch.cuda.stream(self.stream):
                self._load_body()
        except InjectedCrash:
            return

    def _load_body(self) -> None:
        while True:
            self.beat("load")
            item = self._get(self.load_q)
            if item is None:
                if self.stop.is_set() and self.transform_q.empty():
                    return
                self._retry_sweep()       # idle: drain watermark-ready lates
                continue
            n_dead = len(item.dead) if item.dead is not None else 0
            n_total = len(item.batch) + n_dead
            self._yield_to_capture()
            with self.commit_lock:
                if not self.dead:
                    with self.tracer.span("load.commit") as sp:
                        done = (self._load_and_record(item.batch, item.block)
                                if item.block is not None else 0)
                        if item.dead is not None:
                            # poison quarantine: park the records, count
                            # them, and STILL commit their offsets below
                            # — a quarantined record is handled, never
                            # replayed into the same crash
                            self.worker.dead_letter.push(
                                item.dead, reason="transform-poison")
                            self.worker._c_dead.inc(n_dead)
                        # loaded, offsets NOT committed — the window where
                        # a crash leaves at-least-once exposure that
                        # recovery's warehouse rollback turns back into
                        # exactly-once
                        self.pipe.fault.trip(LOAD_PRE_COMMIT)
                        for p, c in item.counts.items():
                            self.worker.queue.commit(self.worker.group,
                                                     item.topic, p, c)
                        self.pipe.fault.trip(COMMIT_POST)
                        sp.put("records", done)
                # retire AFTER the lates are buffered: between push and
                # retirement the records are double-counted (buffer AND
                # in-flight), which errs on the safe side of headroom
                self.records_retired += n_total
                # completed is bumped LAST, still under the lock: a
                # coordinator quiescing on it (under this lock) is
                # guaranteed to also observe the item's offset commits —
                # bumping it first let a rebalance read a stale committed
                # offset and replay a whole partition at its new owner
                self.completed += 1
            # refund the full fetch (lates/quarantined included: they
            # left the in-flight window — lates are buffer-bounded, not
            # credit-bounded)
            self.credits.refund(n_total)
            self._retry_sweep()


class PendingCaptures:
    """The number of checkpoint captures waiting for the workers' commit
    locks. A load stage lets them in before it takes its lock again: a
    busy load thread re-takes a lock it just released before a blocked
    waiter runs, so a capture would otherwise starve until the stream
    idles (on the card, every periodic capture of a drill did)."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self, delta: int) -> None:
        with self._lock:
            self._n += delta

    def waiting(self) -> bool:
        return self._n > 0


class ConcurrentCluster:
    """Coordinator + concurrent worker runtimes (the paper's §3.1 cluster,
    executed for real). Owns the ``PartitionAssignment``; rebalances and
    failovers are incremental — only moved partitions quiesce, healthy
    workers never stop processing their retained partitions.

    Usage::

        pipe = DODETLPipeline(cfg, source, n_workers=4)
        cluster = ConcurrentCluster(pipe)     # poll_cdc=True: extraction
        cluster.start()                       # thread tails the change log
        ... feed source / wait ...
        cluster.run_until_idle()
        report = cluster.report()             # throughput + p50/p95/p99
        cluster.stop_all()
    """

    def __init__(self, pipe: DODETLPipeline, *,
                 max_records_per_partition: Optional[int] = None,
                 poll_cdc: bool = True, serving=None,
                 recovery=None, checkpoint_every_s: Optional[float] = None,
                 control: Union[None, bool, ControlConfig] = None):
        self.pipe = pipe
        self.cap = max_records_per_partition
        self.poll_cdc = poll_cdc
        # coordinator actions (failover, eviction, resize, repartition)
        # serialize here: the autonomous control plane and user calls may
        # now race, and the rebalance machinery assumes one caller at a time.
        # Reentrant — scale_to legitimately nests fail_workers.
        self._coord_lock = threading.RLock()
        # self-healing control plane (supervision + autonomous scaling):
        # opt-in via `control=True` (defaults) or a ControlConfig
        self.control: Optional[ControlPlane] = None
        if control:
            self.control = ControlPlane(
                self, control if isinstance(control, ControlConfig)
                else ControlConfig())
        # durability: a RecoveryCoordinator makes `checkpoint()` journal
        # consistent snapshots; `checkpoint_every_s` adds a periodic
        # checkpointer thread alongside the stage threads
        self.recovery = recovery
        self.checkpoint_every_s = checkpoint_every_s
        self._ckpt_thread: Optional[threading.Thread] = None
        self._stop_ckpt = threading.Event()
        # optional BI serving stage: a MaterializedViewEngine (or a
        # ReportServer / BatchedReportServer wrapping one) whose
        # maintenance thread runs with the cluster; worker load stages
        # publish fact deltas to it via the warehouse hook, and cluster
        # reports include its epoch/staleness (+ batch-front stats when a
        # batching front is attached)
        self.serving_front = serving if hasattr(serving, "submit") else None
        self.serving = getattr(serving, "engine", serving)
        if self.serving is not None:
            pipe.warehouse.attach_serving(self.serving)
            # serving joins the pipeline's observability plane: fold/query
            # spans land on the same tracer, the staleness reservoir on
            # the pipeline registry's "serving" shard
            self.serving.tracer = pipe.tracer
            self.serving.attach_metrics(pipe.metrics.shard("serving"))
            # sharded serving plane (ShardedViewEngine): align shard
            # ownership with the pipeline's live routing epoch and give
            # the warehouse its per-shard sub-logs; repartition() keeps
            # both in sync via _reown_shard_plane
            if hasattr(self.serving, "reown"):
                self.serving.reown(pipe.current_routing())
                pipe.warehouse.attach_shards(self.serving.ownership)
        self._captures = PendingCaptures()
        self.runtimes: Dict[str, WorkerRuntime] = {
            w.name: WorkerRuntime(w, pipe, max_records_per_partition,
                                  self._captures)
            for w in pipe.workers}
        self.assignment = pipe.assignment
        self.redump_s_total = 0.0
        self.last_rebalance_stats = None     # CacheMigrationStats of the
        self.last_migration: Dict = {}       # last grant wave / repartition
        self._extract_thread: Optional[threading.Thread] = None
        self._stop_extract = threading.Event()
        self._next_worker_idx = len(pipe.workers)
        self._t_start: Optional[float] = None

    # --------------------------------------------------------------- lifecycle
    def start(self) -> None:
        self._t_start = time.perf_counter()
        if self.serving is not None:
            self.serving.start()         # view-maintenance stage
        if self.serving_front is not None:
            self.serving_front.start()   # batched-query admission front
        for rt in self.runtimes.values():
            rt.start()
        if self.poll_cdc:
            self._extract_thread = threading.Thread(
                target=self._extract_loop, daemon=True, name="cdc.extract")
            self._extract_thread.start()
        if self.recovery is not None and self.checkpoint_every_s:
            self._ckpt_thread = threading.Thread(
                target=self._ckpt_loop, daemon=True, name="durability.ckpt")
            self._ckpt_thread.start()
        if self.control is not None:
            self.control.start()

    def _ckpt_loop(self) -> None:
        while not self._stop_ckpt.wait(self.checkpoint_every_s):
            try:
                self.checkpoint()
            except InjectedCrash:
                return               # checkpoint-write crash drill

    def checkpoint(self) -> Optional[int]:
        """Journal one consistent snapshot of the whole data plane (see
        ``RecoveryCoordinator.capture``). The live workers' commit locks
        are passed in name order — a fixed acquisition order, so a
        concurrent rebalance (which takes one lock at a time) can never
        deadlock against a capture. No-op once a fault has tripped: a
        dead process journals nothing on the way down — asked again once
        the locks are held, since a load stage can die at
        ``load.pre_commit`` (warehouse loaded, offsets not committed)
        while this capture waits for its lock."""
        if self.recovery is None or self.pipe.fault.tripped.is_set():
            return None
        locks = [rt.commit_lock for _, rt in sorted(self.runtimes.items())
                 if not rt.dead]
        waiting = [True]

        def locked() -> bool:
            # every lock held: the load stages may block on them again;
            # journal nothing if a fault tripped while this waited
            self._captures.add(-1)
            waiting[0] = False
            return self.pipe.fault.tripped.is_set()

        with self.pipe.tracer.span("checkpoint.step") as sp:
            self._captures.add(1)
            try:
                step = self.recovery.checkpoint(
                    self.pipe, engine=self.serving, extra_locks=locks,
                    abort=locked)
            finally:
                if waiting[0]:
                    self._captures.add(-1)
            sp.put("step", step)
        return step

    def _credits_exhausted(self) -> bool:
        """True when EVERY live worker's credit ledger is drained — the
        end-to-end backpressure signal: downstream has stopped refunding,
        so extraction publishing more would only grow broker backlog."""
        rts = [rt for rt in list(self.runtimes.values()) if not rt.dead]
        return bool(rts) and all(rt.credits.exhausted() for rt in rts)

    def _extract_loop(self) -> None:
        tracker = self.pipe.tracker
        idle = self.pipe.cfg.idle_backoff_s
        while not self._stop_extract.is_set():
            if self._credits_exhausted():
                time.sleep(0.005)        # stalled downstream throttles
                continue                 # extraction, not just fetching
            if tracker.poll_all() == 0:
                time.sleep(idle)

    def stop_all(self) -> None:
        if self.control is not None:
            self.control.stop()    # before the heartbeats it watches stop
        self._stop_extract.set()
        self._stop_ckpt.set()
        for rt in self.runtimes.values():
            rt.stop.set()
        if self._extract_thread is not None:
            self._extract_thread.join(5.0)
            self._extract_thread = None
        if self._ckpt_thread is not None:
            self._ckpt_thread.join(5.0)
            self._ckpt_thread = None
        for rt in self.runtimes.values():
            rt.join()
        if self.serving_front is not None:
            self.serving_front.stop()    # drains admitted queries first
        if self.serving is not None:
            self.serving.stop()          # folds the remaining delta backlog

    def abandon(self) -> None:
        """Crash-drill teardown: stop every thread WITHOUT the graceful
        drain ``stop_all`` performs — no queued hand-off is loaded, no
        offset committed, no delta backlog folded, no checkpoint written.
        What a kill -9 leaves behind, minus the process exit: the journal
        and broker/warehouse objects are simply abandoned, and recovery
        starts from fresh objects + the journal (tests assert the result
        matches an uninterrupted run byte-for-byte)."""
        if self.control is not None:
            self.control.stop()
        self._stop_extract.set()
        self._stop_ckpt.set()
        for rt in self.runtimes.values():
            with rt.commit_lock:     # atomic vs an in-progress load+commit
                rt.dead = True       # load stage loads/commits nothing more
            rt.stop.set()
        if self._extract_thread is not None:
            self._extract_thread.join(5.0)
            self._extract_thread = None
        if self._ckpt_thread is not None:
            self._ckpt_thread.join(5.0)
            self._ckpt_thread = None
        for rt in self.runtimes.values():
            rt.join()
        if self.serving_front is not None:
            self.serving_front.stop()
        if self.serving is not None:
            self.serving.abort()         # stop folding, KEEP the backlog

    # ---------------------------------------------------------------- metrics
    def health(self) -> Dict:
        """One consistent ``ClusterHealth`` snapshot — per-worker
        throughput/backlog, freshness & staleness percentiles, commit lag
        per topic/partition, cache retention, checkpoint age, merged
        counters. Lock-free and safe to poll while rebalances,
        repartitions and checkpoints run (see observability.health)."""
        return build_cluster_health(self)

    def alive_workers(self) -> List[str]:
        return [n for n, rt in self.runtimes.items() if not rt.dead]

    def records_done(self) -> int:
        return sum(rt.records_done for rt in self.runtimes.values())

    def freshness(self, drain: bool = False) -> Dict[str, float]:
        merged = [rt.latency.merged(drain) for rt in self.runtimes.values()]
        return _percentiles_ms(np.concatenate(merged) if merged
                               else np.zeros(0))

    def report(self) -> Dict[str, float]:
        wall = (time.perf_counter() - self._t_start) if self._t_start else 0.0
        done = self.records_done()
        out = {"records": done, "wall_s": round(wall, 4),
               "records_s": round(done / wall) if wall > 0 else 0,
               "n_workers": len(self.alive_workers()),
               "redump_s": round(self.redump_s_total, 4)}
        out.update(self.freshness())
        if self.serving is not None:
            out["serving"] = self.serving.report()
            if self.serving_front is not None:
                out["serving"].update(
                    {f"batch_{k}": v
                     for k, v in self.serving_front.stats().items()})
        return out

    # ------------------------------------------------------------ idle waiting
    def _operational_lag(self) -> int:
        q = self.pipe.queue
        lag = 0
        group_of = {n: rt.worker.group for n, rt in self.runtimes.items()}
        for topic in self.pipe.operational_topics:
            hw = [q.topics[topic].high_watermark(p)
                  for p in range(q.topics[topic].cfg.n_partitions)]
            for p, owner in self.assignment.assignment.items():
                lag += max(0, hw[p] - q.committed(group_of[owner], topic, p))
        return lag

    def _extraction_lag(self) -> int:
        log = self.pipe.source.log
        return sum(max(0, log.next_lsn - l.offset)
                   for l in self.pipe.tracker.listeners)

    def _idle_buffered(self) -> Optional[int]:
        """None while any work is in flight; otherwise the total number of
        late-buffered records observed at a provably quiescent instant.
        Taking each worker's commit lock excludes the one blind spot plain
        counters have: a retry sweep that has popped buffered records but
        not yet loaded them."""
        if self.poll_cdc and self._extraction_lag() > 0:
            return None
        buffered = 0
        for rt in self.runtimes.values():
            if rt.dead:
                continue
            with rt.commit_lock:
                if rt.in_flight() > 0 or not rt.transform_q.empty() \
                        or not rt.load_q.empty():
                    return None
                buffered += len(rt.worker.buffer)
        if self._operational_lag() != 0:
            return None
        return buffered

    def idle(self) -> bool:
        """True when there is provably nothing left to do right now."""
        return self._idle_buffered() is not None

    def run_until_idle(self, timeout: float = 120.0,
                       stall_s: float = 2.0) -> int:
        """Block until the stream is drained (lag 0, no in-flight work,
        empty late buffers) or no progress has been made for ``stall_s``
        (e.g. buffered records whose master data never arrives — the
        paper's watermark semantics say those WAIT, so a stall is a clean
        exit, not an error). Returns total records loaded."""
        t0 = time.perf_counter()
        last = (-1, -1)
        last_change = t0
        while time.perf_counter() - t0 < timeout:
            buffered = self._idle_buffered()
            state = (self.records_done(), buffered)
            if state != last:
                last, last_change = state, time.perf_counter()
            if buffered is not None:
                if buffered == 0:
                    return self.records_done()
                if time.perf_counter() - last_change > stall_s:
                    return self.records_done()   # watermark-stalled lates
            time.sleep(0.01)
        return self.records_done()

    # ----------------------------------------------------- coordinator actions
    def _quiesce(self, rt: WorkerRuntime, horizon: int,
                 timeout: float = 10.0) -> None:
        """Wait until every hand-off fetched before ``horizon`` has retired.
        The worker keeps processing; only the coordinator waits. Reading
        ``completed`` under the worker's commit lock guarantees the retired
        items' offset commits are visible before the coordinator moves on
        to the offset transfer."""
        t0 = time.perf_counter()
        while not rt.dead:
            with rt.commit_lock:
                done = (rt.completed + rt.items_dropped_ingest
                        + rt.items_dropped_transform)
            if done >= horizon:
                return
            if time.perf_counter() - t0 > timeout:
                raise QuiesceTimeout(
                    f"quiesce timeout for {rt.worker.name}")
            time.sleep(0.002)

    def _rebalance_to(self, alive: List[str],
                      weights: Optional[np.ndarray] = None) -> float:
        """Incremental rebalance: revoke moved partitions from their live
        owners, quiesce ONLY those workers' in-flight windows, transfer
        committed offsets, then grant — which fires the §3.2 cache trigger
        on the new owners, now SURGICAL: survivors retain rows for keys
        they keep and dump only the gained ranges. ``weights`` (per-
        partition observed load) makes the sticky LPT assignment balance
        load, not just partition counts. Healthy workers never stop
        consuming the partitions they keep."""
        pipe = self.pipe
        with pipe.tracer.span("repartition.rebalance") as sp:
            redump = self._rebalance_body(alive, weights)
            sp.put("workers", len(alive))
        pipe.metrics.shard("coordinator").counter(
            "pipeline.rebalances").inc()
        return redump

    def _rebalance_body(self, alive: List[str],
                        weights: Optional[np.ndarray] = None) -> float:
        pipe = self.pipe
        old_owner = dict(self.assignment.assignment)
        old_group = {n: rt.worker.group for n, rt in self.runtimes.items()}
        self.assignment.rebalance(alive, weights)
        moved: Dict[str, List[int]] = {}
        grants: Dict[str, List[int]] = {}
        for p, new_w in self.assignment.assignment.items():
            ow = old_owner.get(p)
            if ow == new_w:
                continue
            if ow is not None:
                moved.setdefault(ow, []).append(p)
            grants.setdefault(new_w, []).append(p)

        # phase 1: revoke from live old owners, quiesce their in-flight work
        pending = []
        for ow, parts in moved.items():
            rt = self.runtimes.get(ow)
            if rt is None or rt.dead:
                continue
            msg = _Control("revoke", set(parts))
            rt.control.put(msg)
            pending.append((rt, msg))
        for rt, msg in pending:
            if not msg.ack.wait(10.0):
                raise QuiesceTimeout(
                    f"revoke ack timeout for {rt.worker.name}")
            self._quiesce(rt, msg.fetched_at_ack)

        # phase 2: exactly-once offset handoff for every moved partition
        q = pipe.queue
        for p, new_w in self.assignment.assignment.items():
            ow = old_owner.get(p)
            if ow is None or ow == new_w:
                continue
            og = old_group.get(ow)
            ng = self.runtimes[new_w].worker.group
            for topic in pipe.operational_topics:
                committed = q.committed(og, topic, p)
                own = q.committed(ng, topic, p)
                if committed > own:
                    q.commit(ng, topic, p, committed - own)
                q.rewind(og, topic, p)    # abandon the old read-ahead

        # phase 3: grant (surgical cache migration on changed key sets)
        from repro_torch.core.pipeline import CacheMigrationStats
        redump = 0.0
        stats = CacheMigrationStats()
        pending = []
        for nw, parts in grants.items():
            msg = _Control("grant", set(parts))
            self.runtimes[nw].control.put(msg)
            pending.append((self.runtimes[nw], msg))
        for rt, msg in pending:
            if not msg.ack.wait(10.0):
                raise QuiesceTimeout(
                    f"grant ack timeout for {rt.worker.name}")
            redump += msg.redump_s
            if msg.stats is not None:
                stats = stats.merge(msg.stats)
        self.redump_s_total += redump
        self.last_rebalance_stats = stats
        self._redistribute_buffers()
        return redump

    def _redistribute_buffers(self) -> None:
        """Re-home buffered late records to their partitions' CURRENT
        owners under the CURRENT routing epoch (the paper's replicated
        buffer store makes them reachable by any worker). Without this, a
        record buffered by a worker that then loses the record's partition
        — or whose business key was routed away by an epoch change —
        would starve forever: its probes run against a cache that no
        longer holds the record's business keys."""
        from repro_torch.core.partitioning import isin_sorted
        orphans: List[RecordBatch] = []
        for rt in self.runtimes.values():
            if rt.dead:
                continue
            with rt.commit_lock:
                held = rt.worker.buffer.drain()
            if len(held):
                orphans.append(held)
        if not orphans:
            return
        merged = RecordBatch.concat(orphans)
        parts = self.pipe.current_routing().partition_of(
            merged.business_key).astype(np.int64)
        for name, rt in self.runtimes.items():
            if rt.dead:
                continue
            owned = np.asarray(sorted(
                p for p, w in self.assignment.assignment.items()
                if w == name), np.int64)
            if not len(owned):
                continue
            mine = merged.filter(isin_sorted(owned, parts))
            if len(mine):
                with rt.commit_lock:
                    rt.worker.buffer.push(mine)

    def fail_workers(self, names: Iterable[str]) -> float:
        """§4.1.3 failure injection under load: fail-stop the named workers
        (their consumed-but-uncommitted hand-offs are discarded — the broker
        re-serves those records to the partitions' new owners from the
        committed offsets), reassign their partitions incrementally, adopt
        their replicated late buffers. Returns cache re-dump seconds."""
        return self._remove_workers(list(names), forced=False)

    def evict_workers(self, names: Iterable[str], *,
                      lock_timeout: float = 1.0,
                      join_timeout: float = 2.0) -> float:
        """Forced eviction for hung/straggler workers (the control
        plane's confirmed-failure path). Unlike ``fail_workers`` it must
        not block on the victim: the commit lock is taken with a timeout
        (a wedged load stage may never release it), the stage threads
        get a bounded join (wedged ones are surfaced by
        ``WorkerRuntime.join`` and left to no-op as daemons), and the
        victim's consumer group is FENCED at the broker so a zombie
        thread that wakes later cannot move offsets that now belong to a
        survivor. Returns cache re-dump seconds."""
        return self._remove_workers(list(names), forced=True,
                                    lock_timeout=lock_timeout,
                                    join_timeout=join_timeout)

    def _remove_workers(self, names: List[str], *, forced: bool,
                        lock_timeout: float = 1.0,
                        join_timeout: float = 2.0) -> float:
        with self._coord_lock:
            dead_rts = []
            for n in names:
                rt = self.runtimes[n]
                if forced:
                    # hang-tolerant: a load stage wedged INSIDE its
                    # commit critical section would deadlock a plain
                    # `with`; flag the runtime dead regardless (a bool
                    # write is GIL-atomic) — the group fence below keeps
                    # any zombie commit out either way
                    got = rt.commit_lock.acquire(timeout=lock_timeout)
                    rt.dead = True
                    if got:
                        rt.commit_lock.release()
                else:
                    with rt.commit_lock:   # atomic vs the load stage
                        rt.dead = True
                rt.stop.set()
                dead_rts.append(rt)
            for rt in dead_rts:
                if forced:
                    rt.join(join_timeout)
                    self.pipe.queue.fence_group(rt.worker.group)
                else:
                    rt.join()
            alive = [n for n in self.runtimes if not self.runtimes[n].dead]
            if not alive:
                raise RuntimeError("all workers failed")
            self.pipe.workers = [w for w in self.pipe.workers
                                 if w.name not in names]
            # replicated-buffer adoption: a survivor inherits the dead
            # workers' late records before the rebalance; `_rebalance_to`
            # then re-homes every buffered record to its partition's new
            # owner (only committed records ever enter a buffer, so this
            # cannot duplicate anything the broker will re-serve)
            target = self.runtimes[alive[0]]
            for rt in dead_rts:
                orphan = rt.worker.buffer.drain()
                if len(orphan):
                    with target.commit_lock:
                        target.worker.buffer.push(orphan)
            return self._rebalance_to(alive)

    def _spawn_worker(self) -> str:
        """Create + start one fresh worker runtime (no partitions yet —
        the caller rebalances). The runtimes dict is replaced, not
        mutated, so lock-free iterators (health polls, idle checks)
        never observe a resize mid-iteration."""
        name = f"w{self._next_worker_idx}"
        self._next_worker_idx += 1
        w = self.pipe._new_worker(
            name, self.pipe.workers[0].transformer.join_depth
            if self.pipe.workers else 1)
        w.partitions = []
        self.pipe.workers.append(w)
        rt = WorkerRuntime(w, self.pipe, self.cap, self._captures)
        self.runtimes = {**self.runtimes, name: rt}
        if self._t_start is not None:
            rt.start()
        return name

    def scale_to(self, n_workers: int) -> float:
        """Elastic resize (paper §3.2 'cluster scales up or down') without
        stopping the running stream."""
        with self._coord_lock:
            alive = self.alive_workers()
            if n_workers < len(alive):
                return self.fail_workers(alive[n_workers:])
            if n_workers == len(alive):
                return 0.0
            new_names = [self._spawn_worker()
                         for _ in range(n_workers - len(alive))]
            return self._rebalance_to(alive + new_names)

    def replace_worker(self, name: str, *,
                       lock_timeout: float = 1.0,
                       join_timeout: float = 2.0) -> str:
        """Supervised restart: forcibly evict ``name`` and bring up a
        fresh replacement in the SAME rebalance wave, so the grant path
        re-hydrates the newcomer (cache dump from the compacted master
        topics sets its watermarks; `_remove_workers` hands it — or a
        survivor — the evicted buffer, and `_redistribute_buffers`
        re-homes every late record). Spawning before evicting also
        keeps the last-worker case legal: the rebalance always has a
        live grant target. Returns the replacement's name."""
        with self._coord_lock:
            new_name = self._spawn_worker()
            self._remove_workers([name], forced=True,
                                 lock_timeout=lock_timeout,
                                 join_timeout=join_timeout)
            return new_name

    # -------------------------------------------------- adaptive repartition
    def retire_epochs(self) -> bool:
        """Retire routing epochs whose records are fully committed; when
        any retire, re-home buffered lates so none starves at a worker
        about to release the retired epoch's key ranges."""
        pipe = self.pipe
        group_of = {n: rt.worker.group for n, rt in self.runtimes.items()}
        retired = False
        for t in pipe.operational_topics:
            committed = {
                p: pipe.queue.committed(group_of[owner], t, p)
                for p, owner in self.assignment.assignment.items()
                if owner in group_of}
            retired |= pipe.queue.topics[t].retire_epochs(committed)
        if retired:
            self._redistribute_buffers()
        return retired

    def _initial_cache_rows(self) -> int:
        """Pre-migration cache rows across live workers — the retention
        baseline (see ``pipeline.migration_summary``)."""
        return sum(rt.worker.equipment.n_rows + rt.worker.quality.n_rows
                   for rt in self.runtimes.values() if not rt.dead)

    def _reroute_all(self, new_table):
        """Phase 1+2 of an epoch migration: every live worker acks a
        ``reroute`` control (key filter grown to live∪incoming epochs,
        caches migrated surgically) BEFORE publishers switch to the new
        epoch. Returns the merged migration stats."""
        from repro_torch.core.pipeline import CacheMigrationStats
        pipe = self.pipe
        stats = CacheMigrationStats()
        with pipe.tracer.span("repartition.prepare") as sp:
            pending = []
            for name, rt in self.runtimes.items():
                if rt.dead:
                    continue
                msg = _Control("reroute", set(), tables=(new_table,))
                rt.control.put(msg)
                pending.append((rt, msg))
            for rt, msg in pending:
                if not msg.ack.wait(10.0):
                    raise QuiesceTimeout(
                        f"reroute ack timeout for {rt.worker.name}")
                stats = stats.merge(msg.stats)
            sp.put("workers", len(pending))
        self.redump_s_total += stats.dump_s
        with pipe.tracer.span("repartition.epoch_switch") as sp:
            for t in pipe.operational_topics:
                pipe.queue.topics[t].set_routing(new_table)
            sp.put("epoch", new_table.epoch)
        self._reown_shard_plane(new_table)
        return stats

    def _reown_shard_plane(self, new_table) -> None:
        """Sharded serving plane: remap view-segment and warehouse-row
        shard ownership to the new routing epoch, surgically (only moved
        segments/chunks migrate — the mesh twin of the workers' surgical
        cache migration above). No-op for an unsharded engine."""
        eng = self.serving
        if eng is None or not hasattr(eng, "reown"):
            return
        with self.pipe.tracer.span("repartition.shard_reown") as sp:
            stats = eng.reown(new_table)
            wstats = self.pipe.warehouse.reown_shards(eng.ownership)
            sp.put("segments_moved", stats["segments_moved"])
            sp.put("warehouse_rows_moved", wstats["rows_moved"])

    def _finish_migration(self, cur, stats, initial_rows) -> Dict:
        from repro_torch.core.pipeline import migration_summary
        if self.last_rebalance_stats is not None:
            stats = stats.merge(self.last_rebalance_stats)
        moved = cur.moved_fraction(
            self.pipe.current_routing(),
            np.arange(self.pipe.cfg.n_business_keys))
        self.last_migration = migration_summary(
            self.pipe.current_routing().epoch, moved, stats, initial_rows)
        return self.last_migration

    def repartition(self) -> Dict:
        """Adaptive skew-aware repartition WITHOUT stopping the stream:

        1. the strategy turns the broker's observed per-partition /
           per-key publish load into a new routing epoch;
        2. every live worker gets a ``reroute`` control: its key filter
           grows to the union of live + incoming epochs and its caches
           migrate surgically (gained ranges dumped, everything still
           owned retained) — all BEFORE any record routes under the new
           epoch;
        3. publishers switch atomically (per-partition horizons recorded,
           so the old epoch drains and retires);
        4. partition ownership rebalances by observed load through the
           PR-2 machinery (revoke → quiesce-under-commit-lock → offset
           transfer → surgical grant) and buffers re-home.

        Returns migration stats (also kept as ``last_migration``)."""
        with self._coord_lock:
            return self._repartition_body()

    def _repartition_body(self) -> Dict:
        from repro_torch.core.pipeline import CacheMigrationStats
        pipe = self.pipe
        self.retire_epochs()
        initial_rows = self._initial_cache_rows()
        part_loads, keys, counts = pipe.observed_loads()
        cur = pipe.current_routing()
        new_table = pipe.strategy.rebalanced_table(cur, part_loads,
                                                   (keys, counts))
        stats = CacheMigrationStats()
        if new_table.epoch != cur.epoch:
            stats = self._reroute_all(new_table)
            # mid-repartition crash seam: publishers already route by the
            # new epoch, ownership not yet rebalanced (same window the
            # sequential coordinator exposes)
            pipe.fault.trip(REPARTITION_MID)
        # load-aware ownership rebalance: undrained backlog (old-epoch
        # placement) + expected future arrivals under the new epoch
        weights = pipe.backlog_weights()
        if len(keys):
            np.add.at(weights,
                      pipe.current_routing().partition_of(keys), counts)
        self._rebalance_to(self.alive_workers(), weights)
        pipe.metrics.shard("coordinator").counter(
            "pipeline.repartitions").inc()
        return self._finish_migration(cur, stats, initial_rows)

    def scale_partitions(self, n_partitions: int) -> Dict:
        """Elastic partition scale event: operational topics grow to
        ``n_partitions`` empty partitions, the strategy produces the
        scaled routing table (a consistent-hash ring moves only ~1/n of
        the key space; the static modulus reshuffles nearly all of it),
        workers pre-migrate, publishers switch, ownership rebalances."""
        with self._coord_lock:
            pipe = self.pipe
            assert n_partitions >= self.assignment.n_partitions
            initial_rows = self._initial_cache_rows()
            cur = pipe.current_routing()
            new_table = pipe.strategy.scaled_table(cur, n_partitions)
            for t in pipe.operational_topics:
                pipe.queue.topics[t].expand(n_partitions)
            self.assignment.grow(n_partitions)
            stats = self._reroute_all(new_table)
            self._rebalance_to(self.alive_workers())
            return self._finish_migration(cur, stats, initial_rows)
