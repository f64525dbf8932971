"""Partitioned publish/subscribe message queue (paper §3.1.1).

Kafka-shaped semantics, array-backed:
  * one topic per source table,
  * per-partition ordered logs with offsets,
  * consumer groups with committed offsets (restart = resume from commit),
  * *log compaction* for master topics: ``snapshot()`` returns the latest
    record per row key — the mechanism the In-memory Table Updater uses to
    (re)populate caches on bootstrap, failover and elastic reassignment.

On a TPU pod the broker role is played by host memory + ICI; the observable
contract (ordering per partition, at-least-once delivery, compaction) is
preserved so higher stages are transport-agnostic (paper §3.3:
technology-independence).

Thread-safety contract (the concurrent runtime drives one broker from many
worker threads):

  * published batches are frozen (read-only columns), so consumers share
    views without copies or races,
  * per-topic locks guard the append path + compaction index; reads snapshot
    the batch list and do their numpy work outside the lock,
  * consumer-group offset state is split into *positions* (how far a group
    has READ, advanced by ``fetch_many``) and *commits* (how far it has
    durably PROCESSED, advanced by ``commit``). A worker that dies between
    fetch and commit simply abandons its positions: the new owner of its
    partitions resumes from the committed offset, so nothing is lost and
    nothing is double-loaded (commit happens after warehouse load, under the
    worker's commit lock).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.partitioning import RoutingTable
from repro_torch.core.records import RecordBatch
from repro_torch.observability.registry import (MetricsRegistry, MetricsShard)


@dataclasses.dataclass
class TopicConfig:
    name: str
    table_id: int
    n_partitions: int
    partition_by: str            # "row_key" (master) | "business_key" (operational)
    compacted: bool = False      # master topics keep a latest-per-key view


class Partition:
    def __init__(self):
        self.batches: List[RecordBatch] = []
        self.length = 0

    def append(self, batch: RecordBatch):
        if len(batch):
            # freeze THEN publish: once the batch is reachable by consumer
            # threads its columns are immutable; `length` is bumped last so
            # a concurrent reader never sees a length without its batch
            self.batches.append(batch.freeze())
            self.length += len(batch)

    def read(self, offset: int, max_records: Optional[int] = None
             ) -> RecordBatch:
        # snapshot once: `batches` only ever grows at the tail and `length`
        # is published after the append, so (list copy, length) read in this
        # order can only under-report — never return a half-appended batch
        batches = list(self.batches)
        lens = [len(b) for b in batches]
        length = min(self.length, sum(lens))
        if offset >= length:
            return RecordBatch.empty()
        budget = length - offset
        if max_records is not None:
            budget = min(budget, max_records)
        out, seen, taken = [], 0, 0
        for b, lb in zip(batches, lens):
            if seen + lb <= offset:
                seen += lb
                continue
            lo = max(0, offset - seen)
            hi = min(lb, lo + (budget - taken))
            out.append(b.slice(lo, hi))     # zero-copy view of frozen batch
            taken += hi - lo
            seen += lb
            if taken >= budget:
                break
        if len(out) == 1:
            return out[0]                   # still a view; batch is frozen
        return RecordBatch.concat(out)


class Topic:
    """Partitioned log + the topic's ROUTING state: a versioned
    ``RoutingTable`` decides which partition a published record lands in.
    Epoch changes are append-only history — records published under epoch
    E stay readable in the partitions E chose (partition logs never move);
    a historical epoch is *live* until every partition's consumer has
    committed past the high watermark recorded at the switch (its
    ``horizons``), at which point ``retire_epochs`` drops it and workers
    may release the key ranges only that epoch routed to them."""

    def __init__(self, cfg: TopicConfig,
                 metrics_shard: Optional[MetricsShard] = None):
        self.cfg = cfg
        # broker publish counters live on the metrics registry (one read
        # path with every other pipeline signal); the shard is this
        # topic's private write surface — increments happen under the
        # publish lock, which already serializes the only writer
        self.metrics = metrics_shard or MetricsShard(f"broker.{cfg.name}")
        self._pub_counter = self.metrics.counter(
            f"broker.{cfg.name}.published")
        self._key_load_counter = self.metrics.counter(
            f"broker.{cfg.name}.key_loads")
        self.metrics.gauge_fn(
            f"broker.{cfg.name}.high_watermark",
            lambda: sum(p.length for p in self.partitions))
        self.partitions = [Partition() for _ in range(cfg.n_partitions)]
        # compaction index: row_key -> (txn_time, payload, business_key)
        self._compact: Dict[int, Tuple[int, np.ndarray, int]] = {}
        self._compact_view = None    # lazily materialized columnar snapshot
        self._lock = threading.Lock()   # serializes appends + compaction
        self.routing = RoutingTable.static(cfg.n_partitions)
        # ((table, horizons), ...): still-live superseded epochs, newest
        # last; replaced wholesale (copy-on-write) so readers are lock-free
        self._history: Tuple[Tuple[RoutingTable, Tuple[int, ...]], ...] = ()
        # observed publish load: per partition and per business key — the
        # coordinator's input to SkewAwareStrategy.rebalanced_table.
        # Business keys are dense small ints in this deployment, so the
        # per-key counter is a lazily grown array updated with ONE
        # np.add.at per publish (a Python dict loop here would run under
        # the publish lock on every CDC extraction)
        self.partition_pub = np.zeros(cfg.n_partitions, np.int64)
        self._key_loads = np.zeros(0, np.int64)
        self._untracked_key_load = 0      # sparse/negative keys: not used
                                          # for skew splits, but counted

    def publish(self, batch: RecordBatch) -> None:
        if not len(batch):
            return
        key = ("row_key" if self.cfg.partition_by == "row_key"
               else "business_key")
        with self._lock:
            self._publish_locked(batch, key)

    def _publish_locked(self, batch: RecordBatch, key: str) -> None:
        for p, part_batch in batch.split_by_partition(
                self.cfg.n_partitions, key=key, router=self.routing):
            self.partitions[p].append(part_batch)
            self.partition_pub[p] += len(part_batch)
        self._pub_counter.inc(len(batch))
        if key == "business_key" and len(batch):
            self._key_load_counter.inc(len(batch))
            ks = batch.business_key
            lo, hi = int(ks.min()), int(ks.max())
            if lo >= 0 and hi < (1 << 20):
                if hi >= len(self._key_loads):
                    grown = np.zeros(hi + 1, np.int64)
                    grown[:len(self._key_loads)] = self._key_loads
                    self._key_loads = grown
                np.add.at(self._key_loads, ks, 1)
            else:
                self._untracked_key_load += len(ks)
        if self.cfg.compacted:
            self._compact_update(batch)

    def _compact_update(self, batch: RecordBatch) -> None:
        """Lock-held: fold one batch into the compaction index — within-
        batch winner per row key first (latest txn_time, arrival order
        breaking ties — same rule as the per-record loop), then one dict
        update per surviving key. Also the recovery path's replay step:
        last-writer-wins is associative over concatenation, so replaying
        journal segments in partition-log order rebuilds the index the
        original publishes built."""
        order = np.lexsort((np.arange(len(batch)), batch.txn_time,
                            batch.row_key))
        rks = batch.row_key[order]
        last = np.nonzero(np.append(rks[1:] != rks[:-1], True))[0]
        for i in order[last]:
            i = int(i)
            rk = int(batch.row_key[i])
            t = int(batch.txn_time[i])
            prev = self._compact.get(rk)
            if prev is None or t >= prev[0]:
                self._compact[rk] = (t, batch.payload[i],
                                     int(batch.business_key[i]))
        self._compact_view = None

    def _compact_columns(self):
        """Columnar view of the compaction index (cached between publishes)
        as (row_keys, payloads, txn_times, business_keys)."""
        if self._compact_view is None:
            from repro_torch.core.records import PAYLOAD_WIDTH
            if not self._compact:
                self._compact_view = (
                    np.zeros(0, np.int64),
                    np.zeros((0, PAYLOAD_WIDTH), np.float32),
                    np.zeros(0, np.int64), np.zeros(0, np.int64))
            else:
                vals = list(self._compact.values())
                self._compact_view = (
                    np.fromiter(self._compact.keys(), np.int64,
                                len(self._compact)),
                    np.stack([v[1] for v in vals]),
                    np.array([v[0] for v in vals], np.int64),
                    np.array([v[2] for v in vals], np.int64))
            for a in self._compact_view:
                a.flags.writeable = False   # callers get views, not copies
        return self._compact_view

    def snapshot(self, business_keys=None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Compacted latest-per-row-key view, optionally filtered by the
        business keys assigned to the requesting worker (paper: the cache
        'only saves data related to the business keys assigned to its
        corresponding Stream Processor node'). ``business_keys`` may be a
        set or a (sorted) integer array. Returns (row_keys, payloads,
        txn_times)."""
        assert self.cfg.compacted, "snapshot() requires a compacted topic"
        with self._lock:             # publishes mutate the compaction index
            rks, pls, tts, bks = self._compact_columns()
        if business_keys is None or not len(rks):
            return rks, pls, tts
        from repro_torch.core.partitioning import isin_sorted
        sel = np.unique(np.fromiter(business_keys, np.int64)
                        if not isinstance(business_keys, np.ndarray)
                        else business_keys)
        mask = isin_sorted(sel, bks)
        return rks[mask], pls[mask], tts[mask]

    def high_watermark(self, partition: int) -> int:
        return self.partitions[partition].length

    # -------------------------------------------------------- routing epochs
    def set_routing(self, table: RoutingTable) -> None:
        """Switch to a new routing epoch. Under the publish lock, so the
        per-partition horizons (lengths at the switch) are exact: every
        record below a horizon was routed by the OLD table, everything at
        or above it by the new one. The old epoch joins the live history
        unless its partitions were still empty (nothing to drain)."""
        assert table.n_partitions <= len(self.partitions), \
            "routing table wider than the topic (expand first)"
        with self._lock:
            if table.epoch == self.routing.epoch and \
                    table.kind == self.routing.kind:
                return
            horizons = tuple(p.length for p in self.partitions)
            if any(horizons):
                self._history = self._history + ((self.routing, horizons),)
            self.routing = table

    def live_tables(self) -> Tuple[RoutingTable, ...]:
        """Current table plus every superseded epoch still draining —
        the union a worker's business-key filter must cover so records
        published under an old epoch keep finding their master rows.

        Lock-free, so the read ORDER matters against ``set_routing``
        (history append, THEN routing swap): reading ``routing`` first
        can only over-report (the pre-swap table shows up both as
        current and, post-append, in history — callers dedupe by epoch);
        the reverse order could miss the just-superseded epoch
        entirely."""
        cur = self.routing                # read BEFORE history (see above)
        hist = self._history              # atomic tuple read, no lock
        return tuple(t for t, _ in hist) + (cur,)

    def routing_signature(self) -> Tuple[int, int]:
        """(current epoch, live history length) — memo invalidation key
        for anything derived from ``live_tables``."""
        return (self.routing.epoch, len(self._history))

    def retire_epochs(self, committed: Dict[int, int]) -> bool:
        """Drop historical epochs whose records are all committed:
        ``committed[p]`` is the owning consumer group's committed offset
        for partition p. Returns True if anything retired."""
        with self._lock:
            keep = tuple(
                (t, hz) for t, hz in self._history
                if any(committed.get(p, 0) < h for p, h in enumerate(hz)))
            retired = len(keep) != len(self._history)
            self._history = keep
        return retired

    def load_stats(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(per-partition publish counts, observed business keys, counts)
        — the skew strategy's rebalance input."""
        with self._lock:
            parts = self.partition_pub.copy()
            keys = np.nonzero(self._key_loads)[0].astype(np.int64)
            counts = self._key_loads[keys]
        return parts, keys, counts

    def expand(self, n_partitions: int) -> None:
        """Elastic scale event: append empty partitions (existing logs
        never move — only a routing-table change sends keys their way)."""
        with self._lock:
            add = n_partitions - len(self.partitions)
            assert add >= 0, "partitions never shrink (logs are durable)"
            self.partitions.extend(Partition() for _ in range(add))
            self.partition_pub = np.concatenate(
                [self.partition_pub, np.zeros(add, np.int64)])
            self.cfg.n_partitions = n_partitions

    # ------------------------------------------------------------- durability
    def export_state(self, since: Optional[List[int]] = None
                     ) -> Tuple[Dict, Dict[str, Dict]]:
        """(meta, segments): everything the durability journal needs for
        this topic. ``segments`` holds the partition-log SUFFIXES past
        ``since`` (already-journaled lengths, per partition) as column
        dicts; ``meta`` holds the small full state — lengths, routing
        epoch + live history horizons, publish/key-load counters."""
        with self._lock:
            lengths = [p.length for p in self.partitions]
            marks = list(since or [])
            segments: Dict[str, Dict] = {}
            for p, part in enumerate(self.partitions):
                lo = marks[p] if p < len(marks) else 0
                if part.length > lo:
                    segments[str(p)] = part.read(lo).as_dict()
            meta = {
                "lengths": lengths,
                "n_partitions": int(self.cfg.n_partitions),
                "routing": routing_state(self.routing),
                "history": [{"table": routing_state(t),
                             "horizons": [int(h) for h in hz]}
                            for t, hz in self._history],
                "partition_pub": self.partition_pub.copy(),
                "key_loads": self._key_loads.copy(),
                "untracked": int(self._untracked_key_load),
            }
        return meta, segments

    def restore_state(self, meta: Dict,
                      segments: Dict[int, List[Dict]]) -> None:
        """Cold-restart restore: wipe and rebuild the partition logs from
        journal segments (appended DIRECTLY to their recorded partitions
        — never re-routed, since the records were routed by whatever
        epoch ruled at publish time), the compaction index by replaying
        the restored batches, and the routing/counter state verbatim.

        A partition's value may be a LIST of column dicts (the journal's
        accumulated across-step form) or a single column dict (the shape
        ``export_state`` emits — a direct export->restore round trip,
        e.g. broker migration without a journal in between)."""
        with self._lock:
            n = max(int(meta["n_partitions"]), len(self.partitions))
            self.cfg.n_partitions = n
            self.partitions = [Partition() for _ in range(n)]
            self._compact = {}
            self._compact_view = None
            for p, col_list in segments.items():
                if isinstance(col_list, dict):
                    col_list = [col_list]
                for cols in col_list:
                    batch = RecordBatch(
                        **{k: np.asarray(v) for k, v in cols.items()})
                    self.partitions[int(p)].append(batch)
                    if self.cfg.compacted:
                        self._compact_update(batch)
            self.routing = restore_routing(meta["routing"])
            self._history = tuple(
                (restore_routing(h["table"]), tuple(h["horizons"]))
                for h in meta["history"])
            pub = np.zeros(n, np.int64)
            src = np.asarray(meta["partition_pub"], np.int64)
            pub[:len(src)] = src
            self.partition_pub = pub
            self._key_loads = np.asarray(meta["key_loads"], np.int64).copy()
            self._untracked_key_load = int(meta["untracked"])


def routing_state(table: RoutingTable) -> Dict:
    """JSON/array-serializable form of one routing table."""
    out = {"epoch": int(table.epoch), "kind": table.kind,
           "n_partitions": int(table.n_partitions)}
    if table.kind == "points":
        out["points"] = np.asarray(table.points)
        out["owners"] = np.asarray(table.owners)
    return out


def restore_routing(state: Dict) -> RoutingTable:
    if state["kind"] == "points":
        return RoutingTable.from_points(
            np.asarray(state["points"], np.uint64),
            np.asarray(state["owners"], np.int32),
            int(state["n_partitions"]), int(state["epoch"]))
    return RoutingTable.static(int(state["n_partitions"]),
                               epoch=int(state["epoch"]))


class MessageQueue:
    """Broker: topics + consumer-group offsets (restartable consumption).

    ``offsets`` holds COMMITTED progress (durably processed, survives the
    consumer); ``positions`` holds READ progress (advanced by ``fetch_many``
    before the work is done). The gap between the two is a consumer's
    in-flight window — abandoned wholesale if the consumer dies."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        self.topics: Dict[str, Topic] = {}
        self.offsets: Dict[Tuple[str, str, int], int] = {}  # (group, topic, part)
        self.positions: Dict[Tuple[str, str, int], int] = {}
        self._olock = threading.RLock()
        # fenced consumer groups: an evicted-but-possibly-zombie worker's
        # group is fenced so a late commit/fetch from its wedged thread is
        # dropped (worker names — and therefore groups — are never reused)
        self._fenced: set = set()
        self.fenced_commits = 0
        self.fenced_fetches = 0
        # per-topic publish counters land on this registry — the pipeline
        # passes its own so broker signals share its one read path
        self.metrics = metrics if metrics is not None else MetricsRegistry()

    def create_topic(self, cfg: TopicConfig) -> Topic:
        self.topics[cfg.name] = Topic(
            cfg, self.metrics.shard(f"broker.{cfg.name}"))
        return self.topics[cfg.name]

    def publish(self, topic: str, batch: RecordBatch) -> None:
        self.topics[topic].publish(batch)

    def consume(self, group: str, topic: str, partition: int,
                max_records: Optional[int] = None) -> RecordBatch:
        key = (group, topic, partition)
        with self._olock:
            off = self.offsets.get(key, 0)
        batch = self.topics[topic].partitions[partition].read(off, max_records)
        return batch

    def consume_many(self, group: str, topic: str, partitions,
                     max_records_per_partition: Optional[int] = None
                     ) -> Tuple[RecordBatch, Dict[int, int]]:
        """Coalesce reads across ``partitions`` into ONE columnar batch —
        the Stream Processor's single-dispatch micro-batch. Returns
        (batch, {partition: records_read}); offsets still advance per
        partition via ``commit`` so rebalance handoff stays exact."""
        out: List[RecordBatch] = []
        counts: Dict[int, int] = {}
        t = self.topics[topic]
        for p in partitions:
            with self._olock:
                off = self.offsets.get((group, topic, p), 0)
            if off >= t.partitions[p].length:     # drained: skip the read
                continue
            b = t.partitions[p].read(off, max_records_per_partition)
            if len(b):
                out.append(b)
                counts[p] = len(b)
        return RecordBatch.concat(out), counts

    def fetch_many(self, group: str, topic: str, partitions: Iterable[int],
                   max_records_per_partition: Optional[int] = None
                   ) -> Tuple[RecordBatch, Dict[int, int]]:
        """Position-advancing coalesced read (the concurrent runtime's
        ingest stage). Unlike ``consume_many`` this moves the group's READ
        position immediately, so the next fetch returns fresh records even
        though nothing has been committed yet; the records only count as
        processed when ``commit`` runs (after warehouse load). A fetch
        always resumes from ``max(position, committed)`` so a partition
        granted back after a rebalance never re-reads records the interim
        owner committed."""
        out: List[RecordBatch] = []
        counts: Dict[int, int] = {}
        with self._olock:
            if group in self._fenced:
                self.fenced_fetches += 1
                return RecordBatch.concat(out), counts
        t = self.topics[topic]
        for p in partitions:
            key = (group, topic, p)
            with self._olock:
                start = max(self.positions.get(key, 0),
                            self.offsets.get(key, 0))
                hw = t.partitions[p].length
                if start >= hw:
                    continue
                take = hw - start
                if max_records_per_partition is not None:
                    take = min(take, max_records_per_partition)
                self.positions[key] = start + take
            b = t.partitions[p].read(start, take)
            if len(b):
                out.append(b)
                counts[p] = len(b)
        return RecordBatch.concat(out), counts

    def commit(self, group: str, topic: str, partition: int, n: int) -> None:
        key = (group, topic, partition)
        with self._olock:
            if group in self._fenced:
                self.fenced_commits += 1
                return
            self.offsets[key] = self.offsets.get(key, 0) + n

    def fence_group(self, group: str) -> None:
        """Permanently fence a consumer group: subsequent commits and
        fetches from it are dropped. Called when a worker is forcibly
        evicted (hang/straggler) — its stage threads may still be wedged
        mid-loop and must not move offsets after ownership has been
        transferred to a survivor. Groups derive from worker names and
        names are never reused, so the fence never blocks a legitimate
        successor."""
        with self._olock:
            self._fenced.add(group)

    def is_fenced(self, group: str) -> bool:
        with self._olock:
            return group in self._fenced

    def rewind(self, group: str, topic: str, partition: int) -> None:
        """Drop a group's read-ahead: next fetch resumes from the committed
        offset (used when a worker dies with in-flight fetches)."""
        with self._olock:
            self.positions.pop((group, topic, partition), None)

    def lag(self, group: str, topic: str, partition: int) -> int:
        key = (group, topic, partition)
        with self._olock:
            return (self.topics[topic].high_watermark(partition)
                    - self.offsets.get(key, 0))

    def committed(self, group: str, topic: str, partition: int) -> int:
        with self._olock:
            return self.offsets.get((group, topic, partition), 0)

    def commit_lags(self, group: str) -> Dict[str, Dict[int, int]]:
        """Per topic -> partition: high watermark minus ``group``'s
        committed offset — the health snapshot's backlog read path. One
        offset-lock pass per topic; partition lengths are published
        monotonically, so each entry is exact at its own read instant
        and never torn."""
        out: Dict[str, Dict[int, int]] = {}
        for name, t in self.topics.items():
            with self._olock:
                out[name] = {
                    p: t.partitions[p].length
                    - self.offsets.get((group, name, p), 0)
                    for p in range(len(t.partitions))}
        return out

    def restore_offsets(self, state) -> None:
        """Accepts the dict form (keys either (group, topic, part) tuples
        or "group|topic|part" strings) or the journal's list-of-rows form
        ``[[group, topic, part, n], ...]``. String/row partition ids are
        parsed back to int — a str partition key would never match the
        int-keyed lookups every consume path performs."""
        with self._olock:
            if isinstance(state, list):
                for g, t, p, n in state:
                    self.offsets[(g, t, int(p))] = int(n)
            elif state and isinstance(next(iter(state)), str):
                for k, v in state.items():
                    g, t, p = k.split("|")
                    self.offsets[(g, t, int(p))] = int(v)
            else:
                self.offsets.update(state)
            self.positions.clear()   # read-ahead is not durable state

    def export_offsets(self) -> Dict:
        with self._olock:
            return dict(self.offsets)

    # ------------------------------------------------------------- durability
    def export_state(self, since: Optional[Dict[str, List[int]]] = None
                     ) -> Dict:
        """Broker state for the durability journal: per-topic meta (full,
        small) + partition-log suffixes past ``since[topic]`` (large,
        incremental) + committed offsets as rows. Read-ahead positions
        are deliberately NOT exported — a restart abandons them and
        resumes from the committed offsets (the same contract a worker
        death has always had)."""
        since = since or {}
        meta: Dict[str, Dict] = {}
        segments: Dict[str, Dict] = {}
        for name, t in self.topics.items():
            meta[name], segments[name] = t.export_state(since.get(name))
        with self._olock:
            offsets = [[g, tp, int(p), int(n)]
                       for (g, tp, p), n in self.offsets.items()]
        return {"meta": meta, "segments": segments, "offsets": offsets}

    def restore_broker_state(self, state: Dict) -> None:
        """Restore every topic's logs/routing/counters plus the committed
        offsets. ``state["segments"]`` is the journal-accumulated form:
        {topic: {partition: [column-dict, ...]}} in log order."""
        for name, meta in state["meta"].items():
            self.topics[name].restore_state(
                meta, state["segments"].get(name, {}))
        with self._olock:
            self.offsets.clear()
            self.positions.clear()
        self.restore_offsets(state["offsets"])
