"""Sharded warehouse and serving plane.

Splits the materialized-view fold state and the star-schema warehouse
across ``n_shards`` serving shards. Ownership derives from the
``RoutingTable``: a contiguous range of routing partitions maps to each
shard, and a business key's shard is the shard of its routed partition,
so ``repartition()`` epochs remap shard ownership the same way they remap
worker ownership (surgically: only moved segments migrate, as the
workers' caches do).

Why sharding is by SEGMENT COLUMN, not by delta rows: the fold tree's
float adds are associative only in exact arithmetic, so splitting a
delta's *rows* across shards would change each segment's combine order
and break the bitwise determinism contract. Instead every shard folds
the FULL delta with every segment it does not own masked to the ``-1``
identity (``ComputeBackend.fold_segments_sharded``). The fold tree is
elementwise per segment column, so each owned column is bitwise the
single-device fold and each foreign column stays the exact
``empty_fold_state`` identity forever. Segment extraction is host
integer math on the delta; the masked folds are device work: on the
torch backend every (delta, view, shard) item of a fold cycle goes into
ONE ``fold_segments_many`` launch, so a cycle is one launch and one sync
whatever the shard count (the shards of one card live on that card;
nothing crosses shards on the write path).

Cross-shard reads merge shard-local tables two ways, both exact:

* ``owner_gather`` — pure row selection (segment ``s`` comes from
  ``tables[owner[s]]``), unconditionally bitwise the single-device table.
  This is the authoritative merge the published front uses.
* ``tree_reduce`` — explicit pairwise-halving ``combine_fold`` over the
  shard tables (the merge topology a collective would run). Foreign
  columns contribute exact identities (+0.0 adds, +-inf min/max), so on
  the non-negative KPI domain this is bitwise ``owner_gather``; ``-0.0 +
  0.0`` would flip a ``-0.0`` sum, which is why owner-gather, not the
  reduction, is the authoritative path.

Ownership of a view's segments:

* ``spec.key_aligned`` (oee/downtime by equipment): segment id IS the
  business key, so the owner is the shard of the key's routed partition;
  these views migrate on ``repartition()``.
* otherwise (unit x shift, time windows): a static contiguous split of
  the segment domain, independent of routing epochs; never migrates.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.backend import (combine_fold, empty_fold_state,
                                      sharded_fold_items)
from repro_torch.core.partitioning import RoutingTable
from repro_torch.launch.mesh import mesh_devices
from repro_torch.observability.registry import global_registry
from repro_torch.serving.engine import (EpochSnapshot, MaterializedViewEngine,
                                        ViewState, serving_clock)
from repro_torch.serving.views import ViewSpec

_PLANE_SEQ = itertools.count()


# --------------------------------------------------------------- ownership
class ShardOwnership:
    """Frozen mapping of routing partitions / business keys / view
    segments to serving shards for ONE routing epoch.

    Partition -> shard is the contiguous range split
    ``p * n_shards // n_partitions`` (the mesh analogue of the worker
    assignment); key -> shard goes through ``router.partition_of`` so a
    repartition that re-homes a key re-homes its shard too."""

    def __init__(self, n_shards: int, router: RoutingTable,
                 specs: Sequence[ViewSpec]):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.router = router
        self.specs = tuple(specs)
        self._seg_owners: Dict[str, np.ndarray] = {
            spec.name: self._owners_for(spec) for spec in self.specs}

    def shard_of_partitions(self, parts: np.ndarray) -> np.ndarray:
        parts = np.asarray(parts, np.int64)
        return parts * self.n_shards // self.router.n_partitions

    def shard_of_keys(self, keys: np.ndarray) -> np.ndarray:
        return self.shard_of_partitions(
            self.router.partition_of(np.asarray(keys, np.int64)))

    def _owners_for(self, spec: ViewSpec) -> np.ndarray:
        S = spec.n_segments
        if spec.key_aligned:
            owners = self.shard_of_keys(np.arange(S, dtype=np.int64))
        else:
            owners = np.arange(S, dtype=np.int64) * self.n_shards // S
        owners = np.ascontiguousarray(owners, dtype=np.int64)
        owners.flags.writeable = False
        return owners

    def seg_owners(self, view: str) -> np.ndarray:
        """[n_segments] int64: owning shard of each segment of ``view``."""
        return self._seg_owners[view]

    def owned_segments(self, view: str) -> np.ndarray:
        """[n_shards] int64: how many of the view's segments each shard
        owns (the imbalance signal health() exposes)."""
        return np.bincount(self._seg_owners[view],
                           minlength=self.n_shards).astype(np.int64)

    def with_router(self, router: RoutingTable) -> "ShardOwnership":
        return ShardOwnership(self.n_shards, router, self.specs)


# ----------------------------------------------------------------- merges
def owner_gather(shard_tables: Sequence[np.ndarray],
                 owners: np.ndarray) -> np.ndarray:
    """Authoritative cross-shard merge: segment ``s``'s row is selected
    from its OWNER's table — pure indexing, no arithmetic, so the result
    is unconditionally bitwise the single-device table."""
    stacked = np.stack(shard_tables)
    return np.ascontiguousarray(
        stacked[np.asarray(owners, np.int64),
                np.arange(stacked.shape[1], dtype=np.int64)])


def tree_reduce(shard_tables: Sequence[np.ndarray]) -> np.ndarray:
    """Explicit pairwise-halving reduction over shard-local tables:
    ``ceil(log2(K))`` rounds of ``combine_fold``. Foreign segment columns
    hold exact identities, so each owned column combines with +0.0 /
    +-inf only."""
    tabs = list(shard_tables)
    if not tabs:
        raise ValueError("tree_reduce of zero shard tables")
    while len(tabs) > 1:
        tabs = [combine_fold(tabs[i], tabs[i + 1])
                if i + 1 < len(tabs) else tabs[i]
                for i in range(0, len(tabs), 2)]
    return tabs[0]


# ---------------------------------------------------------------- snapshot
@dataclasses.dataclass(frozen=True)
class ShardedEpochSnapshot(EpochSnapshot):
    """An ``EpochSnapshot`` whose ``states`` hold the owner-gathered
    (merged, single-device-identical) tables, carrying the shard-local
    tables and the ownership they were merged from. Readers that know
    about shards (the batched gather router, checkpoints, health) use the
    extra fields; every other reader sees a plain epoch."""

    shard_states: Mapping[str, Tuple[np.ndarray, ...]] = \
        dataclasses.field(default_factory=dict)
    seg_owners: Mapping[str, np.ndarray] = \
        dataclasses.field(default_factory=dict)
    n_shards: int = 1


# ------------------------------------------------------------------ engine
class ShardedViewEngine(MaterializedViewEngine):
    """Drop-in ``MaterializedViewEngine`` whose fold state lives in
    ``n_shards`` shard-local tables.

    * write path: one ``fold_segments_many`` call per fold cycle for every
      (delta, view, shard) masked item (one launch on a card);
    * publish: owner-gather merge into a ``ShardedEpochSnapshot`` whose
      merged tables are bitwise the unsharded engine's, so the whole read
      stack (reports, batched plans, prefix folds, ``rebuild`` oracles)
      works unchanged;
    * ``reown(router)``: surgical ownership remap on repartition — only
      segments whose owner changed move between shard tables;
    * durability: ``export_fold_state`` also captures the per-shard tables
      and the ownership, so recovery restores a sharded engine."""

    def __init__(self, specs: Sequence[ViewSpec], n_shards: int,
                 router: Optional[RoutingTable] = None, backend=None,
                 idle_backoff_s: float = 0.001, scan_fold: bool = False,
                 device: str = "cuda"):
        if scan_fold:
            raise ValueError(
                "ShardedViewEngine folds through the halving tree only "
                "(the opt-in write-side scan form has no sharded twin)")
        super().__init__(specs, backend=backend,
                         idle_backoff_s=idle_backoff_s, scan_fold=False,
                         device=device)
        router = router if router is not None \
            else RoutingTable.static(max(int(n_shards), 1))
        self.ownership = ShardOwnership(n_shards, router, self.specs)
        self.n_shards = self.ownership.n_shards
        # shard-local master tables: replaced functionally per fold
        # (combine_fold returns new arrays), guarded by _fold_lock
        self._shard_tables: Dict[str, List[np.ndarray]] = {
            s.name: [empty_fold_state(s.n_segments, s.n_lanes)
                     for _ in range(self.n_shards)]
            for s in self.specs}
        # shard.* counters on the process-global registry (one read path
        # with the backend dispatch counters; health() merges them)
        mshard = global_registry().shard(f"shard_plane#{next(_PLANE_SEQ)}")
        self._c_fold_rows = [mshard.counter(f"shard.fold_rows.{k}")
                             for k in range(self.n_shards)]
        self._c_fold_cycles = mshard.counter("shard.fold.cycles")
        self._c_fold_items = mshard.counter("shard.fold.items")
        self._c_merge_bytes = mshard.counter("shard.merge.bytes")
        self._c_merge_dispatches = mshard.counter("shard.merge.dispatches")
        self._c_reowns = mshard.counter("shard.reowns")
        self._c_moved = mshard.counter("shard.reown.segments_moved")
        self._front = self._publish_front(
            epoch=0, watermark=-np.inf, rows_folded=0, deltas_folded=0)

    # ----------------------------------------------------------- publication
    def _publish_front(self, *, epoch: int, watermark: float,
                       rows_folded: int, deltas_folded: int
                       ) -> ShardedEpochSnapshot:
        """Owner-gather every view's shard tables into one merged epoch
        (under _fold_lock, but for the constructor's empty epoch). Counts
        the merge traffic: one gather per view, the merged table's bytes
        crossing the shard boundary."""
        states, shard_states, seg_owners = {}, {}, {}
        for spec in self.specs:
            owners = self.ownership.seg_owners(spec.name)
            tabs = tuple(self._shard_tables[spec.name])
            merged = owner_gather(tabs, owners)
            merged.flags.writeable = False
            states[spec.name] = ViewState(spec, merged)
            shard_states[spec.name] = tabs
            seg_owners[spec.name] = owners
            self._c_merge_dispatches.inc()
            self._c_merge_bytes.inc(merged.nbytes)
        return ShardedEpochSnapshot(
            epoch=epoch, states=states, published_at=serving_clock(),
            watermark_event_time=watermark, rows_folded=rows_folded,
            deltas_folded=deltas_folded, shard_states=shard_states,
            seg_owners=seg_owners, n_shards=self.n_shards)

    # ------------------------------------------------------------ fold cycle
    def fold_pending(self, max_deltas: Optional[int] = None) -> int:
        """The sharded fold cycle: the unsharded engine's delta order,
        watermark and staleness bookkeeping, with every (delta, view,
        shard) masked fold of the drain in ONE ``fold_segments_many``
        call, each shard table combined with its items in delta order.
        Publishes ONE merged epoch."""
        with self._fold_lock:
            with self._q_lock:
                take = len(self._pending) if max_deltas is None \
                    else min(max_deltas, len(self._pending))
                deltas = [self._pending.popleft() for _ in range(take)]
            if not deltas:
                return 0
            with self.tracer.span("serving.fold") as sp:
                front = self._front
                watermark = front.watermark_event_time
                rows = sum(len(d.facts) for d in deltas)
                K = self.n_shards
                items, live = [], 0
                for d in deltas:
                    vfacts = d.facts[d.facts[:, 9] > 0.5]
                    for spec in self.specs:
                        owners = self.ownership.seg_owners(spec.name)
                        seg = spec.segments(vfacts)
                        items += sharded_fold_items(
                            seg, spec.values(vfacts), spec.n_segments,
                            owners, K)
                        in_range = (seg >= 0) & (seg < spec.n_segments)
                        per_shard = np.bincount(owners[seg[in_range]],
                                                minlength=K)
                        live += int((per_shard > 0).sum())
                        for k in range(K):
                            self._c_fold_rows[k].inc(int(per_shard[k]))
                aggs = iter(self.backend.fold_segments_many(items))
                for d in deltas:
                    for spec in self.specs:
                        tabs = self._shard_tables[spec.name]
                        for k in range(K):
                            tabs[k] = combine_fold(tabs[k], next(aggs))
                    watermark = max(watermark,
                                    float(d.event_times.max())
                                    if d.event_times is not None
                                    and len(d.event_times)
                                    else d.published_at)
                if live:
                    self._c_fold_cycles.inc()
                    self._c_fold_items.inc(live)
                snap = self._publish_front(
                    epoch=front.epoch + 1, watermark=watermark,
                    rows_folded=front.rows_folded + rows,
                    deltas_folded=front.deltas_folded + len(deltas))
                self._front = snap       # the atomic epoch swap
                for d in deltas:
                    if d.event_times is not None:
                        self.staleness_recorder.add(
                            snap.published_at - d.event_times)
                sp.put("deltas", len(deltas))
                sp.put("rows", rows)
                sp.put("items", live)
                sp.put("epoch", snap.epoch)
            return rows

    # ------------------------------------------------------------ reads
    def tree_reduced_table(self, view: str) -> np.ndarray:
        """The explicit cross-shard tree-reduce read of one view:
        pairwise-halving ``combine_fold`` over the front's shard-local
        tables. Equal to the owner-gathered front on the KPI domain."""
        tabs = self._front.shard_states[view]
        self._c_merge_dispatches.inc(max(0, len(tabs) - 1))
        self._c_merge_bytes.inc(sum(t.nbytes for t in tabs[1:]))
        return tree_reduce(tabs)

    # ------------------------------------------------------------ reown
    def reown(self, router: RoutingTable) -> Dict[str, int]:
        """Surgical shard-ownership remap for a new routing epoch: only
        key-aligned views can move, and within them only the segments
        whose owner shard changed are copied to the new owner (old slot
        reset to the identity). Merged state is invariant — the same rows
        live on different shards. Republishes the front (same epoch and
        counters) so checkpoints and the batched gather router see the
        new placement at once."""
        with self._fold_lock:
            old = self.ownership
            new = old.with_router(router)
            moved_total = views_changed = 0
            for spec in self.specs:
                ow_old = old.seg_owners(spec.name)
                ow_new = new.seg_owners(spec.name)
                moved = np.nonzero(ow_old != ow_new)[0]
                if not len(moved):
                    continue
                views_changed += 1
                moved_total += len(moved)
                tabs = self._shard_tables[spec.name]
                src = owner_gather(tabs, ow_old)   # pre-move residents
                ident = empty_fold_state(spec.n_segments, spec.n_lanes)
                touched = set(ow_old[moved].tolist()) \
                    | set(ow_new[moved].tolist())
                for k in touched:
                    t = tabs[k].copy()
                    lost = moved[ow_old[moved] == k]
                    gained = moved[ow_new[moved] == k]
                    t[lost] = ident[lost]
                    t[gained] = src[gained]
                    tabs[k] = t
            self.ownership = new
            self._c_reowns.inc()
            self._c_moved.inc(moved_total)
            front = self._front
            self._front = self._publish_front(
                epoch=front.epoch, watermark=front.watermark_event_time,
                rows_folded=front.rows_folded,
                deltas_folded=front.deltas_folded)
            return {"segments_moved": int(moved_total),
                    "views_changed": int(views_changed),
                    "routing_epoch": int(router.epoch)}

    # ------------------------------------------------------------ durability
    def export_fold_state(self) -> Dict:
        """The base export (merged tables and counters, lock-free on the
        immutable front) plus the per-shard tables and the ownership they
        were folded under."""
        front = self._front
        state = super().export_fold_state()
        state["shard"] = {
            "n_shards": int(front.n_shards),
            "routing_epoch": int(self.ownership.router.epoch),
            "tables": {name: np.stack(tabs)
                       for name, tabs in front.shard_states.items()},
            "seg_owners": {name: np.asarray(own)
                           for name, own in front.seg_owners.items()},
        }
        return state

    def restore_fold_state(self, state: Dict) -> None:
        """Restore the merged front (authoritative, as the base engine
        does), then place the shard-local tables: straight from the
        checkpoint when its ownership matches this engine's (same shard
        count and per-view owners), else re-derived exactly from the
        merged tables under the CURRENT ownership (owned columns from the
        merged table, foreign columns the identity). The re-derivation
        restores a checkpoint onto another shard count or routing epoch,
        and an unsharded checkpoint onto shards, without any bitwise
        drift."""
        super().restore_fold_state(state)
        shard = state.get("shard")
        with self._fold_lock:
            usable = (shard is not None
                      and int(shard.get("n_shards", -1)) == self.n_shards)
            if usable:
                usable = all(np.array_equal(
                    np.asarray(shard["seg_owners"][spec.name], np.int64),
                    self.ownership.seg_owners(spec.name))
                    for spec in self.specs)
            for spec in self.specs:
                merged = np.asarray(state["tables"][spec.name], np.float32)
                owners = self.ownership.seg_owners(spec.name)
                if usable:
                    stacked = np.asarray(shard["tables"][spec.name],
                                         np.float32)
                    tabs = [np.ascontiguousarray(stacked[k])
                            for k in range(self.n_shards)]
                else:
                    ident = empty_fold_state(spec.n_segments, spec.n_lanes)
                    tabs = [np.where(owners[:, None] == k, merged, ident)
                            for k in range(self.n_shards)]
                self._shard_tables[spec.name] = tabs
            front = self._front
            self._front = self._publish_front(
                epoch=front.epoch, watermark=front.watermark_event_time,
                rows_folded=front.rows_folded,
                deltas_folded=front.deltas_folded)

    # ---------------------------------------------------------- observability
    def mesh_report(self) -> Dict:
        """The health() ``mesh`` block: shard count, per-shard fold rows
        and owned segments (the imbalance signal the control plane's
        observation vector reads), fold cycles and items, merge traffic,
        reown history."""
        fold_rows = [c.value for c in self._c_fold_rows]
        mean = sum(fold_rows) / max(1, len(fold_rows))
        mesh = self.backend.mesh
        return {
            "n_shards": self.n_shards,
            "device_mesh": (mesh is not None
                            and mesh_devices(mesh) == self.n_shards),
            "routing_epoch": int(self.ownership.router.epoch),
            "fold_rows": fold_rows,
            "fold_rows_imbalance": round(max(fold_rows) / mean, 4)
            if mean > 0 else 1.0,
            "owned_segments": {spec.name: self.ownership.owned_segments(
                spec.name).tolist() for spec in self.specs},
            "fold": {"cycles": self._c_fold_cycles.value,
                     "items": self._c_fold_items.value},
            "merge": {"bytes": self._c_merge_bytes.value,
                      "dispatches": self._c_merge_dispatches.value},
            "reowns": self._c_reowns.value,
            "segments_moved": self._c_moved.value,
        }

    def attach_metrics(self, shard) -> None:
        super().attach_metrics(shard)
        shard.gauge_fn("shard.n_shards", lambda: self.n_shards)
        shard.gauge_fn(
            "shard.fold_rows_imbalance",
            lambda: self.mesh_report()["fold_rows_imbalance"])


__all__ = ["ShardOwnership", "ShardedEpochSnapshot", "ShardedViewEngine",
           "owner_gather", "tree_reduce"]
