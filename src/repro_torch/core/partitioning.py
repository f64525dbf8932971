"""Key partitioning (paper §3.1.1): master topics partition by *row key*
(so the latest-per-key compaction reconstructs a table snapshot);
operational topics partition by *business key* (the Stream Processor's
parallelism unit — each partition's lifecycle stays on one worker / one
data shard).

Partitioning is a pluggable, *adaptive* subsystem:

* a ``RoutingTable`` is an immutable, versioned key→partition mapping
  (its version is the **routing epoch**; ``Topic`` carries the current
  table plus the still-draining historical ones, so records published
  under epoch E stay readable while the coordinator migrates to E+1);
* a ``PartitionStrategy`` produces routing tables: ``static`` is the
  paper's bare ``hash % n``; ``consistent`` is a virtual-node hash ring
  whose scale events move only ~1/n of the key space; ``skew`` splits
  hot business-key hash ranges and merges cold ones from observed load,
  so a Zipf-skewed workload (a few hot equipment units emitting most
  events) spreads across partitions instead of pinning one worker;
* ``PartitionAssignment`` maps partitions → workers with a *sticky,
  load-aware* rebalance (greedy LPT preferring the current owner), so a
  scale event moves ~1/n_workers of the key space instead of the ~all
  that round-robin reassignment moved.

The same hashing discipline drives the MoE expert dispatch (a token is a
message, the router's expert choice is its business key):
``assign_positions`` in ``repro.models.moe`` is the capacity-bounded
variant of this assignment.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_MIX = np.uint64(0x9E3779B97F4A7C15)
_UINT64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def hash_key(keys: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix (splitmix64 finalizer-style)."""
    with np.errstate(over="ignore"):
        x = np.asarray(keys).astype(np.uint64) * _MIX
        x ^= x >> np.uint64(31)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(29)
    return x


def partition_of(keys: np.ndarray, n_partitions: int) -> np.ndarray:
    return (hash_key(keys) % np.uint64(n_partitions)).astype(np.int32)


def isin_sorted(sorted_keys: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Vectorized membership of ``values`` in a SORTED unique key array via
    binary search (the shared idiom behind worker business-key filtering and
    compacted-snapshot filtering). Returns a bool mask over ``values``."""
    if not len(sorted_keys):
        return np.zeros(len(values), bool)
    idx = np.minimum(np.searchsorted(sorted_keys, values),
                     len(sorted_keys) - 1)
    return sorted_keys[idx] == values


# ===================================================================== routing
@dataclasses.dataclass(frozen=True)
class RoutingTable:
    """Immutable, versioned key→partition mapping (one routing epoch).

    Two representations share one vectorized lookup:

    * ``kind="mod"`` — the static hash: ``hash_key(k) % n_partitions``
      (byte-identical to the pre-adaptive behavior; the default);
    * ``kind="points"`` — a sorted array of uint64 *points* over the hash
      space with an owner partition per point. A key belongs to the first
      point ≥ its hash (wrapping), which expresses both a consistent-hash
      ring (points = virtual nodes) and a range table (points = range
      upper bounds, last = 2^64−1).
    """

    epoch: int
    kind: str                              # "mod" | "points"
    n_partitions: int
    points: Optional[np.ndarray] = None    # uint64 [R] sorted, read-only
    owners: Optional[np.ndarray] = None    # int32  [R], read-only

    @staticmethod
    def static(n_partitions: int, epoch: int = 0) -> "RoutingTable":
        return RoutingTable(epoch=epoch, kind="mod", n_partitions=n_partitions)

    @staticmethod
    def from_points(points: np.ndarray, owners: np.ndarray,
                    n_partitions: int, epoch: int) -> "RoutingTable":
        order = np.argsort(points, kind="stable")
        points = np.ascontiguousarray(points[order])
        owners = np.ascontiguousarray(owners[order].astype(np.int32))
        points.flags.writeable = False
        owners.flags.writeable = False
        return RoutingTable(epoch=epoch, kind="points",
                            n_partitions=n_partitions,
                            points=points, owners=owners)

    def partition_of(self, keys: np.ndarray) -> np.ndarray:
        if self.kind == "mod":
            return partition_of(keys, self.n_partitions)
        h = hash_key(keys)
        idx = np.searchsorted(self.points, h, side="left")
        return self.owners[idx % len(self.points)]

    def moved_fraction(self, other: "RoutingTable",
                       keys: np.ndarray) -> float:
        """Fraction of ``keys`` whose partition differs under ``other`` —
        the migration cost of an epoch change."""
        if not len(keys):
            return 0.0
        return float(np.mean(self.partition_of(keys)
                             != other.partition_of(keys)))


def partition_bounds(keys: np.ndarray, n_partitions: int,
                     router: Optional[RoutingTable] = None):
    """Stable single-gather bucketing by partition. Returns (order, bounds):
    rows of partition p are ``order[bounds[p]:bounds[p+1]]`` — the one
    algorithm behind queue publish and warehouse load splitting. With a
    ``router`` the bucketing follows that routing epoch; without one it is
    the stable static hash (the loader keeps using the static layout so
    chunk row order is invariant to routing epochs — see ``loader``)."""
    parts = (partition_of(keys, n_partitions) if router is None
             else router.partition_of(keys))
    order = np.argsort(parts, kind="stable")
    bounds = np.searchsorted(parts[order], np.arange(n_partitions + 1))
    return order, bounds


# ================================================================== strategies
class PartitionStrategy:
    """Produces routing tables. Stateless: observed load comes in as
    arguments (the broker's per-partition/per-key publish counters), the
    new epoch comes out as an immutable table."""

    name = "static"

    def initial_table(self, n_partitions: int) -> RoutingTable:
        return RoutingTable.static(n_partitions)

    def scaled_table(self, table: RoutingTable,
                     n_partitions: int) -> RoutingTable:
        """Table for a changed partition count (elastic scale event)."""
        return RoutingTable.static(n_partitions, epoch=table.epoch + 1)

    def rebalanced_table(self, table: RoutingTable,
                         partition_loads: Optional[np.ndarray] = None,
                         key_loads: Optional[Tuple[np.ndarray, np.ndarray]]
                         = None) -> RoutingTable:
        """Adapt to observed load. Default: static hash cannot adapt."""
        return table


class StaticHashStrategy(PartitionStrategy):
    """The paper's bare ``hash_key % n_partitions``."""


class ConsistentHashStrategy(PartitionStrategy):
    """Hash ring with ``virtual_nodes`` points per partition: when the
    partition count changes, only the arcs claimed by the new (or removed)
    partitions' points move — ~1/n_partitions of the key space instead of
    the ~(1 − 1/n) a modulus reshuffle moves."""

    name = "consistent"
    _VNODE_SHIFT = np.uint64(20)       # vnode ids stable across scale events

    def __init__(self, virtual_nodes: int = 64):
        self.virtual_nodes = virtual_nodes

    def _ring(self, n_partitions: int, epoch: int) -> RoutingTable:
        v = self.virtual_nodes
        ids = ((np.arange(n_partitions, dtype=np.uint64)[:, None]
                << self._VNODE_SHIFT)
               | np.arange(v, dtype=np.uint64)[None, :])
        points = hash_key(ids.reshape(-1))
        owners = np.repeat(np.arange(n_partitions, dtype=np.int32), v)
        return RoutingTable.from_points(points, owners, n_partitions, epoch)

    def initial_table(self, n_partitions: int) -> RoutingTable:
        return self._ring(n_partitions, 0)

    def scaled_table(self, table: RoutingTable,
                     n_partitions: int) -> RoutingTable:
        return self._ring(n_partitions, table.epoch + 1)


class SkewAwareStrategy(PartitionStrategy):
    """Range table over the hash space, adapted from observed load: the
    hottest partition's heaviest range is split at its load-weighted
    median and the cooler half handed to the coldest partition, until the
    partition-load imbalance (max/mean) drops under ``imbalance_target``
    or no split can improve it (a single business key is atomic — the
    paper's unit of worker affinity — so one key hotter than the mean is
    the floor). Adjacent ranges with one owner merge back, and only moved
    ranges change key→partition mapping, so cache migration stays
    surgical."""

    name = "skew"

    def __init__(self, imbalance_target: float = 1.15,
                 max_ranges_per_partition: int = 8,
                 max_splits: int = 256):
        self.imbalance_target = imbalance_target
        self.max_ranges_per_partition = max_ranges_per_partition
        self.max_splits = max_splits

    def initial_table(self, n_partitions: int) -> RoutingTable:
        return self._equal_ranges(n_partitions, 0)

    def scaled_table(self, table: RoutingTable,
                     n_partitions: int) -> RoutingTable:
        return self._equal_ranges(n_partitions, table.epoch + 1)

    @staticmethod
    def _equal_ranges(n_partitions: int, epoch: int) -> RoutingTable:
        step = (1 << 64) // n_partitions         # Python ints: no overflow
        pts = [(i + 1) * step - 1 for i in range(n_partitions)]
        pts[-1] = (1 << 64) - 1
        points = np.array(pts, dtype=np.uint64)
        owners = np.arange(n_partitions, dtype=np.int32)
        return RoutingTable.from_points(points, owners, n_partitions, epoch)

    def rebalanced_table(self, table, partition_loads=None, key_loads=None):
        if key_loads is None:
            return table
        keys, counts = key_loads
        keys = np.asarray(keys, np.int64)
        counts = np.asarray(counts, np.float64)
        if not len(keys) or counts.sum() <= 0:
            return table
        n = table.n_partitions
        if table.kind == "mod":
            base = self._equal_ranges(n, table.epoch)
            points = base.points.copy()
            owners = base.owners.copy()
        else:
            points = table.points.copy()
            owners = table.owners.copy()

        hk = hash_key(keys)
        order = np.argsort(hk, kind="stable")
        h, w = hk[order], counts[order]

        changed = False
        frozen = np.zeros(n, bool)     # partitions that cannot be improved
        for _ in range(self.max_splits):
            ridx = np.searchsorted(points, h, side="left")
            range_load = np.bincount(ridx, weights=w, minlength=len(points))
            part_load = np.zeros(n)
            np.add.at(part_load, owners, range_load)
            mean = part_load.sum() / n
            if mean <= 0 or not (~frozen).any():
                break
            hot = int(np.where(frozen, -1.0, part_load).argmax())
            cold = int(part_load.argmin())
            if part_load[hot] <= self.imbalance_target * mean or cold == hot:
                break
            hot_ranges = np.nonzero(owners == hot)[0]
            r = int(hot_ranges[range_load[hot_ranges].argmax()])
            sel = np.nonzero(ridx == r)[0]
            uniq = np.unique(h[sel])
            if len(uniq) >= 2 and \
                    len(points) < n * self.max_ranges_per_partition:
                # load-weighted median split inside the hot range: the
                # lower piece (≈ half the range's load) goes to the
                # coldest partition, but never more than its deficit
                cum = np.cumsum(w[sel])
                give = min(cum[-1] / 2.0, mean - part_load[cold])
                j = int(np.searchsorted(cum, max(give, w[sel][0])))
                j = min(j, len(sel) - 1)
                cut = h[sel][j]
                if cut >= uniq[-1]:          # keep ≥1 key on the hot side
                    cut = uniq[-2]
                points = np.insert(points, r, cut)
                owners = np.insert(owners, r, cold)
                changed = True
            else:
                # the hot range is one atomic key (or the table is at its
                # size cap): peel the hot partition's lightest non-empty
                # other range off to the coldest, if that strictly lowers
                # the pair's max (no ping-pong)
                others = hot_ranges[(hot_ranges != r)
                                    & (range_load[hot_ranges] > 0)]
                if len(others):
                    mv = int(others[range_load[others].argmin()])
                    if part_load[cold] + range_load[mv] < part_load[hot]:
                        owners[mv] = cold
                        changed = True
                        continue
                # a single atomic key hotter than the mean is the floor
                frozen[hot] = True
        if not changed:
            return table
        # merge: adjacent ranges with the same owner collapse (the
        # "merges cold ones" half of the adaptation)
        keep = np.append(owners[:-1] != owners[1:], True)
        points, owners = points[keep], owners[keep]
        return RoutingTable.from_points(points, owners, n, table.epoch + 1)


_STRATEGIES = {
    "static": StaticHashStrategy,
    "consistent": ConsistentHashStrategy,
    "skew": SkewAwareStrategy,
}


def get_strategy(name_or_instance) -> PartitionStrategy:
    """Resolve a strategy by name ("static" | "consistent" | "skew"),
    passing instances through; "" / None mean static."""
    if isinstance(name_or_instance, PartitionStrategy):
        return name_or_instance
    name = name_or_instance or "static"
    try:
        return _STRATEGIES[name]()
    except KeyError:
        raise ValueError(f"unknown partition strategy {name!r}; "
                         f"known: {sorted(_STRATEGIES)}") from None


# ================================================================== assignment
class PartitionAssignment:
    """business-key partitions → worker assignment with rebalancing
    (paper §3.2: on failure/scale events the coordinator reassigns and the
    cache-migration trigger fires for workers whose key set changed).

    ``rebalance`` is a sticky, load-aware greedy LPT: partitions are
    placed heaviest-first onto the least-loaded worker, preferring the
    current owner among equals — so survivors keep their partitions (and
    their caches) and a scale event moves ~1/n_workers of the load, where
    the old round-robin reshuffle moved nearly everything."""

    def __init__(self, n_partitions: int, workers: Sequence[str]):
        self.n_partitions = n_partitions
        self.assignment: Dict[int, str] = {}
        self.rebalance(list(workers))

    def rebalance(self, workers: List[str],
                  weights: Optional[np.ndarray] = None,
                  slack: float = 1.1) -> Dict[str, List[int]]:
        """Reassign all partitions across ``workers``; ``weights`` (one
        non-negative load figure per partition, e.g. observed records)
        drives the balance — uniform when omitted. Sticky: walking the
        partitions heaviest-first, the CURRENT owner keeps a partition as
        long as its projected load stays within ``slack`` × the balanced
        mean — so a partition only moves when balance demands it (every
        move costs its new owner a cache migration); the remainder fills
        least-loaded-first. Returns ``{worker: sorted gained partitions}``
        with EVERY worker present (an empty list means nothing moved to
        it), so callers can fire cache-migration triggers without
        special-casing survivors."""
        if not workers:
            raise ValueError("no workers alive")
        n = self.n_partitions
        if weights is None:
            wts = np.ones(n)
        else:
            wts = np.asarray(weights, np.float64)
            assert len(wts) == n, "one weight per partition"
            wts = np.maximum(wts, 0.0)
        target = slack * wts.sum() / len(workers)
        # count budget keeps zero-weight partitions spread too (future
        # load has to land somewhere)
        count_target = max(1, int(np.ceil(slack * n / len(workers))))
        old = dict(self.assignment)
        load = {w: 0.0 for w in workers}
        count = {w: 0 for w in workers}
        rank = {w: i for i, w in enumerate(workers)}
        for p in np.argsort(-wts, kind="stable"):
            p = int(p)
            ow = old.get(p)
            if ow in load and load[ow] + wts[p] <= target \
                    and count[ow] < count_target:
                best = ow
            else:
                best = min(workers,
                           key=lambda w: (load[w],
                                          0 if ow == w else 1,
                                          count[w], rank[w]))
            self.assignment[p] = best
            load[best] += float(wts[p])
            count[best] += 1
        changed: Dict[str, List[int]] = {w: [] for w in workers}
        for p, w in self.assignment.items():
            if old.get(p) != w:
                changed[w].append(p)
        return {w: sorted(ps) for w, ps in changed.items()}

    def grow(self, n_partitions: int) -> None:
        """Adopt an expanded partition count (new partitions are assigned
        on the next ``rebalance``)."""
        assert n_partitions >= self.n_partitions
        self.n_partitions = n_partitions

    def partitions_of(self, worker: str) -> List[int]:
        return sorted(p for p, w in self.assignment.items() if w == worker)

    def worker_of(self, partition: int) -> str:
        return self.assignment[partition]
