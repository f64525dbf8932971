"""Compute-backend layer: the pluggable numeric engine of the Stream
Processor (paper §3.3 technology-independence, made literal).

Every hot op of the Data Transformer / In-memory Table Updater and of the
serving views is expressed against the ``ComputeBackend`` protocol:

  * ``hash_probe``     — open-addressing probe of the in-memory master cache
                         (the streaming join of §3.1.2),
  * ``transform_block``— the fact-grain transform: both cache probes +
                         interval intersection (Fig. 3) + OEE KPI math (§4),
                         returning a device-resident ``FactBlock`` (and,
                         with ``n_units``, the per-unit KPI rollup —
                         ``transform_and_rollup``),
  * ``transform``      — host-convenience wrapper: ``transform_block`` +
                         an immediate ``FactBlock.to_host()``,
  * ``segment_reduce`` — per-equipment KPI rollup of a fact block (the
                         full-rescan oracle; the hot path gets the rollup
                         from ``transform_and_rollup``),
  * ``fold_segments``  — the serving layer's incremental-view delta fold
                         (count + sum + min + max per segment per lane),
                         segment-compacted, one kernel launch per block,
  * ``fold_segments_scan`` — the same fold as an associative scan over
                         bit-reversed rows, bitwise equal to the tree,
  * ``batch_gather_stats`` — the batched point-query read: one gather for
                         a whole batch of per-segment stat lookups,
  * ``prefix_fold``    — all S window prefixes of a packed view table in
                         one associative scan (oracle:
                         ``prefix_fold_reference``).

Two registered implementations:

  ``numpy``   pure-host reference (the oracle), chosen only by name,
  ``torch``   the default: the hand-written CUDA kernels of
              ``repro_torch.kernels`` on ``device="cuda"``; on
              ``device="cpu"`` every kernel wrapper runs its plain PyTorch
              version, so the CPU tests drive the same code path.

Selection: explicit name > ``ETLConfig.backend`` > ``"torch"``.
``get_backend(name, device)`` returns one instance per (name, device);
asking for ``cuda`` where CUDA is absent raises.

Protocol boundaries: inputs are host numpy arrays; ``transform_block``
returns an opaque ``FactBlock`` whose tensors stay on the device (no
synchronisation) until ``to_host()`` at the warehouse-load boundary. The
torch backend mirrors the cache to the device lazily via
``InMemoryTable.device_state`` (component-dirty tracked).

Instrumentation: every backend instance counts ``op_dispatches`` (kernel
dispatch groups issued) and ``host_syncs`` (blocking device->host
materializations), with the reference package's meaning. The torch backend
counts the same on CPU and CUDA, so the CPU tests pin what a card run
does.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Tuple, Type, Union

import numpy as np
import torch

from repro_torch.kernels.hash_join import ops as hash_join_ops
from repro_torch.kernels.segment_kpi import ops as segment_kpi_ops
from repro_torch.kernels.segment_kpi.ref import (np_maximum, np_minimum,
                                                 unit_rollup_ref)
from repro_torch.observability.registry import global_registry

EPS = 1e-6
DEFAULT_BACKEND = "torch"
DEFAULT_DEVICE = "cuda"

# backends are process singletons (get_backend) but tests construct ad-hoc
# instances too; each instance gets its own registry shard so resets stay
# per-instance while the merged read path sums per-backend process totals
_BACKEND_SEQ = itertools.count()

# fact layout produced by every backend's ``transform`` (keep in sync with
# repro_torch.core.transformer.FACT_COLUMNS)
N_FACT = 10
KPI_LANES = 5   # availability, performance, quality, oee, count

# ------------------------------------------------------------- fold layout
# ``fold_segments`` packs its fused statistics as one [n_segments, W] f32
# table, W = 1 + 3 * n_lanes: [count | sums(L) | mins(L) | maxs(L)].
# Empty segments carry count 0, sum 0, min +inf, max -inf — the identity
# elements, so folds combine associatively lane-by-lane.
FOLD_BLOCK = 2048   # max rows per fold dispatch (bounds the [B, S, L] temp)


def fold_width(n_lanes: int) -> int:
    return 1 + 3 * n_lanes


def empty_fold_state(n_segments: int, n_lanes: int) -> np.ndarray:
    """The fold identity: what every view's aggregate state starts as."""
    out = np.zeros((n_segments, fold_width(n_lanes)), np.float32)
    out[:, 1 + n_lanes:1 + 2 * n_lanes] = np.inf
    out[:, 1 + 2 * n_lanes:] = -np.inf
    return out


def combine_fold(state: np.ndarray, delta: np.ndarray) -> np.ndarray:
    """Associative combine of two packed fold tables (host, elementwise —
    the same ops in every backend, so combining is bitwise deterministic).
    Returns a NEW array; never mutates either input (the serving layer's
    published epochs are immutable)."""
    L = (state.shape[1] - 1) // 3
    out = np.empty_like(state)
    out[:, :1 + L] = state[:, :1 + L] + delta[:, :1 + L]          # count+sum
    out[:, 1 + L:1 + 2 * L] = np.minimum(state[:, 1 + L:1 + 2 * L],
                                         delta[:, 1 + L:1 + 2 * L])
    out[:, 1 + 2 * L:] = np.maximum(state[:, 1 + 2 * L:],
                                    delta[:, 1 + 2 * L:])
    return out


def _fold_tree_np(seg: np.ndarray, vals: np.ndarray,
                  n_segments: int) -> np.ndarray:
    """Reference fold of ONE padded power-of-two block: a fixed pairwise
    halving tree over the one-hot-masked lanes. Every op is an exact or
    correctly-rounded IEEE elementwise op applied in a shape-determined
    order, so the jax twin (same tree) produces bitwise-identical results —
    the property behind the serving layer's byte-identical
    incremental-vs-recompute equivalence tests. Rows with seg outside
    [0, n_segments) (including the -1 padding) contribute the identity."""
    onehot = seg[:, None] == np.arange(n_segments, dtype=seg.dtype)[None, :]
    oh = onehot.astype(np.float32)                       # [B, S]
    cnt = oh
    sums = oh[:, :, None] * vals[:, None, :]             # exact: x*{0,1}
    mins = np.where(onehot[:, :, None], vals[:, None, :],
                    np.float32(np.inf))
    maxs = np.where(onehot[:, :, None], vals[:, None, :],
                    np.float32(-np.inf))
    while cnt.shape[0] > 1:
        h = cnt.shape[0] // 2
        cnt = cnt[:h] + cnt[h:]
        sums = sums[:h] + sums[h:]
        mins = np.minimum(mins[:h], mins[h:])
        maxs = np.maximum(maxs[:h], maxs[h:])
    return np.concatenate([cnt[0][:, None], sums[0], mins[0], maxs[0]],
                          axis=1)


def _fold_blocks(seg: np.ndarray, vals: np.ndarray, n_segments: int,
                 tree) -> np.ndarray:
    """Shared delta driver, SEGMENT-COMPACTED: ``np.unique`` the delta's
    live segment ids, remap them to a dense [0, n_active) range, fold the
    halving tree over ``[block, n_active, lanes]`` instead of
    ``[block, n_segments, lanes]``, then scatter the folded columns back
    into the packed ``[n_segments, W]`` table. A delta touching 2 of 2048
    segments folds a 2-wide tree, not a 2048-wide one.

    Bitwise contract unchanged: the tree is elementwise per segment column
    (a segment's fold never reads another segment's lanes), so dropping
    inactive columns and scattering afterwards reproduces the uncompacted
    tree's per-segment op order EXACTLY — the numpy==jax bitwise
    determinism and ``rebuild()`` byte-identity properties survive
    (asserted against an uncompacted reference in tests/test_serving.py).

    Chunking as before: <= FOLD_BLOCK row blocks, each padded to a power of
    two with seg = -1 identity rows, partials chained in block order (host
    combine). The active-column count is padded to a power of two (>= 8,
    capped at n_segments) so jitted trees compile once per
    (rows, columns) bucket, not once per distinct delta sparsity."""
    seg = np.asarray(seg, np.int64)
    vals = np.asarray(vals, np.float32)
    if vals.ndim == 1:
        vals = vals[:, None]
    n, L = vals.shape
    out = empty_fold_state(n_segments, L)
    if n == 0:
        return out
    in_range = (seg >= 0) & (seg < n_segments)
    live = np.unique(seg[in_range])
    n_active = len(live)
    if n_active == 0:
        return out                       # nothing but identity rows
    n_fold = min(n_segments, max(8, 1 << (n_active - 1).bit_length()))
    # rows outside [0, n_segments) become -1 (identity), live ids become
    # their rank in the sorted live array — the compact column index.
    # Dense deltas (every segment live) skip the remap: rank == id.
    if n_active == n_segments:
        cseg = seg if in_range.all() else np.where(in_range, seg, -1)
    else:
        cseg = np.where(in_range, np.searchsorted(live, seg), -1)
    acc = empty_fold_state(n_fold, L)
    for lo in range(0, n, FOLD_BLOCK):
        s = cseg[lo:lo + FOLD_BLOCK]
        v = vals[lo:lo + FOLD_BLOCK]
        m = len(s)
        bucket = max(8, 1 << (m - 1).bit_length())
        if bucket != m:
            s = np.concatenate([s, np.full(bucket - m, -1, np.int64)])
            v = np.concatenate([v, np.zeros((bucket - m, L), np.float32)])
        acc = combine_fold(acc, tree(s, v, n_fold))
    out[live] = acc[:n_active]           # scatter into the packed table
    return out


_BITREV_CACHE: Dict[int, np.ndarray] = {}


def bitrev_permutation(n: int) -> np.ndarray:
    """Bit-reversal permutation of [0, n) for power-of-two ``n``.

    The load-bearing identity of the scan fold: the halving tree
    (``x[:h] ⊕ x[h:]`` repeated) applied to ``x`` combines exactly the
    same operand pairs, at the same tree levels, as the adjacent-pair
    tree (``x[0::2] ⊕ x[1::2]`` repeated) applied to ``x[bitrev]`` — and
    the adjacent-pair tree is precisely the reduction
    ``jax.lax.associative_scan`` computes for its last output element.
    Permuting rows first therefore makes the scan's reduction BITWISE
    equal to ``_fold_tree_np``'s halving tree."""
    if n & (n - 1):
        raise ValueError(f"bitrev needs a power of two, got {n}")
    cached = _BITREV_CACHE.get(n)
    if cached is None:
        bits = (n - 1).bit_length()
        idx = np.arange(n, dtype=np.int64)
        rev = np.zeros(n, np.int64)
        for b in range(bits):
            rev |= ((idx >> b) & 1) << (bits - 1 - b)
        rev.flags.writeable = False
        _BITREV_CACHE[n] = cached = rev
    return cached


def _fold_tree_scan_np(seg: np.ndarray, vals: np.ndarray,
                       n_segments: int) -> np.ndarray:
    """Scan-order twin of ``_fold_tree_np``: bit-reverse the (padded,
    power-of-two) rows, then reduce ADJACENT pairs — the combine order of
    ``jax.lax.associative_scan``'s final element. Bitwise-identical to the
    halving tree (see ``bitrev_permutation``), so it plugs into
    ``_fold_blocks`` under the same determinism contract."""
    rev = bitrev_permutation(len(seg))
    seg = seg[rev]
    vals = vals[rev]
    onehot = seg[:, None] == np.arange(n_segments, dtype=seg.dtype)[None, :]
    oh = onehot.astype(np.float32)
    cnt = oh
    sums = oh[:, :, None] * vals[:, None, :]
    mins = np.where(onehot[:, :, None], vals[:, None, :], np.float32(np.inf))
    maxs = np.where(onehot[:, :, None], vals[:, None, :], np.float32(-np.inf))
    while cnt.shape[0] > 1:
        cnt = cnt[0::2] + cnt[1::2]
        sums = sums[0::2] + sums[1::2]
        mins = np.minimum(mins[0::2], mins[1::2])
        maxs = np.maximum(maxs[0::2], maxs[1::2])
    return np.concatenate([cnt[0][:, None], sums[0], mins[0], maxs[0]],
                          axis=1)


# ------------------------------------------------- batched read-path helpers
def gather_width(n_lanes: int) -> int:
    """Row width of ``batch_gather_stats`` output:
    [count | sums(L) | mins(L) | maxs(L) | means(L)]."""
    return 1 + 4 * n_lanes


def _gather_stats_np(table: np.ndarray, idx: np.ndarray) -> np.ndarray:
    table = np.asarray(table, np.float32)
    idx = np.asarray(idx, np.int64)
    L = (table.shape[1] - 1) // 3
    t = table[idx]                                   # [B, 1 + 3L]
    cnt = t[:, :1]
    with np.errstate(invalid="ignore", divide="ignore"):
        means = np.where(cnt > 0, t[:, 1:1 + L] / cnt,
                         np.float32(np.nan))
    return np.concatenate([t, means], axis=1)        # [B, 1 + 4L]


def _combine_packed_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized ``combine_fold`` over leading axes (rows are packed
    [1 + 3L] fold vectors; the lane split is the last axis)."""
    L = (a.shape[-1] - 1) // 3
    return np.concatenate([
        a[..., :1 + L] + b[..., :1 + L],
        np.minimum(a[..., 1 + L:1 + 2 * L], b[..., 1 + L:1 + 2 * L]),
        np.maximum(a[..., 1 + 2 * L:], b[..., 1 + 2 * L:])], axis=-1)


def _assoc_scan_np(x: np.ndarray) -> np.ndarray:
    """Host twin of ``jax.lax.associative_scan`` (inclusive, axis 0) over
    packed fold rows — the SAME odd/even recursion, so results are bitwise
    identical to the jitted scan. Callers pad to a power of two first
    (every recursion level then stays even)."""
    n = x.shape[0]
    if n < 2:
        return x.copy()
    reduced = _combine_packed_np(x[0::2], x[1::2])
    odd = _assoc_scan_np(reduced)
    if n % 2 == 0:
        even = _combine_packed_np(odd[:-1], x[2::2])
    else:
        even = _combine_packed_np(odd, x[2::2])
    out = np.empty_like(x)
    out[0] = x[0]
    out[1::2] = odd
    out[2::2] = even
    return out


def prefix_fold_reference(table: np.ndarray) -> np.ndarray:
    """Recompute-from-scratch oracle for ``prefix_fold``: window ``w``'s
    cumulative aggregate built the way ``_fold_blocks`` chains blocks —
    split rows [0, w] into the power-of-two blocks of the binary
    decomposition of w+1 (largest first), reduce each block with the
    balanced adjacent-pair tree, and left-chain the block partials with
    the associative combine. ``jax.lax.associative_scan``'s inclusive
    prefixes use exactly this association, so ``prefix_fold`` must match
    BITWISE (asserted in tests and the scan-fold benchmark). O(S²) — an
    oracle, not a serving path."""
    table = np.asarray(table, np.float32)
    S = len(table)
    out = np.empty_like(table)
    for w in range(S):
        n = w + 1
        acc = None
        lo = 0
        for b in reversed(range(n.bit_length())):
            if (n >> b) & 1:
                blk = table[lo:lo + (1 << b)]
                while len(blk) > 1:          # balanced adjacent-pair tree
                    blk = _combine_packed_np(blk[0::2], blk[1::2])
                acc = blk[0] if acc is None \
                    else _combine_packed_np(acc, blk[0])
                lo += 1 << b
        out[w] = acc
    return out


def _prefix_fold_np(table: np.ndarray) -> np.ndarray:
    """Numpy ``prefix_fold``: pad the window axis to a power of two with
    fold-identity rows (an inclusive scan's prefix [w] never reads rows
    past w, so padding is invisible), run the associative-scan twin,
    slice. One pass, O(S log S) combines — vs O(S²) for S independent
    per-window refolds."""
    table = np.asarray(table, np.float32)
    S, W = table.shape
    if S == 0:
        return table.copy()
    L = (W - 1) // 3
    m = 1 << (S - 1).bit_length()
    if m != S:
        pad = np.broadcast_to(empty_fold_state(1, L), (m - S, W))
        table = np.concatenate([table, pad])
    return _assoc_scan_np(table)[:S]



def _host(t) -> np.ndarray:
    """A block array as host numpy (waits for a CUDA tensor's producer)."""
    if isinstance(t, torch.Tensor):
        return t.cpu().numpy()
    return np.asarray(t)


class FactBlock:
    """Opaque handle to ONE transform's results — the unit of the
    device-resident hot path.

    For the torch backend ``facts``/``found`` (and the optional per-unit
    KPI ``rollup``) are tensors on the backend's device: creating the
    block does NOT wait for the kernels, so the transform stage can hand
    the block downstream while the card is still computing.
    ``start_host_copy()`` enqueues the device->host copies into pinned
    memory behind the compute and records a CUDA event; ``to_host()`` —
    called once, at the warehouse-load boundary — waits on that event and
    caches the host arrays (the step's single host<->device round trip,
    counted in ``backend.host_syncs``, on CPU and CUDA alike). For the
    numpy backend the arrays are already host-resident and ``to_host()``
    is free.

    ``n`` is the logical row count; device arrays may be padded to a
    power-of-two bucket, and ``to_host()`` slices the pad rows off."""

    __slots__ = ("_backend", "_facts", "_found", "_rollup", "n", "_host",
                 "_rollup_host", "_copies")

    def __init__(self, backend: "ComputeBackend", facts, found, n: int,
                 rollup=None):
        self._backend = backend
        self._facts = facts
        self._found = found
        self._rollup = rollup
        self.n = int(n)
        self._host: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._rollup_host: Optional[np.ndarray] = None
        # (pinned host tensors, CUDA event) once start_host_copy ran
        self._copies = None

    def __len__(self) -> int:
        return self.n

    @property
    def backend(self) -> "ComputeBackend":
        return self._backend

    @property
    def device(self) -> bool:
        """True while the block's arrays live on device (not yet synced)."""
        return self._backend.device and self._host is None

    def start_host_copy(self) -> "FactBlock":
        """Enqueue the D2H copies (into pinned memory, non-blocking) behind
        the in-flight kernels WITHOUT waiting, so the copy overlaps
        downstream host work and the eventual ``to_host()`` finds the bytes
        already (or nearly) landed. No-op for host arrays, CPU tensors and
        already-materialized blocks."""
        if (self._host is None and self._copies is None
                and isinstance(self._facts, torch.Tensor)
                and self._facts.is_cuda):
            pinned = []
            for t in (self._facts, self._found, self._rollup):
                if t is None:
                    pinned.append(None)
                    continue
                p = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                p.copy_(t, non_blocking=True)
                pinned.append(p)
            event = torch.cuda.Event()
            event.record()
            self._copies = (pinned, event)
        return self

    def _arrays(self):
        """(facts, found, rollup) as host numpy, from the pinned copies
        when ``start_host_copy`` ran (waiting on its event)."""
        if self._copies is not None:
            pinned, event = self._copies
            event.synchronize()
            return tuple(None if p is None else p.numpy() for p in pinned)
        return tuple(None if t is None else _host(t)
                     for t in (self._facts, self._found, self._rollup))

    def to_host(self) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize (facts [n, N_FACT] f32, found [n] bool) on host.
        The FIRST call on a device block is the hot path's one blocking
        sync (counted in ``backend.host_syncs``); repeats are cached."""
        if self._host is None:
            if self._backend.device:
                self._backend.host_syncs += 1
            facts, found, rollup = self._arrays()
            if rollup is not None and self._rollup_host is None:
                # tiny [n_units, KPI_LANES]; rides the same sync window
                self._rollup_host = rollup
            self._host = (facts[:self.n], found[:self.n])
        return self._host

    def rollup_host(self) -> Optional[np.ndarray]:
        """The per-unit KPI rollup [n_units, KPI_LANES] (host), or None
        when the block was dispatched without one. After ``to_host`` this
        is a cached tiny copy accounted with the block's single sync;
        called BEFORE ``to_host`` on a device block it must wait for the
        whole dispatch, so it counts its own sync — the counter contract
        stays honest under call reordering."""
        if self._rollup is None:
            return None
        if self._rollup_host is None:
            if self._backend.device and self._host is None:
                self._backend.host_syncs += 1
            self._rollup_host = self._arrays()[2]
        return self._rollup_host


class ComputeBackend:
    """Protocol + shared helpers. Subclass and register to add a backend."""

    name: str = "abstract"
    device: bool = False     # True: wants the cache's device-mirrored state

    def __init__(self):
        # dispatch instrumentation lives on the process-wide metrics
        # registry (one read path with every other pipeline signal), one
        # shard per backend INSTANCE so per-instance counts/resets stay
        # per-instance; the registry merge sums instances into per-backend
        # process totals (``backend.<name>.op_dispatches``)
        shard = global_registry().shard(
            f"backend.{self.name}#{next(_BACKEND_SEQ)}")
        self.metrics = shard
        self._op_dispatches = shard.counter(
            f"backend.{self.name}.op_dispatches")
        self._host_syncs = shard.counter(f"backend.{self.name}.host_syncs")

    @property
    def op_dispatches(self) -> int:
        """Device dispatch groups issued (single-threaded use: the
        dispatch-count tests)."""
        return self._op_dispatches.value

    @op_dispatches.setter
    def op_dispatches(self, v: int) -> None:
        self._op_dispatches.value = v

    @property
    def host_syncs(self) -> int:
        """Blocking device->host materializations."""
        return self._host_syncs.value

    @host_syncs.setter
    def host_syncs(self, v: int) -> None:
        self._host_syncs.value = v

    def reset_stats(self) -> None:
        self.op_dispatches = 0
        self.host_syncs = 0

    # ------------------------------------------------------------- protocol
    def hash_probe(self, query_keys, keys_tbl, vals_tbl, txn_tbl
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Linear-probe ``query_keys`` against an open-addressing table.
        Returns host (values [n, W] f32, found [n] bool, txn [n])."""
        raise NotImplementedError

    def transform_block(self, prod: np.ndarray, equipment, quality, *,
                        join_depth: int = 1,
                        n_units: Optional[int] = None) -> FactBlock:
        """Fact-grain transform of production payloads [n, 8] against the
        ``InMemoryTable`` caches, returned as a device-resident
        ``FactBlock`` (NO host sync). With ``n_units`` set, the per-unit
        KPI rollup comes with it (``FactBlock.rollup_host()`` —
        ``segment_reduce`` semantics over the block's valid facts).
        ``join_depth > 1`` replays the probe chain (§4.1.4 complexity knob
        — numerically a no-op, cost is the point)."""
        raise NotImplementedError

    def transform(self, prod: np.ndarray, equipment, quality, *,
                  join_depth: int = 1
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Host-convenience transform: ``transform_block`` + an immediate
        ``to_host()``. Returns host (facts [n, N_FACT] f32, found [n]
        bool)."""
        return self.transform_block(prod, equipment, quality,
                                    join_depth=join_depth).to_host()

    def transform_and_rollup(self, prod: np.ndarray, equipment, quality, *,
                             n_units: int,
                             join_depth: int = 1) -> FactBlock:
        """Transform + per-unit KPI rollup: the block's facts/found plus
        ``rollup_host()`` == ``segment_reduce(facts[found], n_units)``."""
        return self.transform_block(prod, equipment, quality,
                                    join_depth=join_depth, n_units=n_units)

    def segment_reduce(self, facts: np.ndarray, n_units: int) -> np.ndarray:
        """Per-equipment KPI rollup of a fact block: sums
        [availability, performance, quality, oee, count] over valid facts.
        Returns host [n_units, KPI_LANES] f32."""
        raise NotImplementedError

    def fold_segments(self, seg_ids: np.ndarray, values: np.ndarray,
                      n_segments: int) -> np.ndarray:
        """Fused multi-statistic delta fold for incremental materialized
        views: per segment, count + sum + min + max of every value lane,
        segment-compacted (see ``_fold_blocks``). ``seg_ids`` [n] int,
        ``values`` [n, L] f32; rows with seg outside [0, n_segments)
        contribute nothing. Returns the packed host table
        [n_segments, 1 + 3L] (see ``fold_width``)."""
        raise NotImplementedError

    def fold_segments_scan(self, seg_ids: np.ndarray, values: np.ndarray,
                           n_segments: int) -> np.ndarray:
        """``fold_segments`` with the per-block reduction expressed as an
        associative scan over bit-reversed rows: BITWISE-identical output
        (see ``bitrev_permutation``)."""
        raise NotImplementedError

    def batch_gather_stats(self, table: np.ndarray,
                           seg_ids: np.ndarray) -> np.ndarray:
        """Batched point-query op of the read path: gather ``B`` segment
        rows from a packed ``[S, 1 + 3L]`` fold table and derive lane
        means. ``seg_ids`` [B] int in [0, S). Returns host
        ``[B, 1 + 4L]`` f32: [count | sums | mins | maxs | means], means
        NaN where count == 0 (see ``gather_width``)."""
        raise NotImplementedError

    def prefix_fold(self, table: np.ndarray) -> np.ndarray:
        """Cumulative windowed fold: inclusive running combine of a packed
        ``[S, 1 + 3L]`` view table along the window axis — row ``w``
        aggregates windows [0, w] — bitwise equal to
        ``prefix_fold_reference``. Returns host ``[S, 1 + 3L]`` f32."""
        raise NotImplementedError

    # -------------------------------------------------------------- helpers
    @staticmethod
    def _pad_bucket(prod: np.ndarray, floor: int = 1,
                    mutable: bool = False) -> np.ndarray:
        """Pad a payload block to a power-of-two bucket (>= floor) with -1
        rows. When ``n`` already fills the bucket the input is returned
        as-is (zero-copy) — callers that WRITE into the padded block must
        pass ``mutable=True``, which guarantees the result never aliases
        the caller's array."""
        n = len(prod)
        bucket = max(floor, 1 << (n - 1).bit_length())
        if bucket == n:
            return prod.copy() if mutable else prod
        padrow = np.full((bucket - n, prod.shape[1]), -1.0, np.float32)
        return np.concatenate([prod, padrow])


_REGISTRY: Dict[str, Type[ComputeBackend]] = {}
_INSTANCES: Dict[Tuple[str, str], ComputeBackend] = {}


def register_backend(name: str):
    def deco(cls: Type[ComputeBackend]) -> Type[ComputeBackend]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_backend_name(name: Optional[str] = None) -> str:
    return name or DEFAULT_BACKEND


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The torch device an entry point runs on: ``cuda`` unless the
    caller asks for another. Raises when CUDA is asked for and absent —
    nothing falls back to the CPU on its own."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def get_backend(name: Union[str, ComputeBackend, None] = None,
                device: Union[str, torch.device, None] = DEFAULT_DEVICE
                ) -> ComputeBackend:
    """Resolve a backend instance (one per name and device). Accepts an
    already constructed backend (returned as is), a registered name, or
    None (the ``torch`` default). ``device`` places the torch backend;
    the numpy backend has no device and ignores it."""
    if isinstance(name, ComputeBackend):
        return name
    resolved = resolve_backend_name(name)
    if resolved not in _REGISTRY:
        raise KeyError(f"unknown backend {resolved!r}; "
                       f"registered: {available_backends()}")
    cls = _REGISTRY[resolved]
    if cls.device:
        dev = resolve_device(device)
        key = (resolved, str(dev))
        if key not in _INSTANCES:
            _INSTANCES[key] = cls(dev)
    else:
        key = (resolved, "host")
        if key not in _INSTANCES:
            _INSTANCES[key] = cls()
    return _INSTANCES[key]


# =========================================================== numpy backend
def _hash_probe_np(query_keys, keys_tbl, vals_tbl, txn_tbl):
    from repro_torch.core.cache import MAX_PROBES, hash32_np
    keys_tbl = np.asarray(keys_tbl)
    vals_tbl = np.asarray(vals_tbl)
    txn_tbl = np.asarray(txn_tbl)
    n_slots = keys_tbl.shape[0]
    q = (np.asarray(query_keys).astype(np.int64)
         & 0xFFFFFFFF).astype(np.int32)
    h = (hash32_np(q) % np.uint32(n_slots)).astype(np.int64)
    n = len(q)
    done = np.zeros(n, bool)
    found = np.zeros(n, bool)
    val = np.zeros((n, vals_tbl.shape[1]), np.float32)
    txn = np.zeros(n, txn_tbl.dtype)
    for p in range(MAX_PROBES):
        cand = (h + p) % n_slots
        k = keys_tbl[cand]
        hit = (k == q) & ~done
        empty = (k == -1) & ~done
        if hit.any():
            val[hit] = vals_tbl[cand[hit]]
            txn[hit] = txn_tbl[cand[hit]]
            found |= hit
        done |= hit | empty
        if done.all():
            break
    return val, found, txn


def _segment_reduce_np(facts: np.ndarray, n_units: int) -> np.ndarray:
    facts = np.asarray(facts, np.float32)
    agg = np.zeros((n_units, KPI_LANES), np.float32)
    if not len(facts):
        return agg
    unit = facts[:, 0].astype(np.int64)
    # drop invalid facts AND out-of-range units, matching the jax/pallas
    # behavior (segment_sum / one-hot ignore ids outside [0, n_units))
    keep = (facts[:, 9] > 0.5) & (unit >= 0) & (unit < n_units)
    kpis = np.concatenate(
        [facts[keep, 3:7],
         np.ones((int(keep.sum()), 1), np.float32)], axis=-1)
    np.add.at(agg, unit[keep], kpis)
    return agg


@register_backend("numpy")
class NumpyBackend(ComputeBackend):
    """Pure-host reference. Mirrors the jitted math op-for-op in float32 so
    parity with jax/pallas holds to ~1e-6; the correctness oracle and the
    zero-dependency fallback. ``FactBlock``s are host-resident from birth
    (``to_host`` is free and counts no sync)."""

    device = False

    def hash_probe(self, query_keys, keys_tbl, vals_tbl, txn_tbl):
        self.op_dispatches += 1
        return _hash_probe_np(query_keys, keys_tbl, vals_tbl, txn_tbl)

    def transform_block(self, prod, equipment, quality, *, join_depth=1,
                        n_units=None):
        prod = np.asarray(prod, np.float32)
        eq_state = (equipment.keys, equipment.values, equipment.txn)
        q_state = (quality.keys, quality.values, quality.txn)
        equip_id = prod[:, 1].astype(np.int64)
        prod_id = prod[:, 0].astype(np.int64)
        eq_rows, eq_found, _ = _hash_probe_np(equip_id, *eq_state)
        q_rows, q_found, _ = _hash_probe_np(prod_id, *q_state)
        if join_depth > 1:            # flattened hop probe (cost knob;
            mod = max(len(eq_state[0]) // 4, 1)   # numeric no-op)
            hop_keys = ((equip_id[None, :]
                         + np.arange(1, join_depth)[:, None]) % mod)
            _hash_probe_np(hop_keys.reshape(-1), *eq_state)
        found = eq_found & q_found
        facts = _kpi_facts_np(prod, eq_rows, q_rows, found)
        rollup = (_segment_reduce_np(facts, n_units)
                  if n_units is not None else None)
        self.op_dispatches += 1       # the whole fused op: one "dispatch"
        return FactBlock(self, facts, found, len(prod), rollup)

    def segment_reduce(self, facts, n_units):
        self.op_dispatches += 1
        return _segment_reduce_np(facts, n_units)

    def fold_segments(self, seg_ids, values, n_segments):
        def tree(s, v, ns):
            self.op_dispatches += 1
            return _fold_tree_np(s, v, ns)
        return _fold_blocks(seg_ids, values, n_segments, tree)

    def fold_segments_scan(self, seg_ids, values, n_segments):
        def tree(s, v, ns):
            self.op_dispatches += 1
            return _fold_tree_scan_np(s, v, ns)
        return _fold_blocks(seg_ids, values, n_segments, tree)

    def batch_gather_stats(self, table, seg_ids):
        idx = np.asarray(seg_ids, np.int64)
        if not len(idx):
            L = (np.asarray(table).shape[1] - 1) // 3
            return np.zeros((0, gather_width(L)), np.float32)
        self.op_dispatches += 1
        return _gather_stats_np(table, idx)

    def prefix_fold(self, table):
        if not len(table):
            return np.asarray(table, np.float32).copy()
        self.op_dispatches += 1
        return _prefix_fold_np(table)


def _kpi_facts_np(prod, eq_rows, q_rows, found) -> np.ndarray:
    """Host twin of ``transformer.transform_kernel``'s KPI math (same op
    order in float32, so results agree with XLA to float rounding)."""
    f = np.float32
    t_start, t_end = prod[:, 3], prod[:, 4]
    qty = prod[:, 5]
    e_start, e_end = eq_rows[:, 3], eq_rows[:, 4]
    status = eq_rows[:, 5]
    max_speed = eq_rows[:, 6]
    planned = eq_rows[:, 7]
    defects, scrap = q_rows[:, 4], q_rows[:, 6]

    inter_lo = np.maximum(t_start, e_start)
    inter_hi = np.minimum(t_end, e_end)
    overlap = np.maximum(inter_hi - inter_lo, f(0.0))
    duration = np.maximum(t_end - t_start, f(EPS))
    seg_on = np.where(status > f(0.5), overlap, f(0.0))
    seg_off = duration - seg_on

    availability = np.clip(seg_on / np.maximum(planned, f(EPS)),
                           f(0.0), f(1.0))
    performance = np.clip(qty / np.maximum(max_speed * duration, f(EPS)),
                          f(0.0), f(1.0))
    good = np.maximum(qty - defects - scrap, f(0.0))
    quality = np.clip(good / np.maximum(qty, f(EPS)), f(0.0), f(1.0))
    oee = availability * performance * quality
    return np.stack([
        prod[:, 1], t_start, t_end, availability, performance, quality, oee,
        seg_on, seg_off, found.astype(np.float32)], axis=-1).astype(np.float32)


# ============================================================ torch backend
def _combine_packed_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_combine_packed_np`` in torch (numpy's min/max semantics)."""
    L = (a.shape[-1] - 1) // 3
    return torch.cat([
        a[..., :1 + L] + b[..., :1 + L],
        np_minimum(a[..., 1 + L:1 + 2 * L], b[..., 1 + L:1 + 2 * L]),
        np_maximum(a[..., 1 + 2 * L:], b[..., 1 + 2 * L:])], dim=-1)


def _assoc_scan_t(x: torch.Tensor) -> torch.Tensor:
    """``_assoc_scan_np`` in torch: the SAME odd/even recursion, so the
    inclusive scan is bitwise the numpy one (and ``jax.lax``'s)."""
    n = x.shape[0]
    if n < 2:
        return x.clone()
    reduced = _combine_packed_t(x[0::2], x[1::2])
    odd = _assoc_scan_t(reduced)
    if n % 2 == 0:
        even = _combine_packed_t(odd[:-1], x[2::2])
    else:
        even = _combine_packed_t(odd, x[2::2])
    out = torch.empty_like(x)
    out[0] = x[0]
    out[1::2] = odd
    out[2::2] = even
    return out


def _fold_tree_scan_t(seg: torch.Tensor, vals: torch.Tensor,
                      n_segments: int) -> torch.Tensor:
    """``_fold_tree_scan_np`` in torch: bit-reversed rows, then adjacent
    pairs reduced level by level — bitwise the halving tree."""
    rev = torch.from_numpy(bitrev_permutation(len(seg)).copy()).to(seg.device)
    seg = seg[rev]
    vals = vals[rev]
    onehot = seg[:, None] == torch.arange(n_segments, dtype=seg.dtype,
                                          device=seg.device)[None, :]
    oh = onehot.to(torch.float32)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=seg.device)
    cnt = oh
    sums = oh[:, :, None] * vals[:, None, :]
    mins = torch.where(onehot[:, :, None], vals[:, None, :], inf)
    maxs = torch.where(onehot[:, :, None], vals[:, None, :], -inf)
    while cnt.shape[0] > 1:
        cnt = cnt[0::2] + cnt[1::2]
        sums = sums[0::2] + sums[1::2]
        mins = np_minimum(mins[0::2], mins[1::2])
        maxs = np_maximum(maxs[0::2], maxs[1::2])
    return torch.cat([cnt[0][:, None], sums[0], mins[0], maxs[0]], dim=1)


@register_backend("torch")
class TorchBackend(ComputeBackend):
    """The hand-written CUDA kernels (``repro_torch.kernels``) behind the
    backend protocol. ``transform_block`` launches two ``hash_join``
    probes (a third, flattened hop probe when ``join_depth > 1``) and the
    fused ``segment_kpi`` kernel, whose epilogue is the per-unit rollup;
    the block stays on the device with zero host syncs until
    ``to_host()``. ``fold_segments`` runs the fold kernel once per
    compacted row block, ``batch_gather_stats`` the gather kernel once per
    batch. ``fold_segments_scan`` and ``prefix_fold`` are structural scans
    (XLA ops in the reference, not Pallas kernels) and run as plain torch
    on the device.

    On ``device="cpu"`` the kernel wrappers run their plain versions;
    ``op_dispatches``/``host_syncs`` count the same on either device."""

    device = True

    def __init__(self, torch_device: torch.device):
        super().__init__()
        self.torch_device = torch.device(torch_device)

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (never aliasing it: published view
        tables and cache arrays are read-only or keep changing)."""
        return torch.tensor(np.ascontiguousarray(arr),
                            device=self.torch_device)

    def hash_probe(self, query_keys, keys_tbl, vals_tbl, txn_tbl):
        q = (np.asarray(query_keys).astype(np.int64)
             & 0xFFFFFFFF).astype(np.int32)
        vals, found, txn = hash_join_ops.hash_join(
            self._tensor(q), keys_tbl, vals_tbl, txn_tbl)
        self.op_dispatches += 1
        self.host_syncs += 1
        return vals.cpu().numpy(), found.cpu().numpy(), txn.cpu().numpy()

    def transform_block(self, prod, equipment, quality, *, join_depth=1,
                        n_units=None):
        prod = np.asarray(prod, np.float32)
        n = len(prod)
        padded = self._tensor(self._pad_bucket(prod, floor=256))
        eqk, eqv, eqt = equipment.device_state()
        qk, qv, qt = quality.device_state()
        equip_id = padded[:, 1].to(torch.int32).contiguous()
        prod_id = padded[:, 0].to(torch.int32).contiguous()
        eq_rows, eq_found, _ = hash_join_ops.hash_join(equip_id, eqk, eqv,
                                                       eqt)
        q_rows, q_found, _ = hash_join_ops.hash_join(prod_id, qk, qv, qt)
        self.op_dispatches += 2
        if join_depth > 1:            # flattened hop probe (cost knob;
            mod = max(eqk.shape[0] // 4, 1)           # numeric no-op)
            hop_keys = ((equip_id[None, :]
                         + torch.arange(1, join_depth, dtype=torch.int32,
                                        device=self.torch_device)[:, None])
                        % mod)
            hash_join_ops.hash_join(hop_keys.reshape(-1), eqk, eqv, eqt)
            self.op_dispatches += 1
        found = eq_found & q_found
        # the KPI kernel derives its valid flag from the joined rows' key
        # lane: mark misses so facts[:, -1] equals the probes' found mask
        # (the probe outputs are fresh tensors, safe to write in place)
        eq_rows[:, 1].masked_fill_(~eq_found, -1.0)
        q_rows[:, 1].masked_fill_(~q_found, -1.0)
        # the fused kernel always emits the per-unit aggregate; without
        # n_units it is one unit wide and dropped
        facts, agg = segment_kpi_ops.segment_kpi(
            padded, eq_rows, q_rows, n_units=n_units if n_units else 1)
        self.op_dispatches += 1
        return FactBlock(self, facts, found, n, agg if n_units else None)

    def segment_reduce(self, facts, n_units):
        if self.torch_device.type == "cuda":
            raise NotImplementedError(
                "segment_reduce needs segment_rollup_kernel, which is not "
                "ported yet (ROADMAP queue B, item 5)")
        facts = np.asarray(facts, np.float32)
        if not len(facts):
            return np.zeros((n_units, KPI_LANES), np.float32)
        self.op_dispatches += 1
        self.host_syncs += 1
        return unit_rollup_ref(self._tensor(facts), n_units).numpy()

    def fold_segments(self, seg_ids, values, n_segments):
        def tree(s, v, ns):
            self.op_dispatches += 1
            self.host_syncs += 1
            return segment_kpi_ops.fold_segments(
                self._tensor(s), self._tensor(v), ns).cpu().numpy()
        return _fold_blocks(seg_ids, values, n_segments, tree)

    def fold_segments_scan(self, seg_ids, values, n_segments):
        def tree(s, v, ns):
            self.op_dispatches += 1
            self.host_syncs += 1
            return _fold_tree_scan_t(self._tensor(s), self._tensor(v),
                                     ns).cpu().numpy()
        return _fold_blocks(seg_ids, values, n_segments, tree)

    def batch_gather_stats(self, table, seg_ids):
        table = np.asarray(table, np.float32)
        idx = np.asarray(seg_ids, np.int64)
        if not len(idx):
            L = (table.shape[1] - 1) // 3
            return np.zeros((0, gather_width(L)), np.float32)
        if idx.min() < 0 or idx.max() >= len(table):
            raise ValueError(f"segment ids out of range [0, {len(table)})")
        self.op_dispatches += 1
        self.host_syncs += 1
        return segment_kpi_ops.gather_stats(
            self._tensor(table), self._tensor(idx)).cpu().numpy()

    def prefix_fold(self, table):
        table = np.asarray(table, np.float32)
        S, W = table.shape
        if S == 0:
            return table.copy()
        L = (W - 1) // 3
        m = 1 << (S - 1).bit_length()
        if m != S:           # identity pad: inclusive prefixes never read it
            table = np.concatenate(
                [table, np.broadcast_to(empty_fold_state(1, L), (m - S, W))])
        self.op_dispatches += 1
        self.host_syncs += 1
        return _assoc_scan_t(self._tensor(table)).cpu().numpy()[:S]


__all__ = [
    "ComputeBackend", "FactBlock", "NumpyBackend", "TorchBackend",
    "register_backend", "get_backend", "available_backends",
    "resolve_backend_name", "resolve_device", "DEFAULT_BACKEND",
    "DEFAULT_DEVICE", "KPI_LANES", "FOLD_BLOCK", "fold_width",
    "gather_width", "empty_fold_state", "combine_fold",
    "bitrev_permutation", "prefix_fold_reference",
]
