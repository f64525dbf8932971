"""In-memory master-data cache (paper §3.1.2, In-memory Table Updater).

The paper gives each Spark worker an embedded H2 instance holding only the
master rows for its assigned business keys. Here the worker-local store is
an open-addressing hash table kept on the host and mirrored, lazily and
component-dirty tracked, to the compute backend's torch device:

  keys   : i32 [n_slots]   (-1 = empty)   — the JOIN key of the table
  values : f32 [n_slots, W]               — master row payload
  txn    : i64 [n_slots]                  — row transaction time (watermark;
                                            i32 on the device, as in the
                                            reference's x64-off device state)

Slot assignment happens host-side at update time (updates are rare next to
lookups); the hot path — the probe inside the Data Transformer — goes
through the compute-backend layer (``repro_torch.core.backend``): ``numpy``
host probing or the ``hash_join`` CUDA kernel (its plain version on the
CPU). Both are contract-identical.

Fault tolerance / elasticity (paper §3.2): ``reset_from_snapshot`` re-dumps
the compacted master topic filtered by the newly assigned business keys —
the 'cache reset trigger'. The measured cost of this dump is the Fig. 4
initialization overhead.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.records import PAYLOAD_WIDTH

MAX_PROBES = 16


def hash32_np(keys: np.ndarray) -> np.ndarray:
    """32-bit mix (lowbias32), identical on host and device — the device
    probe hashes the int32 key as uint32, so the host side must be 32-bit
    exact too."""
    with np.errstate(over="ignore"):
        x = (np.asarray(keys).astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
    return x


class InMemoryTable:
    def __init__(self, n_slots: int, width: int = PAYLOAD_WIDTH,
                 backend=None):
        self.n_slots = n_slots
        self.width = width
        self._backend = backend          # name/instance; resolved lazily
        self.keys = np.full(n_slots, -1, np.int32)
        self.values = np.zeros((n_slots, width), np.float32)
        self.txn = np.zeros(n_slots, np.int64)
        self.watermark = 0           # latest master txn_time seen
        self.n_rows = 0
        self.init_dump_s = 0.0       # Fig. 4: cache initialization overhead
        self._device = None          # lazily mirrored torch tensors
        self._dirty = {"keys", "values", "txn"}   # components to re-upload
        self.version = 0             # bumped on every mutation
        self._snap = None            # memoized CacheSnapshot
        self._snap_version = -1

    # ------------------------------------------------------------ updates
    def _slot_of(self, key: int) -> int:
        """Find the key's slot within the device probe budget; grow+rehash
        when a chain would exceed MAX_PROBES (the jitted lookup stops there,
        so a longer host-side chain would make the row invisible)."""
        key32 = int(np.int32(np.int64(key) & 0xFFFFFFFF))
        while True:
            h = int(hash32_np(np.array([key32]))[0] % self.n_slots)
            for p in range(MAX_PROBES):
                s = (h + p) % self.n_slots
                k = self.keys[s]
                if k == -1 or k == key32:
                    return s
            self._grow()

    def _grow(self) -> None:
        old_keys, old_vals, old_txn = self.keys, self.values, self.txn
        self.n_slots *= 2
        self.keys = np.full(self.n_slots, -1, np.int32)
        self.values = np.zeros((self.n_slots, self.width), np.float32)
        self.txn = np.zeros(self.n_slots, np.int64)
        self.n_rows = 0
        live = np.nonzero(old_keys != -1)[0]
        for s in live:
            d = self._slot_of(int(old_keys[s]))
            if self.keys[d] == -1:
                self.n_rows += 1
            self.keys[d] = old_keys[s]
            self.values[d] = old_vals[s]
            self.txn[d] = old_txn[s]
        self._device = None
        self._dirty = {"keys", "values", "txn"}

    def upsert(self, keys: np.ndarray, payloads: np.ndarray,
               txn_times: np.ndarray) -> None:
        """Last-writer-wins BY TRANSACTION TIME (not arrival order): cache
        state is then independent of snapshot/stream interleaving — the
        property the §4.1.3 consistency check relies on.

        Fully vectorized (one hash pass + one probe loop over MAX_PROBES
        steps for the whole batch): the per-row Python loop this replaces
        cost ~19us/row and sat on the GIL inside every worker's ingest
        stage — the master pump was the single largest host cost of a
        streaming step."""
        n = len(keys)
        if n == 0:
            return
        keys = np.asarray(keys, np.int64)
        txn_times = np.asarray(txn_times, np.int64)
        payloads = np.asarray(payloads, np.float32)
        # watermark advances over ALL arriving rows, stale or not (same as
        # the per-row loop: it tracked skipped rows' txn times too)
        self.watermark = max(self.watermark, int(txn_times.max()))

        # one winner per key: latest txn_time, arrival order breaking ties
        # (identical to applying the rows one by one)
        order = np.lexsort((np.arange(n), txn_times, keys))
        last = np.nonzero(np.append(keys[order][1:] != keys[order][:-1],
                                    True))[0]
        win = order[last]
        key32 = (keys[win] & 0xFFFFFFFF).astype(np.int32)
        vals, txns = payloads[win], txn_times[win]

        wrote_vals = False           # any slot payload/txn written
        wrote_keys = False           # any NEW key claimed a slot
        while True:
            h = (hash32_np(key32) % np.uint32(self.n_slots)).astype(np.int64)
            pending = np.arange(len(key32))
            for p in range(MAX_PROBES):
                if not len(pending):
                    break
                cand = (h[pending] + p) % self.n_slots
                slot_keys = self.keys[cand]
                # existing slot for this key: overwrite unless stale
                hit = slot_keys == key32[pending]
                upd = pending[hit][txns[pending[hit]] >=
                                   self.txn[cand[hit]]]
                if len(upd):
                    s = (h[upd] + p) % self.n_slots
                    self.keys[s] = key32[upd]
                    self.values[s] = vals[upd]
                    self.txn[s] = txns[upd]
                    wrote_vals = True    # key lane rewritten with the SAME
                                         # content — values/txn dirty only
                # empty slot: first distinct key per slot claims it, the
                # rest continue probing (a valid sequential insert order)
                empty = np.nonzero(slot_keys == -1)[0]
                claimed = np.zeros(len(pending), bool)
                if len(empty):
                    uniq_slots, first = np.unique(cand[empty],
                                                  return_index=True)
                    winners = pending[empty[first]]
                    s = (h[winners] + p) % self.n_slots
                    self.keys[s] = key32[winners]
                    self.values[s] = vals[winners]
                    self.txn[s] = txns[winners]
                    self.n_rows += len(winners)
                    claimed[empty[first]] = True
                    wrote_keys = wrote_vals = True
                pending = pending[~(hit | claimed)]
            if not len(pending):
                break
            # probe chains exhausted: grow + rehash, retry the remainder
            keep = pending
            key32, vals, txns = key32[keep], vals[keep], txns[keep]
            self._grow()
        # device-mirror reuse: re-upload ONLY the components this upsert
        # touched. Steady-state master updates overwrite existing rows'
        # payloads, so the (large, rarely changing) key lane keeps its
        # device buffer; an all-stale batch re-uploads nothing at all.
        if wrote_keys:
            self._dirty.add("keys")
        if wrote_vals:
            self._dirty.update(("values", "txn"))
        self.version += 1

    def retain_only(self, keep_bkeys: np.ndarray,
                    bk_col: int = 1) -> Tuple[int, int]:
        """Surgical cache migration, drop side: keep ONLY the rows whose
        business key (``values[:, bk_col]`` — every master payload carries
        its equipment/business key there) is in ``keep_bkeys``; rows of
        moved-away key ranges are dropped. Returns (kept, dropped) row
        counts.

        Open addressing cannot delete in place (an emptied slot would cut
        the probe chains of keys hashed past it, making them invisible to
        the bounded device probe), so the retained rows are re-inserted
        through the vectorized ``upsert`` — still a pure LOCAL operation:
        unlike the paper's cache-reset trigger it never touches the broker
        snapshot, which is exactly what makes a rebalance keep its
        survivors warm. The watermark is preserved (it tracks the master
        STREAM, not this worker's slice of it)."""
        live = np.nonzero(self.keys != -1)[0]
        if not len(live):
            return 0, 0
        bks = self.values[live, bk_col].astype(np.int64)
        keep_sorted = np.unique(np.asarray(keep_bkeys, np.int64))
        from repro_torch.core.partitioning import isin_sorted
        mask = isin_sorted(keep_sorted, bks)
        kept = live[mask]
        dropped = len(live) - len(kept)
        if dropped == 0:
            return len(kept), 0
        keys = self.keys[kept].astype(np.int64)   # fancy index: copies
        vals = self.values[kept]
        txns = self.txn[kept]
        watermark = self.watermark
        self.keys[:] = -1
        self.values[:] = 0
        self.txn[:] = 0
        self.n_rows = 0
        self._dirty = {"keys", "values", "txn"}
        self.version += 1
        if len(kept):
            self.upsert(keys, vals, txns)
        self.watermark = watermark
        return len(kept), dropped

    def reset_from_snapshot(self, row_keys: np.ndarray, payloads: np.ndarray,
                            txn_times: np.ndarray) -> float:
        """Paper's cache-reset trigger: wipe + re-dump compacted snapshot.
        Returns the dump wall time (Fig. 4)."""
        import time
        t0 = time.perf_counter()
        self.keys[:] = -1
        self.values[:] = 0
        self.txn[:] = 0
        self.n_rows = 0
        self.watermark = 0
        self._dirty = {"keys", "values", "txn"}
        self.version += 1
        self.upsert(row_keys, payloads, txn_times)
        self.init_dump_s = time.perf_counter() - t0
        return self.init_dump_s

    # ------------------------------------------------------------ metrics
    def stats(self) -> Dict[str, float]:
        """Health-snapshot view of the table: occupancy, mutation version,
        watermark and the last re-dump cost. Lock-free — every field is
        one GIL-atomic read."""
        return {"rows": self.n_rows, "slots": self.n_slots,
                "fill": round(self.n_rows / self.n_slots, 4)
                if self.n_slots else 0.0,
                "version": self.version, "watermark": self.watermark,
                "init_dump_s": round(self.init_dump_s, 6)}


    @classmethod
    def from_numpy(cls, keys: np.ndarray, values: np.ndarray,
                   txn: np.ndarray, watermark: int = 0,
                   backend=None) -> "InMemoryTable":
        """A table holding exactly these slot arrays (keys [S] with -1 for
        empty slots, values [S, W], txn [S]) — e.g. another
        implementation's cache state, so two packages can probe one
        cache."""
        keys = np.asarray(keys)
        values = np.asarray(values, np.float32)
        tbl = cls(len(keys), values.shape[1], backend=backend)
        tbl.keys = keys.astype(np.int32)
        tbl.values = values.copy()
        tbl.txn = np.asarray(txn).astype(np.int64)
        tbl.watermark = int(watermark)
        tbl.n_rows = int((tbl.keys != -1).sum())
        tbl.version += 1
        return tbl

    # ------------------------------------------------------------ lookups
    def _torch_device(self) -> torch.device:
        from repro_torch.core.backend import get_backend
        self._backend = get_backend(self._backend)
        return self._backend.torch_device

    def device_state(self) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
        """Device mirror of (keys i32, values f32, txn i32) on the
        backend's torch device, component-dirty tracked: only arrays whose
        host content changed since the last mirror are re-uploaded (every
        upload COPIES, so mirrors already pinned by older
        ``CacheSnapshot``s stay immutable — on the CPU too). A steady-state
        bucket whose master data hasn't moved re-uploads nothing. To a
        card the uploads are non-blocking (``backend.upload``), ordered
        before the kernels that the current stream launches next."""
        if self._device is None or self._dirty:
            from repro_torch.core.backend import upload
            dev = self._torch_device()
            k, v, t = self._device or (None, None, None)
            if k is None or "keys" in self._dirty:
                k = upload(self.keys, dev)
            if v is None or "values" in self._dirty:
                v = upload(self.values, dev)
            if t is None or "txn" in self._dirty:
                t = upload(self.txn.astype(np.int32), dev)
            self._device = (k, v, t)
            self._dirty.clear()
        return self._device

    def snapshot_view(self, device: bool) -> "CacheSnapshot":
        """Immutable point-in-time view for LOCK-FREE probing. The caller
        holds the cache lock only for this call; the returned snapshot is
        safe to probe while concurrent upserts mutate the live table. For
        device backends it pins the (immutable) device mirror; for host
        backends it copies the arrays. Memoized per `version`, so in steady
        state (master data changes rarely — the paper's premise) it is a
        few attribute reads."""
        if self._snap is None or self._snap_version != (self.version,
                                                        device):
            if device:
                state = self.device_state()
                self._snap = CacheSnapshot(None, None, None, self.watermark,
                                           state, backend=self._backend)
            else:
                self._snap = CacheSnapshot(
                    self.keys.copy(), self.values.copy(), self.txn.copy(),
                    self.watermark, None, backend=self._backend)
            self._snap_version = (self.version, device)
        return self._snap


class CacheSnapshot:
    """Frozen view of an ``InMemoryTable`` (see ``snapshot_view``): exactly
    the read surface the compute backends touch, nothing else."""

    __slots__ = ("keys", "values", "txn", "watermark", "_device", "_backend")

    def __init__(self, keys, values, txn, watermark, device, backend=None):
        self.keys = keys
        self.values = values
        self.txn = txn
        self.watermark = watermark
        self._device = device
        self._backend = backend      # name/instance; resolved lazily

    def device_state(self):
        return self._device

    @property
    def backend(self):
        """Resolved ComputeBackend (explicit > config/env default)."""
        from repro_torch.core.backend import ComputeBackend, get_backend
        if not isinstance(self._backend, ComputeBackend):
            self._backend = get_backend(self._backend)
        return self._backend

    def lookup(self, query_keys
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized probe through the compute backend. Returns host
        (values [n, W], found [n] bool, txn_times [n])."""
        be = self.backend
        state = (self.device_state() if be.device
                 else (self.keys, self.values, self.txn))
        return be.hash_probe(query_keys, *state)

