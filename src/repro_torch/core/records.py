"""Record model shared by every DOD-ETL stage.

A *record batch* is a struct-of-arrays (host numpy; device jnp inside the
Stream Processor): integer identity/ordering fields plus a fixed-width f32
payload — the TPU-native stand-in for a database row. Fixed widths keep
every stage jit-compatible.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

PAYLOAD_WIDTH = 8

# op codes
OP_INSERT, OP_UPDATE, OP_DELETE = 0, 1, 2


@dataclasses.dataclass
class RecordBatch:
    """Columnar batch of change records (host side)."""

    table_id: np.ndarray       # i32 [n]
    op: np.ndarray             # i32 [n]
    row_key: np.ndarray        # i64 [n]   unique row identifier
    business_key: np.ndarray   # i64 [n]   domain partition key
    txn_time: np.ndarray       # i64 [n]   transaction timestamp (ns ticks)
    lsn: np.ndarray            # i64 [n]   log sequence number
    payload: np.ndarray        # f32 [n, PAYLOAD_WIDTH]

    def __post_init__(self):
        n = len(self.row_key)
        assert all(len(a) == n for a in
                   (self.table_id, self.op, self.business_key,
                    self.txn_time, self.lsn, self.payload)), "ragged batch"

    def __len__(self) -> int:
        return len(self.row_key)

    @staticmethod
    def empty() -> "RecordBatch":
        z = np.zeros(0, np.int64)
        return RecordBatch(z.astype(np.int32), z.astype(np.int32), z, z, z, z,
                           np.zeros((0, PAYLOAD_WIDTH), np.float32))

    @staticmethod
    def concat(batches) -> "RecordBatch":
        batches = [b for b in batches if len(b)]
        if not batches:
            return RecordBatch.empty()
        return RecordBatch(
            *(np.concatenate([getattr(b, f.name) for b in batches])
              for f in dataclasses.fields(RecordBatch)))

    def take(self, idx: np.ndarray) -> "RecordBatch":
        return RecordBatch(
            *(getattr(self, f.name)[idx]
              for f in dataclasses.fields(RecordBatch)))

    def slice(self, lo: int, hi: int) -> "RecordBatch":
        """Zero-copy contiguous row range (column views). The broker's read
        path slices frozen batches, so sharing the storage is safe."""
        return RecordBatch(
            *(getattr(self, f.name)[lo:hi]
              for f in dataclasses.fields(RecordBatch)))

    def filter(self, mask: np.ndarray) -> "RecordBatch":
        return self.take(np.nonzero(mask)[0])

    def sort_by_lsn(self) -> "RecordBatch":
        return self.take(np.argsort(self.lsn, kind="stable"))

    def split_by_partition(self, n_partitions: int,
                           key: str = "business_key", router=None
                           ) -> List[Tuple[int, "RecordBatch"]]:
        """Bucket rows by hash partition with ONE stable gather; the
        per-partition batches are zero-copy slices of the reordered columns.
        Returns [(partition, batch)] for non-empty partitions only.
        ``router`` (a ``partitioning.RoutingTable``) buckets by that
        routing epoch instead of the static hash."""
        from repro_torch.core.partitioning import partition_bounds
        if not len(self):
            return []
        order, bounds = partition_bounds(getattr(self, key), n_partitions,
                                         router)
        cols = [getattr(self, f.name)[order]
                for f in dataclasses.fields(RecordBatch)]
        return [(p, RecordBatch(*(c[bounds[p]:bounds[p + 1]] for c in cols)))
                for p in range(n_partitions) if bounds[p + 1] > bounds[p]]

    def freeze(self) -> "RecordBatch":
        """Mark every column read-only. Published batches are shared across
        worker threads (the broker hands out views, not copies), so freezing
        at publish time turns a CONSUMER's accidental mutation into an
        immediate ``ValueError`` instead of a data race. (Guard is
        consumer-side only: a producer still holding the base arrays of a
        view column could mutate through them.)"""
        for f in dataclasses.fields(RecordBatch):
            getattr(self, f.name).flags.writeable = False
        return self

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(RecordBatch)}


def make_batch(table_id: int, op: int, row_key, business_key, txn_time,
               payload, lsn_start: int = 0) -> RecordBatch:
    n = len(row_key)
    if n == 0:
        return RecordBatch.empty()
    return RecordBatch(
        table_id=np.full(n, table_id, np.int32),
        op=np.full(n, op, np.int32),
        row_key=np.asarray(row_key, np.int64),
        business_key=np.asarray(business_key, np.int64),
        txn_time=np.asarray(txn_time, np.int64),
        lsn=np.arange(lsn_start, lsn_start + n, dtype=np.int64),
        payload=np.asarray(payload, np.float32).reshape(n, -1),
    )
