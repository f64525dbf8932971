"""Operational Message Buffer (paper §3.1.2 / §3.2, 'unsynchronized
consistency').

Operational records whose master data has not yet arrived are buffered with
their transaction time. At each new operational batch the Data Transformer
retries exactly the buffered records whose ``txn_time`` is older than the
In-memory cache watermark ('only reprocesses buffer messages with
transaction dates older than the latest transaction date from the In-memory
cache, which avoids reprocessing operational messages that still have no
master data').

The buffer state lives in the coordinator's replicated store (the paper used
Zookeeper) so any worker can resume reprocessing after a failure: on a
§4.1.3 failover, ``repro.runtime.cluster.ConcurrentCluster`` drains a dead
worker's buffer into a survivor and re-homes every buffered record to its
partition's current owner.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.records import RecordBatch


class OperationalMessageBuffer:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self._batch: RecordBatch = RecordBatch.empty()
        self.dropped = 0
        self.total_buffered = 0
        self.total_retried = 0

    def __len__(self) -> int:
        return len(self._batch)

    def push(self, late: RecordBatch) -> None:
        if not len(late):
            return
        self.total_buffered += len(late)
        merged = RecordBatch.concat([self._batch, late])
        if len(merged) > self.capacity:
            # drop oldest beyond capacity (recorded; tests assert zero drops
            # under the paper's workloads)
            self.dropped += len(merged) - self.capacity
            merged = merged.take(np.arange(len(merged) - self.capacity,
                                           len(merged)))
        self._batch = merged

    def pop_ready(self, watermark: int,
                  limit: Optional[int] = None) -> RecordBatch:
        """Remove and return records eligible for retry (txn_time <=
        watermark). ``limit`` bounds one retry sweep (oldest-first), so a
        mass-late cold start is drained in micro-batches instead of one
        giant dispatch."""
        if not len(self._batch):
            return RecordBatch.empty()
        ready_mask = self._batch.txn_time <= watermark
        if limit is not None and ready_mask.sum() > limit:
            keep_off = np.nonzero(ready_mask)[0][limit:]
            ready_mask = ready_mask.copy()
            ready_mask[keep_off] = False
        ready = self._batch.filter(ready_mask)
        self._batch = self._batch.filter(~ready_mask)
        self.total_retried += len(ready)
        return ready

    def drain(self) -> RecordBatch:
        """Remove and return ALL buffered records (failover handoff: a dead
        worker's replicated buffer is adopted by a survivor)."""
        out = self._batch
        self._batch = RecordBatch.empty()
        return out

    # ---------------------------------------------------------- durability
    def export_state(self) -> dict:
        return {"batch": self._batch.as_dict(), "dropped": self.dropped}

    @staticmethod
    def restore(state: dict, capacity: int) -> "OperationalMessageBuffer":
        buf = OperationalMessageBuffer(capacity)
        buf._batch = RecordBatch(**{k: np.asarray(v)
                                    for k, v in state["batch"].items()})
        buf.dropped = state.get("dropped", 0)
        return buf


class DeadLetterBuffer:
    """Quarantine for poison records — operational records whose transform
    deterministically raises. Instead of crash-looping the worker, the load
    stage commits their offsets (a quarantined record counts as *handled*:
    it will never replay) and parks the records here for operator triage.

    Append-only during a run; ``drain()`` is the operator's exit (see
    docs/OPERATIONS.md). Exported/restored with worker state so a
    checkpoint+recovery cannot silently lose quarantined records whose
    offsets are already committed."""

    def __init__(self):
        self._batch: RecordBatch = RecordBatch.empty()
        self.reasons: list = []
        self.total_quarantined = 0

    def __len__(self) -> int:
        return len(self._batch)

    def push(self, dead: RecordBatch, reason: str = "transform-error") -> None:
        if not len(dead):
            return
        self.total_quarantined += len(dead)
        self.reasons.append({"reason": reason, "records": int(len(dead))})
        self._batch = RecordBatch.concat([self._batch, dead])

    def peek(self) -> RecordBatch:
        return self._batch

    def drain(self) -> RecordBatch:
        out = self._batch
        self._batch = RecordBatch.empty()
        self.reasons = []
        return out

    # ---------------------------------------------------------- durability
    def export_state(self) -> dict:
        return {"batch": self._batch.as_dict(),
                "reasons": list(self.reasons),
                "total": self.total_quarantined}

    @staticmethod
    def restore(state: Optional[dict]) -> "DeadLetterBuffer":
        dlq = DeadLetterBuffer()
        if state is None:     # journal predates the dead-letter plane
            return dlq
        dlq._batch = RecordBatch(**{k: np.asarray(v)
                                    for k, v in state["batch"].items()})
        dlq.reasons = list(state.get("reasons", []))
        dlq.total_quarantined = int(state.get("total", len(dlq._batch)))
        return dlq
