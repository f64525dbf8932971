"""Log-based Change Data Capture (paper §3.1.1).

``ChangeLog`` models the source database's append-only binlog: *one shared
log for all tables* (MySQL semantics — the property behind the Listener
saturation in the paper's Fig. 5: every Listener scans the whole log and
filters its own table). Writes go through ``apply`` exactly as a database
would serialize transactions; the production tables themselves live in
``SourceDatabase`` and are NEVER read by the ETL path — only the log is.

``SourceDatabase.lookup_*`` exists solely for the *baseline* stream
processor (the paper's unmodified-framework comparison), which performs
look-backs against the source; DOD-ETL never calls it.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.records import OP_INSERT, RecordBatch


class ChangeLog:
    """Append-only shared change log with LSN ordering.

    Every ``append`` is stamped with a monotonic wall-clock *event time*.
    This is where a record's end-to-end freshness clock starts: the
    concurrent runtime (``repro.runtime.cluster``) computes per-record
    latency as ``load_time - event_time(lsn)``, so the reported p50/p95/p99
    freshness covers the whole Fig. 2 path — extraction, queueing,
    buffering, transform and warehouse load."""

    def __init__(self):
        self._batches: List[RecordBatch] = []
        self._next_lsn = 0
        self._lock = threading.Lock()
        # event-time stamps: one (first_lsn, append_time) entry per append
        self._seg_lsns: List[int] = []
        self._seg_times: List[float] = []

    @property
    def next_lsn(self) -> int:
        return self._next_lsn

    @staticmethod
    def clock() -> float:
        """The log's monotonic clock (seconds). Latency consumers must
        subtract ``event_times`` from THIS clock, not ``time.time()``."""
        return time.perf_counter()

    def append(self, batch: RecordBatch) -> Tuple[int, int]:
        """Assigns LSNs; returns (first_lsn, next_lsn)."""
        with self._lock:
            n = len(batch)
            batch.lsn[:] = np.arange(self._next_lsn, self._next_lsn + n)
            first = self._next_lsn
            self._next_lsn += n
            self._batches.append(batch)
            self._seg_lsns.append(first)
            self._seg_times.append(self.clock())
            return first, self._next_lsn

    def event_times(self, lsns: np.ndarray) -> np.ndarray:
        """Event-time stamp (seconds on ``clock()``) for each LSN, at append
        granularity: every record of one ``append`` shares its stamp."""
        with self._lock:
            seg_lsns = np.asarray(self._seg_lsns, np.int64)
            seg_times = np.asarray(self._seg_times, np.float64)
        if not len(seg_lsns):
            return np.zeros(len(lsns), np.float64)
        idx = np.clip(np.searchsorted(seg_lsns, lsns, side="right") - 1,
                      0, len(seg_lsns) - 1)
        return seg_times[idx]

    def read_from(self, lsn: int, limit: Optional[int] = None
                  ) -> Tuple[RecordBatch, int]:
        """Sequential scan from ``lsn`` (a Listener never touches tables).

        Returns (batch, records_scanned). ``records_scanned`` counts every
        log entry visited — the Fig. 5 cost model: reading the shared log is
        O(total log), not O(own-table entries). The in-memory constant is
        kept small: appends assign monotonically increasing LSNs, so the
        segment index bisects straight to the first relevant batch, only a
        boundary batch needs row filtering, and the result needs no re-sort
        (the 'seek' over older segments is still billed to ``scanned``).
        """
        with self._lock:              # appends race with Listener scans
            batches = list(self._batches)
            seg_lsns = np.asarray(self._seg_lsns, np.int64)
        start = int(np.searchsorted(seg_lsns, lsn, side="right")) - 1
        start = max(start, 0)
        # skipped-over segments: seek cost, still "on disk" for Fig. 5
        scanned = int(seg_lsns[start]) if len(seg_lsns) else 0
        out = []
        for b in batches[start:]:
            if len(b) == 0 or b.lsn[-1] < lsn:
                scanned += len(b)
                continue
            if b.lsn[0] >= lsn:
                out.append(b)                   # whole batch: zero-copy
                scanned += len(b)
            else:
                mask = b.lsn >= lsn             # boundary batch only
                scanned += int(mask.sum())
                out.append(b.filter(mask))
        batch = RecordBatch.concat(out)         # append order IS lsn order
        if limit is not None and len(batch) > limit:
            batch = batch.take(np.arange(limit))
        return batch, scanned

    def size(self) -> int:
        return self._next_lsn


class SourceDatabase:
    """Production tables + binlog. ``apply`` is the transactional write path
    (table update + log append). The impact model: every ``lookup`` performed
    by a non-CDC consumer adds contention units, which the benchmarks report
    as 'source load' — DOD-ETL's is zero by construction (paper Table 1:
    log-based CDC removes extraction pressure)."""

    def __init__(self):
        self.log = ChangeLog()
        self.tables: Dict[int, Dict[int, np.ndarray]] = {}
        self.table_txn: Dict[int, Dict[int, int]] = {}
        self.lookup_count = 0       # baseline-induced source pressure
        self.scan_count = 0

    def apply(self, batch: RecordBatch) -> None:
        tbl = self.tables
        for i in range(len(batch)):
            t = int(batch.table_id[i])
            tbl.setdefault(t, {})[int(batch.row_key[i])] = batch.payload[i]
            self.table_txn.setdefault(t, {})[int(batch.row_key[i])] = \
                int(batch.txn_time[i])
        self.log.append(batch)

    # ------------------------------------------------------------ baseline
    def lookup_row(self, table_id: int, row_key: int) -> Optional[np.ndarray]:
        self.lookup_count += 1
        return self.tables.get(table_id, {}).get(row_key)

    def scan_table(self, table_id: int) -> Dict[int, np.ndarray]:
        self.scan_count += 1
        self.lookup_count += len(self.tables.get(table_id, {}))
        return self.tables.get(table_id, {})
