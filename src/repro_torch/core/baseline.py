"""Baseline: the 'unmodified Stream Processing framework' of §4.1.1.

Same workload, same KPI math, but none of DOD-ETL's strategies:

  * no In-memory cache — every operational record looks master data up in
    the *source database* (per-record queries against production tables;
    this is also the source-overload pathology of Table 1),
  * no business-key partitioning — records are processed in arrival order
    on a single consumer view (no partition parallelism to exploit),
  * no late buffer — records with missing master data are retried by
    re-querying the source on the next micro-batch (the common
    polling-based design the paper replaces).

The 10x of Table 2 emerges mechanically: per-record host-side queries +
re-fetch per batch vs vectorized device probes against a worker-local cache.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.configs.dod_etl import ETLConfig
from repro_torch.core.cdc import SourceDatabase
from repro_torch.core.pipeline import StageMetrics
from repro_torch.core.records import RecordBatch
from repro_torch.core.transformer import FACT_COLUMNS, EPS


class BaselineStreamProcessor:
    def __init__(self, cfg: ETLConfig, source: SourceDatabase,
                 equipment_table: str = "equipment",
                 quality_table: str = "quality"):
        self.cfg = cfg
        self.source = source
        self.metrics = StageMetrics()
        self.pending: List[RecordBatch] = []
        names = [t.name for t in cfg.tables]
        self.eq_tid = names.index(equipment_table)
        self.q_tid = names.index(quality_table)
        self.rows_out = 0

    def process(self, batch: RecordBatch) -> np.ndarray:
        t0 = time.perf_counter()
        work = RecordBatch.concat(self.pending + [batch])
        self.pending = []
        n = len(work)
        facts = np.zeros((n, len(FACT_COLUMNS)), np.float32)
        late_idx = []
        for i in range(n):                       # record-at-a-time (paper §2)
            p = work.payload[i]
            equip_id = int(p[1])
            prod_id = int(p[0])
            # look-backs on the source database (the paper's anti-pattern)
            eq = self._query_master(self.eq_tid, "equipment_id", equip_id)
            qu = self._query_master(self.q_tid, "prod_id", prod_id)
            if eq is None or qu is None:
                late_idx.append(i)
                continue
            t_start, t_end, qty, speed = p[3], p[4], p[5], p[6]
            e_start, e_end, status, max_speed, planned = \
                eq[3], eq[4], eq[5], eq[6], eq[7]
            defects, scrap = qu[4], qu[6]
            overlap = max(min(t_end, e_end) - max(t_start, e_start), 0.0)
            duration = max(t_end - t_start, EPS)
            seg_on = overlap if status > 0.5 else 0.0
            availability = min(max(seg_on / max(planned, EPS), 0.0), 1.0)
            performance = min(max(qty / max(max_speed * duration, EPS), 0.0), 1.0)
            good = max(qty - defects - scrap, 0.0)
            quality = min(max(good / max(qty, EPS), 0.0), 1.0)
            oee = availability * performance * quality
            facts[i] = (p[1], t_start, t_end, availability, performance,
                        quality, oee, seg_on, duration - seg_on, 1.0)
        if late_idx:
            self.pending.append(work.take(np.array(late_idx, np.int64)))
        good_mask = facts[:, -1] > 0.5
        out = facts[good_mask]
        self.rows_out += len(out)
        self.metrics.records += len(out)
        self.metrics.wall_s += time.perf_counter() - t0
        return out

    def _query_master(self, table_id: int, join_col: str, join_key: int):
        """Per-record source query: full scan (no index on the join column —
        the paper's 'performance degradation' row of Table 1) returning the
        newest matching row by transaction time, like DOD-ETL's cache."""
        table = self.source.scan_table(table_id)
        txns = self.source.table_txn.get(table_id, {})
        col = 1 if join_col == "equipment_id" else 3
        best, best_t = None, -1
        for rk, row in table.items():
            if int(row[col]) == join_key and txns.get(rk, 0) > best_t:
                best, best_t = row, txns.get(rk, 0)
        return best
