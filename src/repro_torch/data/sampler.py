"""Synthetic steelworks workload (paper §4.1: 'we built a sampler to insert
records on each database table ... 20,000 records at each table, simulating
the steelworks operation').

Deterministic given a seed. Master records (equipment status intervals,
quality inspections) and operational records (production runs) share
equipment units (= business keys) and prod_ids so the streaming join is
exercised, including out-of-order master arrival (late-buffer path).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

from repro_torch.configs.dod_etl import ETLConfig
from repro_torch.core.cdc import SourceDatabase
from repro_torch.core.records import OP_INSERT, RecordBatch, make_batch


@dataclasses.dataclass
class SamplerConfig:
    records_per_table: int = 20_000
    n_equipment: int = 20            # business keys (paper: 20 units)
    late_master_frac: float = 0.05   # master rows arriving after their facts
    seed: int = 0
    zipf_s: float = 0.0              # business-key skew: production events
                                     # hit unit r with p ∝ 1/r^s (0 = the
                                     # original uniform round-robin) — a
                                     # few hot casters emitting most events


class SteelworksSampler:
    def __init__(self, etl_cfg: ETLConfig, cfg: SamplerConfig):
        self.etl = etl_cfg
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self._tick = 1_000
        # Zipf unit-of-product map: a product line belongs to ONE unit for
        # the sampler's lifetime (hot casters stay hot across waves), and
        # the map is prefix-stable so streamed production waves agree with
        # the master rows generated earlier for the same prod_ids
        self._zipf_rng = np.random.default_rng((cfg.seed, 0x51))
        self._unit_of = np.zeros(0, np.int64)

    def _units_for(self, n: int, nunits: int) -> np.ndarray:
        if self.cfg.zipf_s <= 0:
            return (np.arange(n, dtype=np.int64) % nunits)
        if len(self._unit_of) < n:
            p = 1.0 / np.arange(1, nunits + 1) ** self.cfg.zipf_s
            extra = self._zipf_rng.choice(nunits, n - len(self._unit_of),
                                          p=p / p.sum())
            self._unit_of = np.concatenate(
                [self._unit_of, extra.astype(np.int64)])
        return self._unit_of[:n]

    def _times(self, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        start = self._tick + np.arange(n) * 10
        dur = self.rng.integers(5, 50, n)
        self._tick += n * 10
        return start.astype(np.int64), (start + dur).astype(np.int64), \
            (start + dur + 1).astype(np.int64)

    def generate(self, source: SourceDatabase,
                 n_per_table: Optional[int] = None,
                 tables: Optional[Tuple[str, ...]] = None) -> int:
        """Insert n records per selected table into the source DB (through
        the transactional path, so the CDC log sees everything). Master rows
        for a fraction of prod_ids are withheld and inserted AFTER their
        production facts — the out-of-sync arrival of §3.2."""
        n = n_per_table or self.cfg.records_per_table
        names = [t.name for t in self.etl.tables]
        pick = tables or tuple(names)
        nunits = self.cfg.n_equipment

        prod_ids = np.arange(n, dtype=np.int64)
        equip = self._units_for(n, nunits)
        t_start, t_end, txn = self._times(n)
        qty = self.rng.uniform(10, 100, n).astype(np.float32)
        speed = self.rng.uniform(1, 5, n).astype(np.float32)

        total = 0
        late_cut = int(n * (1 - self.cfg.late_master_frac))

        def table_id(name): return names.index(name)

        # ---- master first (except the late tail), then operational,
        # then the late master tail (out-of-order arrival)
        def eq_batch(lo, hi, tshift=0):
            ids = np.arange(lo, hi, dtype=np.int64)
            e = ids % nunits
            # status intervals span the whole shift (overlap every production
            # window of the unit); planned productive time is the shift quota
            payload = np.stack([
                ids.astype(np.float32), e.astype(np.float32),
                (txn[lo:hi] + tshift).astype(np.float32),
                np.zeros(hi - lo, np.float32),                        # t_start
                np.full(hi - lo, 1e9, np.float32),                    # t_end
                (self.rng.random(hi - lo) > 0.2).astype(np.float32),  # status
                np.full(hi - lo, 4.0, np.float32),                    # max_speed
                np.full(hi - lo, 60.0, np.float32),                   # planned
            ], axis=-1)
            return make_batch(table_id(next(nm for nm in names
                                            if "equipment" in nm)),
                              OP_INSERT, ids, e, txn[lo:hi] + tshift, payload)

        def qual_batch(lo, hi, tshift=0):
            ids = np.arange(lo, hi, dtype=np.int64) + 10_000_000
            # a quality inspection belongs to the equipment that produced
            # its prod_id — under Zipf skew that is `equip`, so the row is
            # cached by the worker that processes the production record
            e = equip[lo:hi]
            payload = np.stack([
                ids.astype(np.float32), e.astype(np.float32),
                (txn[lo:hi] + tshift).astype(np.float32),
                np.arange(lo, hi, dtype=np.float32),                  # prod_id
                self.rng.integers(0, 5, hi - lo).astype(np.float32),  # defects
                self.rng.integers(1, 4, hi - lo).astype(np.float32),  # grade
                self.rng.integers(0, 3, hi - lo).astype(np.float32),  # scrap
                np.zeros(hi - lo, np.float32),
            ], axis=-1)
            return make_batch(table_id(next(nm for nm in names
                                            if "quality" in nm)),
                              OP_INSERT, ids, e, txn[lo:hi] + tshift, payload)

        def prod_batch(lo, hi):
            payload = np.stack([
                prod_ids[lo:hi].astype(np.float32),
                equip[lo:hi].astype(np.float32),
                txn[lo:hi].astype(np.float32),
                t_start[lo:hi].astype(np.float32),
                t_end[lo:hi].astype(np.float32),
                qty[lo:hi], speed[lo:hi],
                prod_ids[lo:hi].astype(np.float32),                  # order id
            ], axis=-1)
            return make_batch(table_id(next(nm for nm in names
                                            if "production" in nm)),
                              OP_INSERT, prod_ids[lo:hi], equip[lo:hi],
                              txn[lo:hi], payload)

        has = lambda kind: any(kind in nm for nm in pick)
        if has("equipment"):
            source.apply(eq_batch(0, late_cut))
            total += late_cut
        if has("quality"):
            source.apply(qual_batch(0, late_cut))
            total += late_cut
        if has("production"):
            source.apply(prod_batch(0, n))
            total += n
        # late master tail (arrives after its production facts)
        if has("equipment"):
            source.apply(eq_batch(late_cut, n, tshift=1000))
            total += n - late_cut
        if has("quality"):
            source.apply(qual_batch(late_cut, n, tshift=1000))
            total += n - late_cut
        # duplicate the remaining ISA-95-style normalized tables if present
        for nm in pick:
            if nm not in names:
                continue
            if ("segment" in nm or "event" in nm or "detail" in nm) and \
                    "production" not in nm:
                tid = table_id(nm)
                ids = np.arange(n, dtype=np.int64) + tid * 50_000_000
                payload = np.tile(np.arange(8, dtype=np.float32), (n, 1))
                payload[:, 1] = equip.astype(np.float32)
                payload[:, 2] = txn.astype(np.float32)
                payload[:, 3] = prod_ids.astype(np.float32)
                source.apply(make_batch(tid, OP_INSERT, ids, equip, txn,
                                        payload))
                total += n
        return total


def synthetic_facts(rng: np.random.Generator, n: int, n_units: int,
                    valid_frac: float = 1.0) -> np.ndarray:
    """Random fact rows in the transformer's output layout
    (``repro.core.transformer.FACT_COLUMNS``: col 0 unit, 1-2 window,
    3-6 KPIs, 7-8 on/off segments, 9 valid flag) — the serving-layer
    tests' and benchmarks' direct-to-warehouse workload, bypassing the
    pipeline when only the read side is under test."""
    f = np.zeros((n, 10), np.float32)
    f[:, 0] = rng.integers(0, n_units, n)
    f[:, 1] = rng.uniform(0, 60_000, n)
    f[:, 2] = f[:, 1] + rng.uniform(1, 50, n)
    f[:, 3:7] = rng.uniform(0, 1, (n, 4))
    f[:, 7] = rng.uniform(0, 40, n)
    f[:, 8] = rng.uniform(0, 40, n)
    f[:, 9] = (rng.random(n) <= valid_frac).astype(np.float32)
    return f
