"""Data Transformer (paper §3.1.2): per-partition streaming join of
operational records against the In-memory cache, fact-grain splitting
(Fig. 3: intersect production windows with equipment-status intervals) and
OEE KPI computation (§4: availability / performance / quality / OEE).

The numeric core is routed through the compute-backend layer
(``repro_torch.core.backend``): the ``numpy`` reference, or the ``torch``
backend's ``hash_join`` + ``segment_kpi`` CUDA kernels.

Payload layouts (see configs.dod_etl.steelworks_config):
  production : (prod_id, equipment_id, txn_time, t_start, t_end, qty, speed, order_id)
  equipment  : (row_id, equipment_id, txn_time, t_start, t_end, status, max_speed, planned)
  quality    : (row_id, equipment_id, txn_time, prod_id, defects, grade, scrap, rework)
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.cache import InMemoryTable

EPS = 1e-6

FACT_COLUMNS = ("equipment_id", "t_start", "t_end", "availability",
                "performance", "quality", "oee", "seg_on", "seg_off", "valid")


class DataTransformer:
    """Stateful wrapper: caches + late buffer + metrics for one worker.
    The numeric core is delegated to the selected ``ComputeBackend`` —
    one fused transform dispatch per call, regardless of how many queue
    partitions were coalesced into the batch. With ``n_units`` set the
    dispatch also carries the per-unit KPI rollup (the fused
    ``transform_and_rollup`` op), and the result stays device-resident
    as a ``FactBlock`` until the warehouse-load boundary."""

    def __init__(self, equipment: InMemoryTable, quality: InMemoryTable,
                 buffer, join_depth: int = 1, backend=None,
                 n_units: Optional[int] = None):
        from repro_torch.core.backend import get_backend
        self.equipment = equipment
        self.quality = quality
        self.buffer = buffer
        self.join_depth = join_depth
        self.n_units = n_units    # fused-rollup width (None: facts only)
        self.backend = get_backend(backend)
        self.records_out = 0
        self.records_late = 0
        self.dispatches = 0     # device dispatch count (the tentpole metric)

    def watermark(self) -> int:
        return min(self.equipment.watermark, self.quality.watermark)

    def transform_block(self, batch, equipment=None, quality=None):
        """Pure numeric transform of a RecordBatch: ONE backend dispatch,
        no buffer interaction, NO host sync — returns a device-resident
        ``FactBlock`` (facts + found + fused per-unit rollup when
        ``n_units`` is configured). The concurrent runtime's transform
        stage calls this with immutable ``CacheSnapshot`` views (taken
        under the worker's cache lock) so the dispatch itself runs
        LOCK-FREE and overlaps the ingest stage's master pumps; the block
        materializes to host only in the load stage, under the worker's
        commit lock, so device compute + D2H overlap the load stage's
        host work instead of blocking here."""
        block = self.backend.transform_block(
            batch.payload,
            equipment if equipment is not None else self.equipment,
            quality if quality is not None else self.quality,
            join_depth=self.join_depth, n_units=self.n_units)
        self.dispatches += 1
        return block

    def process_block(self, prod_batch):
        """Retry-merge + dispatch WITHOUT the host sync: pops
        watermark-ready buffered records, concats them ahead of the new
        batch, issues one dispatch. Returns (block, merged_batch) —
        block is None when there was nothing to transform. ``finish``
        (or the load stage) completes the late-buffer accounting once the
        block is materialized."""
        from repro_torch.core.records import RecordBatch

        retry = self.buffer.pop_ready(self.watermark())
        batch = RecordBatch.concat([retry, prod_batch])
        if not len(batch):
            return None, batch
        return self.transform_block(batch), batch

    def finish(self, block, batch) -> Tuple[np.ndarray, int]:
        """Host-side epilogue of ``process_block``: materialize the block
        (the step's one sync), buffer the late records, account metrics.
        Returns (good_facts [m, 10], n_late)."""
        facts, found = block.to_host()
        late = batch.filter(~found)
        self.buffer.push(late)
        self.records_late += len(late)
        good_facts = facts[found]
        self.records_out += len(good_facts)
        return good_facts, len(late)

    def process(self, prod_batch) -> Tuple[np.ndarray, int]:
        """prod_batch: RecordBatch of production records. Returns
        (facts [m, 10], n_late). Late records (missing master data) go to
        the Operational Message Buffer; buffered records whose txn_time
        passed the cache watermark are retried first (paper §3.1.2).

        Backends pad to power-of-two buckets internally so jitted kernels
        compile once per bucket, not once per arrival size (a 100x
        throughput cliff otherwise)."""
        block, batch = self.process_block(prod_batch)
        if block is None:
            return np.zeros((0, len(FACT_COLUMNS)), np.float32), 0
        return self.finish(block, batch)
