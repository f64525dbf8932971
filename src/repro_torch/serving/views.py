"""Report view specs for the BI serving layer.

A ``ViewSpec`` declares one materialized report view over the fact stream:
how a fact row maps to a *segment* (the group-by key, a small dense int
domain) and which fact columns are its *value lanes*. The view engine
(``repro.serving.engine``) maintains, per view, one packed aggregate table
[n_segments, 1 + 3L] — count | sums | mins | maxs per segment — folded
incrementally from fact deltas through the compute backend's
``fold_segments`` op, so a report query costs O(n_segments), never
O(fact-table).

Segment/value extraction runs on host numpy (cheap integer math on the
delta only); the fold itself is the backend dispatch. Both are
deterministic, which is what makes incremental state replayable
bit-for-bit (see the engine's ``rebuild``).

Fact layout (``repro.core.transformer.FACT_COLUMNS``):
  0 equipment_id, 1 t_start, 2 t_end, 3 availability, 4 performance,
  5 quality, 6 oee, 7 seg_on, 8 seg_off, 9 valid
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ViewSpec:
    """One declarative materialized view: fact block -> (segments, values).

    ``segments(facts)`` returns int64 [n] segment ids; rows mapping outside
    [0, n_segments) are dropped by the fold (identity contribution).
    ``values(facts)`` returns f32 [n, len(lanes)] value lanes.
    """

    name: str
    n_segments: int
    lanes: Tuple[str, ...]
    segments: Callable[[np.ndarray], np.ndarray]
    values: Callable[[np.ndarray], np.ndarray]
    segment_names: Tuple[str, ...] = ()   # optional segment labels
    windowed: bool = False   # segments are ordered time windows: cumulative
                             # prefix reads make sense and the engine may
                             # fold deltas via the scan-form op
    key_aligned: bool = False  # segment id IS the business key (fact col 0):
                               # a sharded plane may place each segment on
                               # the shard that owns its RoutingTable
                               # partition, so folds stay shard-local and
                               # ownership migrates with repartition()

    @property
    def n_lanes(self) -> int:
        return len(self.lanes)


def _cols(facts: np.ndarray, idx) -> np.ndarray:
    return np.ascontiguousarray(facts[:, idx].astype(np.float32))


def oee_by_equipment(n_units: int) -> ViewSpec:
    """The paper's §4 deliverable: per-equipment OEE KPIs. Query-time means
    (sum/count) reproduce ``Warehouse.query_oee``; the raw sums + count
    reproduce ``Warehouse.kpi_rollup``'s [n_units, 5] layout."""
    return ViewSpec(
        name="oee_by_equipment", n_segments=n_units,
        lanes=("availability", "performance", "quality", "oee"),
        segments=lambda f: f[:, 0].astype(np.int64),
        values=lambda f: _cols(f, slice(3, 7)),
        key_aligned=True)


def kpi_by_unit_shift(n_units: int, n_shifts: int = 3,
                      shift_len: float = 4_000.0) -> ViewSpec:
    """KPI rollup per (equipment unit, shift-of-day): segment id is
    ``unit * n_shifts + shift`` with shift derived from the fact's
    production-window start tick."""
    def seg(f: np.ndarray) -> np.ndarray:
        unit = f[:, 0].astype(np.int64)
        shift = (f[:, 1] // np.float32(shift_len)).astype(np.int64) % n_shifts
        return unit * n_shifts + shift
    return ViewSpec(
        name="kpi_by_unit_shift", n_segments=n_units * n_shifts,
        lanes=("availability", "performance", "quality", "oee"),
        segments=seg,
        values=lambda f: _cols(f, slice(3, 7)))


def downtime_by_equipment(n_units: int) -> ViewSpec:
    """Top-N downtime causes: per equipment unit, summed off-segment
    seconds (the Fig. 3 fact-grain split's ``seg_off``) next to uptime —
    query-time sort of the tiny state table gives the top-N report."""
    return ViewSpec(
        name="downtime_by_equipment", n_segments=n_units,
        lanes=("downtime_s", "uptime_s"),
        segments=lambda f: f[:, 0].astype(np.int64),
        values=lambda f: _cols(f, [8, 7]),
        key_aligned=True)


def production_rate_windows(n_windows: int = 32,
                            window_len: float = 2_000.0) -> ViewSpec:
    """Windowed production rate: facts bucketed into time windows by
    production start tick (ring of ``n_windows``); count gives facts per
    window, summed runtime + min/max OEE give the window's health."""
    def seg(f: np.ndarray) -> np.ndarray:
        return (f[:, 1] // np.float32(window_len)).astype(np.int64) \
            % n_windows
    return ViewSpec(
        name="production_rate_windows", n_segments=n_windows,
        lanes=("runtime_s", "oee"),
        segments=seg,
        values=lambda f: _cols(f, [7, 6]),
        windowed=True)


def steelworks_views(n_units: int, n_shifts: int = 3,
                     shift_len: float = 4_000.0, n_windows: int = 32,
                     window_len: float = 2_000.0) -> Tuple[ViewSpec, ...]:
    """The paper's shift-report suite: every standard steelworks view."""
    return (oee_by_equipment(n_units),
            kpi_by_unit_shift(n_units, n_shifts, shift_len),
            downtime_by_equipment(n_units),
            production_rate_windows(n_windows, window_len))


__all__ = ["ViewSpec", "oee_by_equipment", "kpi_by_unit_shift",
           "downtime_by_equipment", "production_rate_windows",
           "steelworks_views"]
