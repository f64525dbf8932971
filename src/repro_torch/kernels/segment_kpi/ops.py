"""Wrappers of the ``segment_kpi`` CUDA kernels (``csrc/segment_kpi.cu``):
the fused fact build + per-unit rollup, the per-unit rollup of built facts
(the warehouse's full rescan), the serving-view delta fold and the batched
point-query gather.

For CPU tensors each wrapper runs its plain version (``ref.py``); for
CUDA tensors it launches its kernel on the current stream or raises.
``launches[<wrapper>]`` counts kernel launches (plain-version calls do
not count)."""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels._build import (check, count_launch, on_cuda,
                                        raise_on)
from repro_torch.kernels.segment_kpi.ref import (KPI_BLOCK, KPI_LANES,
                                                 fold_segments_ref,
                                                 gather_stats_ref,
                                                 segment_kpi_ref,
                                                 segment_rollup_ref)

N_FACT = 10
MAX_FOLD_ROWS = 2048  # the fold tree keeps 4 * B floats in shared memory

launches = {"segment_kpi": 0, "segment_rollup": 0, "fold_segments": 0,
            "gather_stats": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "segment_kpi_launch": [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    "segment_rollup_launch": [_P, _L, _I, _P, _P, _P],
    "fold_segments_launch": [_P, _P, _I, _I, _I, _P, _P],
    "gather_stats_launch": [_P, _I, _P, _I, _P, _P],
}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    from repro_torch.kernels._build import library
    fn = getattr(library("segment_kpi"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = _I
    return fn


def segment_kpi(prod: torch.Tensor, eq_rows: torch.Tensor,
                q_rows: torch.Tensor, *, n_units: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused fact build + per-unit KPI rollup. prod/eq_rows/q_rows [N, 8]
    f32 (a joined row with col 1 < 0 marks a join miss) -> (facts [N, 10]
    f32, agg [n_units, 5] f32). Rows that are not valid, or whose unit
    (prod col 1) lies outside [0, n_units), add nothing to ``agg``."""
    if n_units < 1:
        raise ValueError(f"n_units must be >= 1, got {n_units}")
    if not on_cuda(prod, "segment_kpi"):
        return segment_kpi_ref(prod, eq_rows, q_rows, n_units)
    dev = prod.device
    n = prod.shape[0]
    for t, name in ((prod, "prod"), (eq_rows, "eq_rows"), (q_rows, "q_rows")):
        check(t, name, torch.float32, (n, 8), dev)
    n_blocks = -(-n // KPI_BLOCK)
    facts = torch.empty((n, N_FACT), dtype=torch.float32, device=dev)
    partials = torch.empty((n_blocks, n_units, KPI_LANES),
                           dtype=torch.float32, device=dev)
    agg = torch.empty((n_units, KPI_LANES), dtype=torch.float32, device=dev)
    err = _fn("segment_kpi_launch")(
        prod.data_ptr(), eq_rows.data_ptr(), q_rows.data_ptr(), n, n_units,
        facts.data_ptr(), partials.data_ptr(), agg.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "segment_kpi")
    count_launch(launches, "segment_kpi")
    return facts, agg


def segment_rollup(facts: torch.Tensor, n_units: int) -> torch.Tensor:
    """Per-unit KPI rollup of built fact rows: facts [N, 10] f32 (any N, no
    padding) -> [n_units, 5] f32, the sums of fact columns 3-6 and a count
    over rows with col 9 > 0.5 whose unit (col 0, truncated toward zero;
    NaN counts nowhere) lies in [0, n_units). Bitwise ``segment_rollup_ref``:
    rows added in order within 256-row blocks, block partials in block
    order."""
    if n_units < 1:
        raise ValueError(f"n_units must be >= 1, got {n_units}")
    if not on_cuda(facts, "segment_rollup"):
        return segment_rollup_ref(facts, n_units)
    dev = facts.device
    check(facts, "facts", torch.float32, (None, N_FACT), dev)
    n = facts.shape[0]
    partials = torch.empty((-(-n // KPI_BLOCK), n_units, KPI_LANES),
                           dtype=torch.float32, device=dev)
    agg = torch.empty((n_units, KPI_LANES), dtype=torch.float32, device=dev)
    err = _fn("segment_rollup_launch")(
        facts.data_ptr(), n, n_units, partials.data_ptr(), agg.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "segment_rollup")
    count_launch(launches, "segment_rollup")
    return agg


def fold_segments(seg: torch.Tensor, vals: torch.Tensor,
                  n_segments: int) -> torch.Tensor:
    """Serving-view delta fold of ONE power-of-two row block: seg [B] i64
    (ids outside [0, n_segments) are the identity), vals [B, L] f32 ->
    packed [n_segments, 1 + 3L] f32 (count | sums | mins | maxs), bitwise
    the reference's halving tree."""
    if not on_cuda(seg, "fold_segments"):
        return fold_segments_ref(seg, vals, n_segments)
    dev = seg.device
    B = seg.shape[0]
    if B < 1 or B & (B - 1) or B > MAX_FOLD_ROWS:
        raise ValueError(f"fold block must be a power of two in "
                         f"[1, {MAX_FOLD_ROWS}], got {B}")
    check(seg, "seg", torch.int64, (B,), dev)
    check(vals, "vals", torch.float32, (B, None), dev)
    L = vals.shape[1]
    if L < 1:
        raise ValueError("vals needs at least one lane")
    out = torch.empty((n_segments, 1 + 3 * L), dtype=torch.float32,
                      device=dev)
    if n_segments == 0:
        return out
    err = _fn("fold_segments_launch")(
        seg.data_ptr(), vals.data_ptr(), B, L, n_segments, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "fold_segments")
    count_launch(launches, "fold_segments")
    return out


def gather_stats(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched point read: table [S, 1 + 3L] f32, idx [N] i64 in [0, S)
    (the caller validates the range: the kernel does not) -> [N, 1 + 4L]
    f32 (count | sums | mins | maxs | means), means NaN where count is 0."""
    if not on_cuda(table, "gather_stats"):
        return gather_stats_ref(table, idx)
    dev = table.device
    check(table, "table", torch.float32, (None, None), dev)
    check(idx, "idx", torch.int64, (None,), dev)
    if (table.shape[1] - 1) % 3:
        raise ValueError(f"table must be [S, 1 + 3L], got "
                         f"{tuple(table.shape)}")
    n = idx.shape[0]
    L = (table.shape[1] - 1) // 3
    out = torch.empty((n, 1 + 4 * L), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    err = _fn("gather_stats_launch")(
        table.data_ptr(), L, idx.data_ptr(), n, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "gather_stats")
    count_launch(launches, "gather_stats")
    return out


__all__ = ["fold_segments", "gather_stats", "launches", "segment_kpi",
           "segment_rollup"]
