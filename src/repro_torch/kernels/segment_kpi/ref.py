"""Plain PyTorch versions of the ``segment_kpi`` CUDA kernels: the oracles
the card checks them against and what the wrappers run for CPU tensors.

Every elementwise op matches the reference's numpy oracle op for op
(``repro.core.backend._kpi_facts_np``, ``_fold_tree_np`` and
``combine_fold``, ``_gather_stats_np``): float32 throughout, and numpy's min/max semantics
(``np_minimum``/``np_maximum`` below), so facts, folds and gathers are
bitwise the oracle's on the CPU."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.hash_join.ref import hash_join_pair_ref

EPS = 1e-6
KPI_LANES = 5
KPI_BLOCK = 256      # rows per block of the KPI kernel's rollup


def np_minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``np.minimum``: ``a`` where ``a < b`` or ``a`` is NaN, else ``b`` —
    the second operand on ties (``np.minimum(0.0, -0.0)`` is -0.0), NaN
    propagated. ``torch.minimum`` differs on signed zeros."""
    return torch.where((a < b) | torch.isnan(a), a, b)


def np_maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``np.maximum``, mirror of ``np_minimum``."""
    return torch.where((a > b) | torch.isnan(a), a, b)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    # a fill on the device, not a host copy: the plain versions stay
    # capturable in a CUDA graph
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """``np.clip(x, 0, 1)``."""
    return np_minimum(np_maximum(x, _scalar(0.0, x)), _scalar(1.0, x))


def kpi_facts_ref(prod: torch.Tensor, eq_rows: torch.Tensor,
                  q_rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Fact-grain split + OEE KPIs: [N, 10] f32 fact rows (col 9 =
    ``valid``), in ``_kpi_facts_np``'s op order."""
    eps = _scalar(EPS, prod)
    zero = _scalar(0.0, prod)
    t_start, t_end = prod[:, 3], prod[:, 4]
    qty = prod[:, 5]
    e_start, e_end = eq_rows[:, 3], eq_rows[:, 4]
    status, max_speed, planned = eq_rows[:, 5], eq_rows[:, 6], eq_rows[:, 7]
    defects, scrap = q_rows[:, 4], q_rows[:, 6]

    inter_lo = np_maximum(t_start, e_start)
    inter_hi = np_minimum(t_end, e_end)
    overlap = np_maximum(inter_hi - inter_lo, zero)
    duration = np_maximum(t_end - t_start, eps)
    seg_on = torch.where(status > 0.5, overlap, zero)
    seg_off = duration - seg_on

    availability = _clip01(seg_on / np_maximum(planned, eps))
    performance = _clip01(qty / np_maximum(max_speed * duration, eps))
    good = np_maximum(qty - defects - scrap, zero)
    quality = _clip01(good / np_maximum(qty, eps))
    oee = availability * performance * quality
    return torch.stack([prod[:, 1], t_start, t_end, availability,
                        performance, quality, oee, seg_on, seg_off,
                        valid.to(torch.float32)], dim=-1)


def unit_rollup_ref(facts: torch.Tensor, n_units: int) -> torch.Tensor:
    """Per-unit [availability, performance, quality, oee, count] sums over
    rows with col 9 > 0.5 and unit (col 0, truncated toward zero) in
    [0, n_units), added in the KPI kernel's order: row order within each
    ``KPI_BLOCK``-row block, then the block partials in block order. Each
    add is one float32 add in that order, so the result is bitwise the
    kernel's. A NaN unit counts nowhere, as in numpy's oracle (a CUDA
    float-to-int conversion would make it unit 0)."""
    n = facts.shape[0]
    unit = facts[:, 0].to(torch.int64)
    keep = ((facts[:, 9] > 0.5) & ~torch.isnan(facts[:, 0]) & (unit >= 0)
            & (unit < n_units))
    kpis = torch.cat([facts[:, 3:7],
                      torch.ones((n, 1), dtype=torch.float32,
                                 device=facts.device)], dim=1)
    hit = keep[:, None] & (unit[:, None] == torch.arange(
        n_units, device=facts.device)[None, :])                  # [n, U]
    rows = torch.where(hit[:, :, None], kpis[:, None, :],
                       torch.zeros((), dtype=torch.float32,
                                   device=facts.device))         # [n, U, 5]
    n_blocks = -(-n // KPI_BLOCK)
    pad = n_blocks * KPI_BLOCK - n
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, n_units, KPI_LANES))])
    rows = rows.reshape(n_blocks, KPI_BLOCK, n_units, KPI_LANES)
    # explicit float32 adds in order (torch's cumsum/sum may accumulate in
    # double or in another order)
    partials = rows.new_zeros((n_blocks, n_units, KPI_LANES))
    for r in range(KPI_BLOCK):
        partials = partials + rows[:, r]
    agg = rows.new_zeros((n_units, KPI_LANES))
    for b in range(n_blocks):
        agg = agg + partials[b]
    return agg


segment_rollup_ref = unit_rollup_ref     # plain version of ops.segment_rollup


def segment_kpi_ref(prod: torch.Tensor, eq_rows: torch.Tensor,
                    q_rows: torch.Tensor, n_units: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """prod/eq_rows/q_rows [N, 8] f32 (a joined row with col 1 < 0 marks a
    join miss) -> (facts [N, 10], agg [n_units, 5])."""
    valid = (eq_rows[:, 1] >= 0) & (q_rows[:, 1] >= 0)
    facts = kpi_facts_ref(prod, eq_rows, q_rows, valid)
    return facts, unit_rollup_ref(facts, n_units)


def transform_kpi_ref(prod: torch.Tensor, eq_table, q_table, n_units: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``ops.transform_kpi``: the transform's two probes
    (``hash_join_pair_ref``), then ``segment_kpi_ref`` on the joined rows.
    Returns (facts [N, 10], found [N] bool, agg [n_units, 5])."""
    eq_rows, q_rows, found = hash_join_pair_ref(prod, eq_table, q_table)
    facts, agg = segment_kpi_ref(prod, eq_rows, q_rows, n_units)
    return facts, found, agg


def fold_segments_ref(seg: torch.Tensor, vals: torch.Tensor,
                      n_segments: int) -> torch.Tensor:
    """``_fold_tree_np`` in torch: one padded power-of-two block [B] i64 /
    [B, L] f32 -> packed [n_segments, 1 + 3L] (count | sums | mins | maxs)
    by the fixed stride-halving tree ``x[:h] (+) x[h:]``."""
    onehot = seg[:, None] == torch.arange(n_segments, dtype=seg.dtype,
                                          device=seg.device)[None, :]
    oh = onehot.to(torch.float32)
    cnt = oh
    sums = oh[:, :, None] * vals[:, None, :]
    mins = torch.where(onehot[:, :, None], vals[:, None, :],
                       _scalar(float("inf"), vals))
    maxs = torch.where(onehot[:, :, None], vals[:, None, :],
                       _scalar(float("-inf"), vals))
    while cnt.shape[0] > 1:
        h = cnt.shape[0] // 2
        cnt = cnt[:h] + cnt[h:]
        sums = sums[:h] + sums[h:]
        mins = np_minimum(mins[:h], mins[h:])
        maxs = np_maximum(maxs[:h], maxs[h:])
    return torch.cat([cnt[0][:, None], sums[0], mins[0], maxs[0]], dim=1)


def combine_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``combine_fold`` over packed [.., 1 + 3L] fold rows: counts and
    sums added, mins and maxs by numpy's min/max, ``a`` the first operand
    of each."""
    L = (a.shape[-1] - 1) // 3
    return torch.cat([
        a[..., :1 + L] + b[..., :1 + L],
        np_minimum(a[..., 1 + L:1 + 2 * L], b[..., 1 + L:1 + 2 * L]),
        np_maximum(a[..., 1 + 2 * L:], b[..., 1 + 2 * L:])], dim=-1)


def fold_identity(n_segments: int, n_lanes: int,
                  like: torch.Tensor) -> torch.Tensor:
    """The fold identity [n_segments, 1 + 3L] on ``like``'s device: count
    and sums 0, mins +inf, maxs -inf."""
    shape = (n_segments, n_lanes)
    return torch.cat([
        torch.zeros((n_segments, 1 + n_lanes), dtype=torch.float32,
                    device=like.device),
        torch.full(shape, float("inf"), dtype=torch.float32,
                   device=like.device),
        torch.full(shape, float("-inf"), dtype=torch.float32,
                   device=like.device)], dim=1)


def fold_segments_many_ref(words: torch.Tensor, plan) -> torch.Tensor:
    """Plain version of ``ops.fold_segments_many``: for each item that
    ``ops.stage_fold`` laid out in ``words`` (``plan`` its ``FoldPlan``),
    ``fold_segments_ref`` of each padded block, combined in block order
    from the identity, written at the item's output offset."""
    vals = words.view(torch.float32)
    out = torch.empty(plan.n_out, dtype=torch.float32, device=words.device)
    for seg_off, val_off, stride, n, L, S, out_off, _chunk in plan.items:
        lanes = vals[val_off:val_off + L * stride].view(L, stride)
        acc = fold_identity(S, L, words)
        for lo in range(0, n, plan.block):
            m = min(plan.block, n - lo)
            B = max(8, 1 << (m - 1).bit_length())
            seg = words[seg_off + lo:seg_off + lo + B].to(torch.int64)
            acc = combine_packed(acc, fold_segments_ref(
                seg, lanes[:, lo:lo + B].t(), S))
        out[out_off:out_off + S * (1 + 3 * L)] = acc.reshape(-1)
    return out


def gather_stats_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``_gather_stats_np`` in torch: rows ``idx`` of the packed [S, 1 + 3L]
    table plus means = sums / count (NaN where count is 0)."""
    L = (table.shape[1] - 1) // 3
    t = table[idx]
    cnt = t[:, :1]
    means = torch.where(cnt > 0, t[:, 1:1 + L] / cnt,
                        _scalar(float("nan"), table))
    return torch.cat([t, means], dim=1)


def gather_stats_many_ref(words: torch.Tensor, plan) -> torch.Tensor:
    """Plain version of ``ops.gather_stats_many``: for each item that
    ``ops.stage_gather`` laid out in ``words`` (``plan`` its
    ``GatherPlan``), ``gather_stats_ref`` of its table at its ids, written
    at the item's output offset (the alignment gaps between items are left
    unwritten, as the kernel leaves them)."""
    vals = words.view(torch.float32)
    out = torch.empty(plan.n_out, dtype=torch.float32, device=words.device)
    for table_off, S, L, ids_off, n, out_off in plan.items:
        W = 1 + 3 * L
        table = vals[table_off:table_off + S * W].view(S, W)
        ids = words[ids_off:ids_off + n].to(torch.int64)
        out[out_off:out_off + n * (1 + 4 * L)] = \
            gather_stats_ref(table, ids).reshape(-1)
    return out
