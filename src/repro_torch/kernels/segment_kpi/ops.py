"""Wrappers of the ``segment_kpi`` CUDA kernels (``csrc/transform_kpi.cu``
and ``csrc/segment_kpi.cu``): the whole transform in one launch (both
cache probes, the fact build, the per-unit rollup), the fact build +
rollup of joined rows, the per-unit rollup of built facts (the
warehouse's full rescan), the serving views' delta fold of a whole fold
cycle (``stage_fold`` lays its items out in one buffer,
``fold_segments_many`` folds them in one launch, ``fold_tables`` splits
the result) and the batched point-query gather of a whole query batch
(``stage_gather``, ``gather_stats_many``, ``gather_tables`` likewise).

For CPU tensors each wrapper runs its plain version (``ref.py``); for
CUDA tensors it launches its kernel on the current stream or raises.
``launches[<wrapper>]`` counts kernel launches (plain-version calls do
not count)."""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels._build import (check, count_launch, on_cuda,
                                        raise_on)
from repro_torch.kernels.hash_join.ops import check_table
from repro_torch.kernels.segment_kpi.ref import (KPI_BLOCK, KPI_LANES,
                                                 fold_segments_many_ref,
                                                 gather_stats_many_ref,
                                                 gather_stats_ref,
                                                 segment_kpi_ref,
                                                 segment_rollup_ref,
                                                 transform_kpi_ref)

N_FACT = 10
MAX_FOLD_ROWS = 2048  # rows of one fold block: its ids and 4 lanes in smem
FOLD_WARPS = 8        # warps of a fold CTA, one (segment, lane) task each
FOLD_LANES_STAGED = 4  # value lanes a fold CTA holds in smem at once
FOLD_ITEM_WORDS = 8   # int32 words of one item descriptor
GATHER_ROWS = 32      # ids of one gather CTA
GATHER_CTA_WORDS = 8  # int32 words of one gather CTA descriptor

launches = {"transform_kpi": 0, "segment_kpi": 0, "segment_rollup": 0,
            "fold_segments_many": 0, "gather_stats_many": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "transform_kpi_launch": [_P, _I, _P, _P, _I, _I, _P, _P, _I, _I, _I, _P,
                             _P, _P, _P, _P, _P],
    "segment_kpi_launch": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
    "segment_rollup_launch": [_P, _L, _I, _P, _L, _P, _P],
    "fold_segments_many_launch": [_P, _I, _I, _I, _P, _P],
    "gather_stats_many_launch": [_P, _I, _P, _P],
}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    from repro_torch.kernels._build import library
    fn = getattr(library("segment_kpi"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = _I
    return fn


TICKET_BLOCK = 256    # ticket counters zeroed at once, one per stream
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
_TICKET_FREE: Dict[int, list] = {}
_TICKET_LOCK = threading.Lock()


def _ticket(dev: torch.device, stream) -> torch.Tensor:
    """The ticket counter of ``stream``: one u32 per (card, stream), 0
    between launches (the last CTA of each launch that takes tickets sets
    it back). Launches on one stream run in order and share it; launches
    on two streams never do. Counters are zeroed ``TICKET_BLOCK`` at a
    time, outside graph capture, and the zeroing is waited for once, so a
    stream that first appears while it captures a graph (as
    ``torch.cuda.graph``'s own capture stream does) gets a counter that is
    already 0."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    key = (index, stream.cuda_stream)
    with _TICKET_LOCK:
        t = _TICKETS.get(key)
        if t is None:
            free = _TICKET_FREE.setdefault(index, [])
            if not free:
                if torch.cuda.is_current_stream_capturing():
                    raise RuntimeError(
                        "the KPI kernels' ticket counters are zeroed "
                        "outside graph capture: launch once before")
                block = torch.zeros(TICKET_BLOCK, dtype=torch.int32,
                                    device=dev)
                stream.synchronize()
                free.extend(block.split(1))
            t = _TICKETS[key] = free.pop()
    return t


def _check_units(n_units: int) -> None:
    if n_units < 1:
        raise ValueError(f"n_units must be >= 1, got {n_units}")


def _check_rows(t: torch.Tensor, name: str, n: int, dev) -> None:
    check(t, name, torch.float32, (n, 8), dev)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} needs 16-byte alignment")


def _partials(n: int, n_units: int, dev, align: int = 1) -> torch.Tensor:
    """Scratch for the block partials, transposed: [n_units * 5, stride],
    stride the block count rounded up to a multiple of ``align``."""
    stride = -(-n // KPI_BLOCK)
    stride = -(-stride // align) * align
    return torch.empty((n_units * KPI_LANES, stride), dtype=torch.float32,
                       device=dev)


def transform_kpi(prod: torch.Tensor, eq_table, q_table, *, n_units: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole transform of one block in one launch: prod [N, 8] f32
    probed against the equipment cache with col 1 and against the quality
    cache with col 0 (each cast by ``key_to_int32``: NaN to 0, saturated,
    truncated toward zero), the fact-grain split and OEE KPIs of the
    joined rows, and the per-unit rollup. ``eq_table`` / ``q_table`` are a
    cache's (keys [S] i32, vals [S, W] f32, txn [S] i32), W >= 8, txn
    unread. Returns (facts [N, 10] f32, found [N] bool, agg [n_units, 5]
    f32): bitwise ``transform_kpi_ref`` — ``hash_join_pair_ref`` then
    ``segment_kpi_ref``."""
    _check_units(n_units)
    if not on_cuda(prod, "transform_kpi"):
        return transform_kpi_ref(prod, eq_table, q_table, n_units)
    dev = prod.device
    n = prod.shape[0]
    _check_rows(prod, "prod", n, dev)
    (eqk, eqv, _), (qk, qv, _) = eq_table, q_table
    check_table(eqk, eqv, "eq_table", dev)
    check_table(qk, qv, "q_table", dev)
    if eqv.shape[1] < 8 or qv.shape[1] < 8:
        raise ValueError("the joined rows need 8 lanes")
    facts = torch.empty((n, N_FACT), dtype=torch.float32, device=dev)
    found = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return facts, found, torch.zeros((n_units, KPI_LANES), device=dev)
    agg = torch.empty((n_units, KPI_LANES), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev)
    err = _fn("transform_kpi_launch")(
        prod.data_ptr(), n, eqk.data_ptr(), eqv.data_ptr(), eqv.shape[0],
        eqv.shape[1], qk.data_ptr(), qv.data_ptr(), qv.shape[0],
        qv.shape[1], n_units, facts.data_ptr(),
        found.data_ptr(), _partials(n, n_units, dev).data_ptr(),
        _ticket(dev, stream).data_ptr(), agg.data_ptr(), stream.cuda_stream)
    raise_on(err, "transform_kpi")
    count_launch(launches, "transform_kpi")
    return facts, found, agg


def segment_kpi(prod: torch.Tensor, eq_rows: torch.Tensor,
                q_rows: torch.Tensor, *, n_units: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused fact build + per-unit KPI rollup in one launch (the kernel of
    ``transform_kpi`` fed joined rows). prod/eq_rows/q_rows [N, 8] f32 (a
    joined row with col 1 < 0 marks a join miss) -> (facts [N, 10] f32,
    agg [n_units, 5] f32). Rows that are not valid, or whose unit (prod
    col 1) lies outside [0, n_units), add nothing to ``agg``. Bitwise
    ``segment_kpi_ref``."""
    _check_units(n_units)
    if not on_cuda(prod, "segment_kpi"):
        return segment_kpi_ref(prod, eq_rows, q_rows, n_units)
    dev = prod.device
    n = prod.shape[0]
    for t, name in ((prod, "prod"), (eq_rows, "eq_rows"), (q_rows, "q_rows")):
        _check_rows(t, name, n, dev)
    facts = torch.empty((n, N_FACT), dtype=torch.float32, device=dev)
    if n == 0:
        return facts, torch.zeros((n_units, KPI_LANES), device=dev)
    agg = torch.empty((n_units, KPI_LANES), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev)
    err = _fn("segment_kpi_launch")(
        prod.data_ptr(), eq_rows.data_ptr(), q_rows.data_ptr(), n, n_units,
        facts.data_ptr(), _partials(n, n_units, dev).data_ptr(),
        _ticket(dev, stream).data_ptr(), agg.data_ptr(), stream.cuda_stream)
    raise_on(err, "segment_kpi")
    count_launch(launches, "segment_kpi")
    return facts, agg


def segment_rollup(facts: torch.Tensor, n_units: int) -> torch.Tensor:
    """Per-unit KPI rollup of built fact rows: facts [N, 10] f32 (any N, no
    padding) -> [n_units, 5] f32, the sums of fact columns 3-6 and a count
    over rows with col 9 > 0.5 whose unit (col 0, truncated toward zero;
    NaN counts nowhere) lies in [0, n_units). Bitwise ``segment_rollup_ref``:
    rows added in order within 256-row blocks, block partials in block
    order (a second launch adds them)."""
    _check_units(n_units)
    if not on_cuda(facts, "segment_rollup"):
        return segment_rollup_ref(facts, n_units)
    dev = facts.device
    check(facts, "facts", torch.float32, (None, N_FACT), dev)
    n = facts.shape[0]
    if n == 0:
        return torch.zeros((n_units, KPI_LANES), device=dev)
    agg = torch.empty((n_units, KPI_LANES), dtype=torch.float32, device=dev)
    partials = _partials(n, n_units, dev, align=4)
    err = _fn("segment_rollup_launch")(
        facts.data_ptr(), n, n_units, partials.data_ptr(), partials.shape[1],
        agg.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "segment_rollup")
    count_launch(launches, "segment_rollup")
    return agg


def fold_bucket(rows: int) -> int:
    """Rows a fold block of ``rows`` rows is padded to: a power of two,
    at least 8 (the reference's ``_fold_blocks`` buckets)."""
    return max(8, 1 << (rows - 1).bit_length())


def fold_seg_chunk(n_lanes: int) -> int:
    """Segments per fold CTA for an item of ``n_lanes`` lanes: as many as
    fill the CTA's warps with (segment, lane) tasks in one round."""
    return max(1, FOLD_WARPS // min(n_lanes, FOLD_LANES_STAGED))


class FoldPlan(NamedTuple):
    """Where ``stage_fold`` put a fold cycle's items in the staged int32
    words, and where ``fold_segments_many`` writes their tables. ``items``
    holds one descriptor per item, as the kernel reads it: (seg_off,
    val_off, lane_stride, n_rows, n_lanes, n_fold, out_off, seg_chunk),
    offsets in words of the staged buffer or floats of the output."""
    block: int
    items: Tuple[Tuple[int, ...], ...]
    n_ctas: int         # CTA descriptors (item, first segment) from word 0
    item_off: int
    n_words: int
    n_out: int


def _align4(n: int) -> int:
    return -(-n // 4) * 4


def stage_fold(items: Sequence[Tuple[np.ndarray, np.ndarray, int]],
               block: int = MAX_FOLD_ROWS, pin: bool = False
               ) -> Tuple[torch.Tensor, FoldPlan]:
    """Lay a fold cycle's items out in one int32 host buffer (pinned with
    ``pin``, for one non-blocking upload). Each item is (seg [n] int, vals
    [n, L] f32, n_fold) with n >= 1 and n_fold >= 1; ids outside [0,
    n_fold) add the identity. Its rows are cut into ``block``-row blocks,
    the last padded to ``fold_bucket`` rows with id -1 and value 0. The
    words are: per CTA (item, first segment) of each ``fold_seg_chunk``
    segments; per item its descriptor; per item its padded ids, then its
    values lane-major (each lane ``lane_stride`` words). Every region
    starts on a 16-byte boundary."""
    if block < 8 or block & (block - 1) or block > MAX_FOLD_ROWS:
        raise ValueError(f"fold block must be a power of two in "
                         f"[8, {MAX_FOLD_ROWS}], got {block}")
    ctas, descs = [], []
    n_out = 0
    for i, (seg, vals, n_fold) in enumerate(items):
        n, L = vals.shape
        if n < 1 or n_fold < 1 or L < 1 or len(seg) != n:
            raise ValueError(f"fold item {i}: needs rows, lanes and "
                             f"segments, got seg {len(seg)}, vals "
                             f"{vals.shape}, n_fold {n_fold}")
        full = (n - 1) // block * block
        chunk = fold_seg_chunk(L)
        descs.append([0, 0, full + fold_bucket(n - full), n, L, n_fold,
                      n_out, chunk])
        n_out += n_fold * (1 + 3 * L)
        ctas += [(i, lo) for lo in range(0, n_fold, chunk)]
    item_off = _align4(2 * len(ctas))
    off = item_off + FOLD_ITEM_WORDS * len(descs)
    for d in descs:
        d[0], d[1] = off, off + d[2]           # ids, then lanes
        off = d[1] + d[4] * d[2]
    words = torch.zeros(off, dtype=torch.int32, pin_memory=pin)
    w = words.numpy()
    w[:2 * len(ctas)] = np.asarray(ctas, np.int32).reshape(-1)
    w[item_off:item_off + FOLD_ITEM_WORDS * len(descs)] = np.asarray(
        descs, np.int32).reshape(-1)
    f = w.view(np.float32)
    for (seg, vals, _), (seg_off, val_off, stride, n, L, *_) in zip(items,
                                                                    descs):
        w[seg_off:seg_off + n] = seg
        w[seg_off + n:seg_off + stride] = -1
        f[val_off:val_off + L * stride].reshape(L, stride)[:, :n] = vals.T
    plan = FoldPlan(block, tuple(map(tuple, descs)), len(ctas), item_off, off,
                    n_out)
    return words, plan


def fold_tables(flat, plan: FoldPlan) -> list:
    """Split ``fold_segments_many``'s output (a tensor or a numpy array)
    into each item's packed [n_fold, 1 + 3L] table (views)."""
    return [flat[o:o + S * (1 + 3 * L)].reshape(S, 1 + 3 * L)
            for _, _, _, _, L, S, o, _ in plan.items]


def fold_segments_many(words: torch.Tensor, plan: FoldPlan) -> torch.Tensor:
    """Serving-view delta fold of every item ``stage_fold`` laid out in
    ``words`` (its [plan.n_words] i32 buffer, on the device): one launch
    for all items and blocks. Returns [plan.n_out] f32, each item's packed
    [n_fold, 1 + 3L] table (count | sums | mins | maxs; split with
    ``fold_tables``), each block folded by the reference's halving tree
    and the blocks combined in order from the identity: bitwise
    ``fold_segments_many_ref``."""
    if not on_cuda(words, "fold_segments_many"):
        return fold_segments_many_ref(words, plan)
    dev = words.device
    check(words, "words", torch.int32, (plan.n_words,), dev)
    if words.data_ptr() % 16:
        raise ValueError("the staged fold words need 16-byte alignment")
    out = torch.empty(plan.n_out, dtype=torch.float32, device=dev)
    if plan.n_ctas == 0:
        return out
    err = _fn("fold_segments_many_launch")(
        words.data_ptr(), plan.n_ctas, plan.item_off, plan.block,
        out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "fold_segments_many")
    count_launch(launches, "fold_segments_many")
    return out


class GatherPlan(NamedTuple):
    """Where ``stage_gather`` put a query batch's items in the staged
    int32 words, and where ``gather_stats_many`` writes their answers.
    ``items`` holds (table_off, n_segments, n_lanes, ids_off, n_ids,
    out_off) per item, offsets in words of the staged buffer or floats of
    the output; ``head`` the CTA descriptors from word 0, as the kernel
    reads them."""
    items: Tuple[Tuple[int, ...], ...]
    head: Tuple[int, ...]
    n_ctas: int
    n_words: int
    n_out: int


def plan_gather(shapes: Sequence[Tuple[int, int, int]]) -> GatherPlan:
    """The layout of a query batch whose items have (n_segments, n_lanes,
    n_ids) ``shapes``: one ``GATHER_CTA_WORDS``-word descriptor per CTA
    ([table_off, S, L, first id's offset, ids, first answer's offset, 0,
    0]; each CTA answers ``GATHER_ROWS`` ids of one item), then per item
    its packed [S, 1 + 3L] table and its ids. The output holds each item's
    [n, 1 + 4L] answers. Every region and every item's output starts on a
    16-byte boundary."""
    for i, (S, L, n) in enumerate(shapes):
        if S < 0 or L < 1 or n < 0:
            raise ValueError(f"gather item {i}: needs S >= 0, L >= 1 and "
                             f"n >= 0, got ({S}, {L}, {n})")
    n_ctas = sum(-(-n // GATHER_ROWS) for _, _, n in shapes)
    off, n_out = GATHER_CTA_WORDS * n_ctas, 0
    items, head = [], []
    for S, L, n in shapes:
        ids_off = _align4(off + S * (1 + 3 * L))
        items.append((off, S, L, ids_off, n, n_out))
        for lo in range(0, n, GATHER_ROWS):
            head += (off, S, L, ids_off + lo, min(GATHER_ROWS, n - lo),
                     n_out + lo * (1 + 4 * L), 0, 0)
        off = _align4(ids_off + n)
        n_out = _align4(n_out + n * (1 + 4 * L))
    return GatherPlan(tuple(items), tuple(head), n_ctas, off, n_out)


def stage_gather(items: Sequence[Tuple[np.ndarray, np.ndarray]]
                 ) -> Tuple[np.ndarray, GatherPlan]:
    """Lay a query batch's (table [S, 1 + 3L] f32, ids [n] int) items out
    in one int32 host array (for one upload: ``core.backend.upload``), as
    ``plan_gather`` places them. Raises on an id outside [0, S): the
    kernel reads the rows it is given unchecked."""
    items = [(np.asarray(table, np.float32), np.asarray(ids, np.int64))
             for table, ids in items]
    shapes = []
    for i, (table, ids) in enumerate(items):
        if table.ndim != 2 or (table.shape[1] - 1) % 3 or table.shape[1] < 4:
            raise ValueError(f"gather item {i}: table must be [S, 1 + 3L], "
                             f"got {table.shape}")
        if ids.ndim != 1 or (len(ids) and (ids.min() < 0
                                           or ids.max() >= len(table))):
            raise ValueError(f"gather item {i}: ids must be [n] in [0, "
                             f"{len(table)})")
        shapes.append((len(table), (table.shape[1] - 1) // 3, len(ids)))
    plan = plan_gather(shapes)
    w = np.zeros(plan.n_words, np.int32)
    w[:len(plan.head)] = plan.head
    f = w.view(np.float32)
    for (table, ids), (t_off, _, _, i_off, n, _) in zip(items, plan.items):
        f[t_off:t_off + table.size] = table.reshape(-1)
        w[i_off:i_off + n] = ids
    return w, plan


def gather_tables(flat, plan: GatherPlan) -> list:
    """Split ``gather_stats_many``'s output (a tensor or a numpy array)
    into each item's [n, 1 + 4L] answers (views)."""
    return [flat[o:o + n * (1 + 4 * L)].reshape(n, 1 + 4 * L)
            for _, _, L, _, n, o in plan.items]


def gather_stats_many(words: torch.Tensor, plan: GatherPlan) -> torch.Tensor:
    """Batched point read of every item ``stage_gather`` laid out in
    ``words`` (its [plan.n_words] i32 buffer, on the device), one launch
    for the whole batch. Returns [plan.n_out] f32, each item's [n, 1 + 4L]
    answers (count | sums | mins | maxs | means; split with
    ``gather_tables``), means NaN where the count is 0: bitwise
    ``gather_stats_many_ref``."""
    if not on_cuda(words, "gather_stats_many"):
        return gather_stats_many_ref(words, plan)
    dev = words.device
    check(words, "words", torch.int32, (plan.n_words,), dev)
    if words.data_ptr() % 16:
        raise ValueError("the staged gather words need 16-byte alignment")
    out = torch.empty(plan.n_out, dtype=torch.float32, device=dev)
    if plan.n_ctas == 0:
        return out
    err = _fn("gather_stats_many_launch")(
        words.data_ptr(), plan.n_ctas, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "gather_stats_many")
    count_launch(launches, "gather_stats_many")
    return out


def gather_stats(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched point read of one table: table [S, 1 + 3L] f32, idx [N] i64
    in [0, S) (the caller validates the range: the kernel does not) ->
    [N, 1 + 4L] f32 (count | sums | mins | maxs | means), means NaN where
    count is 0. On a card: the one-item case of ``gather_stats_many``,
    its words assembled on the device."""
    if not on_cuda(table, "gather_stats"):
        return gather_stats_ref(table, idx)
    from repro_torch.core.backend import upload   # imports this module
    dev = table.device
    check(table, "table", torch.float32, (None, None), dev)
    check(idx, "idx", torch.int64, (None,), dev)
    if (table.shape[1] - 1) % 3 or table.shape[1] < 4:
        raise ValueError(f"table must be [S, 1 + 3L], got "
                         f"{tuple(table.shape)}")
    S, W = table.shape
    n = idx.shape[0]
    plan = plan_gather([(S, (W - 1) // 3, n)])
    words = torch.zeros(plan.n_words, dtype=torch.int32, device=dev)
    words[:len(plan.head)] = upload(np.asarray(plan.head, np.int32), dev)
    t_off, _, _, i_off, _, _ = plan.items[0]
    words[t_off:t_off + S * W] = table.reshape(-1).view(torch.int32)
    words[i_off:i_off + n] = idx.to(torch.int32)
    return gather_tables(gather_stats_many(words, plan), plan)[0]


__all__ = ["FoldPlan", "GatherPlan", "fold_bucket", "fold_seg_chunk",
           "fold_segments_many", "fold_tables", "gather_stats",
           "gather_stats_many", "gather_tables", "launches", "plan_gather",
           "segment_kpi", "segment_rollup", "stage_fold", "stage_gather",
           "transform_kpi"]
