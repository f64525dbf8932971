"""The port's two ETL kernels that fold and probe a whole step at once, held
against the JAX package on the CPU, where each wrapper runs its plain
version: ``fold_segments_many`` (every (delta, view) item of a fold cycle
in one launch on a card) and ``hash_join_pair`` (both master-cache probes
of one transform in one launch). Inputs are made from a seed with numpy.
Tolerance everywhere: bitwise. The CUDA kernels themselves are held
bitwise against these plain versions on a card in
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from repro.core import backend as ref_backend
from repro.serving import engine as ref_engine
from repro.serving import views as ref_views
from repro_torch.core.backend import FOLD_BLOCK, get_backend
from repro_torch.kernels import launch_counts
from repro_torch.kernels.hash_join import ops as hj_ops
from repro_torch.kernels.hash_join.ref import hash32, hash_join_ref
from repro_torch.kernels.segment_kpi import ops as sk_ops
from repro_torch.serving import MaterializedViewEngine, steelworks_views

CPU = torch.device("cpu")
# Signed zeros, and NaN or +-inf, but never both in one item: a sum lane
# where a NaN value meets a NaN the fold makes (0 * inf is the non-hit
# rows' product, inf + -inf) has no defined bits — numpy's own float32
# add returns the first operand's NaN for 16 elements and the second's
# for 33 — so no implementation can be held bitwise there.
SPECIALS = {"nan": np.float32([0.0, -0.0, np.nan]),
            "inf": np.float32([0.0, -0.0, np.inf, -np.inf]),
            None: np.float32([0.0, -0.0])}


# --------------------------------------------------------------------- fold
def _item(rng, n, S, L, *, ids=None, specials="nan"):
    """(seg, vals, S): ids in [-2, S + 2) (out of range both ways) unless
    ``ids`` names the ids to draw from; values with signed zeros and
    ``specials`` ("nan": NaN; "inf": +-inf) mixed in."""
    seg = (rng.integers(-2, S + 2, n) if ids is None
           else rng.choice(np.asarray(ids), n)).astype(np.int64)
    vals = rng.normal(size=(n, L)).astype(np.float32)
    mask = rng.random((n, L)) < 0.15
    vals[mask] = rng.choice(SPECIALS[specials], int(mask.sum()))
    return seg, vals, S


def _cases():
    """name -> item list, covering: empty items; items over FOLD_BLOCK
    rows (several blocks); n_active < 8 and n_active == n_segments;
    ids all out of range; L 1 to 4."""
    rng = np.random.default_rng(15)
    return {
        "lanes_1_to_4": [_item(rng, 300, S, L, specials=sp)
                         for S, L in ((5, 1), (20, 2), (60, 3), (32, 4))
                         for sp in ("nan", "inf")],
        "several_blocks": [_item(rng, 2 * FOLD_BLOCK + 37, 60, 4),
                           _item(rng, FOLD_BLOCK + 1, 20, 2,
                                 specials="inf"),
                           _item(rng, FOLD_BLOCK, 32, 1)],
        "empty_items": [_item(rng, 0, 20, 4), _item(rng, 17, 20, 4),
                        (np.zeros(0, np.int64),
                         np.zeros((0, 2), np.float32), 32)],
        "sparse_and_dense": [_item(rng, 500, 60, 4, ids=[3, 41, 59]),
                             _item(rng, 900, 20, 4, ids=range(20)),
                             _item(rng, 64, 5, 2, ids=range(5)),
                             _item(rng, 1000, 60, 2, ids=range(60))],
        "all_out_of_range": [_item(rng, 40, 8, 2, ids=[-1, 8, 9])],
        "steelworks_cycle": [_item(rng, n, S, L, specials=None)
                             for n in (1024, 871)
                             for S, L in ((20, 4), (60, 4), (20, 2),
                                          (32, 2))],
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_fold_segments_many_bitwise(case):
    """One call over a cycle's items gives, item by item, the bytes of the
    port's own ``fold_segments`` and of the reference's numpy backend,
    for one dispatch and one sync (none when no item adds anything)."""
    items = _cases()[case]
    be = get_backend("torch", device=CPU)
    before = launch_counts()
    be.reset_stats()
    got = be.fold_segments_many(items)
    live = any(((s >= 0) & (s < S)).any() for s, _, S in items)
    assert (be.op_dispatches, be.host_syncs) == ((1, 1) if live else (0, 0))
    assert launch_counts() == before          # the CPU runs no kernel
    assert len(got) == len(items)
    ref = ref_backend.NumpyBackend()
    for table, item in zip(got, items):
        assert table.dtype == np.float32
        assert table.tobytes() == be.fold_segments(*item).tobytes()
        assert table.tobytes() == ref.fold_segments(*item).tobytes()


@pytest.mark.parametrize("block", [8, 256, FOLD_BLOCK])
def test_stage_fold_layout(block):
    """The staged words as the kernel reads them: CTA and item
    descriptors, every region on a 16-byte boundary, blocks of ``block``
    rows with the last padded to its bucket with id -1 and value 0,
    values lane-major; the plain version's output splits into each item's
    [n_fold, 1 + 3L] table."""
    rng = np.random.default_rng(block)
    items = [_item(rng, n, S, L) for n, S, L in ((700, 20, 4), (9, 60, 2),
                                                 (3000, 32, 1))]
    words, plan = sk_ops.stage_fold(items, block)
    w = words.numpy()
    f = w.view(np.float32)
    assert words.dtype == torch.int32 and plan.n_words == len(w)
    chunks = [sk_ops.fold_seg_chunk(v.shape[1]) for _, v, _ in items]
    assert chunks == [2, 4, 8]            # 8 warps of (segment, lane) tasks
    ctas = w[:2 * plan.n_ctas].reshape(-1, 2)
    assert [tuple(c) for c in ctas] == [
        (i, lo) for i, ((_, _, S), c) in enumerate(zip(items, chunks))
        for lo in range(0, S, c)]
    descs = w[plan.item_off:plan.item_off
              + sk_ops.FOLD_ITEM_WORDS * len(items)].reshape(len(items), -1)
    assert [tuple(d) for d in descs] == list(plan.items)
    assert plan.item_off % 4 == 0
    for (seg, vals, S), (seg_off, val_off, stride, n, L, n_fold, _,
                         chunk) in zip(items, plan.items):
        assert chunk == sk_ops.fold_seg_chunk(L)
        assert seg_off % 4 == 0 and val_off % 4 == 0 and stride % 4 == 0
        last = n - (n - 1) // block * block
        assert stride == n - last + sk_ops.fold_bucket(last)
        assert (n, L, n_fold) == (len(seg), vals.shape[1], S)
        np.testing.assert_array_equal(w[seg_off:seg_off + n], seg)
        assert (w[seg_off + n:seg_off + stride] == -1).all()
        lanes = f[val_off:val_off + L * stride].reshape(L, stride)
        assert lanes[:, :n].tobytes() == np.ascontiguousarray(
            vals.T).tobytes()
        assert (lanes[:, n:].view(np.int32) == 0).all()   # +0.0 pads
    out = sk_ops.fold_segments_many(words, plan)
    assert out.shape == (plan.n_out,)
    tables = sk_ops.fold_tables(out, plan)
    assert [tuple(t.shape) for t in tables] == [(S, 1 + 3 * v.shape[1])
                                                for _, v, S in items]


def test_stage_fold_rejects_what_the_kernel_does_not_take():
    seg, vals, S = _item(np.random.default_rng(0), 16, 4, 2)
    with pytest.raises(ValueError):
        sk_ops.stage_fold([(seg, vals, S)], block=12)
    with pytest.raises(ValueError):
        sk_ops.stage_fold([(seg, vals, S)], block=2 * sk_ops.MAX_FOLD_ROWS)
    with pytest.raises(ValueError):
        sk_ops.stage_fold([(seg[:0], vals[:0], S)])


# ------------------------------------------------------------------- engine
def _facts(rng, n, n_units):
    """Fact rows: units partly out of range, start times past the last
    window, 10% invalid rows, signed zeros and a NaN in the value lanes."""
    f = np.zeros((n, 10), np.float32)
    f[:, 0] = rng.integers(-1, n_units + 1, n)
    f[:, 1] = rng.uniform(0, 70_000, n)
    f[:, 2] = f[:, 1] + rng.uniform(1, 300, n)
    f[:, 3:7] = rng.random((n, 4))
    f[:, 7] = rng.uniform(0, 200, n)
    f[:, 8] = rng.uniform(0, 50, n)
    f[:, 9] = rng.random(n) > 0.1
    f[rng.random(n) < 0.05, 8] = -0.0
    f[rng.random(n) < 0.05, 6] = 0.0
    if n > 3:
        f[3, 7] = np.nan
    return f


@pytest.mark.parametrize("scan_fold", [False, True])
def test_engine_drain_matches_reference_engine(scan_fold):
    """A multi-delta drain of the port's engine on the CPU: every view
    table byte-identical to the reference engine's (numpy backend), one
    dispatch and one sync per fold_pending (tree-folded views), and
    ``rebuild`` from the same chunks gives the same bytes."""
    n_units = 20
    rng = np.random.default_rng(7)
    drains = [[_facts(rng, n, n_units) for n in (300, 1, 2500, 700)],
              [_facts(rng, n, n_units) for n in (64, 1024)]]
    port = MaterializedViewEngine(steelworks_views(n_units), device="cpu",
                                  scan_fold=scan_fold)
    ref = ref_engine.MaterializedViewEngine(
        ref_views.steelworks_views(n_units), backend="numpy",
        scan_fold=scan_fold)
    be = port.backend
    for drain in drains:
        for facts in drain:
            port.publish(facts)
            ref.publish(facts)
        be.reset_stats()
        assert port.fold_pending() == ref.fold_pending() == sum(
            map(len, drain))
        if not scan_fold:
            assert be.op_dispatches == 1 and be.host_syncs == 1
        for name, st in ref.snapshot().states.items():
            assert port.snapshot().view(name).table.tobytes() == \
                st.table.tobytes()
    rebuilt = MaterializedViewEngine.rebuild(
        steelworks_views(n_units), [f for d in drains for f in d],
        backend=be, scan_fold=scan_fold)
    for name, st in ref.snapshot().states.items():
        assert rebuilt.view(name).table.tobytes() == st.table.tobytes()


# ------------------------------------------------------------------- probe
def _key_with_slot(slot, n_slots, start=1000):
    """The smallest key >= start whose home slot is ``slot``."""
    keys = np.arange(start, start + 64 * n_slots, dtype=np.int32)
    home = hash32(torch.from_numpy(keys)).numpy() % n_slots
    return int(keys[np.argmax(home == slot)])


def _cache(rng, n_slots, n_keys, *, wrap=False, width=8):
    """An open-addressing table (keys, vals, txn) with ``n_keys`` keys
    placed by linear probing; with ``wrap`` the first keys' home is the
    last slot, so their chain wraps to slot 0."""
    keys = np.full(n_slots, -1, np.int32)
    vals = np.zeros((n_slots, width), np.float32)
    txn = np.zeros(n_slots, np.int32)
    chosen = []
    if wrap:
        k = _key_with_slot(n_slots - 1, n_slots)
        chosen += [k, _key_with_slot(n_slots - 1, n_slots, k + 1)]
    pool = rng.choice(10**6, 4 * n_keys, replace=False).astype(np.int32)
    chosen += [int(k) for k in pool if k not in chosen][:n_keys - len(chosen)]
    for key in chosen:
        h = int(hash32(torch.tensor([key])).item()) % n_slots
        for p in range(n_slots):
            s = (h + p) % n_slots
            if keys[s] == -1:
                keys[s] = key
                vals[s] = rng.normal(size=width)
                txn[s] = rng.integers(1, 10**6)
                break
    return (torch.from_numpy(keys), torch.from_numpy(vals),
            torch.from_numpy(txn)), np.asarray(chosen, np.int64)


def _today(prod, eq_table, q_table):
    """The transform's probe sequence before the pair kernel: two casts,
    two probes, two masked_fill_, one &."""
    equip_id = prod[:, 1].to(torch.int32).contiguous()
    prod_id = prod[:, 0].to(torch.int32).contiguous()
    eq_rows, eq_found, _ = hash_join_ref(equip_id, *eq_table)
    q_rows, q_found, _ = hash_join_ref(prod_id, *q_table)
    found = eq_found & q_found
    eq_rows[:, 1].masked_fill_(~eq_found, -1.0)
    q_rows[:, 1].masked_fill_(~q_found, -1.0)
    return eq_rows, q_rows, found


def _prod(rng, n, eq_keys, q_keys):
    """[n, 8] production rows: hit keys, missing keys, fractional and
    negative keys (truncated toward zero), and -1 pad rows at the end."""
    prod = rng.normal(size=(n, 8)).astype(np.float32)
    prod[:, 1] = rng.choice(eq_keys, n)
    prod[:, 0] = rng.choice(q_keys, n)
    miss = rng.random(n) < 0.2
    prod[miss, 1] = rng.integers(2 * 10**6, 3 * 10**6, int(miss.sum()))
    miss = rng.random(n) < 0.2
    prod[miss, 0] = rng.integers(2 * 10**6, 3 * 10**6, int(miss.sum()))
    frac = rng.random(n) < 0.1
    prod[frac, 1] += np.float32(0.75)
    prod[:3, 0] = [-0.5, -1.0, -2.0]
    prod[-8:] = -1.0                                   # _pad_bucket's rows
    return torch.from_numpy(prod)


@pytest.mark.parametrize("eq_slots,q_slots,wrap", [
    (64, 1024, False), (32, 64, True), (8, 256, True), (12, 4, False)])
def test_hash_join_pair_bitwise_today_and_numpy(eq_slots, q_slots, wrap):
    """The pair probe gives the exact bits of the transform's old
    sequence, and its rows and found mask agree with the reference's
    numpy probe. Covers pad rows (key -1 hits an empty slot), misses,
    chains that wrap at the table end, and tables under 16 slots (full
    ones included, where every probe of an absent key runs out)."""
    rng = np.random.default_rng(eq_slots * q_slots)
    eq_table, eq_keys = _cache(rng, eq_slots, min(eq_slots, 20), wrap=wrap)
    q_table, q_keys = _cache(rng, q_slots, min(q_slots, 300), wrap=wrap)
    prod = _prod(rng, 256, eq_keys, q_keys)
    before = launch_counts()
    got = hj_ops.hash_join_pair(prod, eq_table, q_table)
    assert launch_counts() == before
    want = _today(prod, eq_table, q_table)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.numpy().tobytes() == w.numpy().tobytes()
    eq_rows, q_rows, found = (t.numpy() for t in got)
    p = prod.numpy()
    ev, ef, _ = ref_backend._hash_probe_np(
        p[:, 1].astype(np.int32), *(t.numpy() for t in eq_table))
    qv, qf, _ = ref_backend._hash_probe_np(
        p[:, 0].astype(np.int32), *(t.numpy() for t in q_table))
    np.testing.assert_array_equal(found, ef & qf)
    for rows, ref_rows, ref_found in ((eq_rows, ev, ef), (q_rows, qv, qf)):
        assert rows[ref_found].tobytes() == ref_rows[ref_found].tobytes()
        assert (rows[~ref_found][:, 1] == -1.0).all()
    assert found[-8:].all() == (
        (eq_table[0] == -1).any() and (q_table[0] == -1).any()).item()
    if wrap:                # a wrapped chain's key is found at slot 0 / 1
        k = int(eq_keys[1])
        assert eq_table[0][:2].tolist().count(k) == 1
        row = torch.tensor([[float(q_keys[0]), float(k)] + [0.0] * 6])
        assert bool(hj_ops.hash_join_pair(row, eq_table, q_table)[2][0])


def test_transform_uses_one_probe_dispatch():
    """The torch backend's transform on the CPU: one dispatch (the fused
    transform kernel: both probes, the facts, the rollup), facts bitwise
    the reference's numpy transform."""
    from repro.core.cache import InMemoryTable as RefTable
    from repro_torch.core.cache import InMemoryTable
    rng = np.random.default_rng(3)
    be = get_backend("torch", device=CPU)
    tables = []
    for n_keys in (20, 300):
        ref = RefTable(1024)
        ref.upsert(np.arange(n_keys),
                   np.abs(rng.normal(size=(n_keys, 8))).astype(np.float32),
                   np.arange(n_keys, dtype=np.int64))
        tables.append((ref, InMemoryTable.from_numpy(
            ref.keys, ref.values, ref.txn, ref.watermark, backend=be)))
    prod = np.abs(rng.normal(size=(200, 8))).astype(np.float32) * 10
    prod[:, 0] = rng.integers(0, 320, 200)
    prod[:, 1] = rng.integers(0, 24, 200)
    be.reset_stats()
    facts, found = be.transform(prod, tables[0][1], tables[1][1])
    assert be.op_dispatches == 1 and be.host_syncs == 1
    ref_facts, ref_found = ref_backend.NumpyBackend().transform(
        prod, tables[0][0], tables[1][0])
    assert facts.tobytes() == ref_facts.tobytes()
    np.testing.assert_array_equal(found, ref_found)
