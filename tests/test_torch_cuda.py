"""The port's CUDA kernels on a card: each against its plain PyTorch
version on the same tensors, the main path on the card against the same
path on the CPU, and the concurrent cluster and its recovery drill on the
card. Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. The file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.backend import get_backend
from repro_torch.core.cache import InMemoryTable
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.hash_join import ops as hj_ops
from repro_torch.kernels.hash_join.ref import hash_join_ref
from repro_torch.kernels.segment_kpi import ops as sk_ops
from repro_torch.kernels.segment_kpi import ref as sk_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> bytes:
    return t.cpu().numpy().tobytes()


@pytest.mark.parametrize("n_slots,n_keys,n_queries", [
    (4096, 2000, 1024), (256, 50, 64), (1024, 1000, 4097)])
def test_hash_join_bitwise(dev, n_slots, n_keys, n_queries):
    rng = np.random.default_rng(n_slots)
    tbl = InMemoryTable(n_slots, backend=get_backend("torch", device=dev))
    keys = rng.choice(10**6, n_keys, replace=False).astype(np.int64)
    tbl.upsert(keys, rng.normal(size=(n_keys, 8)).astype(np.float32),
               rng.integers(0, 2**40, n_keys))
    q = torch.tensor(np.concatenate([
        rng.choice(keys, n_queries // 2),
        rng.integers(2 * 10**6, 3 * 10**6, n_queries - n_queries // 2 - 2),
        [-1, -2]]), dtype=torch.int32, device=dev)
    before = launch_counts()["hash_join"]
    got = hj_ops.hash_join(q, *tbl.device_state())
    want = hash_join_ref(q, *tbl.device_state())
    assert launch_counts()["hash_join"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _bits(g) == _bits(w)


@pytest.mark.parametrize("n,units", [(1024, 20), (513, 32), (7, 3),
                                     (2048, 20), (2048, 1000)])
def test_segment_kpi(dev, n, units):
    rng = np.random.default_rng(n)
    prod = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    prod[:, 1] = rng.integers(-1, units + 1, n)
    prod[:, 4] = prod[:, 3] + np.abs(prod[:, 4]) + 0.1
    eq = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    eq[:, 1] = np.where(rng.random(n) < 0.1, -1.0, prod[:, 1])
    eq[:, 4] = eq[:, 3] + np.abs(eq[:, 4]) + 5
    eq[:, 5] = rng.random(n) > 0.3
    qr = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    qr[:, 1] = np.where(rng.random(n) < 0.1, -1.0, prod[:, 1])
    args = [torch.tensor(a, device=dev) for a in (prod, eq, qr)]
    facts, agg = sk_ops.segment_kpi(*args, n_units=units)
    ref_facts, ref_agg = sk_ref.segment_kpi_ref(*args, units)
    torch.testing.assert_close(facts, ref_facts, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(agg, ref_agg, rtol=1e-4, atol=1e-4)
    # the same op order as the numpy oracle and the same rollup order as
    # the plain version: bitwise on the card as well
    assert _bits(facts) == _bits(ref_facts)
    assert _bits(agg) == _bits(ref_agg)


STEELWORKS_VIEWS = ((20, 4), (60, 4), (20, 2), (32, 2))   # (S, L) each


def _fold_item(rng, n, S, L, special=None):
    seg = np.where(rng.random(n) < 0.1, -1, rng.integers(0, S, n))
    vals = rng.normal(size=(n, L)).astype(np.float32)
    vals[rng.random((n, L)) < 0.1] = 0.0
    vals[rng.random((n, L)) < 0.1] = -0.0
    if special is not None:
        vals[rng.random((n, L)) < 0.05] = special
    return seg, vals, S


def _fold_on_card(dev, items):
    """The kernel and its plain version on the same staged words on the
    card; the kernel launches once."""
    words, plan = sk_ops.stage_fold(items)
    wt = words.to(dev)
    before = launch_counts()["fold_segments_many"]
    got = sk_ops.fold_segments_many(wt, plan)
    assert launch_counts()["fold_segments_many"] == before + 1
    return got, sk_ref.fold_segments_many_ref(wt, plan)


@pytest.mark.parametrize("B", [256, 1024, 2048])
@pytest.mark.parametrize("deltas", [1, 3])
def test_fold_segments_bitwise(dev, B, deltas):
    """A fold cycle at the steelworks views' shapes: ``deltas`` deltas of
    about B rows, each folded into the four views, in one launch."""
    rng = np.random.default_rng(B * deltas)
    items = [_fold_item(rng, int(rng.integers(B // 2 + 1, B + 1)), S, L)
             for _ in range(deltas) for S, L in STEELWORKS_VIEWS]
    got, want = _fold_on_card(dev, items)
    assert _bits(got) == _bits(want)


@pytest.mark.parametrize("shape", ["rows_1_to_64", "several_blocks",
                                   "narrow", "nan", "inf", "lanes_5_to_9"])
def test_fold_segments_many_edges(dev, shape):
    """Edge shapes: every bucket below a warp (8, 16, 32 rows), items of
    several blocks, fewer segments than a CTA's chunk, NaN-only and
    +-inf-only lanes (the card's NaN bits are its own: kernel and plain
    version both compute them there), more lanes than one staging pass."""
    rng = np.random.default_rng(len(shape))
    items = {
        "rows_1_to_64": [_fold_item(rng, n, S, L) for n in (1, 7, 9, 16, 17,
                                                            33, 64)
                         for S, L in ((20, 4), (3, 1))],
        "several_blocks": [_fold_item(rng, n, 60, 4)
                           for n in (2049, 4096, 5000)],
        "narrow": [_fold_item(rng, 100, S, 2) for S in (1, 2, 3, 5)],
        "nan": [_fold_item(rng, 1000, S, L, np.nan)
                for S, L in STEELWORKS_VIEWS],
        "inf": [_fold_item(rng, 1000, S, L, np.inf)
                for S, L in STEELWORKS_VIEWS],
        "lanes_5_to_9": [_fold_item(rng, 700, 20, L) for L in (5, 8, 9)],
    }[shape]
    got, want = _fold_on_card(dev, items)
    assert _bits(got) == _bits(want)


def _open_table(rng, dev, n_slots, keys):
    """(keys, vals, txn) on the card with ``keys`` placed by linear
    probing from their lowbias32 home slot."""
    from repro_torch.kernels.hash_join.ref import hash32
    tk = np.full(n_slots, -1, np.int32)
    tv = np.zeros((n_slots, 8), np.float32)
    home = hash32(torch.tensor(keys, dtype=torch.int32)).numpy() % n_slots
    for key, h in zip(keys, home):
        for p in range(n_slots):
            s = (h + p) % n_slots
            if tk[s] == -1:
                tk[s], tv[s] = key, rng.normal(size=8)
                break
    return (torch.tensor(tk, device=dev), torch.tensor(tv, device=dev),
            torch.zeros(n_slots, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("eq_slots,eq_keys,q_slots,q_keys", [
    (64, 20, 4096, 2000), (1024, 1000, 8192, 8000), (8, 8, 12, 5),
    (16, 3, 16, 16)])
def test_hash_join_pair_bitwise(dev, eq_slots, eq_keys, q_slots, q_keys):
    """Both probes of a transform against the plain version's sequence:
    hits, misses, fractional and negative keys, -1 pad rows, chains that
    wrap at the table end, tables under 16 slots, full tables."""
    rng = np.random.default_rng(eq_slots + q_keys)
    ek = rng.choice(10**6, eq_keys, replace=False).astype(np.int32)
    qk = rng.choice(10**6, q_keys, replace=False).astype(np.int32)
    eq_t, q_t = _open_table(rng, dev, eq_slots, ek), \
        _open_table(rng, dev, q_slots, qk)
    n = 1024
    prod = rng.normal(size=(n, 8)).astype(np.float32)
    prod[:, 1] = rng.choice(ek, n)
    prod[:, 0] = rng.choice(qk, n)
    prod[rng.random(n) < 0.2, 1] = 2.5e6
    prod[rng.random(n) < 0.2, 0] = -3.0e6
    prod[rng.random(n) < 0.1, 1] += 0.75
    prod[:4, 0] = [-0.5, -1.0, -2.0, 0.9]
    prod[-64:] = -1.0
    pt = torch.tensor(prod, device=dev)
    before = launch_counts()["hash_join_pair"]
    got = hj_ops.hash_join_pair(pt, eq_t, q_t)
    assert launch_counts()["hash_join_pair"] == before + 1
    want = hj_ops.hash_join_pair_ref(pt, eq_t, q_t)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _bits(g) == _bits(w)


def _special_table(rng, dev, n_slots, n_keys, key_hi=10**6):
    """A card table of ``n_keys`` keys (0, INT32_MAX and INT32_MIN among
    them, so that NaN, +-inf and +-3e9 keys hit after the cast; the rest
    from [1, key_hi)) placed by linear probing; with n_keys near n_slots
    the chains wrap."""
    keys = np.concatenate([[0, 2**31 - 1, -2**31], rng.choice(
        np.arange(1, key_hi), n_keys - 3, replace=False)]).astype(np.int32)
    return _open_table(rng, dev, n_slots, keys), keys


@pytest.mark.parametrize("n_blocks", [1, 2, 4, 8])
@pytest.mark.parametrize("units", [20, 1000])
@pytest.mark.parametrize("slots", [(64, 4096), (8, 12)])
def test_transform_kpi_bitwise(dev, n_blocks, units, slots):
    """The one-launch transform against its plain version (the pair probe,
    then the KPI kernel's plain version): NaN, +-inf and +-3e9 keys, pad
    rows, misses, fractional keys, chains that wrap at the table end,
    tables under 16 slots, 1 to 8 blocks; equipment keys (the rows' units)
    half in [0, units), at 20 units and at 1000 (the rollup's unit
    chunks)."""
    rng = np.random.default_rng(n_blocks * slots[0] + units)
    eq_t, ek = _special_table(rng, dev, slots[0], min(20, slots[0]),
                              key_hi=2 * units)
    q_t, qk = _special_table(rng, dev, slots[1], min(2000, slots[1] - 1))
    n = 256 * n_blocks
    prod = np.abs(rng.normal(size=(n, 8))).astype(np.float32) * 10
    prod[:, 1] = rng.choice(ek, n)
    prod[:, 0] = rng.choice(qk, n)
    prod[rng.random(n) < 0.2, 1] = 2.5e6
    prod[rng.random(n) < 0.2, 0] = -3.0e6
    prod[rng.random(n) < 0.1, 1] += 0.75
    special = np.float32([np.nan, np.inf, -np.inf, 3e9, -3e9])
    prod[:5, 1] = special
    prod[5:10, 0] = special
    prod[n - n // 8:] = -1.0                     # _pad_bucket's rows
    pt = torch.tensor(prod, device=dev)
    before = launch_counts()["transform_kpi"]
    got = sk_ops.transform_kpi(pt, eq_t, q_t, n_units=units)
    assert launch_counts()["transform_kpi"] == before + 1
    want = sk_ref.transform_kpi_ref(pt, eq_t, q_t, units)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _bits(g) == _bits(w)
    again = sk_ops.transform_kpi(pt, eq_t, q_t, n_units=units)
    assert all(_bits(g) == _bits(a) for g, a in zip(got, again))


def test_upload_stages_through_pinned_memory(dev):
    """``backend.upload`` copies into pinned memory and returns at once:
    the source array may change right after the call, the card still gets
    the values it had."""
    from repro_torch.core.backend import upload
    for arr in (np.arange(10**6, dtype=np.float32),
                np.arange(4096, dtype=np.int32),
                np.arange(12, dtype=np.int64).reshape(3, 4)):
        want = arr.copy()
        t = upload(arr, dev)
        arr += 1
        assert t.device.type == "cuda" and t.dtype == torch.from_numpy(
            want).dtype
        assert _bits(t) == want.tobytes()


@pytest.mark.parametrize("n", [1, 512, 4096])
def test_gather_stats_bitwise(dev, n):
    rng = np.random.default_rng(n)
    table = rng.normal(size=(20, 13)).astype(np.float32)
    table[:, 0] = rng.integers(0, 9, 20)
    table[:3, 0] = 0.0                           # empty: NaN means
    tt = torch.tensor(table, device=dev)
    it = torch.tensor(rng.integers(0, 20, n), device=dev)
    assert _bits(sk_ops.gather_stats(tt, it)) == \
        _bits(sk_ref.gather_stats_ref(tt, it))


def _gather_items(rng, shapes):
    """(table, ids) items with empty segments (NaN means), a -0.0 sum and
    +-inf min/max identities."""
    items = []
    for S, L, n in shapes:
        table = rng.normal(size=(S, 1 + 3 * L)).astype(np.float32)
        table[:, 0] = rng.integers(0, 9, S)
        table[:S // 3 + 1, 0] = 0.0
        table[0, 1 + L:] = np.concatenate([np.full(L, np.inf),
                                           np.full(L, -np.inf)])
        table[-1, 0], table[-1, 1] = 2.0, -0.0
        items.append((table, rng.integers(0, S, n)))
    return items


@pytest.mark.parametrize("shapes", [
    [(20, 4, 400)],                                    # the dashboard's
    [(20, 4, 100), (20, 4, 120), (20, 4, 80), (20, 4, 100)],   # 4 shards
    [(20, 4, 37), (60, 4, 300), (20, 2, 1), (32, 2, 129)],     # the views
    [(20, 4, 1)], [(20, 4, 4096)], [(5, 9, 0), (1, 1, 1)],
    [(3000, 3, 500), (20, 4, 3)],     # a table past the shared memory
])
def test_gather_stats_many_bitwise(dev, shapes):
    """One launch answers every item of a batch, bitwise the plain
    version item by item (and the one-item wrapper), and the backend's
    batched call is one dispatch and one sync, bitwise the CPU's."""
    rng = np.random.default_rng(len(shapes) * 7 + shapes[0][2])
    items = _gather_items(rng, shapes)
    words, plan = sk_ops.stage_gather(items)
    wt = torch.from_numpy(words).to(dev)
    before = launch_counts()["gather_stats_many"]
    got = sk_ops.gather_tables(sk_ops.gather_stats_many(wt, plan), plan)
    assert launch_counts()["gather_stats_many"] == \
        before + int(plan.n_ctas > 0)
    want = sk_ops.gather_tables(sk_ref.gather_stats_many_ref(wt, plan), plan)
    for (table, ids), g, w in zip(items, got, want):
        assert _bits(g) == _bits(w)
        if len(ids):
            assert _bits(sk_ops.gather_stats(
                torch.tensor(table, device=dev),
                torch.tensor(ids, device=dev))) == _bits(g)
    gpu, cpu = get_backend("torch", device=dev), get_backend("torch",
                                                             device="cpu")
    gpu.reset_stats()
    for a, b in zip(gpu.batch_gather_stats_many(items),
                    cpu.batch_gather_stats_many(items)):
        assert a.tobytes() == b.tobytes()
    assert (gpu.op_dispatches, gpu.host_syncs) == (1, 1)


def test_sharded_plane_on_card(dev):
    """The 4-shard engine on one card: each fold cycle is one
    fold_segments_many launch and each query batch one gather_stats_many
    launch, whatever the shard count; tables and answers bitwise the
    unsharded card engine's and the CPU sharded engine's on the same
    deltas; a mesh on the card is taken, one on another device refused."""
    from repro_torch.launch.mesh import make_shard_mesh
    from repro_torch.runtime.shard_plane import ShardedViewEngine
    from repro_torch.serving import (MaterializedViewEngine, ReportQuery,
                                     ReportServer, compile_queries,
                                     steelworks_views)
    rng = np.random.default_rng(4)
    specs = steelworks_views(20)
    gpu = get_backend("torch", device=dev)
    eng = ShardedViewEngine(specs, n_shards=4, backend=gpu)
    plain = MaterializedViewEngine(specs, backend=gpu)
    cpu = ShardedViewEngine(specs, n_shards=4,
                            backend=get_backend("torch", device="cpu"))
    gpu.set_mesh(make_shard_mesh(4))
    try:
        assert eng.mesh_report()["device_mesh"]
        for cycle in range(5):
            for _ in range(cycle % 3 + 1):
                n = int(rng.integers(1, 2500))
                f = np.zeros((n, 10), np.float32)
                f[:, 0] = rng.integers(0, 20, n)
                f[:, 1] = rng.uniform(0, 10000, n)
                f[:, 2] = f[:, 1] + rng.uniform(1, 50, n)
                f[:, 3:7] = rng.uniform(0, 1, (n, 4))
                f[:, 7] = rng.uniform(0, 40, n)
                f[:, 8] = rng.uniform(0, 10, n)
                f[:, 9] = (rng.uniform(0, 1, n) > 0.1).astype(np.float32)
                for e in (eng, plain, cpu):
                    e.publish(f)
            reset_launch_counts()
            eng.fold_pending()
            assert launch_counts()["fold_segments_many"] == 1
            plain.fold_pending()
            cpu.fold_pending()
        queries = [ReportQuery("oee", unit=u % 20) for u in range(400)] + [
            ReportQuery("top_downtime", k=3), ReportQuery("shift_report")]
        plan = compile_queries(queries)
        reset_launch_counts()
        got = plan.execute(ReportServer(eng).snapshot()).reports()
        assert launch_counts()["gather_stats_many"] == 1
        want = plan.execute(ReportServer(plain).snapshot()).reports()
        for a, b in zip(got, want):
            assert a.data.keys() == b.data.keys()
            for k in a.data:
                assert np.asarray(a.data[k]).tobytes() == \
                    np.asarray(b.data[k]).tobytes()
        for spec in specs:
            table = plain.snapshot().view(spec.name).table.tobytes()
            assert eng.snapshot().view(spec.name).table.tobytes() == table
            assert eng.tree_reduced_table(spec.name).tobytes() == table
            assert cpu.snapshot().view(spec.name).table.tobytes() == table
    finally:
        gpu.set_mesh(None)
    with pytest.raises(ValueError):
        gpu.set_mesh(make_shard_mesh(2, [dev, "cpu"]))


def test_wrappers_check_their_inputs(dev):
    keys = torch.full((16,), -1, dtype=torch.int32, device=dev)
    vals = torch.zeros((16, 8), device=dev)
    q = torch.zeros(4, dtype=torch.int64, device=dev)          # not int32
    with pytest.raises(TypeError):
        hj_ops.hash_join(q, keys, vals, keys)
    words, plan = sk_ops.stage_fold([(np.zeros(12, np.int64),
                                      np.zeros((12, 2), np.float32), 4)])
    with pytest.raises(ValueError):                           # not its plan
        sk_ops.fold_segments_many(words[:-4].to(dev), plan)
    with pytest.raises(TypeError):                            # int prod
        hj_ops.hash_join_pair(torch.zeros((4, 8), dtype=torch.int32,
                                          device=dev),
                              (keys, vals, keys), (keys, vals, keys))
    with pytest.raises(ValueError):                           # mixed devices
        sk_ops.segment_kpi(torch.zeros((4, 8), device=dev),
                           torch.zeros((4, 8)), torch.zeros((4, 8)),
                           n_units=2)
    with pytest.raises(TypeError):                            # int prod
        sk_ops.transform_kpi(torch.zeros((4, 8), dtype=torch.int32,
                                         device=dev),
                             (keys, vals, keys), (keys, vals, keys),
                             n_units=2)
    with pytest.raises(ValueError):                           # no units
        sk_ops.segment_rollup(torch.zeros((4, 10), device=dev), 0)
    words, plan = sk_ops.stage_gather([(np.zeros((4, 7), np.float32),
                                        np.arange(4))])
    with pytest.raises(TypeError):                            # not int32
        sk_ops.gather_stats_many(torch.from_numpy(words).float().to(dev),
                                 plan)
    with pytest.raises(ValueError):                           # not its plan
        sk_ops.gather_stats_many(torch.from_numpy(words[:-4]).to(dev), plan)


def test_backend_ops_on_card_match_cpu(dev):
    """The backend ops around the kernels — the structural scans (plain
    torch on the device), the host-convenience probe and the transform
    with hop probes — give the CPU run's bytes on the card."""
    rng = np.random.default_rng(21)
    gpu, cpu = get_backend("torch", device=dev), get_backend("torch",
                                                             device="cpu")
    seg = rng.integers(-1, 40, 3000)
    vals = rng.normal(size=(3000, 3)).astype(np.float32)
    for op in ("fold_segments", "fold_segments_scan"):
        assert getattr(gpu, op)(seg, vals, 37).tobytes() == \
            getattr(cpu, op)(seg, vals, 37).tobytes()
    items = [(seg[:n], vals[:n, :L], S)
             for n, S, L in ((3000, 37, 3), (0, 5, 1), (100, 60, 2))]
    gpu.reset_stats()
    many = gpu.fold_segments_many(items)
    assert (gpu.op_dispatches, gpu.host_syncs) == (1, 1)
    for a, b in zip(many, cpu.fold_segments_many(items)):
        assert a.tobytes() == b.tobytes()
    table = cpu.fold_segments(seg, vals, 37)
    assert gpu.prefix_fold(table).tobytes() == cpu.prefix_fold(table).tobytes()

    tables = {}
    for be in (gpu, cpu):
        eq = InMemoryTable(256, backend=be)
        eqp = np.zeros((8, 8), np.float32)
        eqp[:, 1] = np.arange(8)
        eqp[:, 4], eqp[:, 5], eqp[:, 6], eqp[:, 7] = 100.0, 1.0, 5.0, 50.0
        eq.upsert(np.arange(8), eqp, np.arange(8))
        qu = InMemoryTable(1024, backend=be)
        qp = np.zeros((300, 8), np.float32)
        qp[:, 3] = np.arange(300)
        qu.upsert(np.arange(300), qp, np.arange(300))
        tables[be] = (eq, qu)
    prod = np.zeros((700, 8), np.float32)
    prod[:, 0] = rng.integers(0, 320, 700)
    prod[:, 1] = rng.integers(0, 10, 700)
    prod[:, 4] = rng.uniform(1, 30, 700)
    prod[:, 5] = rng.uniform(1, 100, 700)
    out = {}
    for be in (gpu, cpu):
        block = be.transform_block(prod, *tables[be], join_depth=3,
                                   n_units=8)
        facts, found = block.start_host_copy().to_host()
        snap = tables[be][0].snapshot_view(True)
        out[be] = (facts, found, block.rollup_host(),
                   *snap.lookup(np.arange(-2, 12)))
    for a, b in zip(out[gpu], out[cpu]):
        assert a.tobytes() == b.tobytes()


def _rescan_facts(rng, n, units):
    f = rng.random((n, 10), dtype=np.float32)
    f[:, 0] = rng.integers(-3, units + 3, n) + rng.choice(
        np.float32([0.0, 0.5, -0.5]), n)
    f[:, 9] = (rng.random(n) > 0.2).astype(np.float32)
    f[rng.random(n) < 0.01, 0] = np.nan          # counts nowhere
    return f


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4096, 20000, 1 << 20])
@pytest.mark.parametrize("units", [20, 32])
def test_segment_rollup_bitwise(dev, n, units):
    t = torch.tensor(_rescan_facts(np.random.default_rng(n), n, units),
                     device=dev)
    before = launch_counts()["segment_rollup"]
    got = sk_ops.segment_rollup(t, units)
    assert launch_counts()["segment_rollup"] == before + 1
    assert _bits(got) == _bits(sk_ref.segment_rollup_ref(t, units))


@pytest.mark.parametrize("n", [1, 255, 257, 20000])
@pytest.mark.parametrize("units", [256, 257, 1000])
def test_segment_rollup_bitwise_many_units(dev, n, units):
    """More units than one rollup pass holds (256): the kernel walks them
    in chunks, each unit's rows still added in row order."""
    t = torch.tensor(_rescan_facts(np.random.default_rng(n + units), n,
                                   units), device=dev)
    assert _bits(sk_ops.segment_rollup(t, units)) == \
        _bits(sk_ref.segment_rollup_ref(t, units))


@pytest.mark.parametrize("n", [1, 255, 257, 20000, 1 << 20])
def test_segment_rollup_bitwise_sorted_and_unaligned(dev, n):
    """The rescan on rows sorted by unit (the warehouse's order: whole
    blocks of one unit), on a 16-byte aligned table and on a view 40 bytes
    in (the 4-byte staging path)."""
    f = torch.tensor(_rescan_facts(np.random.default_rng(n), n + 1, 20),
                     device=dev)
    for t in (f[:n], f[1:], f[f[:, 0].argsort()].contiguous()):
        assert _bits(sk_ops.segment_rollup(t, 20)) == \
            _bits(sk_ref.segment_rollup_ref(t, 20))


def test_segment_reduce_on_card(dev):
    """The warehouse rescan on the card: one launch, one sync, the CPU
    run's bytes."""
    facts = _rescan_facts(np.random.default_rng(3), 5000, 20)
    gpu = get_backend("torch", device=dev)
    gpu.reset_stats()
    got = gpu.segment_reduce(facts, 20)
    assert gpu.op_dispatches == 1 and gpu.host_syncs == 1
    assert got.tobytes() == get_backend("torch", device="cpu").segment_reduce(
        facts, 20).tobytes()


def _run(device):
    from repro_torch.configs.dod_etl import steelworks_config
    from repro_torch.core import DODETLPipeline, SourceDatabase
    from repro_torch.data.sampler import SamplerConfig, SteelworksSampler
    from repro_torch.serving import (MaterializedViewEngine, ReportQuery,
                                     ReportSnapshot, compile_queries,
                                     steelworks_views)
    cfg = steelworks_config(n_partitions=4)
    src = SourceDatabase()
    SteelworksSampler(cfg, SamplerConfig(records_per_table=2000,
                                         n_equipment=4, late_master_frac=0.1,
                                         seed=0)).generate(src)
    pipe = DODETLPipeline(cfg, src, n_workers=2, device=device)
    engine = MaterializedViewEngine(steelworks_views(4), backend=pipe.backend)
    pipe.warehouse.attach_serving(engine)
    pipe.extract()
    pipe.bootstrap_caches()
    for _ in range(500):
        n = pipe.step(50)
        engine.fold_pending()
        if n == 0 and not sum(len(w.buffer) for w in pipe.workers):
            break
    queries = [ReportQuery("oee", unit=u % 4) for u in range(50)]
    queries += [ReportQuery("top_downtime", k=3), ReportQuery("shift_report")]
    reports = compile_queries(queries).execute(
        ReportSnapshot(engine.snapshot(), engine.backend)).reports()
    return pipe, engine, reports


def test_main_path_on_card_matches_cpu(dev):
    gpu_pipe, gpu_engine, gpu_reports = _run("cuda")
    cpu_pipe, cpu_engine, cpu_reports = _run("cpu")
    gw, cw = gpu_pipe.warehouse, cpu_pipe.warehouse
    assert gw.rows_loaded == cw.rows_loaded == 2000
    assert gw.canonical_fact_table().tobytes() == \
        cw.canonical_fact_table().tobytes()
    assert gw.kpi_running().tobytes() == cw.kpi_running().tobytes()
    for name, st in cpu_engine.snapshot().states.items():
        assert gpu_engine.snapshot().states[name].table.tobytes() == \
            st.table.tobytes()
    for a, b in zip(gpu_reports, cpu_reports):
        assert a.data.keys() == b.data.keys()
        for k in a.data:
            if isinstance(a.data[k], tuple):
                assert a.data[k] == b.data[k]
            else:
                np.testing.assert_array_equal(a.data[k], b.data[k])


# ------------------------------------------------------------ the cluster
def _cluster_pipe(device, n=3000, n_workers=4, fault=None):
    from repro_torch.configs.dod_etl import steelworks_config
    from repro_torch.core import DODETLPipeline, SourceDatabase
    from repro_torch.data.sampler import SamplerConfig, SteelworksSampler
    cfg = steelworks_config(n_partitions=8)
    cfg = dataclasses.replace(cfg, buffer_capacity=4096)
    src = SourceDatabase()
    SteelworksSampler(cfg, SamplerConfig(records_per_table=n, n_equipment=8,
                                         late_master_frac=0.05,
                                         seed=0)).generate(src)
    pipe = DODETLPipeline(cfg, src, n_workers=n_workers, device=device,
                          fault=fault)
    pipe.extract()
    return cfg, src, pipe


def _sequential_facts(device, n=3000):
    _, _, pipe = _cluster_pipe(device, n, n_workers=1)
    pipe.bootstrap_caches()
    pipe.run_to_completion()
    return pipe.warehouse.canonical_fact_table().tobytes()


def test_cluster_on_card_byte_identical_to_sequential(dev):
    from repro_torch.runtime.cluster import ConcurrentCluster
    _, _, pipe = _cluster_pipe("cuda")
    cluster = ConcurrentCluster(pipe, poll_cdc=False,
                                max_records_per_partition=100)
    cluster.start()
    done = cluster.run_until_idle(timeout=120)
    cluster.stop_all()
    assert done == 3000 == pipe.warehouse.rows_loaded
    facts = pipe.warehouse.canonical_fact_table().tobytes()
    assert facts == _sequential_facts("cuda") == _sequential_facts("cpu")


def test_each_worker_has_its_own_stream(dev):
    from repro_torch.runtime.cluster import ConcurrentCluster
    _, _, pipe = _cluster_pipe("cuda", n=200)
    cluster = ConcurrentCluster(pipe, poll_cdc=False)
    streams = [rt.stream for rt in cluster.runtimes.values()]
    default = torch.cuda.default_stream(dev)
    assert all(isinstance(s, torch.cuda.Stream) for s in streams)
    assert all(s != default for s in streams)
    assert len({s.cuda_stream for s in streams}) == len(streams)


def test_cluster_launch_counts_match_transforms(dev):
    """The launch counters are exact under concurrent stage threads: one
    transform_kpi launch per transform_block call the workers made, and
    no pair probe, KPI kernel or single-table probe of their own
    (join_depth 1, no poison records)."""
    from repro_torch.runtime.cluster import ConcurrentCluster
    _, _, pipe = _cluster_pipe("cuda")
    lock = threading.Lock()
    calls = [0]
    for w in pipe.workers:
        orig = w.transformer.transform_block

        def counted(*a, _orig=orig, **k):
            block = _orig(*a, **k)
            with lock:
                calls[0] += 1
            return block
        w.transformer.transform_block = counted
    cluster = ConcurrentCluster(pipe, poll_cdc=False,
                                max_records_per_partition=25)
    reset_launch_counts()
    cluster.start()
    assert cluster.run_until_idle(timeout=120) == 3000
    cluster.stop_all()
    counts = launch_counts()
    assert calls[0] > 20
    assert counts["transform_kpi"] == calls[0]
    assert counts["segment_kpi"] == counts["hash_join_pair"] == 0
    assert counts["hash_join"] == 0


def _wait_for(predicate, timeout=60.0):
    import time
    t0 = time.perf_counter()
    while not predicate():
        if time.perf_counter() - t0 > timeout:
            return False
        time.sleep(0.001)
    return True


def test_commit_post_recovery_drill_on_card(dev, tmp_path):
    from repro_torch.durability import (DurabilityJournal, FaultInjector,
                                        RecoveryCoordinator,
                                        recover_pipeline)
    from repro_torch.durability.faults import COMMIT_POST
    from repro_torch.runtime.cluster import ConcurrentCluster
    # the crash is armed once a step holding loaded chunks is journaled
    # (a capture still waiting for its locks at the crash journals
    # nothing), and comes 10 loads later: mid-stream
    fault = FaultInjector({})
    cfg, src, pipe = _cluster_pipe("cuda", n_workers=3, fault=fault)
    cluster = ConcurrentCluster(
        pipe, max_records_per_partition=25, poll_cdc=False,
        recovery=RecoveryCoordinator(DurabilityJournal(str(tmp_path))),
        checkpoint_every_s=0.02)
    cluster.checkpoint()
    cluster.start()
    assert _wait_for(lambda: pipe.warehouse.rows_loaded >= 300)
    assert cluster.checkpoint() is not None
    fault.schedule[COMMIT_POST] = 10
    assert fault.tripped.wait(60.0)
    cluster.abandon()
    pipe2, coord2, info = recover_pipeline(
        cfg, src, DurabilityJournal(str(tmp_path)), device="cuda")
    assert info is not None and info["commit_seq"] > 0
    cluster2 = ConcurrentCluster(pipe2, max_records_per_partition=25,
                                 poll_cdc=False, recovery=coord2,
                                 checkpoint_every_s=0.02)
    cluster2.start()
    cluster2.run_until_idle(timeout=120)
    cluster2.stop_all()
    assert pipe2.warehouse.rows_loaded == 3000
    assert pipe2.warehouse.canonical_fact_table().tobytes() == \
        _sequential_facts("cuda")
    facts = torch.tensor(pipe2.warehouse.fact_table(), device=dev)
    assert _bits(sk_ops.segment_rollup(facts, 8)) == \
        _bits(sk_ref.segment_rollup_ref(facts, 8))


# ---------------------------------------------------------------- LM path
# flash_attention and gla_chunk against their plain versions on the card,
# at the tolerances of tests/test_kernels.py (flash 2e-5 in f32, 2e-2 in
# bf16; gla 2e-4): the kernels add in another order than the plain
# versions' cuBLAS products, and bf16 outputs round once more.

def _lm_rand(rng, shape, dev, dtype=torch.float32):
    return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                        device=dev).to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("s,causal", [(256, True), (77, True), (200, False)])
def test_flash_attention_matches_plain(dev, dtype, tol, d, group, s,
                                       causal):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rng = np.random.default_rng(d + s + group)
    b, hkv = 2, 2
    q = _lm_rand(rng, (b, hkv * group, s, d), dev, dtype)
    k = _lm_rand(rng, (b, hkv, s, d), dev, dtype)
    v = _lm_rand(rng, (b, hkv, s, d), dev, dtype)
    before = launch_counts()["flash_attention"]
    got = fa.mha(q, k, v, causal=causal)
    assert launch_counts()["flash_attention"] == before + 1
    want = attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_reads_the_model_layout(dev):
    """Transposed [B, S, H, D] views in, the output in that layout out,
    equal to the kernel on contiguous copies."""
    from repro_torch.kernels.flash_attention import ops as fa
    rng = np.random.default_rng(5)
    q, k, v = (_lm_rand(rng, (2, 300, h, 128), dev, torch.bfloat16)
               for h in (16, 8, 8))
    got = fa.mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert got.transpose(1, 2).is_contiguous()
    want = fa.mha(*(t.transpose(1, 2).contiguous() for t in (q, k, v)))
    assert _bits(got.contiguous().float()) == _bits(want.float())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("s,causal", [(256, True), (77, True), (200, False),
                                      (300, True), (1000, False)])
def test_flash_attention_tc_matches_plain(dev, d, group, s, causal):
    """bf16 on the tensor-core design (wgmma + TMA) within 2e-2 of the
    plain version; S = 300 and 1000 run past one 128-query TMA box into
    ragged query and key tiles."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rng = np.random.default_rng(d + s + group + 1)
    b, hkv = 2, 2
    q = _lm_rand(rng, (b, hkv * group, s, d), dev, torch.bfloat16)
    k = _lm_rand(rng, (b, hkv, s, d), dev, torch.bfloat16)
    v = _lm_rand(rng, (b, hkv, s, d), dev, torch.bfloat16)
    before = launch_counts()
    got = fa.mha(q, k, v, causal=causal)
    after = launch_counts()
    assert after["flash_attention_tc"] == before["flash_attention_tc"] + 1
    assert after["flash_attention"] == before["flash_attention"] + 1
    want = attention_ref(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("d,group", [(64, 1), (128, 2)])
def test_flash_attention_tc_reads_the_model_layout(dev, d, group):
    """The tensor-core design on transposed [B, S, H, D] views (4-D tensor
    maps, the head by coordinate) equals it on contiguous copies."""
    from repro_torch.kernels.flash_attention import ops as fa
    rng = np.random.default_rng(d)
    q, k, v = (_lm_rand(rng, (2, 333, h, d), dev, torch.bfloat16)
               for h in (4 * group, 4, 4))
    before = launch_counts()["flash_attention_tc"]
    got = fa.mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    want = fa.mha(*(t.transpose(1, 2).contiguous() for t in (q, k, v)))
    assert launch_counts()["flash_attention_tc"] == before + 2
    assert got.transpose(1, 2).is_contiguous()
    assert _bits(got.contiguous().float()) == _bits(want.float())


@pytest.mark.parametrize("dtype,d,offset,tc", [
    (torch.bfloat16, 128, 0, True), (torch.bfloat16, 64, 0, True),
    (torch.float32, 128, 0, False), (torch.float32, 64, 0, False),
    (torch.bfloat16, 32, 0, False), (torch.bfloat16, 16, 0, False),
    (torch.bfloat16, 64, 1, False)])
def test_flash_attention_routes_to_a_kernel(dev, dtype, d, offset, tc):
    """bf16 at head_dim 64/128 launches the tensor-core design; f32, head
    dims 16/32 and views TMA cannot address (a 2-byte offset) launch the
    f32 design; none runs the plain version on the card."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rng = np.random.default_rng(d + offset)
    q, k, v = (_lm_rand(rng, (1, 2, 130, d + 8), dev, dtype)
               [..., offset:offset + d] for _ in range(3))
    before = launch_counts()
    got = fa.mha(q, k, v)
    after = launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert (after["flash_attention_tc"] - before["flash_attention_tc"]
            == int(tc))
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), attention_ref(q, k, v).float(),
                               rtol=tol, atol=tol)


def _gla_inputs(rng, dev, b, s, h, dk, dv, *, mamba=False,
                dtype=torch.float32):
    """q, k, v in ``dtype`` (cast before any broadcast, so Mamba2's views
    keep their zero strides) and an f32 log-decay."""
    if mamba:          # q, k shared over heads; one decay per head
        q = _lm_rand(rng, (b, s, 1, dk), dev, dtype).expand(b, s, h, dk)
        k = _lm_rand(rng, (b, s, 1, dk), dev, dtype).expand(b, s, h, dk)
        lw = (-torch.exp(_lm_rand(rng, (b, s, h, 1), dev))).expand(b, s, h,
                                                                   dk)
    else:
        q = _lm_rand(rng, (b, s, h, dk), dev, dtype)
        k = _lm_rand(rng, (b, s, h, dk), dev, dtype)
        lw = -torch.exp(_lm_rand(rng, (b, s, h, dk), dev))
    return q, k, _lm_rand(rng, (b, s, h, dv), dev, dtype), lw


@pytest.mark.parametrize("s", [256, 130])
@pytest.mark.parametrize("inclusive,use_u,mamba", [
    (False, True, False), (True, False, False), (True, False, True)])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dk,dv", [(64, 64), (32, 128), (16, 32)])
def test_gla_chunk_matches_plain(dev, s, inclusive, use_u, mamba,
                                 with_state, dk, dv):
    from repro_torch.kernels.gla_chunk import ops as gl
    from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref
    rng = np.random.default_rng(s + dk + dv)
    b, h = 2, 3
    q, k, v, lw = _gla_inputs(rng, dev, b, s, h, dk, dv, mamba=mamba)
    if mamba:                           # the model's zero-stride views
        assert q.stride(2) == k.stride(2) == lw.stride(3) == 0
    u = _lm_rand(rng, (h, dk), dev) if use_u else None
    s0 = _lm_rand(rng, (b, h, dk, dv), dev) if with_state else None
    before = launch_counts()["gla_chunk"]
    out, final = gl.gla(q, k, v, lw, u, inclusive=inclusive,
                        initial_state=s0)
    assert launch_counts()["gla_chunk"] == before + 1
    ref_out, ref_final = gla_chunk_ref(q, k, v, lw, u, inclusive=inclusive,
                                       initial_state=s0)
    torch.testing.assert_close(out, ref_out, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(final, ref_final, rtol=2e-4, atol=2e-4)


def test_gla_chunk_bf16_inputs(dev):
    """bf16 q, k, v (the model's dtype), f32 decay and state: the kernel
    reads the same bf16 values as the plain version and rounds its output
    to bf16 once (2e-2, the bf16 tolerance)."""
    from repro_torch.kernels.gla_chunk import ops as gl
    from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref
    rng = np.random.default_rng(9)
    q, k, v, lw = _gla_inputs(rng, dev, 2, 200, 4, 64, 64, mamba=True)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    out, final = gl.gla(q, k, v, lw, inclusive=True)
    ref_out, ref_final = gla_chunk_ref(q, k, v, lw, inclusive=True)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(final, ref_final, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s", [256, 130, 2048])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("h,dk,dv", [(8, 64, 64), (6, 32, 128), (3, 16, 32)])
def test_gla_chunk_ssd_matches_plain(dev, s, with_state, h, dk, dv):
    """bf16 Mamba2 inputs as the model passes them (zero-stride q, k and
    decay) on the chunk-parallel SSD design: out within 2e-2 (bf16), the
    final state within 2e-4 of the plain version."""
    from repro_torch.kernels.gla_chunk import ops as gl
    from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref
    rng = np.random.default_rng(s + dk + dv + h)
    q, k, v, lw = _gla_inputs(rng, dev, 2, s, h, dk, dv, mamba=True,
                              dtype=torch.bfloat16)
    assert q.stride(2) == k.stride(2) == lw.stride(3) == 0
    s0 = _lm_rand(rng, (2, h, dk, dv), dev) if with_state else None
    before = launch_counts()
    out, final = gl.gla(q, k, v, lw, inclusive=True, initial_state=s0)
    after = launch_counts()
    assert after["gla_chunk"] == before["gla_chunk"] + 1
    assert after["gla_chunk_ssd"] == before["gla_chunk_ssd"] + 1
    ref_out, ref_final = gla_chunk_ref(q, k, v, lw, inclusive=True,
                                       initial_state=s0)
    assert out.dtype == torch.bfloat16 and out.shape == ref_out.shape
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(final, ref_final, rtol=2e-4, atol=2e-4)


def _rwkv6_inputs(rng, dev, b, s, h, dk, dv):
    """rwkv6's regime as its time mix hands it over: bf16 r, k, v, an f32
    per-channel log decay -exp(clip(x, -8, 4)) with its first 4 channels
    at the clip's -e^4 (a chunk's cumulative decay near -3,500), and the
    f32 bonus u."""
    r, k = (_lm_rand(rng, (b, s, h, dk), dev, torch.bfloat16)
            for _ in range(2))
    v = _lm_rand(rng, (b, s, h, dv), dev, torch.bfloat16)
    x = _lm_rand(rng, (b, s, h, dk), dev) * 3
    x[..., :4] = 4.0
    return r, k, v, -torch.exp(torch.clamp(x, -8.0, 4.0)), \
        _lm_rand(rng, (h, dk), dev)


@pytest.mark.parametrize("s", [256, 130, 1000])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("h,dk,dv,use_u", [
    (4, 64, 64, True), (3, 32, 128, True), (2, 16, 32, True),
    (2, 64, 16, False), (2, 16, 128, False)])
def test_gla_chunk_rwkv6_matches_plain(dev, s, with_state, h, dk, dv,
                                       use_u):
    """rwkv6's bf16 inputs on the chunk-parallel RWKV6 design (tensor-core
    scores anchored per sub-chunk): out within 2e-2 (bf16), the final
    state within 2e-4 of the plain version, at dk 16/32/64 and dv up to
    128, ragged S, with and without an initial state and the bonus; one
    launch counted for the design, none for the SSD design."""
    from repro_torch.kernels.gla_chunk import ops as gl
    from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref
    rng = np.random.default_rng(s + dk + dv + h + use_u)
    r, k, v, lw, u = _rwkv6_inputs(rng, dev, 2, s, h, dk, dv)
    u = u if use_u else None
    s0 = _lm_rand(rng, (2, h, dk, dv), dev) if with_state else None
    before = launch_counts()
    out, final = gl.gla(r, k, v, lw, u, inclusive=False, initial_state=s0)
    after = launch_counts()
    assert after["gla_chunk"] == before["gla_chunk"] + 1
    assert after["gla_chunk_rwkv6"] == before["gla_chunk_rwkv6"] + 1
    assert after["gla_chunk_ssd"] == before["gla_chunk_ssd"]
    ref_out, ref_final = gla_chunk_ref(r, k, v, lw, u, inclusive=False,
                                       initial_state=s0)
    assert out.dtype == torch.bfloat16 and out.shape == ref_out.shape
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(final, ref_final, rtol=2e-4, atol=2e-4)


def test_gla_chunk_rwkv6_reads_strided_views(dev):
    """Views the 16-byte loads cannot take (a channel stride of 2, a head
    stride that is not a multiple of 8 elements, the model's [B, H, S, d]
    transposed) are read element by element through their strides, with
    the same result as their contiguous copies."""
    from repro_torch.kernels.gla_chunk import ops as gl
    rng = np.random.default_rng(41)
    b, s, h, d = 2, 200, 3, 32
    r = _lm_rand(rng, (b, s, h, 2 * d), dev, torch.bfloat16)[..., ::2]
    k = _lm_rand(rng, (b, s, h * d + 4), dev, torch.bfloat16)[
        ..., 4:].unflatten(-1, (h, d))                # token stride h·d + 4
    v = _lm_rand(rng, (b, h, s, d), dev, torch.bfloat16).transpose(1, 2)
    _, _, _, lw, u = _rwkv6_inputs(rng, dev, b, s, h, d, d)
    lw = torch.cat([lw, lw], -1)[..., ::2]
    s0 = _lm_rand(rng, (b, h, d, d), dev)
    got = gl.gla(r, k, v, lw, u, inclusive=False, initial_state=s0)
    want = gl.gla(r.contiguous(), k.contiguous(), v.contiguous(),
                  lw.contiguous(), u, inclusive=False, initial_state=s0)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=0)


@pytest.mark.parametrize("design", ["rwkv6", "serial"])
def test_gla_chunk_rwkv6_pinned_design_matches_plain(dev, design):
    """Either design pinned on rwkv6's bf16 inputs (how chip_smoke.py times
    them in turns) holds the plain version and counts as its own."""
    from repro_torch.kernels.gla_chunk import ops as gl
    from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref
    rng = np.random.default_rng(43)
    r, k, v, lw, u = _rwkv6_inputs(rng, dev, 2, 200, 8, 64, 64)
    s0 = _lm_rand(rng, (2, 8, 64, 64), dev)
    before = launch_counts()["gla_chunk_rwkv6"]
    out, final = gl.gla(r, k, v, lw, u, inclusive=False, initial_state=s0,
                        design=design)
    assert launch_counts()["gla_chunk_rwkv6"] == before + int(
        design == "rwkv6")
    ref_out, ref_final = gla_chunk_ref(r, k, v, lw, u, inclusive=False,
                                       initial_state=s0)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(final, ref_final, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", ["f32", "inclusive", "dk 48", "dv 256"])
def test_gla_chunk_rwkv6_pinned_outside_its_regime_raises(dev, case):
    """``design="rwkv6"`` raises, launching nothing, where ``takes_rwkv6``
    is false."""
    from repro_torch.kernels.gla_chunk import ops as gl
    rng = np.random.default_rng(47)
    dk = 48 if case == "dk 48" else 64
    dv = 256 if case == "dv 256" else 64
    r, k, v, lw, u = _rwkv6_inputs(rng, dev, 1, 70, 2, dk, min(dv, 128))
    if case == "dv 256":
        v = _lm_rand(rng, (1, 70, 2, dv), dev, torch.bfloat16)
    if case == "f32":
        r, k, v = r.float(), k.float(), v.float()
    assert not gl.takes_rwkv6(r, v, case == "inclusive")
    before = launch_counts()
    with pytest.raises(ValueError):
        gl.gla(r, k, v, lw, u, inclusive=case == "inclusive",
               design="rwkv6")
    assert launch_counts() == before


@pytest.mark.parametrize("case,ssd", [
    ("mamba2 bf16", True), ("mamba2 f32", False), ("rwkv6 bf16", False),
    ("per-head q, k bf16", False), ("lag-1 bf16", False)])
def test_gla_chunk_routes_to_a_kernel(dev, case, ssd):
    """Only the Mamba2 regime in bf16 takes the SSD design; the lag-1 read
    in bf16 (RWKV6's, with or without the bonus) takes the RWKV6 design;
    f32 and the inclusive read with per-head q, k launch the f32 design;
    none runs the plain version on the card."""
    from repro_torch.kernels.gla_chunk import ops as gl
    from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref
    rng = np.random.default_rng(len(case))
    b, s, h, d = 2, 100, 4, 32
    dtype = torch.float32 if "f32" in case else torch.bfloat16
    q, k, v, lw = _gla_inputs(rng, dev, b, s, h, d, d,
                              mamba=case.startswith("mamba2"), dtype=dtype)
    inclusive = not case.startswith(("rwkv6", "lag-1"))
    u = _lm_rand(rng, (h, d), dev) if case.startswith("rwkv6") else None
    before = launch_counts()
    out, final = gl.gla(q, k, v, lw, u, inclusive=inclusive)
    after = launch_counts()
    assert after["gla_chunk"] == before["gla_chunk"] + 1
    assert after["gla_chunk_ssd"] - before["gla_chunk_ssd"] == int(ssd)
    rwkv6 = dtype == torch.bfloat16 and not inclusive
    assert (after["gla_chunk_rwkv6"] - before["gla_chunk_rwkv6"]
            == int(rwkv6))
    ref_out, ref_final = gla_chunk_ref(q, k, v, lw, u, inclusive=inclusive)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(final, ref_final, rtol=2e-4, atol=2e-4)


def test_lm_wrappers_raise_instead_of_running_the_plain_version(dev):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.gla_chunk import ops as gl
    before = launch_counts()
    q = torch.zeros((1, 2, 64, 64), device=dev)
    with pytest.raises(TypeError):                       # f16
        fa.mha(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):                       # mixed dtypes
        fa.mha(q, q.bfloat16(), q)
    with pytest.raises(ValueError):                      # head_dim 48
        fa.mha(q[..., :48], q[..., :48], q[..., :48])
    with pytest.raises(ValueError):                      # D not contiguous
        t = q.transpose(2, 3)
        fa.mha(t, t, t)
    with pytest.raises(ValueError):                      # mixed devices
        fa.mha(q, q.cpu(), q)
    x = torch.zeros((1, 64, 2, 64), device=dev)
    with pytest.raises(ValueError):                      # chunk 32
        gl.gla(x, x, x, x, chunk=32)
    with pytest.raises(TypeError):                       # bf16 log_w
        gl.gla(x, x, x, x.bfloat16())
    with pytest.raises(ValueError):                      # dk 128
        y = torch.zeros((1, 64, 2, 128), device=dev)
        gl.gla(y, y, y, y)
    with pytest.raises(ValueError):                      # state shape
        gl.gla(x, x, x, x, initial_state=torch.zeros((1, 2, 64, 32),
                                                     device=dev))
    # inputs of the two new designs, bent one way each
    qb = q.bfloat16()
    with pytest.raises(ValueError):                      # mixed devices
        fa.mha(qb, qb.cpu(), qb)
    with pytest.raises(ValueError):                      # Hq % Hkv
        fa.mha(torch.zeros((1, 3, 64, 64), device=dev).bfloat16(), qb, qb)
    m = torch.zeros((1, 64, 1, 64), device=dev).bfloat16().expand(
        1, 64, 2, 64)
    lw = torch.zeros((1, 64, 2, 1), device=dev).expand(1, 64, 2, 64)
    with pytest.raises(ValueError):                      # state shape
        gl.gla(m, m, m, lw, inclusive=True,
               initial_state=torch.zeros((1, 2, 64, 32), device=dev))
    with pytest.raises(TypeError):                       # f32 v
        gl.gla(m, m, m.float(), lw, inclusive=True)
    with pytest.raises(TypeError):                       # bf16 state
        gl.gla(m, m, m, lw, inclusive=True,
               initial_state=torch.zeros((1, 2, 64, 64), device=dev,
                                         dtype=torch.bfloat16))
    with pytest.raises(ValueError):                      # tc pinned on f32
        fa.mha(q, q, q, design="tc")
    with pytest.raises(ValueError):                      # ssd pinned, f32
        gl.gla(m.float(), m.float(), m.float(), lw, inclusive=True,
               design="ssd")
    with pytest.raises(ValueError):                      # rwkv6 pinned, f32
        gl.gla(m.float(), m.float(), m.float(), lw, design="rwkv6")
    with pytest.raises(ValueError):                      # no such design
        fa.mha(qb, qb, qb, design="wgmma")
    assert launch_counts() == before


@pytest.mark.parametrize("design", ["tc", "simt"])
def test_flash_attention_pinned_design_matches_plain(dev, design):
    """Either design pinned on the models' bf16 shape (how chip_smoke.py
    times them side by side) holds the plain version and counts as its
    own."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rng = np.random.default_rng(23)
    q, k, v = (_lm_rand(rng, (2, 200, h, 128), dev, torch.bfloat16)
               .transpose(1, 2) for h in (8, 4, 4))
    before = launch_counts()["flash_attention_tc"]
    got = fa.mha(q, k, v, design=design)
    assert launch_counts()["flash_attention_tc"] == before + int(
        design == "tc")
    torch.testing.assert_close(got.float(), attention_ref(q, k, v).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("design", ["ssd", "serial"])
def test_gla_chunk_pinned_design_matches_plain(dev, design):
    from repro_torch.kernels.gla_chunk import ops as gl
    from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref
    rng = np.random.default_rng(29)
    q, k, v, lw = _gla_inputs(rng, dev, 2, 200, 8, 64, 64, mamba=True,
                              dtype=torch.bfloat16)
    s0 = _lm_rand(rng, (2, 8, 64, 64), dev)
    before = launch_counts()["gla_chunk_ssd"]
    out, final = gl.gla(q, k, v, lw, inclusive=True, initial_state=s0,
                        design=design)
    assert launch_counts()["gla_chunk_ssd"] == before + int(design == "ssd")
    ref_out, ref_final = gla_chunk_ref(q, k, v, lw, inclusive=True,
                                       initial_state=s0)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(final, ref_final, rtol=2e-4, atol=2e-4)


LM_ARCHS = ["internlm2-1.8b", "zamba2-1.2b", "rwkv6-7b", "qwen2-moe-a2.7b",
            "qwen2-vl-7b", "whisper-small"]


def _lm_launches(model, decode_steps: int = 0):
    """(flash_attention, gla_chunk) launches of one prefill (or train
    forward) and ``decode_steps`` decode steps of a model: one per
    attention layer (whisper: its encoder's, and its decoder's self- and
    cross-attention; its cross-attention again in every decode step) and
    one per Mamba2 / RWKV6 layer."""
    cfg = model.cfg
    L = cfg.n_layers
    flash = {"dense": L, "moe": L, "vlm": L, "ssm": 0,
             "hybrid": model.n_shared_apps(),
             "encdec": cfg.n_enc_layers + 2 * L + decode_steps * L
             }[cfg.family]
    return flash, L if cfg.family in ("ssm", "hybrid") else 0


def _smoke_batch(model, toks):
    """tokens, and frames for an encdec model (seeded normal)."""
    cfg = model.cfg
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = torch.tensor(np.random.default_rng(5).standard_normal(
            (toks.shape[0], cfg.enc_seq, cfg.d_model), dtype=np.float32))
    return batch


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_serve_on_card_matches_cpu(dev, arch):
    """The smoke config's serve run (prefill + greedy decode) on the card
    against the same run on the CPU, f32 weights drawn on the CPU: the
    same tokens, decode logits within 1e-3 x max(|logits|, 1) (the two
    devices' products add in other orders; f32 rounding through a few
    layers stays orders of magnitude below that), and one kernel launch
    per attention / Mamba2 / RWKV6 layer of the prefill, none in decode
    but whisper's cross-attention."""
    from repro_torch.examples.serve_lm import serve
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_map
    model = build_model(arch, smoke=True)
    cfg = model.cfg
    params = tree_map(lambda t: t.float(),
                      model.init(torch.Generator().manual_seed(0)))
    prompts = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 45)))
    frames = _smoke_batch(model, prompts).get("frames")
    cpu = serve(model, params, prompts, gen_len=6, max_len=64,
                frames=frames)
    reset_launch_counts()
    gpu = serve(model, tree_map(lambda t: t.to(dev), params),
                prompts.to(dev), gen_len=6, max_len=64,
                frames=None if frames is None else frames.to(dev))
    counts = launch_counts()
    n_flash, n_gla = _lm_launches(model, decode_steps=5)
    assert counts["flash_attention"] == n_flash
    assert counts["gla_chunk"] == n_gla
    assert torch.equal(gpu["tokens"].cpu(), cpu["tokens"])
    scale = max(float(cpu["logits"].abs().max()), 1.0)
    err = float((gpu["logits"].cpu() - cpu["logits"]).abs().max())
    assert err < 1e-3 * scale, (err, scale)


@pytest.mark.parametrize("sq,skv,hq,hkv,d,causal", [
    (1500, 1500, 12, 12, 64, False),      # whisper's encoder
    (416, 1500, 12, 12, 64, False),       # its cross-attention, prefill
    (1, 1500, 12, 12, 64, False),         # and decode
    (416, 416, 12, 12, 64, True),         # its decoder's self-attention
    (300, 300, 28, 4, 128, True),         # qwen2-vl's GQA group 7
    (130, 77, 14, 2, 128, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_model_regimes_match_plain(dev, sq, skv, hq, hkv, d,
                                                   causal, dtype):
    """The regimes the other families put on the kernel, read through the
    model's [B, S, H, D] layout: full attention with Sq != Skv (a ragged
    last key tile, one query against 1500 keys), GQA group 7; bf16 on the
    tensor-core design within 2e-2, f32 on the CUDA-core one within
    2e-5."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rng = np.random.default_rng(sq + skv + hq)
    q = _lm_rand(rng, (2, sq, hq, d), dev, dtype).transpose(1, 2)
    k, v = (_lm_rand(rng, (2, skv, hkv, d), dev, dtype).transpose(1, 2)
            for _ in range(2))
    before = launch_counts()
    got = fa.mha(q, k, v, causal=causal)
    after = launch_counts()
    tc = dtype == torch.bfloat16
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert (after["flash_attention_tc"] - before["flash_attention_tc"]
            == int(tc))
    tol = 2e-2 if tc else 2e-5
    torch.testing.assert_close(got.float(), attention_ref(
        q, k, v, causal=causal).float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("s", [256, 130])
@pytest.mark.parametrize("with_state", [False, True])
def test_gla_chunk_rwkv6_bf16_regime(dev, s, with_state):
    """rwkv6's regime as its time mix hands it over: bf16 r, k, v, an f32
    per-channel log decay made as the model makes it, -exp(clip(x, -8,
    4)), with channels at -e^4 (a chunk's cumulative decay near -3,500),
    and the bonus u — on the RWKV6 design: out within 2e-2 and the final
    state within 2e-4 of the plain version."""
    from repro_torch.kernels.gla_chunk import ops as gl
    from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref
    rng = np.random.default_rng(s + with_state)
    b, h, dk = 2, 4, 64
    r, k, v = (_lm_rand(rng, (b, s, h, dk), dev, torch.bfloat16)
               for _ in range(3))
    x = _lm_rand(rng, (b, s, h, dk), dev) * 3
    x[..., :4] = 4.0                                  # w = exp(-e^4)
    lw = -torch.exp(torch.clamp(x, -8.0, 4.0))
    u = _lm_rand(rng, (h, dk), dev)
    s0 = _lm_rand(rng, (b, h, dk, dk), dev) if with_state else None
    before = launch_counts()
    out, final = gl.gla(r, k, v, lw, u, inclusive=False, initial_state=s0)
    after = launch_counts()
    assert after["gla_chunk"] == before["gla_chunk"] + 1
    assert after["gla_chunk_ssd"] == before["gla_chunk_ssd"]
    assert after["gla_chunk_rwkv6"] == before["gla_chunk_rwkv6"] + 1
    ref_out, ref_final = gla_chunk_ref(r, k, v, lw, u, inclusive=False,
                                       initial_state=s0)
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(final, ref_final, rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------- training

def test_flash_function_on_card_gradient_is_the_plain_versions(dev):
    """``FlashAttentionFn`` on the tensor-core design: the forward within
    2e-2 of the plain version (one launch), the input gradients bitwise
    autograd's through the plain version."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rng = np.random.default_rng(31)
    base = [_lm_rand(rng, (2, 200, h, 128), dev, torch.bfloat16)
            for h in (8, 4, 4)]
    go = _lm_rand(rng, (2, 8, 200, 128), dev, torch.bfloat16)
    grads, outs = {}, {}
    for name, fn in (("fn", fa.attention), ("plain", attention_ref)):
        x = [t.clone().requires_grad_() for t in base]
        before = launch_counts()["flash_attention_tc"]
        outs[name] = fn(*(t.transpose(1, 2) for t in x))
        assert launch_counts()["flash_attention_tc"] == before + int(
            name == "fn")
        grads[name] = torch.autograd.grad(outs[name], x, go)
    torch.testing.assert_close(outs["fn"].float(), outs["plain"].float(),
                               rtol=2e-2, atol=2e-2)
    assert all(torch.equal(a, b) for a, b in zip(grads["fn"],
                                                 grads["plain"]))


def test_gla_function_on_card_gradient_is_the_plain_versions(dev):
    """``GlaChunkFn`` on Mamba2's bf16 broadcast inputs (the SSD design):
    the forward within 2e-2 of the plain version, the gradients of the
    un-broadcast q, k, v and decay bitwise autograd's through
    ``gla_ssd_ref``."""
    from repro_torch.kernels.gla_chunk import ops as gl
    from repro_torch.kernels.gla_chunk.ref import gla_ssd_ref
    rng = np.random.default_rng(37)
    b, s, h, dk, dv = 2, 200, 8, 64, 64
    base = [_lm_rand(rng, (b, s, 1, dk), dev, torch.bfloat16),
            _lm_rand(rng, (b, s, 1, dk), dev, torch.bfloat16),
            _lm_rand(rng, (b, s, h, dv), dev, torch.bfloat16),
            -torch.exp(_lm_rand(rng, (b, s, h, 1), dev))]
    go = _lm_rand(rng, (b, s, h, dv), dev, torch.bfloat16)
    grads, outs = {}, {}
    for name, fn in (("fn", lambda *a: gl.gla_fn(*a, inclusive=True)),
                     ("plain", gla_ssd_ref)):
        x = [t.clone().requires_grad_() for t in base]
        args = (x[0].expand(b, s, h, dk), x[1].expand(b, s, h, dk), x[2],
                x[3].expand(b, s, h, dk))
        before = launch_counts()["gla_chunk_ssd"]
        outs[name], _ = fn(*args)
        assert launch_counts()["gla_chunk_ssd"] == before + int(name == "fn")
        grads[name] = torch.autograd.grad(outs[name], x, go)
    torch.testing.assert_close(outs["fn"].float(), outs["plain"].float(),
                               rtol=2e-2, atol=2e-2)
    assert all(torch.equal(a, b) for a, b in zip(grads["fn"],
                                                 grads["plain"]))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-1.2b"])
def test_smoke_train_step_on_card_matches_cpu(dev, arch):
    """One ``make_train_step`` of the f32 smoke config on the card against
    the CPU (the kernels forward there): loss, grad norm and every
    parameter within 1e-4; one kernel launch per attention / Mamba2
    layer."""
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train.train_step import make_train_step
    model = build_model(arch, smoke=True)
    cfg = model.cfg
    params = tree_map(lambda t: t.float(),
                      model.init(torch.Generator().manual_seed(0)))
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 64)))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1,
                                              total_steps=10))
    gp = tree_map(lambda t: t.to(dev), params)
    cp, _, cmet = step(params, init_state(params), batch)
    reset_launch_counts()
    gp, _, gmet = step(gp, init_state(gp),
                       {k: v.to(dev) for k, v in batch.items()})
    counts = launch_counts()
    n_attn = cfg.n_layers if cfg.family == "dense" else model.n_shared_apps()
    assert counts["flash_attention"] == n_attn
    assert counts["gla_chunk"] == (0 if cfg.family == "dense"
                                   else cfg.n_layers)
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(gmet[key]) - float(cmet[key])) <= 1e-4 * max(
            1.0, abs(float(cmet[key])))
    for a, b in zip(tree_leaves(gp), tree_leaves(cp)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "qwen2-moe-a2.7b",
                                  "qwen2-vl-7b", "whisper-small"])
def test_family_smoke_train_step_on_card_matches_cpu(dev, arch):
    """The four other families' f32 smoke configs, card against CPU: every
    gradient leaf (the kernels forward on the card, their plain versions'
    recomputed backward), then one ``make_train_step`` from a nonzero
    AdamW state (step 5, random moments, as tests/test_torch_train.py
    holds the CPU against the reference) — loss, aux, grad norm and every
    parameter within 1e-4; one kernel launch per attention / RWKV6 layer.
    The nonzero state matters: from a zero state Adam's first update is
    g / (|g| + eps) per element, so a gradient near 1e-7 (rwkv6's smoke
    config has one in ``tm.wk``) turns the devices' rounding of it into a
    1e-4 parameter difference."""
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, AdamWState
    from repro_torch.train.train_step import (grads_of, make_loss_fn,
                                              make_train_step)
    model = build_model(arch, smoke=True)
    cfg = model.cfg
    params = tree_map(lambda t: t.float(),
                      model.init(torch.Generator().manual_seed(0)))
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 64)))
    batch = dict(_smoke_batch(model, toks), targets=torch.roll(toks, -1, 1))
    gbatch = {k: v.to(dev) for k, v in batch.items()}
    gp = tree_map(lambda t: t.to(dev, copy=True), params)
    loss_fn = make_loss_fn(model)
    cg, closs = grads_of(loss_fn, params, batch)
    reset_launch_counts()
    gg, gloss = grads_of(loss_fn, gp, gbatch)
    counts = launch_counts()
    n_flash, n_gla = _lm_launches(model)
    assert counts["flash_attention"] == n_flash
    assert counts["gla_chunk"] == n_gla
    assert abs(float(gloss) - float(closs)) <= 1e-4 * max(1.0, abs(float(
        closs)))
    for a, b in zip(gg, cg):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        caux = loss_fn(params, batch)[1][1]
        gaux = loss_fn(gp, gbatch)[1][1]
    torch.testing.assert_close(gaux.cpu(), caux, rtol=1e-4, atol=1e-4)

    rng = np.random.default_rng(7)
    mu = [torch.tensor(rng.standard_normal(p.shape, dtype=np.float32)
                       * 1e-3) for p in tree_leaves(params)]
    nu = [torch.tensor(rng.random(p.shape, dtype=np.float32) * 1e-6)
          for p in tree_leaves(params)]

    def state(on):
        from repro_torch.models.param import tree_unflatten
        return AdamWState(step=torch.tensor(5, dtype=torch.int32,
                                            device=on),
                          mu=tree_unflatten(params, [m.to(on, copy=True)
                                                     for m in mu]),
                          nu=tree_unflatten(params, [n.to(on, copy=True)
                                                     for n in nu]))
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1,
                                              total_steps=10))
    cp, _, cmet = step(params, state("cpu"), batch)
    gp, _, gmet = step(gp, state(dev), gbatch)
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(gmet[key]) - float(cmet[key])) <= 1e-4 * max(
            1.0, abs(float(cmet[key])))
    for a, b in zip(tree_leaves(gp), tree_leaves(cp)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def test_manual_dp_world_one_on_card_matches_train_step(dev):
    """``manual_dp`` at world size 1 over NCCL: the update of
    ``make_train_step`` (f32 smoke; the global norm is summed in another
    order, so 1e-6)."""
    import socket
    import torch.distributed as dist
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import manual_dp
    from repro_torch.train.train_step import make_train_step
    model = build_model("internlm2-1.8b", smoke=True)
    params = tree_map(lambda t: t.float().to(dev),
                      model.init(torch.Generator().manual_seed(0)))
    toks = torch.tensor(np.random.default_rng(4).integers(
        0, model.cfg.vocab, (4, 64)), device=dev)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    want, _, _ = make_train_step(model, opt)(
        tree_map(torch.clone, params), init_state(params), batch)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        step = manual_dp.make_manual_dp_train_step(model, opt)
        got, _, _ = step(params, manual_dp.init_shard_state(params), batch)
    finally:
        dist.destroy_process_group()
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_train_lm_on_card(dev, tmp_path):
    """The ETL-fed example on the card: transform_kpi and flash_attention
    launch, the loss falls, the checkpoint restores bitwise."""
    from repro_torch.examples import train_lm
    from repro_torch.train.checkpoint import CheckpointManager, flatten
    reset_launch_counts()
    out = train_lm.main(["--steps", "10", "--ckpt-every", "10", "--ckpt",
                         str(tmp_path)])
    counts = launch_counts()
    assert counts["transform_kpi"] > 0 and counts["flash_attention_tc"] > 0
    assert out["losses"][-1] < out["losses"][0]
    tree = {"params": out["params"], "opt": out["opt"], "corpus": None}
    step, got, _ = CheckpointManager(str(tmp_path)).restore_latest(tree)
    assert step == 10
    for a, b in zip(flatten(got)[0], flatten(tree)[0]):
        if b is not None:
            assert torch.equal(a, b)
