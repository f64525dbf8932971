"""The port's CUDA kernels on a card: each against its plain PyTorch
version on the same tensors, and the main path on the card against the
same path on the CPU. Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. The file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.backend import get_backend
from repro_torch.core.cache import InMemoryTable
from repro_torch.kernels import launch_counts
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


@pytest.mark.parametrize("n,units", [(1024, 20), (513, 32), (7, 3)])
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


@pytest.mark.parametrize("B", [8, 256, 2048])
@pytest.mark.parametrize("S,L", [(20, 4), (60, 2), (32, 1)])
def test_fold_segments_bitwise(dev, B, S, L):
    rng = np.random.default_rng(B * S + L)
    seg = np.where(rng.random(B) < 0.1, -1, rng.integers(0, S, B))
    vals = rng.normal(size=(B, L)).astype(np.float32)
    vals[rng.random((B, L)) < 0.1] = 0.0
    vals[rng.random((B, L)) < 0.1] = -0.0
    st = torch.tensor(seg, device=dev)
    vt = torch.tensor(vals, device=dev)
    assert _bits(sk_ops.fold_segments(st, vt, S)) == \
        _bits(sk_ref.fold_segments_ref(st, vt, S))


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


def test_wrappers_check_their_inputs(dev):
    keys = torch.full((16,), -1, dtype=torch.int32, device=dev)
    vals = torch.zeros((16, 8), device=dev)
    q = torch.zeros(4, dtype=torch.int64, device=dev)          # not int32
    with pytest.raises(TypeError):
        hj_ops.hash_join(q, keys, vals, keys)
    seg = torch.zeros(12, dtype=torch.int64, device=dev)       # not pow2
    with pytest.raises(ValueError):
        sk_ops.fold_segments(seg, torch.zeros((12, 2), device=dev), 4)
    with pytest.raises(ValueError):                           # mixed devices
        sk_ops.segment_kpi(torch.zeros((4, 8), device=dev),
                           torch.zeros((4, 8)), torch.zeros((4, 8)),
                           n_units=2)


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


def test_segment_reduce_not_ported_on_card(dev):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_backend("torch", device=dev).segment_reduce(
            np.zeros((4, 10), np.float32), 2)


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
