"""The port's main path held against the JAX package: one seeded steelworks
deployment (4 partitions, 2 workers, 10% late master rows, serving views
attached) driven through ``repro`` (numpy and pallas backends) and through
``repro_torch`` (torch backend, ``device="cpu"``), plus the dispatch/sync
counter pins of tests/test_backends.py mirrored for the torch backend."""
import numpy as np
import pytest
import torch

import repro.configs.dod_etl as ref_cfg
import repro.core as ref_core
import repro.data.sampler as ref_sampler
import repro.serving as ref_serving
import repro_torch.configs.dod_etl as port_cfg
import repro_torch.core as port_core
import repro_torch.data.sampler as port_sampler
import repro_torch.serving as port_serving
from repro_torch.core.backend import get_backend
from repro_torch.core.cache import InMemoryTable
from repro_torch.kernels import launch_counts

N_UNITS = 4
CPU = torch.device("cpu")


def _queries(serving):
    qs = [serving.ReportQuery("oee", unit=u % N_UNITS) for u in range(9)]
    return qs + [serving.ReportQuery("oee"),
                 serving.ReportQuery("top_downtime", k=3),
                 serving.ReportQuery("shift_report"),
                 serving.ReportQuery("production_rate"),
                 serving.ReportQuery("production_curve"),
                 serving.ReportQuery("kpi_rollup")]


def run_slice(pkg, backend, n_records=300, n_workers=2, device=None,
              step_records=25):
    """Drive one seeded deployment to completion in ``pkg`` ('ref' or
    'port'); returns (pipeline, engine, reports)."""
    cfg_mod, core, sampler, serving = (
        (ref_cfg, ref_core, ref_sampler, ref_serving) if pkg == "ref"
        else (port_cfg, port_core, port_sampler, port_serving))
    cfg = cfg_mod.steelworks_config(n_partitions=N_UNITS, backend=backend)
    src = core.SourceDatabase()
    sampler.SteelworksSampler(cfg, sampler.SamplerConfig(
        records_per_table=n_records, n_equipment=N_UNITS,
        late_master_frac=0.1, seed=0)).generate(src)
    kw = {} if pkg == "ref" else {"device": device or "cpu"}
    pipe = core.DODETLPipeline(cfg, src, n_workers=n_workers, **kw)
    engine = serving.MaterializedViewEngine(
        serving.steelworks_views(N_UNITS), backend=pipe.backend)
    pipe.warehouse.attach_serving(engine)
    pipe.extract()
    pipe.bootstrap_caches()
    for _ in range(200):
        n = pipe.step(step_records)
        engine.fold_pending()
        if n == 0 and not sum(len(w.buffer) for w in pipe.workers):
            break
    reports = serving.compile_queries(_queries(serving)).execute(
        serving.ReportSnapshot(engine.snapshot(), engine.backend)).reports()
    return pipe, engine, reports


@pytest.fixture(scope="module")
def runs():
    return {"numpy": run_slice("ref", "numpy"),
            "pallas": run_slice("ref", "pallas"),
            "torch": run_slice("port", "torch")}


def test_rows_loaded_and_late_records(runs):
    rows = {k: v[0].warehouse.rows_loaded for k, v in runs.items()}
    assert rows["torch"] == rows["numpy"] == rows["pallas"] == 300
    late = lambda p: sum(w.transformer.records_late for w in p.workers)
    assert late(runs["torch"][0]) == late(runs["numpy"][0])


def test_facts_byte_identical_to_numpy(runs):
    got = runs["torch"][0].warehouse.canonical_fact_table()
    assert got.tobytes() == \
        runs["numpy"][0].warehouse.canonical_fact_table().tobytes()
    np.testing.assert_allclose(
        got, runs["pallas"][0].warehouse.canonical_fact_table(),
        rtol=1e-5, atol=1e-5)


def test_kpi_running_matches(runs):
    got = runs["torch"][0].warehouse.kpi_running()
    for ref in ("numpy", "pallas"):
        np.testing.assert_allclose(got, runs[ref][0].warehouse.kpi_running(),
                                   rtol=0, atol=1e-4)


def test_view_tables_bitwise_vs_numpy(runs):
    got = runs["torch"][1].snapshot()
    want = runs["numpy"][1].snapshot()
    assert got.epoch == want.epoch and got.rows_folded == want.rows_folded
    for name, st in want.states.items():
        assert got.states[name].table.tobytes() == st.table.tobytes(), name
    for name, st in runs["pallas"][1].snapshot().states.items():
        np.testing.assert_allclose(got.states[name].table, st.table,
                                   rtol=1e-5, atol=1e-5)


def test_incremental_views_equal_rebuild(runs):
    pipe, engine, _ = runs["torch"]
    rebuilt = port_serving.MaterializedViewEngine.rebuild(
        engine.specs, pipe.warehouse.read_view().chunks,
        backend=engine.backend)
    for name, st in engine.snapshot().states.items():
        assert rebuilt.states[name].table.tobytes() == st.table.tobytes()


def _assert_reports_equal(got, want, exact):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.view, a.epoch, a.rows) == (b.view, b.epoch, b.rows)
        assert a.data.keys() == b.data.keys()
        for k in a.data:
            va, vb = a.data[k], b.data[k]
            if isinstance(va, tuple):
                assert va == vb
            elif exact:
                np.testing.assert_array_equal(va, vb)
            else:
                np.testing.assert_allclose(va, vb, rtol=1e-5, atol=1e-5)


def test_compile_queries_answers_equal(runs):
    _assert_reports_equal(runs["torch"][2], runs["numpy"][2], exact=True)
    _assert_reports_equal(runs["torch"][2], runs["pallas"][2], exact=False)


def test_restore_fold_state_from_reference_export(runs):
    """The reference engine's ``export_fold_state`` dict restores into the
    port's engine; both then fold the same delta to the same bytes."""
    ref_engine = runs["numpy"][1]
    port_engine = port_serving.MaterializedViewEngine(
        port_serving.steelworks_views(N_UNITS), device="cpu")
    port_engine.restore_fold_state(ref_engine.export_fold_state())
    facts = ref_sampler.synthetic_facts(np.random.default_rng(5), 200,
                                        N_UNITS, valid_frac=0.9)
    ref_copy = ref_serving.MaterializedViewEngine(
        ref_serving.steelworks_views(N_UNITS), backend="numpy")
    ref_copy.restore_fold_state(ref_engine.export_fold_state())
    for eng in (port_engine, ref_copy):
        eng.publish(facts)
        eng.fold_pending()
    for name, st in ref_copy.snapshot().states.items():
        assert port_engine.snapshot().states[name].table.tobytes() == \
            st.table.tobytes()


def test_segment_reduce_cpu_matches_numpy(runs):
    facts = runs["torch"][0].warehouse.fact_table()
    got = get_backend("torch", device=CPU).segment_reduce(facts, N_UNITS)
    np.testing.assert_allclose(
        got, ref_core.get_backend("numpy").segment_reduce(facts, N_UNITS),
        rtol=0, atol=1e-4)


# --------------------------------------------------- dispatch/sync counters
def _master_tables(rng, n_units=8, n_prod=300):
    be = get_backend("torch", device=CPU)
    eq = InMemoryTable(256, backend=be)
    eqp = np.zeros((n_units, 8), np.float32)
    eqp[:, 1] = np.arange(n_units)
    eqp[:, 4] = 100.0
    eqp[:, 5] = (rng.random(n_units) > 0.3).astype(np.float32)
    eqp[:, 6] = 5.0 + rng.random(n_units).astype(np.float32)
    eqp[:, 7] = 50.0
    eq.upsert(np.arange(n_units), eqp, np.arange(n_units, dtype=np.int64))
    qu = InMemoryTable(1024, backend=be)
    qp = np.zeros((n_prod, 8), np.float32)
    qp[:, 3] = np.arange(n_prod)
    qp[:, 4] = rng.integers(0, 3, n_prod)
    qp[:, 6] = rng.integers(0, 2, n_prod)
    qu.upsert(np.arange(n_prod), qp, np.arange(n_prod, dtype=np.int64))
    return eq, qu


def _prod_payloads(rng, n, n_units=8, n_prod=300):
    prod = np.zeros((n, 8), np.float32)
    prod[:, 0] = rng.integers(0, n_prod, n)
    prod[:, 1] = rng.integers(0, n_units + 2, n)     # some join misses
    prod[:, 3] = rng.uniform(0, 50, n)
    prod[:, 4] = prod[:, 3] + rng.uniform(1, 30, n)
    prod[:, 5] = rng.uniform(1, 100, n)
    return prod


@pytest.mark.parametrize("join_depth,dispatches", [(1, 1), (3, 2)])
def test_factblock_dispatch_and_sync_counters(join_depth, dispatches):
    """Mirrors tests/test_backends.py::test_factblock_dispatch_and_sync_
    counters for the torch backend: the transform is one launch that
    probes both caches, builds the facts and rolls them up (+1 flattened
    hop probe) — the jax backend's one dispatch — and ZERO host syncs
    until the load boundary materializes the block (exactly one sync,
    cached after that)."""
    rng = np.random.default_rng(12)
    eq, qu = _master_tables(rng)
    prod = _prod_payloads(rng, 200)
    be = get_backend("torch", device=CPU)
    be.reset_stats()
    block = be.transform_block(prod, eq, qu, join_depth=join_depth,
                               n_units=8)
    assert be.op_dispatches == dispatches and be.host_syncs == 0
    block.start_host_copy()
    assert be.host_syncs == 0
    facts, found = block.to_host()
    block.rollup_host()
    assert be.host_syncs == 1
    again = block.to_host()
    assert be.host_syncs == 1 and again[0] is facts
    assert facts.shape == (200, 10) and found.shape == (200,)
    ref_facts, ref_found = ref_core.get_backend("numpy").transform(
        prod, _ref_table(eq), _ref_table(qu))
    assert facts.tobytes() == ref_facts.tobytes()
    np.testing.assert_array_equal(found, ref_found)


def _ref_table(tbl):
    from repro.core.cache import InMemoryTable as RefTable
    ref = RefTable(tbl.n_slots)
    ref.keys, ref.values, ref.txn = tbl.keys, tbl.values, tbl.txn
    return ref


def test_worker_step_single_round_trip():
    """One process_operational step: one launch (both probes, the facts
    and the rollup in the fused transform kernel) and one host sync."""
    cfg = port_cfg.steelworks_config(n_partitions=N_UNITS)
    src = port_core.SourceDatabase()
    port_sampler.SteelworksSampler(cfg, port_sampler.SamplerConfig(
        records_per_table=200, n_equipment=N_UNITS)).generate(src)
    pipe = port_core.DODETLPipeline(cfg, src, n_workers=1, device="cpu")
    pipe.extract()
    pipe.bootstrap_caches()
    pipe.step(max_records_per_partition=25)
    be = pipe.backend
    be.reset_stats()
    assert pipe.step(max_records_per_partition=25) > 0
    assert be.op_dispatches == 1 and be.host_syncs == 1


def test_cpu_runs_launch_no_kernels(runs):
    before = launch_counts()
    run_slice("port", "torch", n_records=50, n_workers=1)
    assert launch_counts() == before


# ------------------------------------------------------------ device choice
def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    cfg = port_cfg.steelworks_config(n_partitions=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_backend()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_core.DODETLPipeline(cfg, port_core.SourceDatabase())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_serving.MaterializedViewEngine(port_serving.steelworks_views(2))


def test_backend_registry():
    assert set(port_core.available_backends()) == {"numpy", "torch"}
    cpu = get_backend("torch", device="cpu")
    assert cpu is get_backend("torch", device=CPU)       # one per device
    assert cpu.torch_device == CPU and cpu.device
    assert get_backend("numpy", device="cpu") is get_backend("numpy")
    with pytest.raises(KeyError):
        get_backend("jax", device="cpu")


def test_from_numpy_round_trip():
    from repro.core.cache import InMemoryTable as RefTable
    rng = np.random.default_rng(4)
    ref = RefTable(64)
    ref.upsert(rng.choice(1000, 40, replace=False), rng.normal(
        size=(40, 8)).astype(np.float32), np.arange(40))
    port = InMemoryTable.from_numpy(ref.keys, ref.values, ref.txn,
                                    ref.watermark,
                                    backend=get_backend("torch", device=CPU))
    assert port.n_rows == ref.n_rows == 40
    assert port.watermark == ref.watermark
    k, v, t = port.device_state()
    np.testing.assert_array_equal(k.numpy(), ref.keys)
    np.testing.assert_array_equal(t.numpy(), ref.txn.astype(np.int32))
    port.upsert(np.array([5000]), np.ones((1, 8), np.float32), np.array([99]))
    assert port.device_state()[0] is not k          # dirty key lane re-mirrors
