"""The port's sharded serving plane (``repro_torch.runtime.shard_plane``)
on the CPU, held against the port's unsharded engine and against the JAX
package's ``ShardedViewEngine`` on its numpy backend: tests/test_shard_plane.py
mirrored on the reference's own workload (``_workload``: 400-500 records,
4 partitions). Sharding must be invisible to the numbers: byte-identical
warehouse facts and bitwise view tables and batched answers at 1, 2 and 4
shards, across a mid-run ``repartition()`` and a crash recovery. Also the
batched read's plain version (``gather_stats_many_ref``) against the
numpy oracle and the Pallas gather in interpret mode, and the one-dispatch
counts of a fold cycle and a query batch. The card legs are in
tests/test_torch_cuda.py."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.dod_etl as ref_cfg
import repro.core as ref_core
import repro.data.sampler as ref_sampler
import repro.runtime.shard_plane as ref_plane
import repro.serving.views as ref_views
from repro.core import backend as ref_backend
from repro.kernels.segment_kpi.ops import gather_stats as pallas_gather
import repro_torch.configs.dod_etl as port_cfg
import repro_torch.core as port_core
import repro_torch.data.sampler as port_sampler
from repro_torch.core import DODETLPipeline
from repro_torch.core.backend import get_backend
from repro_torch.durability import (DurabilityJournal, FaultInjector,
                                    InjectedCrash, RecoveryCoordinator,
                                    recover_pipeline)
from repro_torch.durability.faults import COMMIT_POST, REPARTITION_MID
from repro_torch.kernels.segment_kpi import ops as sk_ops
from repro_torch.kernels.segment_kpi import ref as sk_ref
from repro_torch.launch.mesh import make_shard_mesh, mesh_devices
from repro_torch.runtime.cluster import ConcurrentCluster
from repro_torch.runtime.shard_plane import (ShardedViewEngine, owner_gather,
                                             tree_reduce)
from repro_torch.serving import (MaterializedViewEngine, ReportQuery,
                                 ReportServer, compile_queries,
                                 steelworks_views)

CPU = torch.device("cpu")
SHARD_COUNTS = (1, 2, 4)
SKEWED = (("n", 500), ("zipf_s", 1.2), ("strategy", "skew"))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The cluster's stage threads each driving torch's CPU pool would
    oversubscribe the cores; one intra-op thread per call."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- harness
def _workload(n=400, n_partitions=4, zipf_s=0.0, strategy="static", seed=0,
              ref=False):
    """tests/test_shard_plane.py's ``_workload``: the port's, or with
    ``ref`` the JAX package's (numpy backend)."""
    cfg_mod, core, sampler = ((ref_cfg, ref_core, ref_sampler) if ref else
                              (port_cfg, port_core, port_sampler))
    extra = {"backend": "numpy"} if ref else {}
    cfg = cfg_mod.steelworks_config(n_partitions=n_partitions,
                                    partition_strategy=strategy, **extra)
    cfg = dataclasses.replace(cfg, buffer_capacity=4096)
    src = core.SourceDatabase()
    sampler.SteelworksSampler(cfg, sampler.SamplerConfig(
        records_per_table=n, n_equipment=n_partitions,
        late_master_frac=0.15, zipf_s=zipf_s, seed=seed)).generate(src)
    return cfg, src


def _extraction_lag(pipe):
    log = pipe.source.log
    return sum(max(0, log.next_lsn - l.offset)
               for l in pipe.tracker.listeners)


def _drill_loop(pipe, engine, coord=None, ckpt_every=2, extract_per=60,
                repartition_at=None, cap=40, max_steps=300):
    """tests/test_shard_plane.py's deterministic loop: bounded extract,
    state-derived repartition trigger, micro-batch step, fold, maybe
    checkpoint (either package)."""
    steps = stalls = 0
    while steps < max_steps:
        steps += 1
        pipe.extract(extract_per)
        if repartition_at is not None \
                and pipe.current_routing().epoch == 0 \
                and pipe.warehouse.commit_seq >= repartition_at:
            pipe.repartition()
        n = pipe.step(cap)
        engine.fold_pending()
        if coord is not None and steps % ckpt_every == 0:
            coord.checkpoint(pipe, engine=engine)
        if _extraction_lag(pipe) > 0:
            stalls = 0
            continue
        if n == 0 and sum(len(w.buffer) for w in pipe.workers) == 0:
            break
        stalls = stalls + 1 if n == 0 else 0
        if stalls >= 3:
            break
    return steps


def _final_state(pipe, engine):
    snap = engine.snapshot()
    return {
        "facts": pipe.warehouse.canonical_fact_table().tobytes(),
        "rows": pipe.warehouse.rows_loaded,
        "seq": pipe.warehouse.commit_seq,
        "views": {n: st.table.tobytes() for n, st in snap.states.items()},
        "rows_folded": snap.rows_folded,
        "deltas_folded": snap.deltas_folded,
    }


def _assert_identical(got, want):
    for key in ("rows", "seq", "facts", "rows_folded", "deltas_folded"):
        assert got[key] == want[key], key
    for name, table in want["views"].items():
        assert got["views"][name] == table, name


def _attach(pipe, eng):
    eng.reown(pipe.current_routing())
    pipe.warehouse.attach_serving(eng)
    pipe.warehouse.attach_shards(eng.ownership)


@functools.lru_cache(maxsize=None)
def _port_run(n_shards, repartition_at=None, wl=()):
    """One workload through the port (sharded with ``n_shards``, or the
    unsharded engine for 0), driven by ``_drill_loop``. Cached: the runs
    are read, never changed, by the tests."""
    cfg, src = _workload(**dict(wl))
    pipe = DODETLPipeline(cfg, src, n_workers=2, device="cpu")
    if n_shards:
        eng = ShardedViewEngine(steelworks_views(cfg.n_business_keys),
                                n_shards=n_shards, backend=pipe.backend)
        _attach(pipe, eng)
    else:
        eng = MaterializedViewEngine(steelworks_views(cfg.n_business_keys),
                                     backend=pipe.backend)
        pipe.warehouse.attach_serving(eng)
    _drill_loop(pipe, eng, repartition_at=repartition_at)
    return _final_state(pipe, eng), pipe, eng


@functools.lru_cache(maxsize=None)
def _ref_run(n_shards, repartition_at=None, wl=()):
    """The same through the JAX package's sharded engine, numpy backend."""
    cfg, src = _workload(ref=True, **dict(wl))
    pipe = ref_core.DODETLPipeline(cfg, src, n_workers=2)
    eng = ref_plane.ShardedViewEngine(
        ref_views.steelworks_views(cfg.n_business_keys), n_shards=n_shards,
        backend="numpy")
    eng.reown(pipe.current_routing())
    pipe.warehouse.attach_serving(eng)
    pipe.warehouse.attach_shards(eng.ownership)
    _drill_loop(pipe, eng, repartition_at=repartition_at)
    return _final_state(pipe, eng), pipe, eng


def _assert_warehouse_shards_partition(pipe, eng):
    """The per-shard sub-logs partition the chunk log: their union,
    canonically sorted, is byte-identical to the warehouse's canonical
    fact table, and each shard holds only its owned keys."""
    wh = pipe.warehouse
    parts = [wh.shard_fact_table(k) for k in range(eng.n_shards)]
    union = np.concatenate([p for p in parts if len(p)])
    canon = union[np.lexsort(union.T[::-1])]
    assert canon.tobytes() == wh.canonical_fact_table().tobytes()
    for k, p in enumerate(parts):
        if len(p):
            owners = eng.ownership.shard_of_keys(p[:, 0].astype(np.int64))
            assert (owners == k).all()


# ------------------------------------------------------------------ parity
@pytest.mark.parametrize("n_shards,repartition_at,wl", [
    *((k, None, ()) for k in SHARD_COUNTS),
    *((k, 3, SKEWED) for k in (2, 4))])
def test_sharded_parity_bitwise(n_shards, repartition_at, wl):
    """1/2/4 shards, and 2/4 across a mid-run repartition() under a
    zipf-skewed workload with the skew-aware strategy: byte-identical
    warehouse facts and bitwise view tables against the port's unsharded
    engine and the JAX package's sharded engine; the per-shard warehouse
    sub-logs partition the chunk log; ownership follows the routing."""
    got, pipe, eng = _port_run(n_shards, repartition_at, wl)
    _assert_identical(got, _port_run(0, repartition_at, wl)[0])
    want, ref_pipe, ref_eng = _ref_run(n_shards, repartition_at, wl)
    _assert_identical(got, want)
    _assert_warehouse_shards_partition(pipe, eng)
    rep = eng.mesh_report()
    assert rep["routing_epoch"] == pipe.current_routing().epoch \
        == ref_eng.mesh_report()["routing_epoch"]
    assert rep["owned_segments"] == ref_eng.mesh_report()["owned_segments"]
    if repartition_at is not None:
        assert pipe.current_routing().epoch >= 1      # it really switched
        assert rep["reowns"] >= 1


def test_tree_reduce_merge_equals_owner_gather():
    """The pairwise-halving tree reduce over the shard tables is bitwise
    the authoritative owner-gather merge, and so the unsharded table, on
    the KPI domain; a -0.0 sum is where they part (why owner-gather is
    the authoritative one)."""
    _, _, eng = _port_run(4)
    want = _port_run(0)[0]["views"]
    snap = eng.snapshot()
    for spec in eng.specs:
        reduced = eng.tree_reduced_table(spec.name)
        gathered = owner_gather(snap.shard_states[spec.name],
                                snap.seg_owners[spec.name])
        assert reduced.tobytes() == gathered.tobytes() == want[spec.name]
        assert reduced.tobytes() == ref_plane.tree_reduce(
            snap.shard_states[spec.name]).tobytes()
    a = np.array([[1.0, -0.0, 2.0, 3.0]], np.float32)
    ident = np.array([[0.0, 0.0, np.inf, -np.inf]], np.float32)
    assert owner_gather([a, ident], np.array([0])).tobytes() == a.tobytes()
    assert tree_reduce([a, ident]).tobytes() != a.tobytes()


def _dashboard(n_units):
    return ([ReportQuery("oee", unit=int(u)) for u in range(n_units)] * 3
            + [ReportQuery("oee"), ReportQuery("top_downtime", k=3),
               ReportQuery("kpi_rollup"), ReportQuery("production_rate"),
               ReportQuery("shift_report")])


def _assert_reports_bitwise(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.view == b.view and set(a.data) == set(b.data), a.view
        for key, va in a.data.items():
            vb = b.data[key]
            if isinstance(va, np.ndarray):
                assert va.tobytes() == vb.tobytes(), (a.view, key)
            else:
                assert np.asarray(va).tobytes() == \
                    np.asarray(vb).tobytes(), (a.view, key)


@pytest.mark.parametrize("n_shards", (2, 4))
def test_shard_routed_batch_gather_bitwise(n_shards):
    """The batched read routes each point query to its owning shard, every
    (view, shard) item in ONE batched gather dispatch and one sync, and
    the answers are bitwise the unsharded engine's and the JAX package's
    sharded engine's."""
    from repro.serving.batch import ReportQuery as RefQuery
    from repro.serving.batch import compile_queries as ref_compile
    from repro.serving.server import ReportServer as RefServer
    _, pipe, eng = _port_run(n_shards)
    _, _, plain = _port_run(0)
    queries = _dashboard(4)
    plan = compile_queries(queries)
    be = pipe.backend
    before = (be.op_dispatches, be.host_syncs)
    got = plan.execute(ReportServer(eng).snapshot()).reports()
    shards = {int(k) for k in eng.snapshot().seg_owners["oee_by_equipment"]}
    assert len(shards) > 1                     # the batch spans shards
    # one gather for the batch; the shared reports' windowed curve is a
    # host-side read here (no production_curve in the batch)
    assert (be.op_dispatches - before[0], be.host_syncs - before[1]) == \
        (1, 1)
    _assert_reports_bitwise(
        got, plan.execute(ReportServer(plain).snapshot()).reports())
    _, _, ref_eng = _ref_run(n_shards)
    ref_plan = ref_compile([RefQuery(q.kind, q.view, q.unit, q.k)
                            for q in queries])
    _assert_reports_bitwise(
        got, ref_plan.execute(RefServer(ref_eng).snapshot()).reports())


# -------------------------------------------------------- checkpoint/recovery
@pytest.mark.parametrize("point,ordinal", [(COMMIT_POST, 5),
                                           (REPARTITION_MID, 1)])
def test_sharded_checkpoint_recovery_drill(tmp_path, point, ordinal):
    """Crash mid-stream (and mid-repartition) with a 2-shard engine on
    both sides: checkpoints capture the per-shard fold state, recovery
    restores it onto a sharded engine, and the finished run is
    byte-identical to the uninterrupted sharded run (itself bitwise the
    unsharded one and the JAX package's)."""
    want = _port_run(2, 3, SKEWED)[0]
    cfg, src = _workload(**dict(SKEWED))
    fault = FaultInjector({point: ordinal})
    pipe = DODETLPipeline(cfg, src, n_workers=2, fault=fault, device="cpu")
    eng = ShardedViewEngine(steelworks_views(cfg.n_business_keys),
                            n_shards=2, backend=pipe.backend)
    _attach(pipe, eng)
    coord = RecoveryCoordinator(DurabilityJournal(str(tmp_path)))
    with pytest.raises(InjectedCrash):
        _drill_loop(pipe, eng, coord=coord, repartition_at=3)

    eng2 = ShardedViewEngine(steelworks_views(cfg.n_business_keys),
                             n_shards=2, backend=pipe.backend)
    pipe2, coord2, info = recover_pipeline(
        cfg, src, DurabilityJournal(str(tmp_path)), engine=eng2,
        n_workers=2, device="cpu")
    assert info is not None
    eng2.reown(pipe2.current_routing())
    pipe2.warehouse.attach_shards(eng2.ownership)
    _drill_loop(pipe2, eng2, coord=coord2, repartition_at=3)
    _assert_identical(_final_state(pipe2, eng2), want)
    _assert_warehouse_shards_partition(pipe2, eng2)


@pytest.mark.parametrize("target", [2, 4, 0])
def test_export_restores_across_shapes(target):
    """A 4-shard checkpoint carries the per-shard tables and ownership
    (the owner-gather of its stacked tables is its merged tables); it
    restores onto 4 shards (adopted), onto 2 (re-derived from the merged
    tables) and onto the unsharded engine (the merged tables), and an
    unsharded checkpoint restores onto shards — every view bitwise the
    unsharded run's, through both merges."""
    _, _, eng = _port_run(4)
    want = _port_run(0)[0]["views"]
    state = eng.export_fold_state()
    assert state["shard"]["n_shards"] == 4
    for spec in eng.specs:
        stacked = state["shard"]["tables"][spec.name]
        assert stacked.shape[0] == 4
        merged = owner_gather(list(stacked),
                              state["shard"]["seg_owners"][spec.name])
        assert merged.tobytes() == state["tables"][spec.name].tobytes()
    sources = [state]
    if target:
        sources.append(_port_run(0)[2].export_fold_state())
    for src_state in sources:
        if target:
            eng2 = ShardedViewEngine(eng.specs, n_shards=target,
                                     router=eng.ownership.router,
                                     device="cpu")
        else:
            eng2 = MaterializedViewEngine(eng.specs, device="cpu")
        eng2.restore_fold_state(src_state)
        snap = eng2.snapshot()
        for spec in eng.specs:
            assert snap.view(spec.name).table.tobytes() == want[spec.name]
            if target:
                assert owner_gather(
                    snap.shard_states[spec.name],
                    snap.seg_owners[spec.name]).tobytes() == want[spec.name]
                assert eng2.tree_reduced_table(spec.name).tobytes() == \
                    want[spec.name]


# ----------------------------------------------------------------- cluster
def test_cluster_wires_sharded_plane_and_health_mesh_block():
    """ConcurrentCluster with a sharded engine: ownership aligns to the
    live routing epoch, the warehouse gets shard sub-logs, the views are
    bitwise a rebuild of the committed chunk log, and health() exposes
    the mesh block; an unsharded engine gets the same-shape stub."""
    cfg, src = _workload(n=600, n_partitions=8)
    pipe = DODETLPipeline(cfg, src, n_workers=2, device="cpu")
    eng = ShardedViewEngine(steelworks_views(cfg.n_business_keys),
                            n_shards=2, backend=pipe.backend)
    pipe.extract()
    cluster = ConcurrentCluster(pipe, poll_cdc=False, serving=eng)
    cluster.start()
    cluster.run_until_idle(timeout=60)
    cluster.stop_all()
    eng.fold_pending()
    h = cluster.health()
    assert h["mesh"]["n_shards"] == 2 and not h["mesh"]["device_mesh"]
    assert sum(h["mesh"]["fold_rows"]) > 0
    assert h["mesh"]["fold"]["cycles"] >= 1
    assert h["mesh"]["merge"]["dispatches"] > 0
    assert any(k.startswith("shard.fold_rows") for k in h["counters"])
    _assert_warehouse_shards_partition(pipe, eng)
    rebuilt = MaterializedViewEngine.rebuild(
        eng.specs, pipe.warehouse.read_view().chunks, backend=pipe.backend)
    for name, st in eng.snapshot().states.items():
        assert st.table.tobytes() == rebuilt.view(name).table.tobytes()

    cfg2, src2 = _workload(n=100)
    pipe2 = DODETLPipeline(cfg2, src2, n_workers=1, device="cpu")
    cluster2 = ConcurrentCluster(pipe2, poll_cdc=False,
                                 serving=MaterializedViewEngine(
                                     steelworks_views(cfg2.n_business_keys),
                                     device="cpu"))
    h2 = cluster2.health()
    assert set(h2["mesh"]) == set(h["mesh"])
    assert h2["mesh"]["n_shards"] == 1 and not h2["mesh"]["device_mesh"]


# ------------------------------------------------ one dispatch per fold cycle
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_fold_cycle_is_one_dispatch(n_shards):
    """A fold cycle of 3 deltas into the 4 views at K shards is one
    backend dispatch and one sync on the torch backend (3 x 4 x K masked
    items of one ``fold_segments_many`` call), and its tables are bitwise
    the JAX package's sharded engine's on the same deltas; the backend's
    ``fold_segments_sharded`` is bitwise the reference's."""
    rng = np.random.default_rng(n_shards)
    specs = steelworks_views(16)
    be = get_backend("torch", device=CPU)
    eng = ShardedViewEngine(specs, n_shards=n_shards, backend=be)
    ref = ref_plane.ShardedViewEngine(ref_views.steelworks_views(16),
                                      n_shards=n_shards, backend="numpy")
    deltas = []
    for n in (300, 1, 2100):
        f = np.zeros((n, 10), np.float32)
        f[:, 0] = rng.integers(0, 16, n)
        f[:, 1] = rng.uniform(0, 10000, n)
        f[:, 2] = f[:, 1] + rng.uniform(1, 50, n)
        f[:, 3:7] = rng.uniform(0, 1, (n, 4))
        f[:, 7] = rng.uniform(0, 40, n)
        f[:, 8] = rng.uniform(0, 10, n)
        f[:, 9] = (rng.uniform(0, 1, n) > 0.1).astype(np.float32)
        deltas.append(f)
    for d in deltas:
        eng.publish(d)
        ref.publish(d)
    before = (be.op_dispatches, be.host_syncs)
    eng.fold_pending()
    ref.fold_pending()
    assert (be.op_dispatches - before[0], be.host_syncs - before[1]) == \
        (1, 1)
    assert eng.mesh_report()["fold"]["cycles"] == 1
    s, r = eng.snapshot(), ref.snapshot()
    for spec in specs:
        assert s.view(spec.name).table.tobytes() == \
            r.view(spec.name).table.tobytes(), spec.name
    d, spec = deltas[2], specs[0]
    owners = eng.ownership.seg_owners(spec.name)
    assert be.fold_segments_sharded(
        spec.segments(d), spec.values(d), spec.n_segments, owners,
        n_shards).tobytes() == ref_backend.NumpyBackend(
        ).fold_segments_sharded(spec.segments(d), spec.values(d),
                                spec.n_segments, owners,
                                n_shards).tobytes()


def test_all_foreign_item_is_identity_and_no_dispatch():
    """A masked item whose rows all belong to other shards has no live
    segment: the identity table, and no work (a call of only such items
    makes no dispatch)."""
    be = get_backend("torch", device=CPU)
    vals = np.ones((4, 2), np.float32)
    owners = np.array([0, 0, 1, 0])
    ident = ref_backend.empty_fold_state(4, 2)
    before = be.op_dispatches
    out = be.fold_segments_sharded(np.array([-1, 7]), vals[:2], 4, owners,
                                   2)
    assert be.op_dispatches == before
    assert out[0].tobytes() == out[1].tobytes() == ident.tobytes()
    seg = np.array([0, 1, 1, 3])          # shard 1 owns only segment 2
    out = be.fold_segments_sharded(seg, vals, 4, owners, 2)
    assert be.op_dispatches == before + 1
    assert out[1].tobytes() == ident.tobytes()
    assert out[0].tobytes() == ref_backend.NumpyBackend().fold_segments(
        seg, vals, 4).tobytes()


def test_shard_mesh():
    """``make_shard_mesh`` holds one device per shard; the torch backend
    takes a mesh on its own device (``device_mesh`` then reads true) and
    refuses one that places a shard elsewhere."""
    mesh = make_shard_mesh(4, [CPU] * 4)
    assert mesh_devices(mesh) == 4 and mesh.axis_names == ("shards",)
    be = get_backend("torch", device=CPU)
    eng = ShardedViewEngine(steelworks_views(8), n_shards=4, backend=be)
    be.set_mesh(mesh)
    try:
        assert eng.mesh_report()["device_mesh"]
    finally:
        be.set_mesh(None)
    assert not eng.mesh_report()["device_mesh"]
    with pytest.raises(ValueError):
        be.set_mesh(make_shard_mesh(2, ["cpu", "cuda:1"]))
    with pytest.raises(ValueError):
        make_shard_mesh(0, [])
    with pytest.raises(ValueError):
        make_shard_mesh(3, [CPU] * 2)


# ------------------------------------------------------- the batched gather
def _gather_items(rng, shapes, neg_zero=False):
    """(table, ids) items: tables with empty segments (NaN means) and
    +-inf min/max identities; with ``neg_zero`` a -0.0 sum."""
    items = []
    for S, L, n in shapes:
        table = rng.normal(size=(S, 1 + 3 * L)).astype(np.float32)
        table[:, 0] = rng.integers(0, 9, S)
        table[:S // 3 + 1, 0] = 0.0
        table[0, 1 + L:] = np.concatenate([np.full(L, np.inf),
                                           np.full(L, -np.inf)])
        if neg_zero:
            table[-1, 0], table[-1, 1] = 2.0, -0.0
        items.append((table, rng.integers(0, S, n)))
    return items


@pytest.mark.parametrize("shapes,neg_zero", [
    ([(20, 4, 400)], False),                           # the dashboard's
    ([(20, 4, 100), (20, 4, 120), (20, 4, 80), (20, 4, 100)], False),
    ([(20, 4, 37), (60, 4, 300), (20, 2, 1), (32, 2, 129)], False),
    ([(1, 1, 1), (5, 9, 0), (3000, 3, 4096), (6, 2, 40)], True),  # edges
])
def test_gather_stats_many_ref_bitwise(shapes, neg_zero):
    """``gather_stats_many_ref`` on staged items of mixed widths (the
    dashboard's 400 oee queries, the same over 4 shards, the four views'
    S and L, edge shapes) is bitwise the numpy oracle
    (``_gather_stats_np``) and the Pallas gather in interpret mode, NaN
    means included (the Pallas gather's one-hot product turns a -0.0 sum
    into +0.0, so it is held on tables without one); the torch backend's
    batched call is bitwise the same in one dispatch, the numpy backend's
    in one per item."""
    rng = np.random.default_rng(len(shapes))
    items = _gather_items(rng, shapes, neg_zero)
    words, plan = sk_ops.stage_gather(items)
    assert plan.n_ctas == sum(-(-n // sk_ops.GATHER_ROWS)
                              for _, _, n in shapes)
    flat = sk_ref.gather_stats_many_ref(torch.from_numpy(words), plan)
    got = sk_ops.gather_tables(flat.numpy(), plan)
    be = get_backend("torch", device=CPU)
    before = be.op_dispatches
    batched = be.batch_gather_stats_many(items)
    assert be.op_dispatches == before + 1
    for (table, ids), g, b in zip(items, got, batched):
        want = ref_backend._gather_stats_np(table, ids)
        assert g.tobytes() == b.tobytes() == want.tobytes()
        assert np.isnan(g[:, 1 + 3 * ((table.shape[1] - 1) // 3):][
            table[ids, 0] == 0]).all()
        if len(ids) and len(table) <= 64 and not neg_zero:
            pallas = np.asarray(pallas_gather(jnp.asarray(table), ids,
                                              block=8))
            assert g.tobytes() == pallas.tobytes()
    numpy_be = get_backend("numpy")
    before = numpy_be.op_dispatches
    assert [a.tobytes() for a in numpy_be.batch_gather_stats_many(items)] \
        == [g.tobytes() for g in got]
    assert numpy_be.op_dispatches - before == sum(1 for *_, n in shapes
                                                  if n)


def test_stage_gather_layout_and_checks():
    """One descriptor per CTA of ``GATHER_ROWS`` ids; every table, id list
    and output starts 16-byte aligned and holds its item's bytes; an id
    outside its table raises before anything is staged."""
    rng = np.random.default_rng(5)
    items = _gather_items(rng, [(3, 1, 5), (7, 2, 130), (2, 3, 0)])
    words, plan = sk_ops.stage_gather(items)
    assert plan.n_ctas == 1 + -(-130 // sk_ops.GATHER_ROWS)
    head = words[:sk_ops.GATHER_CTA_WORDS * plan.n_ctas].reshape(
        plan.n_ctas, sk_ops.GATHER_CTA_WORDS)
    assert head.reshape(-1).tolist() == list(plan.head)
    rows = sk_ops.GATHER_ROWS
    assert head[:, 4].tolist() == [5, *[min(rows, 130 - lo)
                                        for lo in range(0, 130, rows)]]
    for (table, ids), (t_off, S, L, i_off, n, o_off) in zip(items,
                                                           plan.items):
        assert t_off % 4 == i_off % 4 == o_off % 4 == 0
        assert words[t_off:t_off + table.size].view(np.float32).tobytes() \
            == table.tobytes()
        assert words[i_off:i_off + n].tolist() == ids.tolist()
    with pytest.raises(ValueError):
        sk_ops.stage_gather([(items[0][0], np.array([3]))])
    with pytest.raises(ValueError):
        sk_ops.stage_gather([(items[0][0], np.array([-1]))])
    with pytest.raises(ValueError):
        get_backend("torch", device=CPU).batch_gather_stats(
            items[1][0], np.array([0, 7]))
