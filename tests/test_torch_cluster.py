"""The port's concurrent runtime (``repro_torch.runtime.cluster``) on the
CPU: tests/test_concurrent_runtime.py mirrored with the torch backend
(every kernel wrapper runs its plain version), plus the cross-package
legs — the port cluster's warehouse against the reference package's
numpy sequential oracle on the same seed. The card runs of the same
cluster are in tests/test_torch_cuda.py and chip_smoke.py."""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import repro.configs.dod_etl as ref_cfg
import repro.core as ref_core
import repro.data.sampler as ref_sampler
import repro.runtime.cluster as ref_cluster
from repro_torch.configs.dod_etl import steelworks_config
from repro_torch.core import DODETLPipeline, SourceDatabase
from repro_torch.core.message_queue import MessageQueue, TopicConfig
from repro_torch.core.records import make_batch
from repro_torch.data.sampler import SamplerConfig, SteelworksSampler
from repro_torch.runtime.cluster import ConcurrentCluster, SimulatedCluster
from repro_torch.serving import MaterializedViewEngine, steelworks_views


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Five workers' stage threads each driving torch's CPU pool would
    oversubscribe the cores; one intra-op thread per call keeps the
    stage threads the unit of parallelism."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(n_workers, n_records=3000, n_partitions=8, late_frac=0.05,
          buffer_capacity=1024):
    cfg = steelworks_config(n_partitions=n_partitions)
    cfg = dataclasses.replace(cfg, buffer_capacity=buffer_capacity)
    src = SourceDatabase()
    sampler = SteelworksSampler(cfg, SamplerConfig(
        records_per_table=n_records, n_equipment=n_partitions,
        late_master_frac=late_frac))
    pipe = DODETLPipeline(cfg, src, n_workers=n_workers, device="cpu")
    return cfg, src, sampler, pipe


def sequential_oracle(n_records, n_partitions=8, late_frac=0.05):
    _, src, sampler, pipe = build(1, n_records, n_partitions, late_frac)
    sampler.generate(src)
    pipe.extract()
    pipe.bootstrap_caches()
    pipe.run_to_completion()
    return pipe


def reference_oracle(n_records, n_partitions=8, late_frac=0.05):
    """tests/test_concurrent_runtime.py's ``sequential_oracle``: the
    reference package, numpy backend, one worker, same seed."""
    cfg = ref_cfg.steelworks_config(n_partitions=n_partitions,
                                    backend="numpy")
    cfg = dataclasses.replace(cfg, buffer_capacity=1024)
    src = ref_core.SourceDatabase()
    ref_sampler.SteelworksSampler(cfg, ref_sampler.SamplerConfig(
        records_per_table=n_records, n_equipment=n_partitions,
        late_master_frac=late_frac)).generate(src)
    pipe = ref_core.DODETLPipeline(cfg, src, n_workers=1)
    pipe.extract()
    pipe.bootstrap_caches()
    pipe.run_to_completion()
    return pipe


def run_pre_extracted(n_workers, n, serving=None, **kw):
    _, src, sampler, pipe = build(n_workers, n, **kw)
    sampler.generate(src)
    pipe.extract()                      # everything queued before start
    cluster = ConcurrentCluster(pipe, poll_cdc=False, serving=serving)
    cluster.start()
    done = cluster.run_until_idle(timeout=60)
    cluster.stop_all()
    return pipe, cluster, done


def test_concurrent_byte_identical_to_sequential():
    """N concurrent workers produce a warehouse byte-identical to the
    single-worker sequential pipeline (pre-extracted stream, so both runs
    join every record against the same master versions)."""
    n = 3000
    pipe, cluster, done = run_pre_extracted(4, n)
    assert done == n
    assert pipe.warehouse.rows_loaded == n
    a = pipe.warehouse.canonical_fact_table()
    b = sequential_oracle(n).warehouse.canonical_fact_table()
    assert a.shape == b.shape
    assert a.tobytes() == b.tobytes()   # literally byte-identical
    # off the card the runtime enters no CUDA stream
    assert all(rt.stream is None for rt in cluster.runtimes.values())


def test_cluster_byte_identical_to_reference_oracle():
    """Cross-package: the port's 4-worker cluster gives the reference's
    numpy sequential oracle's canonical fact table byte for byte, and its
    full rescan (``kpi_rollup``, the segment_rollup plain version) is
    within the reference's rollup tolerance of the reference's."""
    n = 1000
    pipe, _, done = run_pre_extracted(4, n)
    ref = reference_oracle(n)
    assert done == n == ref.warehouse.rows_loaded
    assert pipe.warehouse.canonical_fact_table().tobytes() == \
        ref.warehouse.canonical_fact_table().tobytes()
    np.testing.assert_allclose(
        pipe.warehouse.kpi_rollup(8),
        ref.warehouse.kpi_rollup(8, backend="numpy"), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pipe.warehouse.kpi_running(),
                               pipe.warehouse.kpi_rollup(8), rtol=0,
                               atol=1e-4)


def test_cluster_with_views_matches_rebuild():
    """The serving engine's fold thread runs beside the workers; its
    final tables are the byte-identical rebuild of the loaded chunks."""
    n = 2000
    engine = MaterializedViewEngine(steelworks_views(8), device="cpu")
    pipe, cluster, done = run_pre_extracted(3, n, serving=engine)
    assert done == n
    snap = engine.snapshot()
    assert snap.rows_folded == n
    rebuilt = MaterializedViewEngine.rebuild(
        engine.specs, pipe.warehouse.read_view().chunks,
        backend=engine.backend)
    for name, st in snap.states.items():
        assert rebuilt.states[name].table.tobytes() == st.table.tobytes()
    rep = cluster.report()
    assert rep["serving"]["rows_folded"] == n
    assert rep["serving"]["staleness_p50_ms"] > 0


def test_failover_under_load_loses_no_records():
    """§4.1.3 drill, for real: kill 2 of 5 workers while the feeder is
    still writing and the cluster is mid-stream; then scale back up. Zero
    records lost, zero duplicated, zero buffer drops."""
    n = 6000
    _, src, sampler, pipe = build(5, n, n_partitions=10,
                                  buffer_capacity=8192)
    feeder = threading.Thread(target=lambda: sampler.generate(src))
    cluster = ConcurrentCluster(pipe)
    cluster.start()
    feeder.start()
    time.sleep(0.15)                     # mid-run, under load
    redump = cluster.fail_workers(["w1", "w3"])
    assert redump >= 0.0
    assert sorted(cluster.alive_workers()) == ["w0", "w2", "w4"]
    time.sleep(0.1)
    cluster.scale_to(4)                  # elastic recovery, still streaming
    feeder.join(60)
    assert not feeder.is_alive()
    done = cluster.run_until_idle(timeout=90)
    cluster.stop_all()

    assert done == n
    assert pipe.warehouse.rows_loaded == n         # no loss, no duplicates
    drops = sum(rt.worker.buffer.dropped for rt in cluster.runtimes.values())
    assert drops == 0

    # same record set as the oracle: identity columns (equipment, window)
    # must match exactly; KPI columns may differ where a record was joined
    # against an earlier (still-correct) master version mid-stream
    oracle = sequential_oracle(n, n_partitions=10)
    a = pipe.warehouse.canonical_fact_table()
    b = oracle.warehouse.canonical_fact_table()
    assert a.shape == b.shape
    order = lambda t: t[np.lexsort((t[:, 2], t[:, 1], t[:, 0]))]
    np.testing.assert_array_equal(order(a)[:, :3], order(b)[:, :3])
    assert (a[:, -1] > 0.5).all()                  # every fact valid


def test_concurrent_scale_up_mid_stream():
    """Start with 1 worker, scale to 3 mid-run; the stream completes and
    newly added workers actually take over partitions."""
    n = 4000
    _, src, sampler, pipe = build(1, n, buffer_capacity=8192)
    feeder = threading.Thread(target=lambda: sampler.generate(src))
    cluster = ConcurrentCluster(pipe)
    cluster.start()
    feeder.start()
    time.sleep(0.1)
    cluster.scale_to(3)
    feeder.join(60)
    assert not feeder.is_alive()
    done = cluster.run_until_idle(timeout=60)
    cluster.stop_all()
    assert done == n
    assert len(cluster.alive_workers()) == 3
    owners = set(cluster.assignment.assignment.values())
    assert len(owners) == 3              # every worker owns partitions


def test_freshness_percentiles_recorded():
    """Every loaded record contributes one end-to-end freshness sample;
    percentiles are ordered and positive."""
    n = 2000
    _, src, sampler, pipe = build(2, n)
    sampler.generate(src)
    cluster = ConcurrentCluster(pipe)
    cluster.start()
    done = cluster.run_until_idle(timeout=60)
    cluster.stop_all()
    assert done == n
    lat = cluster.freshness()
    assert lat["n"] == n
    assert 0.0 < lat["p50_ms"] <= lat["p95_ms"] <= lat["p99_ms"]


def test_simulated_cluster_matches_reference():
    """The round-based runtime: same records per round and same facts as
    the reference's ``SimulatedCluster`` on the numpy backend, through a
    mid-run failure."""
    n = 800
    _, src, sampler, pipe = build(3, n)
    sampler.generate(src)
    pipe.extract()
    pipe.bootstrap_caches()
    ref = ref_core.DODETLPipeline(
        dataclasses.replace(ref_cfg.steelworks_config(n_partitions=8,
                                                      backend="numpy"),
                            buffer_capacity=1024),
        ref_core.SourceDatabase(), n_workers=3)
    ref_sampler.SteelworksSampler(ref.cfg, ref_sampler.SamplerConfig(
        records_per_table=n, n_equipment=8,
        late_master_frac=0.05)).generate(ref.source)
    ref.extract()
    ref.bootstrap_caches()
    sims = [SimulatedCluster(pipe), ref_cluster.SimulatedCluster(ref)]
    for r in range(6):
        if r == 2:
            for sim in sims:
                sim.fail_workers(["w1"])
        got = [sim.run_round(50).records for sim in sims]
        assert got[0] == got[1]
    assert pipe.warehouse.canonical_fact_table().tobytes() == \
        ref.warehouse.canonical_fact_table().tobytes()


def test_fetch_many_positions_vs_commits():
    """The broker's read-position / committed-offset split: fetch advances
    the position (no re-reads), commit is durable progress, and an
    abandoned read-ahead rewinds to the committed offset."""
    q = MessageQueue()
    q.create_topic(TopicConfig("t", 0, 2, "business_key"))
    n = 100
    q.publish("t", make_batch(0, 0, np.arange(n), np.arange(n),
                              np.arange(n), np.zeros((n, 8), np.float32)))
    batch1, counts1 = q.fetch_many("g", "t", [0, 1])
    assert sum(counts1.values()) == n
    batch2, counts2 = q.fetch_many("g", "t", [0, 1])
    assert not counts2
    assert all(q.committed("g", "t", p) == 0 for p in (0, 1))
    for p in (0, 1):
        q.rewind("g", "t", p)
    batch3, counts3 = q.fetch_many("g", "t", [0, 1])
    assert sum(counts3.values()) == n
    np.testing.assert_array_equal(np.sort(batch3.row_key),
                                  np.sort(batch1.row_key))
    for p, c in counts3.items():
        q.commit("g", "t", p, c)
        q.rewind("g", "t", p)
    _, counts4 = q.fetch_many("g", "t", [0, 1])
    assert not counts4


def test_concurrent_commits_are_exact():
    """Offset commits from many threads never lose an increment."""
    q = MessageQueue()
    q.create_topic(TopicConfig("t", 0, 1, "business_key"))
    per_thread, n_threads = 500, 8

    def worker():
        for _ in range(per_thread):
            q.commit("g", "t", 0, 1)

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert q.committed("g", "t", 0) == per_thread * n_threads


def test_launch_counter_is_exact_under_threads():
    """The wrappers' launch counters take one lock: eight threads adding
    concurrently (with a tiny switch interval to force interleaving) lose
    no count."""
    import sys
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels._build import count_launch
    from repro_torch.kernels.segment_kpi import ops as sk_ops
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reset_launch_counts()
        threads = [threading.Thread(target=lambda: [
            count_launch(sk_ops.launches, "segment_rollup")
            for _ in range(2000)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert launch_counts()["segment_rollup"] == 16000
    finally:
        sys.setswitchinterval(old)
        reset_launch_counts()      # CPU runs launch nothing: back to zero


def test_cdc_event_times_monotonic():
    """Event-time stamps are assigned at CDC append and are non-decreasing
    in LSN order — the foundation of the freshness metric."""
    src = SourceDatabase()
    for i in range(5):
        src.apply(make_batch(0, 0, np.arange(3) + 3 * i, np.zeros(3),
                             np.zeros(3), np.zeros((3, 8), np.float32)))
    lsns = np.arange(src.log.next_lsn)
    stamps = src.log.event_times(lsns)
    assert len(stamps) == 15
    assert (np.diff(stamps) >= 0).all()
    assert (stamps <= src.log.clock()).all()
