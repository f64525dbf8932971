"""The paper's case study (§4): OEE reporting for a steelworks, including
the fault-tolerance drill (§4.1.3) and the ISA-95 complex-model comparison
(§4.1.4). The steady-state + failure phases run on the genuinely
concurrent cluster runtime (one executor per worker, live CDC polling,
end-to-end freshness percentiles) with the BI serving layer attached:
shift reports are answered from incrementally maintained materialized
views — O(n_units) per query, snapshot-isolated from the loading workers —
while the cluster is mid-run, each stamped with its report staleness; a
dashboard-refresh burst is then served through the batched query plane
(admission-coalesced, one vectorized gather dispatch per view).

Runs on the CUDA card unless asked otherwise (the first launch builds the
kernels with nvcc); ``--device cpu`` runs every kernel's plain version:

    PYTHONPATH=src python -m repro_torch.examples.steelworks_etl
    PYTHONPATH=src python -m repro_torch.examples.steelworks_etl --device cpu
"""
import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs.dod_etl import steelworks_config
from repro_torch.core import DODETLPipeline, SourceDatabase
from repro_torch.data.sampler import SamplerConfig, SteelworksSampler
from repro_torch.runtime.cluster import ConcurrentCluster
from repro_torch.serving import (BatchedReportServer, MaterializedViewEngine,
                                 ReportQuery, ReportServer, ReportSnapshot,
                                 steelworks_views)


def run_plant(complex_model: bool, join_depth: int, n=8_000,
              device: str = "cuda"):
    cfg = steelworks_config(n_partitions=20, complex_model=complex_model)
    src = SourceDatabase()
    SteelworksSampler(cfg, SamplerConfig(
        records_per_table=n, n_equipment=20)).generate(src)
    pipe = DODETLPipeline(cfg, src, n_workers=5, join_depth=join_depth,
                          device=device)
    if complex_model:
        pipe.extract()
        pipe.bootstrap_caches()
    return cfg, pipe


def main(device: str = "cuda"):
    # ---- normal operation (simple process-specific model), live cluster
    # with the serving layer folding report views as workers load
    cfg, pipe = run_plant(False, 1, device=device)
    engine = MaterializedViewEngine(steelworks_views(20),
                                    backend=pipe.backend)
    engine.prewarm()
    # run the fused transform+rollup once per bucket too, so the kernels
    # are built and the steady-state window below shows streaming
    if pipe.backend.device:
        w0 = pipe.workers[0]
        for size in (128, 256, 512, 1024):
            dummy = np.full((size, 8), -1.0, np.float32)
            pipe.backend.transform_and_rollup(
                dummy, w0.equipment, w0.quality,
                n_units=cfg.n_business_keys).to_host()
    server = ReportServer(engine)
    cluster = ConcurrentCluster(pipe, max_records_per_partition=200,
                                serving=engine)
    cluster.start()
    deadline = time.time() + 30          # wait out warm-up, then let
    while (cluster.records_done() < 2000                 # the stream and
           or engine.snapshot().epoch == 0) \
            and time.time() < deadline:                  # the fold cycle
        time.sleep(0.05)                 # reach steady state

    # ---- mid-run shift reports: the cluster is still loading, yet every
    # query reads one pinned epoch (no torn aggregates, no blocking)
    snap = server.snapshot()
    shift = snap.shift_report()
    top = snap.top_downtime(3)
    print(f"mid-run shift report @ epoch {shift.epoch} covering "
          f"{shift.rows} facts, staleness {shift.staleness_ms:.0f} ms")
    print("  worst downtime units: " + ", ".join(
        f"#{u} ({d:.0f}s off)" for u, d in
        zip(top.data['unit'], top.data['downtime_s'])))
    rep = cluster.report()
    sv = rep["serving"]
    print(f"steady state: {rep['records_s']:,.0f} records/s on "
          f"{rep['n_workers']} workers; freshness p50/p95 = "
          f"{rep['p50_ms']:.0f}/{rep['p95_ms']:.0f} ms; report staleness "
          f"p50/p95 = {sv['staleness_p50_ms']:.0f}/"
          f"{sv['staleness_p95_ms']:.0f} ms")

    # ---- one health() call: the unified observability plane. Per-worker
    # load, stage-queue depths, commit lag, freshness/staleness
    # percentiles and the merged counter registry, collected lock-free at
    # one instant — the observation vector an autoscaling controller (or
    # a wallboard) polls while the data plane keeps streaming.
    hp = cluster.health()
    busiest, bw = max(hp["workers"].items(),
                      key=lambda kv: kv[1]["records_done"])
    lag = hp["backlog"]
    c = hp["counters"]
    published = sum(v for k, v in c.items()
                    if k.startswith("broker.") and k.endswith(".published"))
    print(f"health @ {hp['wall_s']:.1f}s: backlog "
          f"{lag['operational_lag']} uncommitted + {lag['buffered']} "
          f"late-buffered; routing epoch {hp['routing_epoch']}; serving "
          f"epoch {hp['serving']['epoch']} "
          f"({hp['serving']['pending_deltas']} deltas pending)")
    print(f"  busiest worker {busiest}: {bw['records_done']} done @ "
          f"{bw['throughput_rps']:,.0f} rps, queues t/l "
          f"{bw['transform_q']}/{bw['load_q']}, "
          f"{bw['cache_rows']} cached master rows, partitions "
          f"{bw['partitions'][:4]}{'...' if len(bw['partitions']) > 4 else ''}")
    print(f"  counters: {published} broker msgs, cache hit/miss "
          f"{c.get('worker.cache_hits', 0)}/"
          f"{c.get('worker.cache_misses', 0)}")

    # ---- §4.1.3 failure drill: two workers die mid-shift, under load
    redump = cluster.fail_workers(["w1", "w3"])
    print(f"2/5 workers failed; partitions reassigned incrementally, "
          f"caches re-dumped in {redump * 1e3:.1f} ms")
    done = cluster.run_until_idle()
    cluster.stop_all()                   # folds the remaining view backlog
    rep = cluster.report()
    sv = rep["serving"]
    print(f"post-failure: {rep['records_s']:,.0f} records/s on "
          f"{rep['n_workers']} workers; stream completed, "
          f"{pipe.warehouse.rows_loaded} facts loaded, zero lost; views "
          f"at epoch {sv['epoch']} cover {sv['rows_folded']} facts")

    # ---- the BI deliverable: near-real-time OEE per equipment unit, all
    # 20 queries answered from ONE pinned epoch (mutually consistent)
    snap = server.snapshot()
    worst = min(range(20), key=lambda e: snap.oee(e).data["oee"])
    k = snap.oee(worst).data
    print(f"lowest-OEE unit: #{worst} OEE={k['oee']:.3f} "
          f"(A={k['availability']:.2f} P={k['performance']:.2f} "
          f"Q={k['quality']:.2f}) -> maintenance ticket")
    # the incremental answer is the full-rescan answer
    scan = pipe.warehouse.query_oee(worst)
    assert abs(k["oee"] - scan["oee"]) < 1e-4
    # ... and the per-unit KPI aggregate the fused transform+rollup
    # dispatches fed at load time reproduces the rescan in O(1): the hot
    # path never re-uploads a fact block for a separate rollup dispatch.
    # The rescan itself runs on the pipeline's backend (the segment_rollup
    # kernel on the card).
    running = pipe.warehouse.kpi_running()
    full = pipe.warehouse.kpi_rollup(20)
    assert running is not None and np.allclose(running, full, atol=1e-2)
    print(f"running KPI aggregate (O(1), fused rollups) matches the "
          f"full rescan over {pipe.warehouse.rows_loaded} facts")

    # ---- dashboard refresh burst: a wallboard redraw is hundreds of tiny
    # queries arriving at once. The batched front coalesces them, pins
    # each to the epoch current at admission, and answers all point
    # queries against a view in ONE vectorized gather dispatch — same
    # bytes as asking the snapshot one query at a time.
    engine.prewarm_read(batch_buckets=(512,))   # warm the gather shape
    front = BatchedReportServer(server, max_batch=4096, max_wait_ms=2.0)
    front.start()
    burst = [ReportQuery("oee", unit=u) for u in range(20)] * 20 \
        + [ReportQuery("top_downtime", k=3), ReportQuery("shift_report"),
           ReportQuery("production_rate")] * 4
    t0 = time.perf_counter()
    tickets = [front.submit(q) for q in burst]
    answers = [t.result(timeout=5.0) for t in tickets]
    burst_ms = (time.perf_counter() - t0) * 1e3
    front.stop()
    st = front.stats()
    # batched answer == the per-query snapshot answer, same epoch or newer
    fresh = ReportSnapshot(tickets[0].snapshot, engine.backend)
    assert answers[0].data["oee"] == fresh.oee(0).data["oee"] \
        or np.isnan(answers[0].data["oee"])
    print(f"dashboard burst: {len(burst)} queries answered in "
          f"{burst_ms:.1f} ms ({len(burst) / burst_ms * 1e3:,.0f} qps) "
          f"across {st['batches']} coalesced batch(es), "
          f"mean batch {st['mean_batch']:.0f}")

    # ---- skewed shift: one hot caster + many cold finishing lines.
    # Real plants are Zipf-skewed — the caster emits most events. Static
    # hash%n pins its keys to fixed partitions (one worker drowns, the
    # rest idle); the skew-aware strategy watches the broker's per-key
    # load and repartitions MID-RUN: hot hash ranges split away, caches
    # migrate surgically (survivors stay warm), and per-worker load
    # evens out. Records keep flowing throughout — routing epochs keep
    # every already-published record readable.
    skew_cfg = steelworks_config(n_partitions=20, partition_strategy="skew")
    skew_cfg = dataclasses.replace(skew_cfg, n_business_keys=100,
                                   buffer_capacity=32768)
    src2 = SourceDatabase()
    sampler2 = SteelworksSampler(skew_cfg, SamplerConfig(
        records_per_table=1000, n_equipment=100, zipf_s=1.2))
    sampler2.generate(src2)
    pipe_sk = DODETLPipeline(skew_cfg, src2, n_workers=4, device=device)
    pipe_sk.extract()
    pipe_sk.bootstrap_caches()

    def shares(counts):
        tot = max(sum(counts.values()), 1)
        return " ".join(f"{w}:{100 * c / tot:.0f}%"
                        for w, c in sorted(counts.items()))

    for _ in range(3):                   # shift starts under equal ranges
        sampler2.generate(src2, n_per_table=1000, tables=("production",))
        pipe_sk.extract()
        pipe_sk.step(200)
    pre = {w.name: w.metrics.records for w in pipe_sk.workers}
    mig = pipe_sk.repartition()          # coordinator reads its own load
    for _ in range(5):                   # metrics, splits the hot ranges
        sampler2.generate(src2, n_per_table=1000, tables=("production",))
        pipe_sk.extract()
        pipe_sk.step(200)
    pipe_sk.run_to_completion()
    post = {w.name: w.metrics.records - pre[w.name]
            for w in pipe_sk.workers}
    print(f"skewed shift (hot caster, Zipf 1.2): per-worker share "
          f"before adaptation  {shares(pre)}")
    print(f"  after skew-aware repartition (epoch {mig['epoch']})      "
          f"{shares(post)}")
    print(f"  surgical cache migration kept "
          f"{100 * mig['cache_retention']:.0f}% of cached master rows "
          f"({mig['retained_rows']} retained, {mig['gained_rows']} dumped "
          f"for gained keys only)")

    # ---- §4.1.4: the ISA-95 generalized model costs throughput
    t0 = time.perf_counter()
    cfg2, pipe2 = run_plant(True, 8, n=2_000, device=device)
    done = pipe2.run_to_completion()
    complex_rate = done / (time.perf_counter() - t0)
    print(f"ISA-95-style normalized model: {complex_rate:,.0f} records/s "
          f"(deep join chains; paper measured 10,090 -> 230)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    main(ap.parse_args().device)
