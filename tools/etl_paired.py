#!/usr/bin/env python3
"""Paired, interleaved runs of the ETL main path on one NVIDIA card: two
checkouts of the repository (say, a change and its parent) measured in
turns inside one machine, so their difference is not the difference
between two cards or two hosts.

    python3 tools/etl_paired.py --tree parent=DIR --tree change=DIR \\
        --order parent,change,change,parent,parent,change \\
        --out build/etl_paired.json [--profile]

Each entry of ``--order`` is one fresh process that imports that tree's
own ``chip_smoke.py`` and ``src/repro_torch`` (so each tree runs its own
code and builds its own kernels, into its own ``build/``), warms the path
up once, then measures:

- phase 3: the sequential steelworks loop (20,000 records per table, 5
  workers, the four views, 200 records per partition per step) —
  records/s of streaming, backend dispatches and host syncs, launches
  per kernel;
- phase 5a: the concurrent cluster on the pre-extracted stream —
  records/s, freshness and report staleness p50/p95, the ``serving.fold``
  and ``transform.dispatch`` spans (count, summed thread-seconds),
  launches per kernel;
- the dashboard's query batch (phase 3's 403 queries: 400 oee point
  queries and three shared reports) answered by ``QueryPlan.execute``
  against phase 3's final epoch, as it is and with its tables split
  over 4 shards (a snapshot carrying shard-local tables, as a sharded
  engine publishes; the tree's own router sends each point query to its
  owning shard): host ms per batch (median of 50), gather launches,
  backend dispatches and host syncs per batch, and the CUDA runtime calls
  of 10 batches under ``torch.profiler``;
- with ``--profile``, under ``torch.profiler``: 20 transforms
  (``TorchBackend.transform_block`` at the steelworks shapes: a 1000-row
  payload, padded to 1024, against caches of 20 and 2,000 keys in 4096
  slots, 20 units) with their ``to_host`` — the CUDA runtime calls of
  each kind (stream, event and device synchronisations, async copies,
  kernel launches) and each CUDA kernel's count and mean device time in
  us; and 10 full rescans (``segment_rollup`` of a seeded 2^20-row fact
  table, 20 units) — each kernel's count and mean device time in us.

Every run prints one JSON line; the parent process prints and writes the
per-tree medians, with the card's name and power limit. Exits non-zero
without CUDA.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

NUMERIC = ("seq_records_s", "seq_dispatches", "seq_host_syncs",
           "clu_records_s", "clu_fresh_p50_ms", "clu_fresh_p95_ms",
           "clu_stale_p50_ms", "clu_stale_p95_ms", "clu_fold_spans",
           "clu_fold_s", "clu_transform_s", "clu_fold_launches",
           "clu_probe_launches", "seq_fold_launches", "seq_probe_launches",
           "q1_ms", "q1_launches", "q1_dispatches", "q1_syncs",
           "q4_ms", "q4_launches", "q4_dispatches", "q4_syncs")
GATHER = ("gather_stats", "gather_stats_many")
FOLD = ("fold_segments", "fold_segments_many")
PROBE = ("hash_join", "hash_join_pair", "transform_kpi")
RUNTIME = ("cudaStreamSynchronize", "cudaEventSynchronize",
           "cudaDeviceSynchronize", "cudaMemcpyAsync", "cudaLaunchKernel",
           "cudaEventRecord", "cudaEventQuery", "cudaHostAlloc")


def _profile(run):
    """(runtime call counts, {kernel: (count, mean us)}) of ``run()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    calls = {k: 0 for k in RUNTIME}
    kernels = {}
    for e in prof.events():
        if e.name in calls:
            calls[e.name] += 1
        if e.device_type == torch.autograd.DeviceType.CUDA:
            c, t = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (c + 1, t + e.time_range.end
                               - e.time_range.start)
    return calls, {k: (c, t / c) for k, (c, t) in kernels.items()}


def profile_kernels() -> dict:
    """The transforms and rescans of ``--profile`` on this process's
    tree."""
    import numpy as np
    import torch
    from repro_torch.core.backend import get_backend
    from repro_torch.core.cache import InMemoryTable
    from repro_torch.kernels.segment_kpi import ops
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    be = get_backend("torch", device=dev)
    tables, keys = [], []
    for n_keys in (20, 2000):
        tbl = InMemoryTable(4096, backend=be)
        k = rng.choice(10**6, n_keys, replace=False).astype(np.int64)
        tbl.upsert(k, np.abs(rng.normal(size=(n_keys, 8))).astype(
            np.float32), rng.integers(0, 10**6, n_keys))
        tables.append(tbl)
        keys.append(k)
    prod = np.abs(rng.normal(size=(1000, 8))).astype(np.float32) * 10
    prod[:, 1] = rng.choice(keys[0], 1000)
    prod[:, 0] = rng.choice(keys[1], 1000)

    def transforms(n):
        for _ in range(n):
            be.transform_block(prod, *tables, n_units=20).to_host()
    transforms(5)
    t_calls, t_kernels = _profile(lambda: transforms(20))
    facts = torch.tensor(rng.random((1 << 20, 10), dtype=np.float32),
                         device=dev)
    facts[:, 0] = torch.tensor(rng.integers(0, 20, 1 << 20),
                               dtype=torch.float32, device=dev)

    def rescans(n):
        for _ in range(n):
            ops.segment_rollup(facts, 20)
    rescans(3)
    _, r_kernels = _profile(lambda: rescans(10))
    return {"transform_x20_runtime_calls": t_calls,
            "transform_x20_kernels_us": t_kernels,
            "rescan_2p20_x10_kernels_us": r_kernels}


def query_batches(engine, dashboard) -> dict:
    """The dashboard's batch against ``engine``'s epoch, unsharded and
    over 4 shards (see the module docstring)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.backend import empty_fold_state
    from repro_torch.kernels import launch_counts
    from repro_torch.serving import ReportSnapshot, compile_queries
    from repro_torch.serving.engine import EpochSnapshot

    @dataclasses.dataclass(frozen=True)
    class Sharded(EpochSnapshot):
        shard_states: dict = dataclasses.field(default_factory=dict)
        seg_owners: dict = dataclasses.field(default_factory=dict)

    snap, be = engine.snapshot(), engine.backend
    states, owners = {}, {}
    for name, st in snap.states.items():
        S, W = st.table.shape
        owners[name] = np.arange(S) * 4 // S
        ident = empty_fold_state(S, (W - 1) // 3)
        states[name] = tuple(np.where(owners[name][:, None] == k, st.table,
                                      ident) for k in range(4))
    sharded = Sharded(epoch=snap.epoch, states=snap.states,
                      published_at=snap.published_at,
                      watermark_event_time=snap.watermark_event_time,
                      rows_folded=snap.rows_folded,
                      deltas_folded=snap.deltas_folded,
                      shard_states=states, seg_owners=owners)
    plan = compile_queries(dashboard)
    out = {}
    for label, s in (("q1", snap), ("q4", sharded)):
        rsnap = ReportSnapshot(s, be)
        for _ in range(5):
            plan.execute(rsnap)
        torch.cuda.synchronize()
        g0 = sum(launch_counts().get(k, 0) for k in GATHER)
        d0, h0 = be.op_dispatches, be.host_syncs
        times = []
        for _ in range(50):
            t0 = time.perf_counter()
            plan.execute(rsnap)
            times.append((time.perf_counter() - t0) * 1e3)
        out.update({
            f"{label}_ms": statistics.median(times),
            f"{label}_launches": (sum(launch_counts().get(k, 0)
                                      for k in GATHER) - g0) / 50,
            f"{label}_dispatches": (be.op_dispatches - d0) / 50,
            f"{label}_syncs": (be.host_syncs - h0) / 50,
            f"{label}_x10_runtime_calls": _profile(
                lambda: [plan.execute(rsnap) for _ in range(10)])[0]})
    return out


def one_run(tree: Path, profile: bool) -> dict:
    """Measure phases 3 and 5a of ``tree`` in this process (and the
    ``--profile`` runs)."""
    sys.path.insert(0, str(tree))
    import chip_smoke as cs            # the tree's own script and package
    card = cs.phase_card()
    from repro_torch.core.backend import get_backend
    from repro_torch.kernels import launch_counts, reset_launch_counts
    cs.run_main_path("cuda")           # warm-up: libraries, caches, pools
    reset_launch_counts()
    get_backend("torch", device="cuda").reset_stats()   # one per device
    pipe, engine, _, secs = cs.run_main_path("cuda")
    seq = launch_counts()
    out = {"tree": str(tree), "card": card,
           "seq_records_s": pipe.warehouse.rows_loaded / secs,
           "seq_dispatches": pipe.backend.op_dispatches,
           "seq_host_syncs": pipe.backend.host_syncs,
           "seq_fold_launches": sum(seq.get(k, 0) for k in FOLD),
           "seq_probe_launches": sum(seq.get(k, 0) for k in PROBE),
           "seq_launches": seq,
           **query_batches(engine, cs.dashboard_queries())}
    cs.run_cluster_pre_extracted()     # warm-up of the cluster path
    reset_launch_counts()
    pipe, _, rep, _, _, spans = cs.run_cluster_pre_extracted()
    clu = launch_counts()
    per = spans["per_name"]
    out.update({
        "clu_records_s": rep["records_s"],
        "clu_fresh_p50_ms": rep["p50_ms"], "clu_fresh_p95_ms": rep["p95_ms"],
        "clu_stale_p50_ms": rep["serving"]["staleness_p50_ms"],
        "clu_stale_p95_ms": rep["serving"]["staleness_p95_ms"],
        "clu_fold_spans": per.get("serving.fold", (0, 0.0))[0],
        "clu_fold_s": per.get("serving.fold", (0, 0.0))[1],
        "clu_transform_s": per.get("transform.dispatch", (0, 0.0))[1],
        "clu_fold_launches": sum(clu.get(k, 0) for k in FOLD),
        "clu_probe_launches": sum(clu.get(k, 0) for k in PROBE),
        "clu_launches": clu})
    if profile:
        out["profile"] = profile_kernels()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="label=DIR of a checkout (repeat)")
    ap.add_argument("--order", help="comma-separated labels, one run each")
    ap.add_argument("--out", default="build/etl_paired.json")
    ap.add_argument("--profile", action="store_true",
                    help="also profile transforms and 2^20-row rescans")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print("RUN " + json.dumps(one_run(Path(args.one).resolve(),
                                          args.profile)))
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("etl_paired: needs a CUDA card")
    trees = dict(t.split("=", 1) for t in args.tree)
    runs = []
    for label in args.order.split(","):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, __file__, "--one",
                               trees[label]] + ["--profile"] * args.profile,
                              capture_output=True, text=True, timeout=900)
        line = [l for l in proc.stdout.splitlines() if l.startswith("RUN ")]
        if proc.returncode or not line:
            sys.exit(f"etl_paired: the {label} run failed:\n"
                     f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        run = {"label": label, **json.loads(line[-1][4:]),
               "process_s": time.perf_counter() - t0}
        runs.append(run)
        print(json.dumps({k: run[k] for k in (
            "label", "card", *NUMERIC, "q1_x10_runtime_calls",
            "q4_x10_runtime_calls", "profile") if k in run}),
              flush=True)
    medians = {label: {k: statistics.median(r[k] for r in runs
                                            if r["label"] == label)
                       for k in NUMERIC}
               for label in dict.fromkeys(args.order.split(","))}
    result = {"card": runs[0]["card"], "order": args.order,
              "medians": medians, "runs": runs}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({"card": result["card"], "medians": medians}))


if __name__ == "__main__":
    main()
