#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (no fallback to the CPU):

1. card: name and power limit (nvidia-smi); build the CUDA kernels from
   the checkout's sources (nvcc, one process per source) and time it;
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the main path's shapes — hash_join, fold_segments and
   gather_stats bitwise, segment_kpi facts within 1e-5 and its rollup
   within 1e-4 — with each kernel's device time and its plain version's
   (calls captured in a CUDA graph, replays timed with CUDA events), the
   wrapper's host-issued time per call, and the kernel's bound (the larger
   of the bytes this run's inputs need / 3.35 TB/s and fp32 operations /
   67 TFLOP/s, an H100 SXM's published peaks);
3. main path: the paper's steelworks deployment (20 partitions, 20 units,
   5 workers, 20,000 records per table) through ``DODETLPipeline`` with
   the serving views attached, micro-batches of 200 records per partition
   until drained, then a dashboard batch through ``compile_queries`` —
   run on the card and again on the CPU (plain versions), the results
   held against each other;
4. launch counts: every kernel must have launched on the main path; the
   hash join is checked bitwise once more on the main path's own caches,
   at the slot counts they reached.

The line before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX and nothing of
the JAX package.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.modules["jax"] = None          # the port must never need these
sys.modules["repro"] = None

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12            # H100 SXM, outside the tensor cores
N_UNITS = 20


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def issue_ms(fn, reps: int = 50, rounds: int = 5) -> float:
    """Median per-call milliseconds of ``fn`` over ``rounds`` CUDA-event
    timed runs of ``reps`` calls issued back to back by the host, after a
    warm-up. For a launch this short the host's issue time dominates."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median device milliseconds per call of ``fn``: ``reps`` calls
    captured in one CUDA graph, the graph replayed ``rounds`` times between
    CUDA events. One replay is one host call, so this is the card's time,
    the quantity ``bound`` estimates from below."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def timings(kernel, plain) -> dict:
    return {"ms": graph_ms(kernel), "plain_ms": graph_ms(plain),
            "issue_ms": issue_ms(kernel)}


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_bits(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        (a.contiguous().view(-1).view(_int_of(a)) ==
         b.contiguous().view(-1).view(_int_of(b))).all())


def _int_of(t):
    import torch
    return {torch.float32: torch.int32, torch.int32: torch.int32,
            torch.int64: torch.int64, torch.bool: torch.uint8}[t.dtype]


# ------------------------------------------------------------------ phase 1
def phase_card():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found next to chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)                     # name, power limit: as nvidia-smi says
    from repro_torch.kernels import _build
    secs = _build.build_all()
    print(f"kernel build: {secs:.2f} s ({len(_build.SOURCES)} sources, "
          f"flags {' '.join(_build.NVCC_FLAGS)})")
    for name in _build.SOURCES:
        log = _build.lib_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")
    return card


# ------------------------------------------------------------------ phase 2
def probe_queries(rng, keys, n):
    """``n`` int32 queries: half drawn from the table's ``keys``, the rest
    absent keys, then -1 (hits an empty slot) and the pad key -2."""
    import numpy as np
    hits = n // 2 if len(keys) else 0
    return np.concatenate([rng.choice(keys, hits) if hits else [],
                           rng.integers(2 * 10**6, 3 * 10**6, n - hits - 2),
                           [-1, -2]]).astype(np.int32)


def hash_join_bytes(q, keys, width: int):
    """Bytes the probe of ``q`` against the slot keys ``keys`` (numpy
    int32, -1 empty) must move: each query read once; each distinct key
    slot the probe chains visit read once; the vals row and txn of each
    distinct hit slot read once; the outputs written once. Returns (bytes,
    slots visited, hit rows)."""
    import numpy as np
    import torch
    from repro_torch.kernels.hash_join.ref import MAX_PROBES, hash32
    S = len(keys)
    h = hash32(torch.tensor(q)).numpy() % S
    done = np.zeros(len(q), bool)
    visited = np.zeros(S, bool)
    hit_rows = np.zeros(S, bool)
    for p in range(MAX_PROBES):
        cand = (h + p) % S
        visited[cand[~done]] = True
        k = keys[cand]
        hit = ~done & (k == q)
        hit_rows[cand[hit]] = True
        done |= hit | (k == -1)
    n, n_vis, n_hit = len(q), int(visited.sum()), int(hit_rows.sum())
    return (4 * n + 4 * n_vis + (4 * width + 4) * n_hit
            + n * (4 * width + 1 + 4), n_vis, n_hit)


def hash_join_bitwise(q, kt, vt, tt, what: str):
    import torch
    from repro_torch.kernels.hash_join.ops import hash_join
    from repro_torch.kernels.hash_join.ref import hash_join_ref
    qt = torch.tensor(q, device=kt.device)
    got = hash_join(qt, kt, vt, tt)
    want = hash_join_ref(qt, kt, vt, tt)
    torch.cuda.synchronize()
    for g, w, out in zip(got, want, ("vals", "found", "txn")):
        if not same_bits(g, w):
            fail(f"hash_join {out} differs from the plain version ({what})")
    return qt, got, float((got[0] - want[0]).abs().max())


def check_hash_join(rng, dev):
    import numpy as np
    from repro_torch.core.backend import get_backend
    from repro_torch.core.cache import InMemoryTable
    from repro_torch.kernels.hash_join.ops import hash_join
    from repro_torch.kernels.hash_join.ref import hash_join_ref
    S, n = 4096, 1024
    tbl = InMemoryTable(S, backend=get_backend("torch", device=dev))
    keys = rng.choice(10**6, 2000, replace=False).astype(np.int64)
    tbl.upsert(keys, rng.normal(size=(2000, 8)).astype(np.float32),
               rng.integers(0, 10**6, 2000))
    kt, vt, tt = tbl.device_state()
    q = probe_queries(rng, keys, n)
    qt, got, err = hash_join_bitwise(q, kt, vt, tt, f"{S} slots")
    n_bytes, n_vis, n_hit = hash_join_bytes(q, tbl.keys, vt.shape[1])
    print(f"hash_join N={n} slots={S} W=8: bitwise equal, hit rate "
          f"{float(got[1].float().mean()):.3f}; the probe visits {n_vis} "
          f"key slots and reads {n_hit} hit rows = {n_bytes} B to move")
    b_ms, b_by = bound(n_bytes, 0)
    return {"name": "hash_join", "max_abs_err": err,
            **timings(lambda: hash_join(qt, kt, vt, tt),
                      lambda: hash_join_ref(qt, kt, vt, tt)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_main_path_caches(pipe, rng) -> None:
    """The hash join bitwise on every master cache the main path left
    behind, at the slot count each reached (``_grow`` doubles a cache
    whose probe chain would pass 16)."""
    import numpy as np
    sizes = []
    for w in pipe.workers:
        for name in ("equipment", "quality"):
            tbl = getattr(w, name)
            live = tbl.keys[tbl.keys != -1].astype(np.int64)
            hash_join_bitwise(probe_queries(rng, live, 1024),
                              *tbl.device_state(),
                              f"{w.name} {name} cache, {tbl.n_slots} slots")
            sizes.append(f"{w.name}.{name} {tbl.n_rows}/{tbl.n_slots}")
    print("hash_join on the main path's caches (rows/slots): bitwise equal "
          "for " + ", ".join(sizes))


def kpi_inputs(rng, n, units):
    import numpy as np
    prod = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    prod[:, 1] = rng.integers(0, units, n)
    prod[:, 4] = prod[:, 3] + np.abs(prod[:, 4]) + 0.1
    eq = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    eq[:, 1] = prod[:, 1]
    eq[:, 4] = eq[:, 3] + np.abs(eq[:, 4]) + 5
    eq[:, 5] = rng.random(n) > 0.3
    qr = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    qr[:, 1] = prod[:, 1]
    eq[rng.random(n) < 0.05, 1] = -1.0          # join misses
    qr[rng.random(n) < 0.05, 1] = -1.0
    return prod, eq, qr


def check_segment_kpi(rng, dev):
    import torch
    from repro_torch.kernels.segment_kpi.ops import segment_kpi
    from repro_torch.kernels.segment_kpi.ref import segment_kpi_ref
    n = 1024
    prod, eq, qr = (torch.tensor(a, device=dev)
                    for a in kpi_inputs(rng, n, N_UNITS))
    f_k, a_k = segment_kpi(prod, eq, qr, n_units=N_UNITS)
    f_r, a_r = segment_kpi_ref(prod, eq, qr, N_UNITS)
    f_err = float((f_k - f_r).abs().max())
    a_err = float((a_k - a_r).abs().max())
    if not f_err <= 1e-5 or not a_err <= 1e-4:
        fail(f"segment_kpi facts err {f_err} (tol 1e-5), rollup err "
             f"{a_err} (tol 1e-4)")
    print(f"segment_kpi N={n} units={N_UNITS}: facts max err {f_err:.3g} "
          f"(tol 1e-5, bitwise {same_bits(f_k, f_r)}), rollup max err "
          f"{a_err:.3g} (tol 1e-4, bitwise {same_bits(a_k, a_r)})")
    n_bytes = 3 * n * 32 + n * 40 + N_UNITS * 5 * 4
    b_ms, b_by = bound(n_bytes, 30 * n)
    return {"name": "segment_kpi", "max_abs_err": max(f_err, a_err),
            **timings(lambda: segment_kpi(prod, eq, qr, n_units=N_UNITS),
                      lambda: segment_kpi_ref(prod, eq, qr, N_UNITS)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_fold(rng, dev):
    import numpy as np
    import torch
    from repro_torch.kernels.segment_kpi.ops import fold_segments
    from repro_torch.kernels.segment_kpi.ref import fold_segments_ref
    timed = None
    for B in (256, 2048):
        for S in (20, 32, 60):
            for L in (2, 4):
                seg = rng.integers(-1, S, B)
                vals = rng.normal(size=(B, L)).astype(np.float32)
                vals[rng.random((B, L)) < 0.05] = 0.0
                vals[rng.random((B, L)) < 0.05] = -0.0
                st = torch.tensor(seg, device=dev)
                vt = torch.tensor(vals, device=dev)
                got = fold_segments(st, vt, S)
                want = fold_segments_ref(st, vt, S)
                torch.cuda.synchronize()
                if not same_bits(got, want):
                    fail(f"fold_segments B={B} S={S} L={L} not bitwise")
                if (B, S, L) == (2048, 60, 4):
                    timed = (st, vt, S, B, L)
    st, vt, S, B, L = timed
    print("fold_segments B in {256, 2048} x S in {20, 32, 60} x L in "
          "{2, 4}: bitwise equal")
    n_bytes = B * (8 + 4 * L) + S * (1 + 3 * L) * 4
    b_ms, b_by = bound(n_bytes, B * (1 + 3 * L))    # one lane op per row
    return {"name": "fold_segments", "max_abs_err": 0.0,
            **timings(lambda: fold_segments(st, vt, S),
                      lambda: fold_segments_ref(st, vt, S)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_gather(rng, dev):
    import numpy as np
    import torch
    from repro_torch.kernels.segment_kpi.ops import gather_stats
    from repro_torch.kernels.segment_kpi.ref import gather_stats_ref
    S, L = N_UNITS, 4
    table = rng.normal(size=(S, 1 + 3 * L)).astype(np.float32)
    table[:, 0] = rng.integers(0, 50, S)
    table[:3, 0] = 0.0                            # empty segments: NaN
    tt = torch.tensor(table, device=dev)
    for n in (512, 4096):
        it = torch.tensor(rng.integers(0, S, n), device=dev)
        got = gather_stats(tt, it)
        want = gather_stats_ref(tt, it)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            fail(f"gather_stats N={n} not bitwise")
    print(f"gather_stats table [{S}, {1 + 3 * L}] N in {{512, 4096}}: "
          "bitwise equal (NaN means included)")
    n_bytes = S * (1 + 3 * L) * 4 + n * 8 + n * (1 + 4 * L) * 4
    b_ms, b_by = bound(n_bytes, n * L)
    return {"name": "gather_stats", "max_abs_err": 0.0,
            **timings(lambda: gather_stats(tt, it),
                      lambda: gather_stats_ref(tt, it)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


# ------------------------------------------------------------------ phase 3
def dashboard_queries():
    from repro_torch.serving import ReportQuery
    qs = [ReportQuery("oee", unit=i % N_UNITS) for i in range(400)]
    return qs + [ReportQuery("top_downtime", k=5),
                 ReportQuery("shift_report"),
                 ReportQuery("production_rate")]


def run_main_path(device: str, records: int = 20_000):
    """The steelworks deployment of examples/steelworks_etl.py, driven
    step by step on ``device``. Returns (pipeline, engine, reports,
    stream seconds)."""
    import torch
    from repro_torch.configs.dod_etl import steelworks_config
    from repro_torch.core import DODETLPipeline, SourceDatabase
    from repro_torch.data.sampler import SamplerConfig, SteelworksSampler
    from repro_torch.serving import (MaterializedViewEngine, ReportSnapshot,
                                     compile_queries, steelworks_views)
    cfg = steelworks_config(n_partitions=N_UNITS)
    src = SourceDatabase()
    SteelworksSampler(cfg, SamplerConfig(records_per_table=records,
                                         n_equipment=N_UNITS,
                                         seed=0)).generate(src)
    pipe = DODETLPipeline(cfg, src, n_workers=5, device=device)
    engine = MaterializedViewEngine(steelworks_views(N_UNITS),
                                    backend=pipe.backend)
    pipe.warehouse.attach_serving(engine)
    pipe.extract()
    pipe.bootstrap_caches()
    t0 = time.perf_counter()
    stalls = 0
    for _ in range(1000):
        n = pipe.step(200)
        engine.fold_pending()
        buffered = sum(len(w.buffer) for w in pipe.workers)
        if n == 0 and buffered == 0:
            break
        stalls = stalls + 1 if n == 0 else 0
        if stalls >= 3:
            break
    plan = compile_queries(dashboard_queries())
    reports = plan.execute(ReportSnapshot(engine.snapshot(),
                                          engine.backend)).reports()
    if device != "cpu":
        torch.cuda.synchronize()
    return pipe, engine, reports, time.perf_counter() - t0


def _close(a, b, atol) -> bool:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and bool(
        np.allclose(a, b, rtol=0, atol=atol, equal_nan=True))


def compare_main_path(gpu, cpu) -> None:
    import numpy as np
    (gp, ge, gr, _), (cp, ce, cr, _) = gpu, cpu
    gw, cw = gp.warehouse, cp.warehouse
    if gw.rows_loaded != cw.rows_loaded:
        fail(f"rows_loaded {gw.rows_loaded} on the card vs "
             f"{cw.rows_loaded} on the CPU")
    gf, cf = gw.canonical_fact_table(), cw.canonical_fact_table()
    if not _close(gf, cf, 1e-5):
        fail("canonical fact tables differ beyond 1e-5")
    gk, ck = gw.kpi_running(), cw.kpi_running()
    if not _close(gk, ck, 1e-4):
        fail("kpi_running differs beyond 1e-4")
    views_bitwise = True
    for name, st in ge.snapshot().states.items():
        ct = ce.snapshot().states[name].table
        if not _close(st.table, ct, 1e-5):
            fail(f"view {name} differs beyond 1e-5")
        views_bitwise &= st.table.tobytes() == ct.tobytes()
    if len(gr) != len(cr):
        fail("query batch lengths differ")
    for a, b in zip(gr, cr):
        if a.view != b.view or a.data.keys() != b.data.keys():
            fail(f"query answer shapes differ for {a.view}")
        for k in a.data:
            va, vb = a.data[k], b.data[k]
            if isinstance(va, tuple):
                if va != vb:
                    fail(f"query {a.view}.{k} differs")
            elif not _close(va, vb, 1e-5):
                fail(f"query {a.view}.{k} differs beyond 1e-5")
    print(f"main path vs CPU: rows_loaded {gw.rows_loaded} equal; facts "
          f"within 1e-5 (byte-identical: {gf.tobytes() == cf.tobytes()}); "
          f"kpi_running within 1e-4 (byte-identical: "
          f"{gk.tobytes() == ck.tobytes()}); views within 1e-5 "
          f"(byte-identical: "
          f"{views_bitwise}); {len(gr)} query answers within 1e-5")
    if not np.isfinite(gf).all() or gf.shape[1] != 10:
        fail("fact table is not finite [n, 10]")


def profile_main_path(card: str) -> None:
    """Run the card's main path once more under ``torch.profiler`` and
    print each CUDA kernel's count and mean device time, plus the share of
    the run's wall time in which the card was busy (union of kernel and
    copy intervals; the profiler's own host overhead lengthens the wall
    time, so the share is a lower bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_main_path("cuda")
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        print("device time under the profiler: not measured (no CUDA "
              "events recorded)")
        return
    per = {}
    for name, lo, hi in spans:
        c, t = per.get(name, (0, 0.0))
        per[name] = (c + 1, t + hi - lo)
    busy, end = 0.0, float("-inf")
    for _, lo, hi in sorted(spans, key=lambda s: s[1]):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    print(f"profiled main path [{card}]: card busy {busy:.0f} us of "
          f"{wall_us:.0f} us wall ({100 * busy / wall_us:.2f}%)")
    for name, (c, t) in sorted(per.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {c:5d} x {t / c:8.2f} us  {name[:90]}")


def main() -> None:
    card = phase_card()
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    results = [check_hash_join(rng, dev), check_segment_kpi(rng, dev),
               check_fold(rng, dev), check_gather(rng, dev)]
    for r in results:
        print(f"  {r['name']}: {r['ms']:.5f} ms kernel, {r['plain_ms']:.5f} "
              f"ms plain (device, CUDA graph), {r['issue_ms']:.5f} ms per "
              f"host-issued wrapper call, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}) [{card}]")

    reset_launch_counts()
    gpu = run_main_path("cuda")
    counts = launch_counts()
    rows = gpu[0].warehouse.rows_loaded
    print(f"main path on the card: {rows} records loaded in "
          f"{gpu[3]:.3f} s of streaming = {rows / gpu[3]:.1f} records/s "
          f"[{card}]; backend dispatches {gpu[0].backend.op_dispatches}, "
          f"host syncs {gpu[0].backend.host_syncs}")
    cpu = run_main_path("cpu")
    print(f"the same path with the plain versions on this machine's CPU: "
          f"{rows / cpu[3]:.1f} records/s (host CPU, not a card number)")
    compare_main_path(gpu, cpu)
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    check_main_path_caches(gpu[0], rng)
    profile_main_path(card)
    sources = {"hash_join": ("src/repro_torch/kernels/hash_join/csrc/"
                             "hash_join.cu",
                             "src/repro/kernels/hash_join/hash_join.py:73"),
               "segment_kpi": ("src/repro_torch/kernels/segment_kpi/csrc/"
                               "segment_kpi.cu",
                               "src/repro/kernels/segment_kpi/"
                               "segment_kpi.py:226"),
               "fold_segments": ("src/repro_torch/kernels/segment_kpi/csrc/"
                                 "segment_kpi.cu",
                                 "src/repro/kernels/segment_kpi/"
                                 "segment_kpi.py:180"),
               "gather_stats": ("src/repro_torch/kernels/segment_kpi/csrc/"
                                "segment_kpi.cu",
                                "src/repro/kernels/segment_kpi/"
                                "segment_kpi.py:152")}
    kernels = []
    for r in results:
        src, replaces = sources[r["name"]]
        kernels.append({"name": r["name"], "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": counts[r["name"]],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "issue_ms": r["issue_ms"],
                        "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
