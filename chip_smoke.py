#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (no fallback to the CPU):

1. card: name and power limit (nvidia-smi); build the CUDA kernels from
   the checkout's sources (nvcc, one process per source) and time it;
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the main path's shapes, bitwise — hash_join,
   hash_join_pair (both cache probes of a transform; no path launches it
   since the transform runs them fused), transform_kpi (the whole
   transform in one launch: both probes, facts, rollup; NaN, +-inf and
   +-3e9 keys, pad rows, misses, wrapping chains, 1-8 blocks, 20 and 1000
   units), segment_kpi (the same kernel fed joined rows, 1-8 blocks, 20
   and 1000 units), fold_segments_many (a whole fold
   cycle: every delta x view item, at the steelworks views' shapes and at
   edge shapes) and gather_stats_many (a whole query batch in one launch:
   the dashboard's 400 oee point queries, the same routed over 4 shards,
   the four views' tables in one launch, one id, empty segments, 4096
   queries, a table too large for shared memory; its host time per batch
   through ``TorchBackend.batch_gather_stats_many`` too) — with each
   kernel's device time and its plain version's
   (calls captured in a CUDA graph, replays timed with CUDA events), the
   wrapper's host-issued time per call, and the kernel's bound (the larger
   of the bytes this run's inputs need / 3.35 TB/s and fp32 operations /
   67 TFLOP/s, an H100 SXM's published peaks); then the host-to-device
   uploads under ``torch.profiler``: a pageable ``torch.tensor(...,
   device="cuda")`` against ``backend.upload`` (pinned, non-blocking) and
   the transform, each with its count of stream synchronisations;
3. main path: the paper's steelworks deployment (20 partitions, 20 units,
   5 workers, 20,000 records per table) through ``DODETLPipeline`` with
   the serving views attached, micro-batches of 200 records per partition
   until drained, then a dashboard batch through ``compile_queries`` —
   run on the card and again on the CPU (plain versions), the results
   held against each other;
4. launch counts: every kernel of the main path must have launched on
   it (backend dispatches and host syncs printed); the probes and the
   fused transform are checked bitwise once more on the main path's own
   caches, at the slot counts they reached; the main path once more
   under ``torch.profiler``
   (the card's busy share); then the example's ISA-95 complex model
   (2,000 records, join depth 8: the single-table hash_join's path, its
   flattened hop probe) on the card and on the CPU, facts byte-identical;
5. the cluster on the card: the same deployment on ``ConcurrentCluster``
   (5 workers, one CUDA stream each, the four views attached, 200 records
   per partition per fetch). (a) Pre-extracted stream: facts
   byte-identical to the sequential card run and to the CPU run, the
   running KPI aggregate within 1e-2 of the card's full rescan
   (``kpi_rollup``, the segment_rollup kernel), then the 412-query
   dashboard burst through the batched front — every kernel must have
   launched in this run. (b) Live feed: 2 of 5 workers killed mid-stream,
   then scaled to 4: nothing lost, no buffer drop, identity columns equal
   to the sequential run's. Records/s, freshness and report staleness
   p50/p95, and the card's busy share of a profiled run of (a). (c) The
   sharded serving plane: the pre-extracted stream through the cluster
   with a ``ShardedViewEngine`` of 4 shards on the card (the shard mesh
   attached, skew-aware routing, ``repartition()`` at half the stream):
   facts byte-identical to (a) and to the CPU run, every view bitwise an
   unsharded engine's on the same chunk log through ``owner_gather`` and
   ``tree_reduce``, the burst's answers bitwise the unsharded front's,
   one fold_segments_many launch per fold cycle and one
   gather_stats_many launch per query batch; records/s, staleness, stage
   spans and ``mesh_report()``;
6. segment_rollup against its plain version, bitwise, at 1, 255 and 257
   rows (16-byte aligned and not), on the cluster's own fact table
   (20,000 facts), on 20,000 rows over 1000 units, and on a 2^20-row
   table from the seed with invalid,
   out-of-range, negative, fractional and NaN units, spread over the
   units and sorted by unit; its device time at both sizes and sorted,
   the issue time, the bound, ``index_add_``'s time over the pre-masked
   KPI lanes, and its two kernels' device times under the profiler;
7. durability on the card: the cluster journaling to a checkpoint
   directory, crashed at ``commit.post``, recovered with
   ``recover_pipeline(device="cuda")`` and run to the end — facts
   byte-identical to the uninterrupted run, the rescan bitwise its plain
   version;
8. LM kernels against their plain versions on the card, at the serving
   path's shapes and at ragged S, each in both of its designs:
   flash_attention in f32 on the CUDA-core design (2e-5) and in bf16 on
   the tensor-core design (wgmma + TMA, 2e-2) at internlm2's and zamba2's
   attention shapes, and at the other families' (whisper's full-attention
   encoder [4, 12, 1500, 64], its cross-attention with 416 and 1 queries
   against 1500 keys, its causal decoder at 416; qwen2-vl's GQA group 7
   [4, 28 / 4, 2048, 128]; qwen2-moe's [4, 16, 2048, 128]); gla_chunk in
   f32 on the serial design in both regimes, zamba2's bf16 Mamba2 inputs
   on the SSD design and rwkv6's bf16 RWKV6 inputs [4, S, 64, 64] (decay
   -exp(clip(x, -8, 4)), channels at -e^4, bonus u) on the RWKV6 design
   and, pinned, on the serial design (out 2e-2), with and without an
   initial state, final state included (2e-4); each call's design checked
   by the launch counters. Both designs of each kernel then timed in turns
   (old, new, new, old) on the bf16 serving shapes (gla: zamba2's and
   rwkv6's), and the tensor-core flash at whisper's encoder shape and
   qwen2-vl's: device and issue times, the plain version,
   ``scaled_dot_product_attention`` beside flash, and the bound (bytes /
   3.35 TB/s or operations over the input dtype's peak: 989 TFLOP/s dense
   bf16 tensor core, 67 TFLOP/s f32), the SSD and RWKV6 designs' chunk-
   state scratch bytes beside it;
9. LM serving for all six families at full published width and depth,
   bf16 weights from a seeded ``torch.Generator`` on the card:
   internlm2-1.8b, zamba2-1.2b, rwkv6-7b, qwen2-moe-a2.7b, qwen2-vl-7b
   (batch 4 x 2048 prompt tokens) and whisper-small (4 x 1500 seeded
   frames, a 416-token decoder prompt); prefill/decode consistency
   (prefill of the prompt less 4 tokens, 4 decode steps against one full
   forward, within 0.02 x max(|logits|, 1); not for qwen2-moe, whose
   dispatch groups' capacity depends on their token count, as the
   reference leaves it out); launches per prefill (internlm2 24, qwen2-moe
   24, qwen2-vl 28 flash on the tensor-core design; zamba2 6 flash + 38
   gla on the tensor-core and SSD designs; rwkv6 32 gla on the RWKV6
   design, none on the serial one; whisper 36 flash: 12 encoder, 12
   causal self, 12 cross) and per decode step (whisper's 12
   cross-attention flash, none for the others);
   the serve run (32 greedy decode steps, ``examples.serve_lm.serve``)
   with prefill and decode tokens/s and its peak memory, counted as the
   bf16 designs' launches; the card's busy share of a profiled serve run
   (qwen2-moe: the share of its one-hot dispatch and combine products);
   the same prefill in f32 (the CUDA-core and serial designs, counted as
   theirs; qwen2-moe cut to 8 of its 24 layers, tokens routed otherwise
   at a near tie of the router left out and counted) with the kernels
   against their plain versions on the card, final recurrent states
   included, and the consistency once more in f32;
10. training: (a) the LM kernels' autograd Functions at the training
   shapes (internlm2's attention, zamba2's Mamba2; bf16): the forward
   within the kernels' bounds, every input gradient bitwise autograd's
   through the plain version (the backward recomputes it), the kernel
   forward and the recompute backward timed; (b) one ``make_train_step``
   of the f32 smoke configs, card against CPU within 1e-4; (c)
   internlm2-1.8b and zamba2-1.2b at full width and depth, seeded bf16
   weights, batch 8 x 2048 tokens in 8 microbatches, remat on, 3 steps:
   every gradient leaf finite and not all zero, the loss finite, the LM
   kernels' launches per step checked (two per layer and microbatch:
   the forward, then its recompute), step ms, train tokens/s, 6·N·tokens
   per step time over the bf16 dense peak, peak memory; (d)
   ``examples.train_lm`` (ETL-fed) for 30 steps: the loss falls,
   transform_kpi launched, its checkpoint restores bitwise; (e)
   ``manual_dp`` over NCCL at world size 1 against ``make_train_step``;
   (f) ``examples.quickstart`` on the card against its CPU run.

The line before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX and nothing of
the JAX package.
"""
import contextlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.modules["jax"] = None          # the port must never need these
sys.modules["repro"] = None

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12            # H100 SXM, outside the tensor cores
BF16_FLOP_PER_S = 989e12           # H100 SXM, dense bf16 tensor cores
N_UNITS = 20
MANY_UNITS = 1000                  # the KPI kernels' rollup: 4 unit chunks
# the ETL kernels of the cluster path (the ETL main path); the
# single-table hash_join runs on the complex model's path (COMPLEX_PATH)
ETL_KERNELS = ("transform_kpi", "fold_segments_many", "gather_stats_many",
               "segment_rollup")
# units of the port that no path launches: the transform runs both probes
# and the KPI kernel fused in transform_kpi; they are still held against
# their plain versions and timed
OFF_PATH = ("hash_join_pair", "segment_kpi")
COMPLEX_PATH = "complex_join8"


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


def bound(n_bytes: float, n_flops: float, peak: float = FP32_FLOP_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / peak * 1e3
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
          f"one nvcc each; flags {' '.join(_build.NVCC_FLAGS)}, plus "
          f"{' '.join(_build.BITWISE)} for "
          f"{', '.join(sorted(_build.EXTRA_FLAGS))})")
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


def probe_footprint(q, keys):
    """(distinct key slots, distinct hit slots) the probe chains of the
    int32 queries ``q`` visit in a table with slot keys ``keys`` (numpy
    int32, -1 empty)."""
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
    return int(visited.sum()), int(hit_rows.sum())


def hash_join_bytes(q, keys, width: int):
    """Bytes the probe of ``q`` against the slot keys ``keys`` must move:
    each query read once; each distinct key slot the probe chains visit
    read once; the vals row and txn of each distinct hit slot read once;
    the outputs written once. Returns (bytes, slots visited, hit rows)."""
    n_vis, n_hit = probe_footprint(q, keys)
    n = len(q)
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


def pair_rows(rng, eq_keys, q_keys, n):
    """[n, 8] f32 production rows as a transform pads them: col 1 drawn
    from the equipment keys, col 0 from the quality keys, a fifth of each
    absent, some fractional (truncated toward zero), the last eighth -1.0
    pad rows."""
    import numpy as np
    prod = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    prod[:, 1] = rng.choice(eq_keys, n)
    prod[:, 0] = rng.choice(q_keys, n)
    prod[rng.random(n) < 0.2, 1] = 2.5e6
    prod[rng.random(n) < 0.2, 0] = 3.5e6
    prod[rng.random(n) < 0.1, 1] += 0.75
    prod[n - n // 8:] = -1.0
    return prod


def hash_join_pair_bitwise(prod, eq_state, q_state, what: str):
    import torch
    from repro_torch.kernels.hash_join.ops import hash_join_pair
    from repro_torch.kernels.hash_join.ref import hash_join_pair_ref
    pt = torch.tensor(prod, device=eq_state[0].device)
    got = hash_join_pair(pt, eq_state, q_state)
    want = hash_join_pair_ref(pt, eq_state, q_state)
    torch.cuda.synchronize()
    for g, w, out in zip(got, want, ("eq_rows", "q_rows", "found")):
        if not same_bits(g, w):
            fail(f"hash_join_pair {out} differs from the plain version "
                 f"({what})")
    return pt, got


def check_hash_join_pair(rng, dev):
    """Both probes of one transform at the main path's shapes: a 1024-row
    padded block against the two 4096-slot caches of a worker (20
    equipment units, 2,000 products)."""
    import numpy as np
    from repro_torch.core.backend import get_backend
    from repro_torch.core.cache import InMemoryTable
    from repro_torch.kernels.hash_join.ops import hash_join_pair
    from repro_torch.kernels.hash_join.ref import hash_join_pair_ref
    S, n = 4096, 1024
    be = get_backend("torch", device=dev)
    tables, keys = [], []
    for n_keys in (N_UNITS, 2000):
        tbl = InMemoryTable(S, backend=be)
        k = rng.choice(10**6, n_keys, replace=False).astype(np.int64)
        tbl.upsert(k, rng.normal(size=(n_keys, 8)).astype(np.float32),
                   rng.integers(0, 10**6, n_keys))
        tables.append(tbl)
        keys.append(k)
    eq_state, q_state = (t.device_state() for t in tables)
    prod = pair_rows(rng, *keys, n)
    pt, got = hash_join_pair_bitwise(prod, eq_state, q_state,
                                     f"{S}-slot caches")
    n_bytes = 8 * n + n * (32 + 32 + 1)     # key cols in; rows, flag out
    for tbl, col in zip(tables, (1, 0)):
        n_vis, n_hit = probe_footprint(prod[:, col].astype(np.int32),
                                       tbl.keys)
        n_bytes += 4 * n_vis + 32 * n_hit
    print(f"hash_join_pair N={n} (last {n // 8} pad rows) against "
          f"{N_UNITS}- and 2000-key caches of {S} slots: bitwise equal, "
          f"found rate {float(got[2].float().mean()):.3f}; {n_bytes} B to "
          f"move")
    b_ms, b_by = bound(n_bytes, 0)
    return {"name": "hash_join_pair", "max_abs_err": 0.0,
            **timings(lambda: hash_join_pair(pt, eq_state, q_state),
                      lambda: hash_join_pair_ref(pt, eq_state, q_state)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_main_path_caches(pipe, rng) -> None:
    """The hash join bitwise on every master cache the main path left
    behind, at the slot count each reached (``_grow`` doubles a cache
    whose probe chain would pass 16)."""
    import numpy as np
    sizes = []
    for w in pipe.workers:
        live = {}
        for name in ("equipment", "quality"):
            tbl = getattr(w, name)
            live[name] = tbl.keys[tbl.keys != -1].astype(np.int64)
            hash_join_bitwise(probe_queries(rng, live[name], 1024),
                              *tbl.device_state(),
                              f"{w.name} {name} cache, {tbl.n_slots} slots")
            sizes.append(f"{w.name}.{name} {tbl.n_rows}/{tbl.n_slots}")
        prod = pair_rows(rng, live["equipment"], live["quality"], 1024)
        for check in (hash_join_pair_bitwise, transform_kpi_bitwise):
            check(prod, w.equipment.device_state(), w.quality.device_state(),
                  f"{w.name}'s caches")
    print("hash_join, hash_join_pair and transform_kpi on the main path's "
          "caches (rows/slots): bitwise equal for " + ", ".join(sizes))


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
    """The KPI kernel fed joined rows (one launch: facts, block rollup,
    the last CTA's block sum), bitwise at 1 to 8 blocks; timed at the
    main path's 1024 rows."""
    import torch
    from repro_torch.kernels.segment_kpi.ops import segment_kpi
    from repro_torch.kernels.segment_kpi.ref import segment_kpi_ref
    for n in (200, 256, 512, 1000, 1024, 2048):
        prod, eq, qr = (torch.tensor(a, device=dev)
                        for a in kpi_inputs(rng, n, N_UNITS))
        got = segment_kpi(prod, eq, qr, n_units=N_UNITS)
        want = segment_kpi_ref(prod, eq, qr, N_UNITS)
        torch.cuda.synchronize()
        for g, w, out in zip(got, want, ("facts", "rollup")):
            if not same_bits(g, w):
                fail(f"segment_kpi {out} differs from the plain version "
                     f"(N={n})")
    for n in (1000, 2048):
        prod, eq, qr = (torch.tensor(a, device=dev)
                        for a in kpi_inputs(rng, n, MANY_UNITS))
        got = segment_kpi(prod, eq, qr, n_units=MANY_UNITS)
        want = segment_kpi_ref(prod, eq, qr, MANY_UNITS)
        torch.cuda.synchronize()
        if not all(same_bits(g, w) for g, w in zip(got, want)):
            fail(f"segment_kpi differs from the plain version (N={n}, "
                 f"{MANY_UNITS} units)")
    print(f"segment_kpi N in {{200, 256, 512, 1000, 1024, 2048}} (1-8 "
          f"blocks), units={N_UNITS}, and N in {{1000, 2048}}, "
          f"units={MANY_UNITS}: facts and rollup bitwise equal")
    n = 1024
    prod, eq, qr = (torch.tensor(a, device=dev)
                    for a in kpi_inputs(rng, n, N_UNITS))
    n_bytes = 3 * n * 32 + n * 40 + N_UNITS * 5 * 4
    b_ms, b_by = bound(n_bytes, 30 * n)
    return {"name": "segment_kpi", "max_abs_err": 0.0,
            **timings(lambda: segment_kpi(prod, eq, qr, n_units=N_UNITS),
                      lambda: segment_kpi_ref(prod, eq, qr, N_UNITS)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


SPECIAL_KEYS = (float("nan"), float("inf"), float("-inf"), 3e9, -3e9)


def special_caches(rng, dev, slots, n_keys, key_hi: int = 10**6):
    """Two master caches (equipment, quality) of ``slots`` slots holding
    ``n_keys`` keys each, 0, INT32_MAX and INT32_MIN among them (the casts
    of NaN, +inf and -inf / +-3e9 keys), the rest drawn from [1,
    ``key_hi``). Returns (tables, keys)."""
    import numpy as np
    from repro_torch.core.backend import get_backend
    from repro_torch.core.cache import InMemoryTable
    be = get_backend("torch", device=dev)
    tables, keys = [], []
    for S, n_k in zip(slots, n_keys):
        tbl = InMemoryTable(S, backend=be)
        k = np.concatenate([[0, 2**31 - 1, -2**31], rng.choice(
            np.arange(1, key_hi), n_k - 3, replace=False)]).astype(np.int64)
        tbl.upsert(k, np.abs(rng.normal(size=(n_k, 8))).astype(np.float32),
                   rng.integers(0, 10**6, n_k))
        tables.append(tbl)
        keys.append(k)
    return tables, keys


def transform_rows(rng, eq_keys, q_keys, n):
    """``pair_rows`` with the special keys in both key columns."""
    import numpy as np
    prod = pair_rows(rng, eq_keys, q_keys, n)
    k = len(SPECIAL_KEYS)
    prod[:k, 1] = np.float32(SPECIAL_KEYS)
    prod[k:2 * k, 0] = np.float32(SPECIAL_KEYS)
    return prod


def transform_kpi_bitwise(prod, eq_state, q_state, what: str,
                          n_units: int = N_UNITS):
    import torch
    from repro_torch.kernels.segment_kpi.ops import transform_kpi
    from repro_torch.kernels.segment_kpi.ref import transform_kpi_ref
    pt = torch.tensor(prod, device=eq_state[0].device)
    want = transform_kpi_ref(pt, eq_state, q_state, n_units)
    got = transform_kpi(pt, eq_state, q_state, n_units=n_units)
    torch.cuda.synchronize()
    for g, w, out in zip(got, want, ("facts", "found", "agg")):
        if not same_bits(g, w):
            fail(f"transform_kpi {out} differs from the plain version "
                 f"({what})")
    return pt, want


def check_transform_kpi(rng, dev):
    """The whole transform in one launch at the main path's shape (a
    1024-row padded block against two 4096-slot caches of 20 and 2,000
    keys), at 1-8 blocks against full caches of 8 and 12 slots (every
    chain wraps), and over MANY_UNITS units (the rollup's unit chunks),
    with NaN, +-inf and +-3e9 keys, pad rows and misses, bitwise."""
    import numpy as np
    from repro_torch.kernels.segment_kpi.ops import transform_kpi
    from repro_torch.kernels.segment_kpi.ref import transform_kpi_ref
    for n in (256, 512, 1024, 2048):
        tables, keys = special_caches(rng, dev, (8, 12), (8, 12))
        transform_kpi_bitwise(transform_rows(rng, *keys, n),
                              *(t.device_state() for t in tables),
                              f"N={n}, full 8- and 12-slot caches")
    S, n = 4096, 1024
    tables, keys = special_caches(rng, dev, (S, S), (2000, 2000),
                                  key_hi=2 * MANY_UNITS)
    _, want = transform_kpi_bitwise(transform_rows(rng, *keys, n),
                                    *(t.device_state() for t in tables),
                                    f"{MANY_UNITS} units", MANY_UNITS)
    many_counted = int(want[2][:, 4].sum())
    tables, keys = special_caches(rng, dev, (S, S), (N_UNITS, 2000))
    eq_state, q_state = (t.device_state() for t in tables)
    prod = transform_rows(rng, *keys, n)
    pt, want = transform_kpi_bitwise(prod, eq_state, q_state,
                                     f"{S}-slot caches")
    print(f"transform_kpi: bitwise equal at N in {{256, 512, 1024, 2048}} "
          f"against full 8- and 12-slot caches and at N={n} (last "
          f"{n // 8} pad rows) against {N_UNITS}- and 2000-key caches of "
          f"{S} slots, NaN/+-inf/+-3e9 keys included (found rate "
          f"{float(want[1].float().mean()):.3f}), and over {MANY_UNITS} "
          f"units ({many_counted} rows counted)")
    n_bytes = n * 32 + n * (40 + 1) + N_UNITS * 5 * 4
    for tbl, col in zip(tables, (1, 0)):
        q = np.nan_to_num(prod[:, col], nan=0.0).clip(-2**31, 2**31 - 1)
        n_vis, n_hit = probe_footprint(q.astype(np.int64).astype(np.int32),
                                       tbl.keys)
        n_bytes += 4 * n_vis + 32 * n_hit
    b_ms, b_by = bound(n_bytes, 30 * n)
    print(f"  transform_kpi at N={n}: {n_bytes} B to move")
    return {"name": "transform_kpi", "max_abs_err": 0.0,
            **timings(lambda: transform_kpi(pt, eq_state, q_state,
                                            n_units=N_UNITS),
                      lambda: transform_kpi_ref(pt, eq_state, q_state,
                                                N_UNITS)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def count_syncs(label: str, run, card: str) -> None:
    """Run ``run()`` under ``torch.profiler`` and print how many CUDA
    runtime calls of each kind it made: stream, event and device
    synchronisations, async copies and kernel launches."""
    from torch.profiler import ProfilerActivity, profile
    kinds = ("cudaStreamSynchronize", "cudaEventSynchronize",
             "cudaDeviceSynchronize", "cudaMemcpyAsync", "cudaLaunchKernel")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    counts = {k: 0 for k in kinds}
    for e in prof.events():
        if e.name in counts:
            counts[e.name] += 1
    if not any(counts.values()):
        print(f"  {label}: CUDA runtime calls not measured (the profiler "
              f"recorded none) [{card}]")
        return
    print(f"  {label}: " + ", ".join(f"{k} {v}" for k, v in counts.items())
          + f" [{card}]")


def check_uploads(rng, dev, card: str) -> None:
    """Whether a host-to-device upload waits for the stream: 20 uploads of
    a transform's padded 1024-row payload as a pageable ``torch.tensor(...,
    device="cuda")`` and through ``backend.upload``, then 20 transforms
    through ``TorchBackend.transform_block`` (payload upload and one
    launch each; the caches' mirrors are current)."""
    import numpy as np
    import torch
    from repro_torch.core.backend import get_backend, upload
    arr = np.abs(rng.normal(size=(1024, 8))).astype(np.float32)
    tables, keys = special_caches(rng, dev, (4096, 4096), (N_UNITS, 2000))
    prod = pair_rows(rng, *keys, 1000)
    be = get_backend("torch", device=dev)
    be.transform_block(prod, *tables, n_units=N_UNITS).to_host()
    torch.cuda.synchronize()
    print("host-to-device uploads under the profiler (20 calls each):")
    count_syncs("pageable torch.tensor(payload, device='cuda')",
                lambda: [torch.tensor(arr, device=dev) for _ in range(20)],
                card)
    count_syncs("backend.upload(payload) (pinned, non-blocking)",
                lambda: [upload(arr, dev) for _ in range(20)], card)
    count_syncs("TorchBackend.transform_block (no to_host)",
                lambda: [be.transform_block(prod, *tables, n_units=N_UNITS)
                         for _ in range(20)], card)
    torch.cuda.synchronize()


STEELWORKS_VIEWS = ((20, 4), (60, 4), (20, 2), (32, 2))   # (S, L) each


def fold_item(rng, n, S, L, special=None):
    """(seg, vals, S): ids in [-1, S) (-1: identity), values with signed
    zeros and, with ``special``, that value mixed in."""
    import numpy as np
    seg = rng.integers(-1, S, n)
    vals = rng.normal(size=(n, L)).astype(np.float32)
    vals[rng.random((n, L)) < 0.05] = 0.0
    vals[rng.random((n, L)) < 0.05] = -0.0
    if special is not None:
        vals[rng.random((n, L)) < 0.05] = special
    return seg, vals, S


def check_fold(rng, dev):
    """fold_segments_many bitwise its plain version on fold cycles at the
    steelworks views' shapes (1 and 5 deltas of 256 to 2048 rows, each
    into the four views) and at edge shapes; timed at one cycle of one
    1024-row delta into the four views."""
    import numpy as np
    import torch
    from repro_torch.kernels.segment_kpi.ops import (fold_segments_many,
                                                     stage_fold)
    from repro_torch.kernels.segment_kpi.ref import fold_segments_many_ref
    cycles = {f"{d} x {B}-row deltas": [
        fold_item(rng, B, S, L) for _ in range(d) for S, L in
        STEELWORKS_VIEWS] for d in (1, 5) for B in (256, 1024, 2048)}
    cycles["edges"] = (
        [fold_item(rng, n, 20, 4) for n in (1, 9, 17, 33, 2049, 5000)]
        + [fold_item(rng, 100, S, 2) for S in (1, 3)]
        + [fold_item(rng, 700, 20, L) for L in (1, 5, 9)]
        + [fold_item(rng, 1000, 60, 4, sp) for sp in (np.nan, np.inf)])
    for what, items in cycles.items():
        words, plan = stage_fold(items)
        wt = words.to(dev)
        got = fold_segments_many(wt, plan)
        want = fold_segments_many_ref(wt, plan)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            fail(f"fold_segments_many not bitwise ({what})")
    print(f"fold_segments_many: bitwise equal on {len(cycles)} fold cycles "
          f"({', '.join(cycles)}; edges: 1-5000 rows, 1-3 segments, 1-9 "
          f"lanes, NaN and +-inf lanes)")
    items = [fold_item(rng, 1024, S, L) for S, L in STEELWORKS_VIEWS]
    words, plan = stage_fold(items)
    wt = words.to(dev)
    n_bytes = 4 * plan.n_words + 4 * plan.n_out
    b_ms, b_by = bound(n_bytes, sum(len(s) * (1 + 3 * v.shape[1])
                                    for s, v, _ in items))
    print(f"  timed cycle: one 1024-row delta into the 4 views, "
          f"{plan.n_ctas} CTAs, {4 * plan.n_words} B staged, "
          f"{4 * plan.n_out} B out")
    return {"name": "fold_segments_many", "max_abs_err": 0.0,
            **timings(lambda: fold_segments_many(wt, plan),
                      lambda: fold_segments_many_ref(wt, plan)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def backend_fold_ms(dev, rng, deltas: int, reps: int = 50) -> float:
    """Host-clock ms per ``TorchBackend.fold_segments_many`` call for one
    fold cycle of ``deltas`` 1024-row deltas into the four views: host
    compaction and staging, one upload, one launch, one copy back and the
    sync, as the view-fold thread pays them."""
    from repro_torch.core.backend import get_backend
    be = get_backend("torch", device=dev)
    items = [fold_item(rng, 1024, S, L) for _ in range(deltas)
             for S, L in STEELWORKS_VIEWS]
    be.fold_segments_many(items)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        be.fold_segments_many(items)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def gather_table(rng, S, L):
    """A packed [S, 1 + 3L] view table: counts in [0, 50) with a third of
    the segments empty (NaN means), a -0.0 sum, +-inf min/max
    identities."""
    import numpy as np
    table = rng.normal(size=(S, 1 + 3 * L)).astype(np.float32)
    table[:, 0] = rng.integers(0, 50, S)
    table[rng.random(S) < 0.33, 0] = 0.0
    table[0, 0], table[0, 1] = 3.0, -0.0
    table[-1, 1 + L:] = np.concatenate([np.full(L, np.inf),
                                        np.full(L, -np.inf)])
    return table


def shard_items(table, ids, n_shards):
    """The (shard-local table, routed ids) items of one view's point
    queries over ``n_shards`` shards owning contiguous segment ranges:
    foreign rows hold the fold identity, as a shard's table does."""
    import numpy as np
    from repro_torch.core.backend import empty_fold_state
    S, W = table.shape
    owner = np.arange(S) * n_shards // S
    ident = empty_fold_state(S, (W - 1) // 3)
    return [(np.where(owner[:, None] == k, table, ident), ids[owner[ids] == k])
            for k in range(n_shards) if (owner[ids] == k).any()]


def gather_bitwise(items, dev, what: str):
    """One gather_stats_many launch over ``items``, held bitwise against
    the plain version item by item. Returns (words on the card, plan)."""
    import torch
    from repro_torch.kernels.segment_kpi.ops import (gather_stats_many,
                                                     gather_tables,
                                                     stage_gather)
    from repro_torch.kernels.segment_kpi.ref import gather_stats_many_ref
    words, plan = stage_gather(items)
    wt = torch.from_numpy(words).to(dev)
    got = gather_tables(gather_stats_many(wt, plan), plan)
    want = gather_tables(gather_stats_many_ref(wt, plan), plan)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        if not same_bits(g, w):
            fail(f"gather_stats_many item {i} not bitwise ({what})")
    return wt, plan


def gather_bytes(items) -> int:
    """Each table and id read once, each answer written once."""
    return sum(4 * t.size + 4 * len(i) + 4 * len(i) * (1 + 4 * (
        (t.shape[1] - 1) // 3)) for t, i in items)


def backend_gather_ms(dev, items, reps: int = 50) -> float:
    """Host-clock ms per ``TorchBackend.batch_gather_stats_many`` call:
    staging, one upload, one launch, one copy back and the sync, as a
    query batch pays them."""
    from repro_torch.core.backend import get_backend
    be = get_backend("torch", device=dev)
    be.batch_gather_stats_many(items)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        be.batch_gather_stats_many(items)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_gather_stats_many(rng, dev, card: str):
    """The batched gather bitwise its plain version, one launch per
    batch: the dashboard's 400 oee point queries, the same routed over 4
    shards, the four views in one launch (L 4, 4, 2, 2), one id, a table
    of empty segments, a 4096-query batch and a table too large for
    shared memory; device, issue, plain and bound times at 400 and 4096
    queries and at 4 shards, and the backend's host time per batch."""
    import numpy as np
    from repro_torch.kernels.segment_kpi.ops import gather_stats_many
    from repro_torch.kernels.segment_kpi.ref import gather_stats_many_ref
    oee = gather_table(rng, N_UNITS, 4)
    dash = np.arange(400) % N_UNITS
    big = rng.integers(0, N_UNITS, 4096)
    empty = gather_table(rng, N_UNITS, 4)
    empty[:, 0] = 0.0
    cases = {
        "dashboard, 400 oee queries": [(oee, dash)],
        "the same over 4 shards": shard_items(oee, dash, 4),
        "the four views": [(gather_table(rng, S, L), rng.integers(0, S, n))
                           for (S, L), n in zip(STEELWORKS_VIEWS,
                                                (400, 300, 20, 129))],
        "one id": [(oee, np.array([7]))],
        "empty segments": [(empty, dash)],
        "4096 queries": [(oee, big)],
        "a 3000 x 10 table (read through L2)": [
            (gather_table(rng, 3000, 3), rng.integers(0, 3000, 1000))],
    }
    staged = {what: gather_bitwise(items, dev, what)
              for what, items in cases.items()}
    print(f"gather_stats_many: bitwise equal, one launch each, on "
          f"{len(cases)} batches ({'; '.join(cases)})")
    timed = {}
    for what, label in (("dashboard, 400 oee queries", "dashboard"),
                        ("the same over 4 shards", "dashboard_4_shards"),
                        ("4096 queries", "q4096")):
        wt, plan = staged[what]
        items = cases[what]
        b_ms, b_by = bound(gather_bytes(items),
                           sum(len(i) * ((t.shape[1] - 1) // 3)
                               for t, i in items))
        timed[label] = {
            **timings(lambda: gather_stats_many(wt, plan),
                      lambda: gather_stats_many_ref(wt, plan)),
            "bound_ms": b_ms, "bound_by": b_by,
            "batch_ms": backend_gather_ms(dev, items)}
        t = timed[label]
        print(f"  gather_stats_many {what} ({plan.n_ctas} CTAs, "
              f"{len(items)} items): {t['ms']:.7f} ms kernel, "
              f"{t['plain_ms']:.7f} ms plain (device, CUDA graph), "
              f"{t['issue_ms']:.7f} ms per host-issued wrapper call, "
              f"bound {b_ms:.7f} ms ({b_by}, {gather_bytes(items)} B); "
              f"TorchBackend.batch_gather_stats_many per batch (host "
              f"clock: staging, upload, launch, copy back, sync) "
              f"{t['batch_ms']:.4f} ms [{card}]")
    main = timed["q4096"]
    return {"name": "gather_stats_many", "max_abs_err": 0.0,
            **{k: main[k] for k in ("ms", "plain_ms", "issue_ms",
                                    "bound_ms", "bound_by", "batch_ms")},
            "library_ms": None,
            "dashboard": timed["dashboard"],
            "dashboard_4_shards": timed["dashboard_4_shards"]}


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
    pipe.backend.reset_stats()    # one backend per device: count this run
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


def profile_run(label: str, run, card: str, ranges=()):
    """Run ``run()`` once under ``torch.profiler`` and print each CUDA
    kernel's count and mean device time, plus the share of the run's wall
    time in which the card was busy (union of kernel and copy intervals
    over all streams; the profiler's own host overhead lengthens the wall
    time, so the share is a lower bound), the device time of the kernels
    launched inside each ``record_function`` range named in ``ranges``
    and its share of the busy time, and the host side: the torch ops' and
    CUDA runtime calls' self time summed over all threads, with the
    largest. Returns {"busy_us", "wall_us", range: device us} (None when
    no CUDA event was recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.name not in ranges]      # not a range's GPU-side mark
    if not spans:
        print(f"device time under the profiler ({label}): not measured (no "
              "CUDA events recorded)")
        return None
    per = {}
    for name, lo, hi in spans:
        c, t = per.get(name, (0, 0.0))
        per[name] = (c + 1, t + hi - lo)
    busy, end = 0.0, float("-inf")
    for _, lo, hi in sorted(spans, key=lambda s: s[1]):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    print(f"profiled {label} [{card}]: card busy {busy:.0f} us of "
          f"{wall_us:.0f} us wall ({100 * busy / wall_us:.2f}%)")
    for name, (c, t) in sorted(per.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {c:5d} x {t / c:8.2f} us  {name[:90]}")
    out = {"busy_us": busy, "wall_us": wall_us}
    for rng_name in ranges:
        marks = [e for e in prof.events() if e.name == rng_name and
                 e.device_type == torch.autograd.DeviceType.CPU]
        dev_us = sum(e.cuda_time_total if getattr(
            e, "device_time_total", None) is None else e.device_time_total
            for e in marks)
        out[rng_name] = dev_us
        print(f"  range {rng_name}: {len(marks)} calls, kernels {dev_us:.0f}"
              f" us = {100 * dev_us / busy:.2f}% of the busy time")
    host = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            c, t = host.get(e.name, (0, 0.0))
            host[e.name] = (c + 1, t + e.self_cpu_time_total)
    total = sum(t for _, t in host.values())
    print(f"  host: torch ops and CUDA runtime calls, self time summed over "
          f"threads {total / 1e6:.3f} s; largest:")
    for name, (c, t) in sorted(host.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  {c:5d} x {t / c:8.2f} us  {name[:90]}")
    return out


def run_complex(device: str, records: int = 2_000):
    """The example's ISA-95 generalized model (``complex_model``, join
    depth 8: each transform also runs the flattened hop probe through the
    single-table hash_join), sequential to completion on ``device``.
    Returns (pipeline, records loaded)."""
    import torch
    from repro_torch.configs.dod_etl import steelworks_config
    from repro_torch.core import DODETLPipeline, SourceDatabase
    from repro_torch.data.sampler import SamplerConfig, SteelworksSampler
    cfg = steelworks_config(n_partitions=N_UNITS, complex_model=True)
    src = SourceDatabase()
    SteelworksSampler(cfg, SamplerConfig(records_per_table=records,
                                         n_equipment=N_UNITS,
                                         seed=0)).generate(src)
    pipe = DODETLPipeline(cfg, src, n_workers=5, join_depth=8,
                          device=device)
    pipe.extract()
    pipe.bootstrap_caches()
    done = pipe.run_to_completion()
    if device != "cpu":
        torch.cuda.synchronize()
    return pipe, done


# ------------------------------------------------------------------ phase 5
CLUSTER_RECORDS = 20_000
CLUSTER_CAP = 200                  # records per partition per fetch
DEVICE = "cuda"                    # where the cluster phases run


def steelworks_deployment(device: str, fault=None, tracer=None,
                          strategy: str = "static"):
    """The steelworks deployment of phase 3 (same seed, so the same
    records), unextracted: (cfg, source, sampler, pipeline)."""
    from repro_torch.configs.dod_etl import steelworks_config
    from repro_torch.core import DODETLPipeline, SourceDatabase
    from repro_torch.data.sampler import SamplerConfig, SteelworksSampler
    cfg = steelworks_config(n_partitions=N_UNITS, partition_strategy=strategy)
    src = SourceDatabase()
    sampler = SteelworksSampler(cfg, SamplerConfig(
        records_per_table=CLUSTER_RECORDS, n_equipment=N_UNITS, seed=0))
    pipe = DODETLPipeline(cfg, src, n_workers=5, device=device, fault=fault,
                          tracer=tracer)
    return cfg, src, sampler, pipe


def views_for(backend):
    from repro_torch.serving import MaterializedViewEngine, steelworks_views
    return MaterializedViewEngine(steelworks_views(N_UNITS), backend=backend)


def dashboard_burst(engine):
    """The example's dashboard refresh: 412 queries through the batched
    front (its own stream), every answer awaited."""
    from repro_torch.serving import (BatchedReportServer, ReportQuery,
                                     ReportServer)
    front = BatchedReportServer(ReportServer(engine), max_batch=4096,
                                max_wait_ms=2.0)
    front.start()
    burst = [ReportQuery("oee", unit=u) for u in range(N_UNITS)] * 20 \
        + [ReportQuery("top_downtime", k=3), ReportQuery("shift_report"),
           ReportQuery("production_rate")] * 4
    try:
        answers = [t.result(timeout=30.0)
                   for t in [front.submit(q) for q in burst]]
    finally:
        front.stop()
    return answers, front.stats()


def run_cluster_pre_extracted():
    """(a): the whole stream published before the cluster starts, then
    the full rescan and the dashboard burst. Returns (pipeline, engine,
    report, rescan, answers, stage spans)."""
    from repro_torch.observability.tracer import StageTracer
    from repro_torch.runtime.cluster import ConcurrentCluster
    tracer = StageTracer()
    _, src, sampler, pipe = steelworks_deployment(DEVICE, tracer=tracer)
    sampler.generate(src)
    pipe.extract()
    engine = views_for(pipe.backend)
    cluster = ConcurrentCluster(pipe, max_records_per_partition=CLUSTER_CAP,
                                poll_cdc=False, serving=engine)
    cluster.start()
    done = cluster.run_until_idle(timeout=300)
    cluster.stop_all()
    if done != CLUSTER_RECORDS:
        fail(f"pre-extracted cluster loaded {done} of {CLUSTER_RECORDS}")
    report = cluster.report()
    spans = stage_spans(tracer, cluster._t_start)
    rescan = pipe.warehouse.kpi_rollup(N_UNITS)     # segment_rollup kernel
    answers, _ = dashboard_burst(engine)
    return pipe, engine, report, rescan, answers, spans


def stage_spans(tracer, t_start: float) -> dict:
    """Where the cluster run's wall time went, from the pipeline's own
    stage spans: per span name its count and summed seconds (over all
    threads), and per worker the seconds from start to its first fetch
    and to its last commit."""
    per_name, first, last = {}, {}, {}
    for ph, name, lane, t0, dur, _ in tracer.events():
        if ph != "X":
            continue
        c, t = per_name.get(name, (0, 0.0))
        per_name[name] = (c + 1, t + dur)
        worker = lane.split(".")[0]
        if name == "ingest.fetch":
            first[worker] = min(first.get(worker, t0), t0)
        if name == "load.commit":
            last[worker] = max(last.get(worker, t0 + dur), t0 + dur)
    return {"per_name": per_name,
            "workers": {w: (first[w] - t_start, last.get(w, first[w])
                            - t_start) for w in sorted(first)}}


def print_cluster_report(label: str, rep: dict, card: str) -> None:
    sv = rep["serving"]
    print(f"cluster {label} [{card}]: {rep['records']} records in "
          f"{rep['wall_s']} s = {rep['records_s']} records/s on "
          f"{rep['n_workers']} workers; freshness p50/p95 "
          f"{rep['p50_ms']:.3f}/{rep['p95_ms']:.3f} ms; report staleness "
          f"p50/p95 {sv['staleness_p50_ms']:.3f}/"
          f"{sv['staleness_p95_ms']:.3f} ms; views at epoch {sv['epoch']}")


def check_cluster_pre_extracted(clu, gpu, cpu, card: str) -> None:
    import numpy as np
    pipe, engine, rep, rescan, answers, spans = clu
    facts = pipe.warehouse.canonical_fact_table().tobytes()
    for other, what in ((gpu[0], "sequential card run"),
                        (cpu[0], "CPU run")):
        if facts != other.warehouse.canonical_fact_table().tobytes():
            fail(f"cluster facts are not byte-identical to the {what}")
    running = pipe.warehouse.kpi_running()
    if running is None:
        fail("kpi_running() is None after the cluster run")
    diff = float(np.abs(running - rescan).max())
    if not diff <= 1e-2:
        fail(f"kpi_running vs the card's rescan: max diff {diff} > 1e-2")
    if len(answers) != 412 or any(a is None for a in answers):
        fail("dashboard burst did not answer every query")
    if engine.snapshot().rows_folded != CLUSTER_RECORDS:
        fail("views do not cover every loaded fact")
    print(f"cluster (a) pre-extracted: {pipe.warehouse.rows_loaded} facts "
          f"byte-identical to the sequential card run and to the CPU run; "
          f"kpi_running vs the card's full rescan: max diff {diff:.6g} "
          f"(tol 1e-2); 412 dashboard answers")
    print_cluster_report("(a) pre-extracted", rep, card)
    print("  stage spans (count, summed s over all threads): " + ", ".join(
        f"{k} {c} / {t:.3f}" for k, (c, t) in sorted(
            spans["per_name"].items())))
    print("  per worker, s from start to first fetch / last commit: "
          + ", ".join(f"{w} {a:.3f}/{b:.3f}"
                      for w, (a, b) in spans["workers"].items()))


def run_cluster_live(gpu, card: str) -> None:
    """(b): the feed publishes while the cluster extracts (poll_cdc);
    w1 and w3 die after a quarter of the stream, the cluster scales back
    to 4 after half."""
    import numpy as np
    from repro_torch.runtime.cluster import ConcurrentCluster
    _, src, sampler, pipe = steelworks_deployment(DEVICE)
    engine = views_for(pipe.backend)
    cluster = ConcurrentCluster(pipe, max_records_per_partition=CLUSTER_CAP,
                                serving=engine)
    feeder = threading.Thread(target=lambda: sampler.generate(src))
    cluster.start()
    feeder.start()

    def wait_done(n):
        t0 = time.perf_counter()
        while cluster.records_done() < n:
            if time.perf_counter() - t0 > 120:
                fail(f"live cluster stalled at {cluster.records_done()}")
            time.sleep(0.002)

    wait_done(CLUSTER_RECORDS // 4)
    redump = cluster.fail_workers(["w1", "w3"])
    at_fail = cluster.records_done()
    wait_done(CLUSTER_RECORDS // 2)
    cluster.scale_to(4)
    feeder.join(120)
    if feeder.is_alive():
        fail("feeder did not finish")
    done = cluster.run_until_idle(timeout=300)
    cluster.stop_all()
    rep = cluster.report()
    drops = sum(rt.worker.buffer.dropped for rt in cluster.runtimes.values())
    wh = pipe.warehouse
    if done != CLUSTER_RECORDS or wh.rows_loaded != CLUSTER_RECORDS:
        fail(f"live cluster lost records: {wh.rows_loaded} loaded of "
             f"{CLUSTER_RECORDS}")
    if drops:
        fail(f"live cluster dropped {drops} buffered records")
    a = wh.canonical_fact_table()
    b = gpu[0].warehouse.canonical_fact_table()
    order = lambda t: t[np.lexsort((t[:, 2], t[:, 1], t[:, 0]))]
    if a.shape != b.shape or not np.array_equal(order(a)[:, :3],
                                                order(b)[:, :3]):
        fail("live cluster identity columns differ from the sequential run")
    if not (a[:, -1] > 0.5).all() or not np.isfinite(a).all():
        fail("live cluster facts are not all valid and finite")
    print(f"cluster (b) live feed: w1, w3 failed after {at_fail} records "
          f"(caches re-dumped in {redump * 1e3:.1f} ms), scaled to 4; "
          f"{wh.rows_loaded} loaded, 0 lost, 0 buffer drops, identity "
          f"columns equal to the sequential run; workers alive "
          f"{sorted(cluster.alive_workers())}")
    print_cluster_report("(b) live feed", rep, card)


SHARDS = 4                         # serving shards of phase 5c, one card


def run_cluster_sharded():
    """(c): the pre-extracted stream through the cluster with a
    ``ShardedViewEngine`` of ``SHARDS`` shards on the card (the skew
    strategy's routing; ``repartition()`` once half the records are
    loaded), then the dashboard burst. Returns (pipeline, engine, report,
    answers, front stats, repartition seconds, launches of the run,
    launches of the burst, stage spans, mesh report)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_shard_mesh
    from repro_torch.observability.tracer import StageTracer
    from repro_torch.runtime.cluster import ConcurrentCluster
    from repro_torch.runtime.shard_plane import ShardedViewEngine
    from repro_torch.serving import steelworks_views
    tracer = StageTracer()
    _, src, sampler, pipe = steelworks_deployment(DEVICE, tracer=tracer,
                                                  strategy="skew")
    sampler.generate(src)
    pipe.extract()
    engine = ShardedViewEngine(steelworks_views(N_UNITS), n_shards=SHARDS,
                               backend=pipe.backend)
    pipe.backend.set_mesh(make_shard_mesh(SHARDS))
    try:
        cluster = ConcurrentCluster(
            pipe, max_records_per_partition=CLUSTER_CAP, poll_cdc=False,
            serving=engine)
        reset_launch_counts()
        cluster.start()
        t0 = time.perf_counter()
        while cluster.records_done() < CLUSTER_RECORDS // 2:
            if time.perf_counter() - t0 > 120:
                fail(f"sharded cluster stalled at {cluster.records_done()}")
            time.sleep(0.002)
        t0 = time.perf_counter()
        cluster.repartition()
        repartition_s = time.perf_counter() - t0
        done = cluster.run_until_idle(timeout=300)
        cluster.stop_all()
        run_counts = launch_counts()
        if done != CLUSTER_RECORDS:
            fail(f"sharded cluster loaded {done} of {CLUSTER_RECORDS}")
        report = cluster.report()
        spans = stage_spans(tracer, cluster._t_start)
        reset_launch_counts()
        answers, stats = dashboard_burst(engine)
        burst_counts = launch_counts()
        mesh = engine.mesh_report()          # while the mesh is attached
    finally:
        pipe.backend.set_mesh(None)
    return (pipe, engine, report, answers, stats, repartition_s, run_counts,
            burst_counts, spans, mesh)


def same_answers(a, b) -> bool:
    """Two reports' data, value for value, bit for bit."""
    import numpy as np
    if a.view != b.view or a.data.keys() != b.data.keys():
        return False
    return all(np.asarray(a.data[k]).tobytes() == np.asarray(
        b.data[k]).tobytes() for k in a.data)


def check_cluster_sharded(shd, clu, cpu, card: str) -> dict:
    """Phase 5c's checks: facts byte-identical to 5a's unsharded card run
    and to the CPU run; every view, through owner_gather (the front) and
    tree_reduce, and every burst answer bitwise an unsharded engine's on
    the same committed stream (the warehouse's chunk log, folded on the
    card: a cluster's delta order is its own, so two cluster runs' float
    sums differ in order); one fold_segments_many launch per fold cycle
    and one gather_stats_many launch per query batch. Returns the run's
    launch counts by kernel."""
    from repro_torch.runtime.shard_plane import owner_gather
    (pipe, engine, rep, answers, stats, repartition_s, run_counts,
     burst_counts, spans, mesh) = shd
    facts = pipe.warehouse.canonical_fact_table().tobytes()
    for other, what in ((clu[0], "unsharded card cluster run (a)"),
                        (cpu[0], "CPU run")):
        if facts != other.warehouse.canonical_fact_table().tobytes():
            fail(f"sharded cluster facts are not byte-identical to the "
                 f"{what}")
    if pipe.current_routing().epoch < 1:
        fail("the mid-run repartition() made no new routing epoch")
    if not mesh["device_mesh"]:
        fail("the shard mesh was not attached to the card's backend")
    snap = engine.snapshot()
    if snap.rows_folded != CLUSTER_RECORDS:
        fail("sharded views do not cover every loaded fact")
    plain = views_for(pipe.backend)
    for chunk in pipe.warehouse.read_view().chunks:
        plain.publish(chunk)
    plain.fold_pending()
    for spec in engine.specs:
        want = plain.snapshot().view(spec.name).table.tobytes()
        gathered = owner_gather(snap.shard_states[spec.name],
                                snap.seg_owners[spec.name]).tobytes()
        if not (snap.view(spec.name).table.tobytes() == gathered == want
                == engine.tree_reduced_table(spec.name).tobytes()):
            fail(f"sharded view {spec.name} is not bitwise the unsharded "
                 f"engine's (owner_gather / tree_reduce)")
    plain_answers, _ = dashboard_burst(plain)
    if len(answers) != 412 or not all(
            same_answers(a, b) for a, b in zip(answers, plain_answers)):
        fail("sharded burst answers are not bitwise the unsharded front's")
    folds, gathers = (run_counts["fold_segments_many"],
                      burst_counts["gather_stats_many"])
    if folds != mesh["fold"]["cycles"] or folds < 1:
        fail(f"{folds} fold_segments_many launches for "
             f"{mesh['fold']['cycles']} fold cycles")
    if gathers != stats["point_executes"] or gathers < 1:
        fail(f"{gathers} gather_stats_many launches for "
             f"{stats['point_executes']} query batches")
    print(f"cluster (c) {SHARDS} shards on one card, skew routing: "
          f"repartition() at {CLUSTER_RECORDS // 2} records made routing "
          f"epoch {pipe.current_routing().epoch} in {repartition_s:.3f} s "
          f"({mesh['segments_moved']} view segments moved shard); "
          f"{pipe.warehouse.rows_loaded} facts "
          f"byte-identical to run (a) and to the CPU run; the 4 views "
          f"bitwise an unsharded engine on the same chunk log through "
          f"owner_gather and tree_reduce; 412 burst answers bitwise the "
          f"unsharded front's")
    print(f"  launches: {folds} fold_segments_many for "
          f"{mesh['fold']['cycles']} fold cycles ({mesh['fold']['items']} live (delta, view, shard) "
          f"items); {gathers} gather_stats_many for "
          f"{stats['point_executes']} query batches with point queries "
          f"({stats['batches']} batches, {stats['queries']} queries)")
    print_cluster_report(f"(c) {SHARDS} shards", rep, card)
    print("  stage spans (count, summed s over all threads): " + ", ".join(
        f"{k} {c} / {t:.3f}" for k, (c, t) in sorted(
            spans["per_name"].items())))
    print(f"  mesh_report: {json.dumps(mesh)}")
    return {k: run_counts[k] + burst_counts[k] for k in run_counts}


# ------------------------------------------------------------------ phase 6
def rescan_table(rng, n: int, n_units: int):
    """``n`` fact rows from the seed: units in [-3, n_units + 3) with
    fractional parts (some truncate into range, some out of it), 1% NaN,
    20% invalid rows, finite KPI lanes in [0, 1)."""
    import numpy as np
    f = rng.random((n, 10), dtype=np.float32)
    f[:, 0] = (rng.integers(-3, n_units + 3, n)
               + rng.choice(np.float32([0.0, 0.25, -0.5, 0.75]), n))
    f[rng.random(n) < 0.01, 0] = np.nan
    f[:, 9] = (rng.random(n) > 0.2).astype(np.float32)
    return f


def rollup_bitwise(t, n_units: int, what: str):
    import torch
    from repro_torch.kernels.segment_kpi.ops import segment_rollup
    from repro_torch.kernels.segment_kpi.ref import segment_rollup_ref
    want = segment_rollup_ref(t, n_units)
    got = segment_rollup(t, n_units)
    torch.cuda.synchronize()
    if not same_bits(got, want):
        fail(f"segment_rollup differs from the plain version ({what})")
    return want


def check_segment_rollup(rng, dev, pipe, card: str) -> dict:
    import torch
    from repro_torch.kernels.segment_kpi.ops import segment_rollup
    from repro_torch.kernels.segment_kpi.ref import segment_rollup_ref
    for n in (1, 255, 257):
        t = torch.tensor(rescan_table(rng, n + 1, N_UNITS), device=dev)
        for view, where in ((t[:n], "16-byte aligned"),
                            (t[1:], "40 bytes in")):
            rollup_bitwise(view, N_UNITS, f"{n} rows, {where}")
    warehouse = torch.tensor(pipe.warehouse.fact_table(), device=dev)
    rollup_bitwise(warehouse, N_UNITS, f"the cluster's "
                   f"{warehouse.shape[0]} facts")
    many = torch.tensor(rescan_table(rng, 20_000, MANY_UNITS), device=dev)
    rollup_bitwise(many, MANY_UNITS, f"20000 rows, {MANY_UNITS} units")
    n = 1 << 20
    big = torch.tensor(rescan_table(rng, n, N_UNITS), device=dev)
    agg = rollup_bitwise(big, N_UNITS, f"{n} rows")
    clustered = big[big[:, 0].argsort()].contiguous()
    rollup_bitwise(clustered, N_UNITS, f"{n} rows sorted by unit")
    print(f"segment_rollup: bitwise equal to the plain version at 1, 255 "
          f"and 257 rows (aligned and 40 bytes in), on the cluster's "
          f"{warehouse.shape[0]} facts, on 20000 rows over {MANY_UNITS} "
          f"units and on {n} seeded rows, spread over units and sorted by "
          f"unit ({int(agg[:, 4].sum())} counted)")
    unit = big[:, 0].to(torch.int64)
    keep = ((big[:, 9] > 0.5) & ~torch.isnan(big[:, 0]) & (unit >= 0)
            & (unit < N_UNITS))
    lanes = torch.cat([big[keep, 3:7], torch.ones(
        (int(keep.sum()), 1), dtype=torch.float32, device=dev)], dim=1)
    idx = unit[keep].contiguous()

    def library():
        return torch.zeros((N_UNITS, 5), dtype=torch.float32,
                           device=dev).index_add_(0, idx, lanes)
    lib = library()
    print(f"  index_add_ over the pre-masked lanes: max diff "
          f"{float((lib - agg).abs().max()):.3g} from the kernel (not "
          f"bitwise: atomic order)")
    print(f"  segment_rollup at {n} rows sorted by unit: "
          f"{graph_ms(lambda: segment_rollup(clustered, N_UNITS)):.7f} ms "
          f"(device, CUDA graph) [{card}]")
    for label, t in (("the cluster's facts", warehouse),
                     (f"{n} rows", big)):
        profile_run(f"segment_rollup x 20 at {label}",
                    lambda: [segment_rollup(t, N_UNITS) for _ in range(20)],
                    card)
    b_ms, b_by = bound(n * 40 + N_UNITS * 5 * 4, n * 5)
    return {"name": "segment_rollup", "max_abs_err": 0.0,
            "ms": graph_ms(lambda: segment_rollup(big, N_UNITS)),
            "plain_ms": graph_ms(lambda: segment_rollup_ref(big, N_UNITS),
                                 reps=2, rounds=3),
            "issue_ms": issue_ms(lambda: segment_rollup(big, N_UNITS)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": graph_ms(library),
            "cluster_facts_ms": graph_ms(lambda: segment_rollup(
                warehouse, N_UNITS)),
            "shape": f"[{n}, 10] -> [{N_UNITS}, 5]"}


# ------------------------------------------------------------------ phase 7
def check_durability(clu) -> None:
    """Crash the journaling cluster at commit.post, recover on the card,
    finish the stream: the facts must be the uninterrupted run's bytes."""
    from repro_torch.durability import (DurabilityJournal, FaultInjector,
                                        RecoveryCoordinator,
                                        recover_pipeline)
    from repro_torch.durability.faults import COMMIT_POST
    from repro_torch.runtime.cluster import ConcurrentCluster
    # the crash is armed once the explicit checkpoint below has journaled
    # the first tenth of the stream (a capture still waiting for its
    # locks at the crash journals nothing), and comes 10 loads later (a
    # load holds 150-800 records, so 17-50% through); the periodic
    # checkpointer runs besides
    fault = FaultInjector({})
    cfg, src, sampler, pipe = steelworks_deployment(DEVICE, fault=fault)
    sampler.generate(src)
    pipe.extract()
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_journal-", dir=scratch)
    try:
        cluster = ConcurrentCluster(
            pipe, max_records_per_partition=CLUSTER_CAP, poll_cdc=False,
            serving=views_for(pipe.backend),
            recovery=RecoveryCoordinator(DurabilityJournal(root)),
            checkpoint_every_s=0.05)
        cluster.checkpoint()
        cluster.start()
        t0 = time.perf_counter()
        while pipe.warehouse.rows_loaded < CLUSTER_RECORDS // 10:
            if time.perf_counter() - t0 > 120:
                fail("the journaling cluster stalled")
            time.sleep(0.001)
        if cluster.checkpoint() is None:
            fail("the explicit checkpoint journaled nothing")
        fault.schedule[COMMIT_POST] = 10
        if not fault.tripped.wait(120):
            fail("the commit.post crash point was never reached")
        cluster.abandon()
        crashed_at = pipe.warehouse.rows_loaded
        engine2 = views_for(pipe.backend)
        pipe2, coord2, info = recover_pipeline(
            cfg, src, DurabilityJournal(root), engine=engine2,
            device=DEVICE)
        if info is None or info["commit_seq"] == 0:
            fail("the journal held no loaded state at the crash")
        cluster2 = ConcurrentCluster(
            pipe2, max_records_per_partition=CLUSTER_CAP, poll_cdc=False,
            serving=engine2, recovery=coord2, checkpoint_every_s=0.05)
        cluster2.start()
        cluster2.run_until_idle(timeout=300)
        cluster2.stop_all()
        steps = len(DurabilityJournal(root).steps())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wh = pipe2.warehouse
    if wh.rows_loaded != CLUSTER_RECORDS:
        fail(f"recovered run loaded {wh.rows_loaded} of {CLUSTER_RECORDS}")
    if wh.canonical_fact_table().tobytes() != \
            clu[0].warehouse.canonical_fact_table().tobytes():
        fail("recovered facts are not byte-identical to the uninterrupted "
             "run")
    import torch
    rollup_bitwise(torch.tensor(wh.fact_table(), device=DEVICE), N_UNITS,
                   "the recovered warehouse")
    if engine2.snapshot().rows_folded != CLUSTER_RECORDS:
        fail("recovered views do not cover every fact")
    print(f"durability: crashed at commit.post with {crashed_at} rows "
          f"loaded, recovered journal step {info['step']} (commit seq "
          f"{info['commit_seq']}, {info['replayed_chunks']} chunks "
          f"replayed into the views), finished: {wh.rows_loaded} facts "
          f"byte-identical to the uninterrupted run; rescan bitwise its "
          f"plain version; {steps} journal steps")


# ------------------------------------------------------------------ phase 8
LM_ARCHS = ("internlm2-1.8b", "zamba2-1.2b", "rwkv6-7b", "qwen2-moe-a2.7b",
            "qwen2-vl-7b", "whisper-small")
# each model's serve path in the kernels record
LM_PATHS = {"internlm2-1.8b": "lm_internlm2", "zamba2-1.2b": "lm_zamba2",
            "rwkv6-7b": "lm_rwkv6", "qwen2-moe-a2.7b": "lm_qwen2moe",
            "qwen2-vl-7b": "lm_qwen2vl", "whisper-small": "lm_whisper"}
LM_BATCH, LM_PROMPT, LM_DECODE, LM_TAIL = 4, 2048, 32, 4
# whisper's decoder prompt: 416 tokens + 32 decode steps fill its 448-token
# text context (arXiv:2212.04356)
WHISPER_PROMPT = 416
# qwen2-moe's f32 weights (~57 GB) leave no room for the activations: its
# f32 prefill check runs at full width, 8 of its 24 layers
MOE_F32_LAYERS = 8
NEAR_TIE = 1e-4                    # router probabilities this close tie
# rwkv6-7b's measured bf16 miss and f32 head (rwkv6_bf16_miss,
# rwkv6_f32_head)
RWKV6_BF16_SLACK = 1.25
RWKV6_HEAD, RWKV6_HEAD_SLACK = 16, 1.5
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py
GLA_TOL = 2e-4


def stored_elems(t) -> int:
    """Elements a tensor's storage holds for it: broadcast (zero-stride)
    axes count once."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st != 0)


def max_err(got, want, tol: float, what: str) -> float:
    """Max |got - want|; fails unless every element is within tol + tol *
    |want| (numpy's allclose with rtol = atol = tol)."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if not bool(((g - w).abs() <= tol + tol * w.abs()).all()):
        fail(f"{what}: max abs err {err} beyond rtol = atol = {tol}")
    return err


def lm_rand(shape, dev, dtype, gen):
    import torch
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def flash_inputs(b, hq, hkv, s, d, dtype, dev, gen):
    """q, k, v as the model hands them to the kernel: transposed views of
    [B, S, H, D] activations."""
    return tuple(lm_rand((b, s, h, d), dev, dtype, gen).transpose(1, 2)
                 for h in (hq, hkv, hkv))


def flash_bound(q, k, v, causal=True):
    """Least time for one attention call: each input read once and the
    output written once over HBM, against 4·B·Hq·Sq·Skv·D flops (full;
    half of that causal, at Sq = Skv) over the input dtype's peak."""
    import torch
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    n_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    flops = (2 if causal else 4) * b * hq * sq * skv * d
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    return bound(n_bytes, flops, peak)


def design_moved(before, after, key: str, n: int, what: str) -> None:
    """Fail unless the per-design launch count ``key`` moved by ``n``."""
    got = after[key] - before[key]
    if got != n:
        fail(f"{what}: {key} launched {got} times, expected {n}")


def check_flash(dev, gen, card) -> list:
    """Both flash_attention designs against the plain version at both
    models' serving shapes and ragged S: f32 (the CUDA-core design, 2e-5)
    and bf16 (the tensor-core design, 2e-2); then both designs timed side
    by side on the bf16 shapes. Returns the two designs' records
    (internlm2's shape)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import build_model
    errs = {"simt": [], "tc": []}
    rows = {}
    for arch in ("internlm2-1.8b", "zamba2-1.2b"):
        cfg = build_model(arch).cfg
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            design = "tc" if dtype == torch.bfloat16 else "simt"
            for s in (LM_PROMPT, LM_PROMPT - LM_TAIL, 1000):
                q, k, v = flash_inputs(LM_BATCH, hq, hkv, s, d, dtype, dev,
                                       gen)
                before = launch_counts()
                got = mha(q, k, v)
                design_moved(before, launch_counts(), "flash_attention_tc",
                             int(design == "tc"), f"flash {arch} {name}")
                want = attention_ref(q, k, v)
                torch.cuda.synchronize()
                errs[design].append(max_err(
                    got, want, FLASH_TOL[name],
                    f"flash_attention {arch} {name} S={s}"))
            print(f"flash_attention {arch} [B {LM_BATCH}, Hq {hq}, Hkv {hkv},"
                  f" D {d}] {name} ({'tensor-core' if design == 'tc' else 'CUDA-core'}"
                  f" design), S in {{{LM_PROMPT}, {LM_PROMPT - LM_TAIL}, "
                  f"1000}}: within {FLASH_TOL[name]} of the plain version, "
                  f"max abs err {max(errs[design][-3:]):.3g}")
        q, k, v = flash_inputs(LM_BATCH, hq, hkv, LM_PROMPT, d,
                               torch.bfloat16, dev, gen)
        plain_ms = graph_ms(lambda: attention_ref(q, k, v), reps=3, rounds=3)
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        b_ms, b_by = flash_bound(q, k, v)
        want = attention_ref(q, k, v)
        for design in ("tc", "simt"):
            errs[design].append(max_err(
                mha(q, k, v, design=design), want, FLASH_TOL["bfloat16"],
                f"flash_attention {arch} bf16 pinned to {design}"))
        del want
        for design in ("simt", "tc", "tc", "simt"):    # in turns
            fn = lambda: mha(q, k, v, design=design)
            t = {"ms": graph_ms(fn), "issue_ms": issue_ms(fn, reps=10)}
            old = rows.get((arch, design))
            rows[(arch, design)] = t if old is None else {
                key: min(old[key], t[key]) for key in t}
        for design in ("tc", "simt"):
            t = rows[(arch, design)]
            t.update(plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                     bound_by=b_by)
            print(f"  flash_attention {arch} bf16 S={LM_PROMPT}, "
                  f"{'tensor-core' if design == 'tc' else 'CUDA-core'} design:"
                  f" {t['ms']:.5f} ms kernel ({2 * LM_BATCH * hq * LM_PROMPT**2 * d / t['ms'] / 1e9:.1f} TFLOP/s), "
                  f"{plain_ms:.5f} ms plain, {library_ms:.5f} ms "
                  f"scaled_dot_product_attention (device, CUDA graph; the "
                  f"better of two turns), {t['issue_ms']:.5f} ms per "
                  f"host-issued call, bound {b_ms:.6f} ms ({b_by}, bf16 "
                  f"tensor-core peak) [{card}]")
    r_errs, regimes = check_flash_regimes(dev, gen, card)
    main = "internlm2-1.8b"
    return [{"name": "flash_attention",
             "max_abs_err": max(errs["simt"] + r_errs["simt"]),
             "zamba2": rows[("zamba2-1.2b", "simt")], **rows[(main, "simt")]},
            {"name": "flash_attention_tc",
             "max_abs_err": max(errs["tc"] + r_errs["tc"]),
             "zamba2": rows[("zamba2-1.2b", "tc")], **regimes,
             **rows[(main, "tc")]}]


# the other families' attention calls: (label, arch, Sq, Skv, causal, the
# key of its timing in the kernels record or None)
FLASH_REGIMES = (
    ("whisper encoder", "whisper-small", 1500, 1500, False,
     "whisper_encoder"),
    ("whisper cross-attention, prefill", "whisper-small", WHISPER_PROMPT,
     1500, False, None),
    ("whisper cross-attention, decode", "whisper-small", 1, 1500, False,
     None),
    ("whisper decoder self-attention", "whisper-small", WHISPER_PROMPT,
     WHISPER_PROMPT, True, None),
    ("qwen2-vl self-attention (GQA group 7)", "qwen2-vl-7b", LM_PROMPT,
     LM_PROMPT, True, "qwen2_vl"),
    ("qwen2-moe self-attention", "qwen2-moe-a2.7b", LM_PROMPT, LM_PROMPT,
     True, None))


def check_flash_regimes(dev, gen, card):
    """Phase 8's flash checks at the other families' shapes, read through
    the model's [B, S, H, D] layout: full attention (whisper's encoder, its
    cross-attention with Sq != Skv: 416 and 1 queries against 1500 keys,
    a ragged last key tile), causal (whisper's decoder, qwen2-vl's GQA
    group 7, qwen2-moe) — bf16 on the tensor-core design within 2e-2, f32
    on the CUDA-core design within 2e-5 of the plain version, each call's
    design checked by the counters. At whisper's encoder shape and
    qwen2-vl's, the tensor-core design's device and issue times, the
    plain version's, ``scaled_dot_product_attention``'s (``is_causal`` as
    the call's, ``enable_gqa``) and the bound. Returns (errors per design,
    the timed records by key)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import build_model
    errs = {"simt": [], "tc": []}
    rows = {}
    for label, arch, sq, skv, causal, key in FLASH_REGIMES:
        cfg = build_model(arch).cfg
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        shape = (f"q [{LM_BATCH}, {hq}, {sq}, {d}], k/v [{LM_BATCH}, {hkv}, "
                 f"{skv}, {d}], causal={causal}")
        got_errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            design = "tc" if dtype == torch.bfloat16 else "simt"
            q = lm_rand((LM_BATCH, sq, hq, d), dev, dtype, gen).transpose(1, 2)
            k, v = (lm_rand((LM_BATCH, skv, hkv, d), dev, dtype,
                            gen).transpose(1, 2) for _ in range(2))
            before = launch_counts()
            got = mha(q, k, v, causal=causal)
            after = launch_counts()
            design_moved(before, after, "flash_attention", 1, label)
            design_moved(before, after, "flash_attention_tc",
                         int(design == "tc"), f"{label} {name}")
            want = attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            got_errs[design] = max_err(got, want, FLASH_TOL[name],
                                       f"flash_attention {label} {name}")
            errs[design].append(got_errs[design])
            del got, want
        print(f"flash_attention {label}, {shape}: bf16 (tensor-core design)"
              f" within {FLASH_TOL['bfloat16']}, max abs err "
              f"{got_errs['tc']:.3g}; f32 (CUDA-core design) within "
              f"{FLASH_TOL['float32']}, max abs err {got_errs['simt']:.3g}")
        if key is None:
            continue
        # q, k, v of the last (bf16) round: time them
        fn = lambda: mha(q, k, v, causal=causal)
        t = {"ms": graph_ms(fn), "issue_ms": issue_ms(fn, reps=10),
             "plain_ms": graph_ms(lambda: attention_ref(q, k, v,
                                                        causal=causal),
                                  reps=3, rounds=3),
             "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=causal, enable_gqa=True)),
             "shape": shape}
        t["bound_ms"], t["bound_by"] = flash_bound(q, k, v, causal)
        flops = (2 if causal else 4) * LM_BATCH * hq * sq * skv * d
        rows[key] = t
        print(f"  flash_attention {label} bf16, tensor-core design: "
              f"{t['ms']:.5f} ms kernel ({flops / t['ms'] / 1e9:.1f} "
              f"TFLOP/s), {t['plain_ms']:.5f} ms plain, "
              f"{t['library_ms']:.5f} ms scaled_dot_product_attention "
              f"(device, CUDA graph), {t['issue_ms']:.5f} ms per host-issued"
              f" call, bound {t['bound_ms']:.6f} ms ({t['bound_by']}, bf16 "
              f"tensor-core peak) [{card}]")
        del q, k, v
    torch.cuda.empty_cache()
    return errs, rows


def gla_inputs(b, s, h, dk, dv, dtype, dev, gen, *, mamba):
    """Mamba2's inputs as the model hands them over (q, k shared by all
    heads, one decay per head, as zero-stride views), or RWKV6-shaped ones
    (per-head q, k and per-channel decay)."""
    import torch
    if mamba:
        q = lm_rand((b, s, 1, dk), dev, dtype, gen).expand(b, s, h, dk)
        k = lm_rand((b, s, 1, dk), dev, dtype, gen).expand(b, s, h, dk)
        lw = (-torch.exp(lm_rand((b, s, h, 1), dev, torch.float32, gen))
              ).expand(b, s, h, dk)
    else:
        q = lm_rand((b, s, h, dk), dev, dtype, gen)
        k = lm_rand((b, s, h, dk), dev, dtype, gen)
        lw = -torch.exp(lm_rand((b, s, h, dk), dev, torch.float32, gen))
    return q, k, lm_rand((b, s, h, dv), dev, dtype, gen), lw


def gla_work(q, v, inclusive: bool) -> float:
    """Operations of one gla_chunk call, from its shapes: per chunk and
    head, the intra scores (5 per (t, i, d) pair: sub, exp, 2 mul, add over
    the unmasked pairs), the intra, inter and state products (2 each per
    multiply-add), the decays (3 per element) and the cumsum."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    c = 64
    n = -(-s // c)
    pairs = c * (c + 1) // 2 if inclusive else c * (c - 1) // 2
    per_chunk = (5 * pairs * dk + 2 * pairs * dv + 2 * c * dk * dv
                 + 2 * c * dk * dv + 6 * c * dk + 3 * dk * dv)
    return float(b * h * n * per_chunk)


def check_gla(dev, gen, card) -> list:
    """Both gla_chunk designs against the plain version: f32 in both
    regimes (the serial design, 2e-4), then zamba2's bf16 Mamba2 inputs
    (the SSD design: out 2e-2, final state 2e-4) at S 2048, 2044 and 1000,
    with and without an initial state; then both designs timed side by
    side on zamba2's bf16 shape. Returns the two designs' records."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.gla_chunk.ops import CHUNK, gla
    from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref
    from repro_torch.models import build_model
    cfg = build_model("zamba2-1.2b").cfg
    h = cfg.ssm.n_ssm_heads
    dk = cfg.ssm.state_size
    dv = cfg.ssm.expand * cfg.d_model // h
    errs = {"serial": [], "ssd": []}
    state_errs = {"serial": [], "ssd": []}
    cases = [(True, False, True, LM_BATCH, torch.float32),   # Mamba2 f32
             (False, True, False, 1, torch.float32),         # RWKV6
             (True, False, True, LM_BATCH, torch.bfloat16)]  # zamba2's
    for inclusive, use_u, mamba, b, dtype in cases:
        design = "ssd" if dtype == torch.bfloat16 else "serial"
        for s in (LM_PROMPT, LM_PROMPT - LM_TAIL, 1000):
            for with_state in (False, True):
                q, k, v, lw = gla_inputs(b, s, h, dk, dv, dtype, dev, gen,
                                         mamba=mamba)
                u = lm_rand((h, dk), dev, torch.float32, gen) if use_u \
                    else None
                s0 = (lm_rand((b, h, dk, dv), dev, torch.float32, gen)
                      if with_state else None)
                before = launch_counts()
                out, fin = gla(q, k, v, lw, u, inclusive=inclusive,
                               initial_state=s0)
                what = (f"gla_chunk {'mamba2' if mamba else 'rwkv6'} "
                        f"{str(dtype)[6:]} S={s} state={with_state}")
                design_moved(before, launch_counts(), "gla_chunk_ssd",
                             int(design == "ssd"), what)
                r_out, r_fin = gla_chunk_ref(q, k, v, lw, u,
                                             inclusive=inclusive,
                                             initial_state=s0)
                torch.cuda.synchronize()
                out_tol = (FLASH_TOL["bfloat16"] if dtype == torch.bfloat16
                           else GLA_TOL)
                state_errs[design].append(
                    max_err(fin, r_fin, GLA_TOL, what + " final state"))
                errs[design].append(max(max_err(out, r_out, out_tol, what),
                                        state_errs[design][-1]))
        print(f"gla_chunk {'Mamba2 inclusive' if mamba else 'RWKV6 lag-1 + u'}"
              f" [B {b}, H {h}, dk {dk}, dv {dv}] {str(dtype)[6:]} ("
              f"{'SSD' if design == 'ssd' else 'serial'} design), S in "
              f"{{{LM_PROMPT}, {LM_PROMPT - LM_TAIL}, 1000}}, with and "
              f"without an initial state: out within {out_tol}, final "
              f"state within {GLA_TOL} of the plain version, max abs err "
              f"{max(errs[design][-6:]):.3g} (final state "
              f"{max(state_errs[design][-6:]):.3g})")
    q, k, v, lw = gla_inputs(LM_BATCH, LM_PROMPT, h, dk, dv, torch.bfloat16,
                             dev, gen, mamba=True)
    r_out, r_fin = gla_chunk_ref(q, k, v, lw, inclusive=True)
    for design in ("ssd", "serial"):
        out, fin = gla(q, k, v, lw, inclusive=True, design=design)
        errs[design].append(max(
            max_err(out, r_out, FLASH_TOL["bfloat16"], f"gla {design} out"),
            max_err(fin, r_fin, GLA_TOL, f"gla {design} state")))
    del r_out, r_fin
    plain_ms = graph_ms(lambda: gla_chunk_ref(q, k, v, lw, inclusive=True),
                        reps=2, rounds=3)
    n_bytes = (sum(x.element_size() * stored_elems(x) for x in (q, k, v, lw))
               + out.element_size() * out.numel() + 4 * fin.numel())
    b_ms, b_by = bound(n_bytes, gla_work(q, v, True), BF16_FLOP_PER_S)
    # the SSD design's f32 chunk states: written (1), read and rewritten
    # (2), read (3) — traffic the function's bound does not count
    n_chunks = -(-LM_PROMPT // CHUNK)
    scratch = 4 * 4 * LM_BATCH * h * n_chunks * dk * dv
    rows = {}
    for design in ("serial", "ssd", "ssd", "serial"):      # in turns
        fn = lambda: gla(q, k, v, lw, inclusive=True, design=design)
        t = {"ms": graph_ms(fn), "issue_ms": issue_ms(fn, reps=10)}
        old = rows.get(design)
        rows[design] = t if old is None else {key: min(old[key], t[key])
                                              for key in t}
    for design in ("ssd", "serial"):
        t = rows[design]
        t.update(plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                 bound_by=b_by)
        print(f"  gla_chunk zamba2 bf16 S={LM_PROMPT}, "
              f"{'SSD' if design == 'ssd' else 'serial'} design: "
              f"{t['ms']:.5f} ms kernel, {plain_ms:.5f} ms plain (device, "
              f"CUDA graph; the better of two turns), {t['issue_ms']:.5f} ms "
              f"per host-issued call, bound {b_ms:.6f} ms ({b_by}: "
              f"{n_bytes} B, {gla_work(q, v, True):.4g} operations at the "
              f"bf16 peak)"
              + (f"; chunk-state scratch {scratch} B more = "
                 f"{scratch / HBM_BYTES_PER_S * 1e3:.6f} ms at the HBM peak"
                 if design == "ssd" else "") + f" [{card}]")
    rows["ssd"]["scratch_bytes"] = scratch
    def ssd_call():
        gla(q, k, v, lw, inclusive=True, design="ssd")
        torch.cuda.synchronize()
    profile_run("gla_chunk SSD design, one call (its three kernels)",
                ssd_call, card)
    del q, k, v, lw, out, fin
    rwkv_err, rwkv, rwkv6_design = check_gla_rwkv6(dev, gen, card)
    return [{"name": "gla_chunk",
             "max_abs_err": max(errs["serial"] + [rwkv_err]),
             "zamba2": rows["serial"], **rwkv},
            {"name": "gla_chunk_ssd", "max_abs_err": max(errs["ssd"]),
             **rows["ssd"]},
            rwkv6_design]


def rwkv6_gla_inputs(b, s, h, dk, dev, gen):
    """rwkv6's time-mix inputs as the model hands them over: bf16 r, k, v
    [B, S, H, dk], the f32 per-channel log decay made as the model makes
    it, -exp(clip(x, -8, 4)), its first 4 channels at the clip's -e^4 per
    token (a chunk's cumulative decay near -3,500), and the f32 bonus u
    [H, dk]."""
    import torch
    r, k, v = (lm_rand((b, s, h, dk), dev, torch.bfloat16, gen)
               for _ in range(3))
    x = lm_rand((b, s, h, dk), dev, torch.float32, gen) * 3
    x[..., :4] = 4.0
    lw = -torch.exp(torch.clamp(x, -8.0, 4.0))
    return r, k, v, lw, lm_rand((h, dk), dev, torch.float32, gen)


def check_gla_rwkv6(dev, gen, card):
    """Phase 8's gla_chunk check in the RWKV6 regime at rwkv6-7b's shape
    ([4, S, 64, 64]; lag-1 read, bonus u, per-channel decay) in bf16, at S
    2048, 2044 and 1000, with and without an initial state: the RWKV6
    design (what ``gla`` picks) and the serial design pinned, each with
    out within 2e-2 and the final state within 2e-4 of the plain version
    and its launch counted as its own. Then both timed in turns (serial,
    RWKV6, RWKV6, serial) at S = 2048: device and issue time, the plain
    version's, the bound (bytes / 3.35 TB/s or ``gla_work`` operations at
    the bf16 peak) and the RWKV6 design's chunk-state scratch; its three
    kernels under the profiler. Returns (the serial design's max error and
    timed record, the RWKV6 design's record)."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.gla_chunk.ops import CHUNK, gla
    from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref
    from repro_torch.models import build_model
    cfg = build_model("rwkv6-7b").cfg
    h = cfg.ssm.n_ssm_heads
    dk = cfg.d_model // h
    errs = {"rwkv6": [], "serial": []}
    state_errs = {"rwkv6": [], "serial": []}
    for s in (LM_PROMPT, LM_PROMPT - LM_TAIL, 1000):
        for with_state in (False, True):
            r, k, v, lw, u = rwkv6_gla_inputs(LM_BATCH, s, h, dk, dev, gen)
            s0 = (lm_rand((LM_BATCH, h, dk, dk), dev, torch.float32, gen)
                  if with_state else None)
            r_out, r_fin = gla_chunk_ref(r, k, v, lw, u, inclusive=False,
                                         initial_state=s0)
            for design in ("auto", "serial"):
                name = "serial" if design == "serial" else "rwkv6"
                what = (f"gla_chunk rwkv6 bf16 S={s} state={with_state} "
                        f"{name} design")
                before = launch_counts()
                out, fin = gla(r, k, v, lw, u, inclusive=False,
                               initial_state=s0, design=design)
                after = launch_counts()
                design_moved(before, after, "gla_chunk", 1, what)
                design_moved(before, after, "gla_chunk_ssd", 0, what)
                design_moved(before, after, "gla_chunk_rwkv6",
                             int(name == "rwkv6"), what)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(out.float()).all()):
                    fail(f"{what}: output not finite")
                state_errs[name].append(max_err(fin, r_fin, GLA_TOL,
                                                what + " final state"))
                errs[name].append(max(max_err(out, r_out,
                                              FLASH_TOL["bfloat16"], what),
                                      state_errs[name][-1]))
                del out, fin
            del r_out, r_fin
    for name in ("rwkv6", "serial"):
        print(f"gla_chunk RWKV6 lag-1 + u [B {LM_BATCH}, H {h}, dk = dv "
              f"{dk}] bf16, decay -exp(clip(x, -8, 4)) with channels at "
              f"-e^4 ({'RWKV6' if name == 'rwkv6' else 'serial'} design), S "
              f"in {{{LM_PROMPT}, {LM_PROMPT - LM_TAIL}, 1000}}, with and "
              f"without an initial state: out within "
              f"{FLASH_TOL['bfloat16']}, final state within {GLA_TOL} of the"
              f" plain version, max abs err {max(errs[name]):.3g} (final "
              f"state {max(state_errs[name]):.3g})")
    r, k, v, lw, u = rwkv6_gla_inputs(LM_BATCH, LM_PROMPT, h, dk, dev, gen)
    plain_ms = graph_ms(lambda: gla_chunk_ref(r, k, v, lw, u,
                                              inclusive=False),
                        reps=2, rounds=3)
    n_bytes = (sum(x.element_size() * x.numel() for x in (r, k, v, lw, u))
               + v.element_size() * v.numel()
               + 4 * LM_BATCH * h * dk * dk)
    ops = gla_work(r, v, False)
    b_ms, b_by = bound(n_bytes, ops, BF16_FLOP_PER_S)
    # the RWKV6 design's f32 chunk states: written (1), read and rewritten
    # (2), read (3) — traffic the function's bound does not count
    n_chunks = -(-LM_PROMPT // CHUNK)
    scratch = 4 * 4 * LM_BATCH * h * n_chunks * dk * dk
    rows = {}
    for name in ("serial", "rwkv6", "rwkv6", "serial"):        # in turns
        fn = lambda: gla(r, k, v, lw, u, inclusive=False, design=name)
        t = {"ms": graph_ms(fn), "issue_ms": issue_ms(fn, reps=10)}
        old = rows.get(name)
        rows[name] = t if old is None else {key: min(old[key], t[key])
                                            for key in t}
    shape = (f"RWKV6 lag-1 + u, r/k/v [{LM_BATCH}, {LM_PROMPT}, {h}, {dk}] "
             f"bf16, decay f32 (rwkv6-7b)")
    for name in ("rwkv6", "serial"):
        t = rows[name]
        t.update(plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                 bound_by=b_by, shape=shape)
        print(f"  gla_chunk rwkv6 bf16 S={LM_PROMPT}, "
              f"{'RWKV6' if name == 'rwkv6' else 'serial'} design: "
              f"{t['ms']:.5f} ms kernel, {plain_ms:.5f} ms plain (device, "
              f"CUDA graph; the better of two turns), {t['issue_ms']:.5f} ms"
              f" per host-issued call, bound {b_ms:.7f} ms ({b_by}: "
              f"{n_bytes} B, {ops:.4g} operations at the bf16 peak)"
              + (f"; chunk-state scratch {scratch} B more = "
                 f"{scratch / HBM_BYTES_PER_S * 1e3:.6f} ms at the HBM peak"
                 if name == "rwkv6" else "") + f" [{card}]")
    rows["rwkv6"]["scratch_bytes"] = scratch
    print(f"  gla_chunk rwkv6 bf16: the RWKV6 design "
          f"{rows['serial']['ms'] / rows['rwkv6']['ms']:.3f} x faster than "
          f"the serial design, timed in turns [{card}]")

    def rwkv6_call():
        gla(r, k, v, lw, u, inclusive=False)
        torch.cuda.synchronize()
    profile_run("gla_chunk RWKV6 design, one call (its three kernels)",
                rwkv6_call, card)
    del r, k, v, lw, u
    torch.cuda.empty_cache()
    return max(errs["serial"]), rows["serial"], {
        "name": "gla_chunk_rwkv6", "max_abs_err": max(errs["rwkv6"]),
        **rows["rwkv6"]}


# ------------------------------------------------------------------ phase 9
@contextlib.contextmanager
def plain_versions(dtype=None):
    """The model's kernel calls routed to the plain versions, on the card
    (the wrappers themselves run their plain version only for CPU
    tensors). With ``dtype`` (f64), the plain versions compute in that
    dtype from the same inputs and hand back the inputs' dtypes: a run
    more accurate than both the kernels and the f32 plain versions."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gla_chunk import ops as gl
    from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref

    def mha(q, k, v, *, causal=True, scale=None, design="auto"):
        return attention_ref(q.to(dtype), k.to(dtype), v.to(dtype),
                             causal=causal, scale=scale).to(q.dtype)

    def gla(q, k, v, log_w, u=None, *, inclusive=False, chunk=64,
            initial_state=None, design="auto"):
        out, final = gla_chunk_ref(
            *(t.to(dtype) for t in (q, k, v, log_w)),
            None if u is None else u.to(dtype), inclusive=inclusive,
            chunk=chunk, initial_state=None if initial_state is None
            else initial_state.to(dtype))
        return out.to(v.dtype), final.float()
    saved = fa.mha, gl.gla
    fa.mha, gl.gla = ((attention_ref, gla_chunk_ref) if dtype is None
                      else (mha, gla))
    try:
        yield
    finally:
        fa.mha, gl.gla = saved


LM_KEYS = ("flash_attention", "flash_attention_tc", "gla_chunk",
           "gla_chunk_ssd", "gla_chunk_rwkv6")


def lm_expected(model, bf16: bool = True, decode_steps: int = 0) -> dict:
    """Launches of one prefill and ``decode_steps`` decode steps: every
    attention layer and every Mamba2 / RWKV6 layer once per prefill
    (whisper: its encoder's self-attention and its decoder's self- and
    cross-attention), whisper's cross-attention once per decode step, the
    other families none in decode; in bf16 on the tensor-core design
    (flash) and the SSD (Mamba2) or RWKV6 one (gla), in f32 on the
    CUDA-core and serial ones."""
    cfg = model.cfg
    L = cfg.n_layers
    n_attn = {"dense": L, "moe": L, "vlm": L, "ssm": 0,
              "hybrid": model.n_shared_apps(),
              "encdec": cfg.n_enc_layers + 2 * L + decode_steps * L
              }[cfg.family]
    n_gla = L if cfg.family in ("ssm", "hybrid") else 0
    return {"flash_attention": n_attn,
            "flash_attention_tc": n_attn if bf16 else 0,
            "gla_chunk": n_gla,
            "gla_chunk_ssd": n_gla if bf16 and cfg.family == "hybrid"
            else 0,
            "gla_chunk_rwkv6": n_gla if bf16 and cfg.family == "ssm" else 0}


def decode_expected(model, steps: int) -> dict:
    """Launches of ``steps`` bf16 decode steps alone."""
    with_steps = lm_expected(model, decode_steps=steps)
    return {k: n - lm_expected(model)[k] for k, n in with_steps.items()}


def lm_launches(counts) -> dict:
    return {k: counts[k] for k in LM_KEYS}


def by_design(counts) -> dict:
    """Per-design launches from the wrappers' counts (each wrapper counts
    every launch, and the new design's under its own key as well)."""
    return {"flash_attention": counts["flash_attention"]
            - counts["flash_attention_tc"],
            "flash_attention_tc": counts["flash_attention_tc"],
            "gla_chunk": counts["gla_chunk"] - counts["gla_chunk_ssd"]
            - counts["gla_chunk_rwkv6"],
            "gla_chunk_ssd": counts["gla_chunk_ssd"],
            "gla_chunk_rwkv6": counts["gla_chunk_rwkv6"]}


@contextlib.contextmanager
def routing_log(log: list):
    """Record every MoE layer's routing (``moe.route``) as (its top-k
    experts [G, gs, k], keep mask [G, gs, k], the gap between each token's
    k-th and (k+1)-th router probability [G, gs]) into ``log``."""
    import torch
    from repro_torch.models import moe
    saved = moe.route

    def recorded(params, x, cfg):
        r = saved(params, x, cfg)
        top = torch.topk(r.probs, cfg.top_k + 1, dim=-1).values
        k = cfg.top_k
        log.append((r.topi, r.keep, top[..., k - 1] - top[..., k]))
        return r
    moe.route = recorded
    try:
        yield
    finally:
        moe.route = saved


def routing_flips(got_log, want_log, what: str):
    """Tokens whose routing differs between two runs of one prefill (the
    kernels' and the plain versions'), layer by layer. A token routed to
    another set of experts must sit at a near tie in the plain run (its
    k-th and (k+1)-th probabilities within ``NEAR_TIE``) unless its
    routing already differed at an earlier layer; a token whose only
    difference is the order of its k experts (a tie among them) or a
    dropped or kept slot must share its dispatch group (capacity is per
    group) with a token whose routing differs now or did before (the
    queues moved). Fails otherwise. Returns the mask of tokens [B * S] to
    leave out of the logits comparison."""
    import torch
    flipped = None
    for layer, ((ti, kg, _), (tw, kw, gap)) in enumerate(zip(got_log,
                                                            want_log)):
        if flipped is None:                                  # [G, gs]
            flipped = torch.zeros(ti.shape[:2], dtype=torch.bool,
                                  device=ti.device)
        experts = (torch.sort(ti, -1).values
                   != torch.sort(tw, -1).values).any(-1)
        moved = experts | (ti != tw).any(-1)
        differ = moved | (kg != kw).any(-1)
        fresh = experts & ~flipped
        if bool(fresh.any()) and not bool((gap[fresh] < NEAR_TIE).all()):
            fail(f"{what}: layer {layer} routes tokens to other experts "
                 f"away from a near tie")
        licensed = (moved | flipped).any(-1, keepdim=True)   # per group
        if bool((differ & ~licensed).any()):
            fail(f"{what}: layer {layer} drops or keeps other tokens in a "
                 f"dispatch group where no routing moved")
        flipped |= differ
    return flipped.reshape(-1)


def consistency_errs(model, params, batch, prompt: int, p: int, full=None):
    """A prefill of the first ``p`` of ``batch(prompt)``'s tokens, then
    ``prompt - p`` decode steps, against one forward of all ``prompt``
    (``full``: its logits, else a train-mode forward made here). Returns
    (max |decode logits - full logits| over those positions,
    max(|full logits|, 1), the prefill's launches, the decode steps')."""
    import torch
    from repro_torch.examples.serve_lm import fill_cache
    from repro_torch.kernels import launch_counts, reset_launch_counts
    cfg = model.cfg
    if full is None:
        full, _, _ = model.forward(params, batch(prompt), mode="train")
        if full.shape != (LM_BATCH, prompt, cfg.vocab) or \
                not bool(torch.isfinite(full).all()):
            fail(f"{cfg.arch}: full-forward logits are not finite "
                 f"[{LM_BATCH}, {prompt}, {cfg.vocab}]")
    scale = max(float(full.abs().max()), 1.0)
    tail = full[:, p:prompt].clone()
    del full
    reset_launch_counts()
    _, pre, _ = model.forward(params, batch(p), mode="prefill")
    pre_counts = lm_launches(launch_counts())
    cache = fill_cache(model.init_cache(LM_BATCH, prompt, tail.device), pre)
    del pre
    reset_launch_counts()
    err = 0.0
    for t in range(p, prompt):
        dl, cache, _ = model.forward(params, {"tokens": batch(
            t + 1, t)["tokens"]}, mode="decode", cache=cache, cache_index=t)
        err = max(err, float((dl[:, 0] - tail[:, t - p]).abs().max()))
    dec_counts = lm_launches(launch_counts())
    del tail, cache
    torch.cuda.empty_cache()
    if not math.isfinite(err):
        fail(f"{cfg.arch}: decode logits are not finite")
    return err, scale, pre_counts, dec_counts


def first_layers(model, params, n: int):
    """The model cut to its first ``n`` layers, with those layers' weights
    (the init of the whole depth, so the layers are the full run's)."""
    import dataclasses
    from repro_torch.models import Model
    from repro_torch.models.param import tree_map
    return (Model(dataclasses.replace(model.cfg, n_layers=n)),
            dict(params, layers=tree_map(lambda t: t[:n], params["layers"])))


def rwkv6_bf16_miss(model, params, batch, prompt: int, p: int, err: float,
                    scale: float) -> str:
    """rwkv6-7b's prefill/decode consistency in bf16 misses the bound
    0.02 x max(|logits|, 1), which is the reference's at smoke size: at
    its full width the JAX package misses it too from 4 layers on
    (tests/rwkv6_bf16_witness.py on the CPU, from the same weights as the
    port), and the miss grows with depth (printed here for the first 2,
    4, 8 and 16 layers). Its f32 run meets the bound (checked after the f32
    prefill), and phase 8 holds the kernel in this bf16 regime at 2e-2. So
    the full depth holds the kernels to the plain versions' own bf16 miss
    on the card: within ``RWKV6_BF16_SLACK`` of its error. Returns the note
    to print."""
    ratios = []
    for n in (2, 4, 8, 16):
        m, prm = first_layers(model, params, n)
        e, sc, _, _ = consistency_errs(m, prm, batch, prompt, p)
        ratios.append(f"{n}: {e / (0.02 * sc):.4f}")
        del prm
    with plain_versions():
        plain_err, plain_scale, _, _ = consistency_errs(model, params, batch,
                                                        prompt, p)
    if not err <= RWKV6_BF16_SLACK * plain_err:
        fail(f"rwkv6-7b: bf16 decode logits differ from the full forward by "
             f"{err} (0.02 x {scale}), more than {RWKV6_BF16_SLACK} x the "
             f"plain versions' {plain_err}")
    return (f" — MISSED in bf16, as the reference misses it at this width "
            f"(tests/rwkv6_bf16_witness.py): {err / (0.02 * scale):.4f} of "
            f"the bound; the plain versions {plain_err:.4g} = "
            f"{plain_err / (0.02 * plain_scale):.4f} of theirs, the kernels "
            f"{err / plain_err:.4f} x that (held within "
            f"{RWKV6_BF16_SLACK}); the kernels' share of the bound at the "
            f"first n layers: {', '.join(ratios)}")


def rwkv6_f32_head(model, params, batch, prompt: int, got, want,
                   scale: float) -> str:
    """rwkv6-7b's first ``RWKV6_HEAD`` tokens are ill-conditioned in f32:
    there the f32 plain versions are far from a run with the plain versions
    in f64 (measured on an H100: 0.231 at position 0, falling to 0.00194
    at position 15, bound 0.00131), and the kernels about as far; from
    position 16 on the plain versions stay at the f32 floor of this random
    32-layer model (0.0004-0.0019 from the f64 run). So the caller holds
    the kernels to the plain versions at the 1e-3 bound from position
    ``RWKV6_HEAD`` on, and here, at each head position, the kernels must
    be within the larger of the bound and ``RWKV6_HEAD_SLACK`` x the plain
    versions' distance to the f64 run. Returns the note to print."""
    import torch
    bound = 1e-3 * scale
    with plain_versions(torch.float64):
        truth, _, _ = model.forward(params, batch(prompt), mode="prefill")
    p_pos = (want - truth).abs_().amax(dim=(0, 2))
    k_pos = (got - truth).abs_().amax(dim=(0, 2))[:RWKV6_HEAD]
    del truth
    torch.cuda.empty_cache()

    def fmt(t):
        return "[" + ", ".join(f"{x:.3g}" for x in t.tolist()) + "]"
    head = p_pos[:RWKV6_HEAD]
    if bool((k_pos > torch.clamp(RWKV6_HEAD_SLACK * head, min=bound)).any()):
        fail(f"rwkv6-7b: in the f32 head (positions 0-{RWKV6_HEAD - 1}) the "
             f"kernels are {fmt(k_pos)} from the f64 run, the plain versions "
             f"{fmt(head)}")
    return (f"; positions 0-{RWKV6_HEAD - 1} held against the model with "
            f"its plain versions in f64 instead (ill-conditioned in f32): "
            f"the kernels {fmt(k_pos)} from it, the f32 plain versions "
            f"{fmt(head)}, each within max(bound, {RWKV6_HEAD_SLACK} x the "
            f"plain versions'); past them the plain versions are at most "
            f"{float(p_pos[RWKV6_HEAD:].max()):.4g} from it")


def run_lm(arch: str, dev, card: str):
    """Phase 9 for one model. Returns the serve run's launch counts and
    the f32 prefill's."""
    import torch
    from repro_torch.examples.serve_lm import serve
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models.param import count_params, tree_map
    model = build_model(arch)
    cfg = model.cfg
    fam = cfg.family
    prompt = WHISPER_PROMPT if fam == "encdec" else LM_PROMPT
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, prompt),
                            generator=gen, device=dev)
    frames = None
    if fam == "encdec":        # the stubbed conv front end's output
        frames = torch.randn((LM_BATCH, cfg.enc_seq, cfg.d_model),
                             generator=gen, device=dev).to(torch.bfloat16)

    def batch(hi, lo=0, fr=frames):
        out = {"tokens": prompts[:, lo:hi]}
        if fr is not None:
            out["frames"] = fr
        return out

    torch.cuda.synchronize()
    print(f"{arch} ({fam}): {cfg.n_layers} layers"
          + (f" + {cfg.n_enc_layers} encoder layers over {cfg.enc_seq} "
             f"frames" if fam == "encdec" else "")
          + f", d_model {cfg.d_model}, vocab {cfg.vocab} (padded "
          f"{cfg.padded_vocab}), {count_params(model.defs) / 1e9:.3f} B "
          f"parameters in bf16, drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")

    # prefill/decode consistency against one full forward, with the
    # launches of the prefill and of each decode step (not checked for
    # MoE, which the reference leaves out of this check: a dispatch
    # group's capacity depends on how many tokens it holds)
    p = prompt - LM_TAIL
    errs, scale, pre_counts, dec_counts = consistency_errs(
        model, params, batch, prompt, p)
    if pre_counts != lm_expected(model):
        fail(f"{arch}: prefill launched {pre_counts}, expected "
             f"{lm_expected(model)}")
    if dec_counts != decode_expected(model, LM_TAIL):
        fail(f"{arch}: {LM_TAIL} decode steps launched {dec_counts}, "
             f"expected {decode_expected(model, LM_TAIL)}")
    launched = (f"prefill launched {pre_counts}, {LM_TAIL} decode steps "
                f"{dec_counts}")
    if fam == "moe":
        print(f"{arch} prefill/decode consistency: not checked (MoE: a "
              f"dispatch group's capacity depends on how many tokens it "
              f"holds, so a prefill of {p} tokens routes otherwise than one "
              f"of {prompt}; the reference leaves MoE out of this check, "
              f"tests/test_models_smoke.py): max err {errs:.4g}; {launched}")
    else:
        bf16_note = ""
        if not errs < 0.02 * scale:
            if fam != "ssm":
                fail(f"{arch}: decode logits differ from the full forward "
                     f"by {errs} >= 0.02 x {scale}")
            bf16_note = rwkv6_bf16_miss(model, params, batch, prompt, p,
                                        errs, scale)
        print(f"{arch} prefill/decode consistency: prefill of {p} tokens, "
              f"{LM_TAIL} decode steps vs one full forward of {prompt}: max"
              f" err {errs:.4g} vs 0.02 x max(|logits|, 1) = "
              f"{0.02 * scale:.4g}{bf16_note}; {launched}")

    # the serve run: warm-up, then the counted and timed run
    serve(model, params, prompts[:, :64], gen_len=4, max_len=128,
          frames=frames)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    out = serve(model, params, prompts, gen_len=LM_DECODE + 1,
                max_len=prompt + LM_DECODE, frames=frames)
    counts = lm_launches(launch_counts())
    peak = torch.cuda.max_memory_allocated(dev)
    want = lm_expected(model, decode_steps=LM_DECODE)
    if counts != want:
        fail(f"{arch}: the serve run launched {counts}, expected {want} "
             f"(one prefill, {LM_DECODE} decode steps)")
    toks = out["tokens"]
    if toks.shape != (LM_BATCH, LM_DECODE + 1) or \
            not bool(((toks >= 0) & (toks < cfg.vocab)).all()) or \
            not bool(torch.isfinite(out["logits"]).all()):
        fail(f"{arch}: serve returned bad tokens or logits")
    pre_tps = LM_BATCH * prompt / out["prefill_s"]
    dec_tps = LM_BATCH * LM_DECODE / out["decode_s"]
    print(f"{arch} serve [{card}]: prefill {LM_BATCH} x {prompt} tokens "
          + (f"(and {cfg.enc_seq} frames) " if fam == "encdec" else "")
          + f"in {out['prefill_s'] * 1e3:.3f} ms = {pre_tps:.1f} tokens/s; "
          f"{LM_DECODE} decode steps x {LM_BATCH} in "
          f"{out['decode_s'] * 1e3:.3f} ms = {dec_tps:.1f} tokens/s "
          f"({out['decode_s'] / LM_DECODE * 1e3:.3f} ms per step); "
          f"launches {counts}; peak memory of the serve run "
          f"{peak / 2**30:.2f} GiB")
    ranges = ("moe.dispatch", "moe.combine") if fam == "moe" else ()
    prof = profile_run(f"serve {arch}", lambda: serve(
        model, params, prompts, gen_len=LM_DECODE + 1,
        max_len=prompt + LM_DECODE, frames=frames), card, ranges)
    if prof is not None and ranges:
        shares = {r: prof[r] / prof["busy_us"] for r in ranges}
        print(f"{arch}: the one-hot MoE products' share of the profiled "
              f"serve run's busy time: dispatch {shares['moe.dispatch']:.4f}"
              f", combine (f32) {shares['moe.combine']:.4f}")
    del out

    # the same prefill in f32 (the CUDA-core and serial designs), kernels
    # against the plain versions on the card
    f_model = model
    if fam == "moe":
        f_model, params = first_layers(model, params, MOE_F32_LAYERS)
        print(f"{arch}: the f32 check runs at full width with its depth cut"
              f" to {MOE_F32_LAYERS} of {cfg.n_layers} layers (f32 weights "
              f"of all {cfg.n_layers} would not leave the activations room)")
    params = tree_map(lambda t: t.float(), params)
    f_frames = None if frames is None else frames.float()
    torch.cuda.empty_cache()
    got_log, want_log = [], []
    reset_launch_counts()
    with routing_log(got_log):
        got, got_cache, _ = f_model.forward(params, batch(prompt, fr=f_frames),
                                            mode="prefill")
    f32_counts = lm_launches(launch_counts())
    if f32_counts != lm_expected(f_model, bf16=False):
        fail(f"{arch}: the f32 prefill launched {f32_counts}, expected "
             f"{lm_expected(f_model, bf16=False)}")
    with plain_versions(), routing_log(want_log):
        want, want_cache, _ = f_model.forward(params,
                                              batch(prompt, fr=f_frames),
                                              mode="prefill")
    torch.cuda.synchronize()
    f_scale = max(float(want.abs().max()), 1.0)
    note = ""
    diff = (got - want).abs_()
    if fam == "moe":
        flipped = routing_flips(got_log, want_log, f"{arch} f32 prefill")
        diff.masked_fill_(flipped.reshape(LM_BATCH, prompt, 1), 0.0)
        note = (f"; {int(flipped.sum())} of {flipped.numel()} tokens routed "
                f"otherwise at a near tie (k-th and (k+1)-th router "
                f"probabilities within {NEAR_TIE}), left out")
    err_pos = diff.amax(dim=(0, 2))
    del diff
    head = 0
    if fam == "ssm":
        head = RWKV6_HEAD
        note += rwkv6_f32_head(f_model, params,
                               lambda hi: batch(hi, fr=f_frames), prompt,
                               got, want, f_scale)
        note += (f"; kernels vs plain from position {head} on: largest at "
                 f"{head + int(err_pos[head:].argmax())}, at positions "
                 f"{head}-63 {float(err_pos[head:64].max()):.4g}")
    err = float(err_pos[head:].max())

    def state_of(c):
        if fam not in ("hybrid", "ssm"):
            return None
        return c["mamba"]["state"] if fam == "hybrid" else c["state"]
    gs_, ws_ = state_of(got_cache), state_of(want_cache)
    state_err = None if gs_ is None else float((gs_ - ws_).abs().max())
    s_scale = None if ws_ is None else max(float(ws_.abs().max()), 1.0)
    if not err <= 1e-3 * f_scale or (
            state_err is not None and not state_err <= 1e-3 * s_scale):
        fail(f"{arch}: f32 prefill with the kernels differs from the plain "
             f"versions by {err} (> 1e-3 x {f_scale}) or its final states by"
             f" {state_err} (1e-3 x {s_scale}){note}")
    print(f"{arch} f32 prefill [{LM_BATCH} x {prompt}] (launched "
          f"{f32_counts}), kernels vs plain versions on the card: logits max"
          f" err {err:.4g} (tol 1e-3 x max(|logits|, 1) = "
          f"{1e-3 * f_scale:.4g})"
          + (f", final {'Mamba2' if fam == 'hybrid' else 'RWKV6'} states "
             f"max err {state_err:.4g} (tol {1e-3 * s_scale:.4g})"
             if state_err is not None else "")
          + note)
    del want, got_cache, want_cache, got_log, want_log
    if fam != "moe":
        # the consistency check once more in f32 (the prefill's logits are
        # the full forward's): the algorithm's agreement without bf16
        # rounding
        f_errs, _, _, _ = consistency_errs(
            model, params, lambda hi, lo=0: batch(hi, lo, fr=f_frames),
            prompt, p, full=got)
        if not f_errs < 0.02 * f_scale:
            fail(f"{arch}: f32 decode logits differ from the full forward "
                 f"by {f_errs} >= 0.02 x {f_scale}")
        print(f"{arch} prefill/decode consistency in f32 (the caches in the "
              f"prefill's dtypes): max err {f_errs:.4g} = "
              f"{f_errs / (0.02 * f_scale):.4f} of the bound (bf16: "
              f"{errs / (0.02 * scale):.4f})")
    del params, got
    torch.cuda.empty_cache()
    return counts, f32_counts


# ----------------------------------------------------------------- phase 10
TRAIN_ARCHS = ("internlm2-1.8b", "zamba2-1.2b")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 3
TRAIN_LM_STEPS = 30
SMOKE_TOL = 1e-4


def backward_ms(run, reps: int = 3) -> float:
    """Median milliseconds of ``run()`` (a forward and its backward, or a
    backward alone) between CUDA events, after one warm-up; autograd's
    backward is not captured in a graph, so this is host-issued time."""
    import torch
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_function_grads(dev, gen, card) -> dict:
    """Phase 10a: ``FlashAttentionFn`` and ``GlaChunkFn`` against autograd
    through their plain versions at the training shapes (internlm2's
    attention, q [1, 16, 2048, 128] and k/v [1, 8, 2048, 128] bf16 causal;
    zamba2's Mamba2, [1, 2048, 64, 64] bf16 with an f32 decay): the
    forward within the kernels' bounds, every input gradient bitwise the
    plain version's (the backward recomputes it); the kernel forward, the
    Function's forward + backward and the recompute backward alone timed.
    Returns {name: times}."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gla_chunk import ops as gl
    from repro_torch.kernels.gla_chunk.ref import gla_ssd_ref
    from repro_torch.models import build_model
    out = {}
    cfg = build_model("internlm2-1.8b").cfg
    hd = cfg.resolved_head_dim
    base = [lm_rand((1, TRAIN_SEQ, h, hd), dev, torch.bfloat16, gen)
            for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)]
    go = lm_rand((1, cfg.n_heads, TRAIN_SEQ, hd), dev, torch.bfloat16, gen)
    mz = build_model("zamba2-1.2b").cfg
    h, dk = mz.ssm.n_ssm_heads, mz.ssm.state_size
    dv = mz.ssm.expand * mz.d_model // h
    gbase = [lm_rand((1, TRAIN_SEQ, 1, dk), dev, torch.bfloat16, gen),
             lm_rand((1, TRAIN_SEQ, 1, dk), dev, torch.bfloat16, gen),
             lm_rand((1, TRAIN_SEQ, h, dv), dev, torch.bfloat16, gen),
             -torch.exp(lm_rand((1, TRAIN_SEQ, h, 1), dev, torch.float32,
                                gen))]
    ggo = lm_rand((1, TRAIN_SEQ, h, dv), dev, torch.bfloat16, gen)

    def flash_args(x):
        return tuple(t.transpose(1, 2) for t in x)

    def gla_args(x):
        s = TRAIN_SEQ
        return (x[0].expand(1, s, h, dk), x[1].expand(1, s, h, dk), x[2],
                x[3].expand(1, s, h, dk))

    cases = (("flash_attention_tc", base, go, flash_args,
              lambda *a: fa.attention(*a, causal=True),
              lambda *a: attention_ref(*a, causal=True),
              lambda *a: fa.mha(*a, causal=True), FLASH_TOL["bfloat16"]),
             ("gla_chunk_ssd", gbase, ggo, gla_args,
              lambda *a: gl.gla_fn(*a, inclusive=True)[0],
              lambda *a: gla_ssd_ref(*a)[0],
              lambda *a: gl.gla(*a, inclusive=True)[0],
              FLASH_TOL["bfloat16"]))
    for name, x0, g, args, fn, plain, kernel, tol in cases:
        leaves = {}
        outs = {}
        for side, f in (("fn", fn), ("plain", plain)):
            x = [t.clone().requires_grad_() for t in x0]
            outs[side] = f(*args(x))
            leaves[side] = torch.autograd.grad(outs[side], x, g)
        torch.cuda.synchronize()
        err = max_err(outs["fn"].detach(), outs["plain"].detach(), tol,
                      f"{name} Function forward")
        if not all(a.dtype == b.dtype and bool(torch.equal(a, b))
                   for a, b in zip(leaves["fn"], leaves["plain"])):
            fail(f"{name}: the Function's input gradients differ from the "
                 f"plain version's")
        del outs, leaves
        x = [t.clone().requires_grad_() for t in x0]
        with torch.no_grad():
            fwd_ms = graph_ms(lambda: kernel(*args(x0)), reps=5, rounds=3)
        fn_ms = backward_ms(lambda: torch.autograd.grad(fn(*args(x)), x, g))
        y = fn(*args(x))
        bwd_ms = backward_ms(lambda: torch.autograd.grad(
            y, x, g, retain_graph=True))
        del y
        plain_ms = backward_ms(lambda: torch.autograd.grad(
            plain(*args(x)), x, g))
        out[name] = {"fwd_ms": fwd_ms, "fn_ms": fn_ms, "bwd_ms": bwd_ms,
                     "plain_fwd_bwd_ms": plain_ms, "max_abs_err": err}
        print(f"{name} Function at the training shape: forward within {tol}"
              f" of the plain version (max abs err {err:.3g}), every input "
              f"gradient bitwise the plain version's; kernel forward "
              f"{fwd_ms:.4f} ms (device, CUDA graph), the Function's forward"
              f" + backward {fn_ms:.4f} ms, its recompute backward alone "
              f"{bwd_ms:.4f} ms, the plain version's forward + backward "
              f"{plain_ms:.4f} ms (CUDA events) [{card}]")
        torch.cuda.empty_cache()
    return out


def smoke_train_parity(dev, card) -> None:
    """Phase 10b: one ``make_train_step`` of the f32 smoke configs on the
    card against the CPU: loss, grad norm and updated parameters within
    1e-4."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train.train_step import make_train_step
    for arch in TRAIN_ARCHS:
        model = build_model(arch, smoke=True)
        params = tree_map(lambda t: t.float(),
                          model.init(torch.Generator().manual_seed(0)))
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, model.cfg.vocab, (4, 64)))
        batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
        step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1,
                                                  total_steps=10))
        gp = tree_map(lambda t: t.to(dev, copy=True), params)
        cp, _, cm = step(params, init_state(params), batch)   # in place
        gp, _, gm = step(gp, init_state(gp),
                         {k: v.to(dev) for k, v in batch.items()})
        errs = {k: abs(float(gm[k]) - float(cm[k])) for k in
                ("loss", "grad_norm")}
        errs["params"] = max(float((a.cpu() - b).abs().max())
                             for a, b in zip(tree_leaves(gp),
                                             tree_leaves(cp)))
        if not all(e <= SMOKE_TOL for e in errs.values()):
            fail(f"{arch}-smoke train step on the card differs from the "
                 f"CPU's: {errs}")
        print(f"{arch}-smoke f32 train step, card vs CPU: loss "
              f"{float(gm['loss']):.6f}, max abs differences {errs} (tol "
              f"{SMOKE_TOL})")


def run_train(arch: str, dev, card: str, fn_times: dict) -> dict:
    """Phase 10c: the full-width, full-depth model (seeded bf16 weights on
    the card) takes ``TRAIN_STEPS`` steps of batch 8 x 2048 tokens in the
    config's 8 microbatches with remat on. Every gradient leaf must be
    finite and not all zero (read through the train step's
    ``compress_fn`` hook, which returns them unchanged); the loss finite.
    Prints step ms (median of steps 2..), train tokens/s, 6·N·tokens per
    step time over the bf16 dense peak, peak memory and the LM kernels'
    launches per step, and the share of a step the recompute backwards of
    the LM kernels take at phase 10a's times (one backward per attention /
    Mamba2 layer per microbatch). Returns the kernel launches of the
    run."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models.param import count_params, tree_leaves
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train.train_step import make_train_step
    model = build_model(arch)
    cfg = model.cfg
    if not cfg.remat or cfg.microbatches != 8:
        fail(f"{arch}: expected remat on and 8 microbatches")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    opt = init_state(params)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                         generator=gen, device=dev)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    n_params = count_params(model.defs)
    bad = []

    def inspect(grads):
        for i, g in enumerate(tree_leaves(grads)):
            if not bool(torch.isfinite(g).all()) or not bool(
                    (g != 0).any()):
                bad.append(i)
        return grads

    checked = make_train_step(model, AdamWConfig(), compress_fn=inspect)
    plain = make_train_step(model, AdamWConfig())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    times, losses, counts = [], [], []
    for i in range(TRAIN_STEPS):
        before = launch_counts()
        t0 = time.perf_counter()
        params, opt, met = (checked if i == 0 else plain)(params, opt, batch)
        loss = float(met["loss"])             # syncs
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        after = launch_counts()
        counts.append({k: after[k] - before[k] for k in LM_KEYS})
    total = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if bad:
        fail(f"{arch}: gradient leaves {bad} are not finite or all zero")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{arch}: train loss not finite: {losses}")
    n_mb = cfg.microbatches
    n_attn = (cfg.n_layers if cfg.family == "dense"
              else model.n_shared_apps())
    n_gla = 0 if cfg.family == "dense" else cfg.n_layers
    # each layer's forward runs twice per microbatch: once, then again
    # under remat in the backward
    want = {"flash_attention": 2 * n_mb * n_attn,
            "flash_attention_tc": 2 * n_mb * n_attn,
            "gla_chunk": 2 * n_mb * n_gla, "gla_chunk_ssd": 2 * n_mb * n_gla,
            "gla_chunk_rwkv6": 0}
    if any(c != want for c in counts):
        fail(f"{arch}: train steps launched {counts}, expected {want} each")
    step_s = statistics.median(times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    recompute_ms = n_mb * (n_attn * fn_times["flash_attention_tc"]["bwd_ms"]
                           + n_gla * fn_times["gla_chunk_ssd"]["bwd_ms"])
    share = 6 * n_params * tokens / step_s / BF16_FLOP_PER_S
    print(f"{arch} train [{card}]: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters (bf16, f32 "
          f"moments), batch {TRAIN_BATCH} x {TRAIN_SEQ} in {n_mb} "
          f"microbatches, remat on; {len(bad)} of "
          f"{len(tree_leaves(params))} gradient leaves non-finite or all "
          f"zero; losses {[round(x, 4) for x in losses]}; step ms "
          f"{[round(t * 1e3, 3) for t in times]} (median of steps 2-"
          f"{TRAIN_STEPS}: {step_s * 1e3:.3f} ms) = {tokens / step_s:.1f} "
          f"train tokens/s; 6·N·tokens / step time over the bf16 dense "
          f"peak (989 TFLOP/s) = {share:.4f}; peak memory "
          f"{peak / 2**30:.2f} GiB; launches per step "
          f"{counts[-1]}; the LM kernels' recompute backwards at phase 10a's"
          f" times {recompute_ms:.3f} ms = {recompute_ms / (step_s * 1e3):.4f}"
          f" of a step")
    del params, opt, batch
    torch.cuda.empty_cache()
    return {k: total[k] for k in total}


def run_train_lm(card: str) -> dict:
    """Phase 10d: ``examples.train_lm`` on the card for 30 steps: the loss
    falls, ``transform_kpi`` launched, the final checkpoint restores
    bitwise through ``restore_latest``. Returns the run's launches."""
    import torch
    from repro_torch.examples import train_lm
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train.checkpoint import CheckpointManager, flatten
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_lm-", dir=scratch)
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        out = train_lm.main(["--steps", str(TRAIN_LM_STEPS), "--ckpt-every",
                             str(TRAIN_LM_STEPS), "--ckpt", root])
        wall = time.perf_counter() - t0
        counts = launch_counts()
        losses = out["losses"]
        if not losses[-1] < losses[0]:
            fail(f"train_lm: the loss did not fall: {losses}")
        if counts["transform_kpi"] <= 0 or counts["flash_attention_tc"] <= 0:
            fail(f"train_lm launched {counts}")
        tree = {"params": out["params"], "opt": out["opt"], "corpus": None}
        step, got, extra = CheckpointManager(root).restore_latest(tree)
        same = all(b is None or bool(torch.equal(a, b)) for a, b in zip(
            flatten(got)[0], flatten(tree)[0]))
        if step != TRAIN_LM_STEPS or not same or \
                extra["stream"] != out["stream"]:
            fail("train_lm: the checkpoint does not restore bitwise")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"train_lm (lm_small, ETL-fed) on the card [{card}]: "
          f"{TRAIN_LM_STEPS} steps in {wall:.2f} s wall (ETL set-up "
          f"included), loss {losses[0]:.4f} -> {losses[-1]:.4f}; checkpoint "
          f"of step {step} restored bitwise with the listener offsets; "
          f"launches {counts}")
    return counts


def check_manual_dp(dev, card) -> None:
    """Phase 10e: ``manual_dp`` at world size 1 over NCCL against
    ``make_train_step`` (f32 smoke): the same update, within 1e-6 (the
    global norm is summed in another order)."""
    import socket
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import manual_dp
    from repro_torch.train.train_step import make_train_step
    model = build_model("internlm2-1.8b", smoke=True)
    params = tree_map(lambda t: t.float().to(dev),
                      model.init(torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, model.cfg.vocab, (4, 64))).to(dev)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    want, _, wm = make_train_step(model, cfg)(
        tree_map(torch.clone, params), init_state(params), batch)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        got, _, gm = manual_dp.make_manual_dp_train_step(model, cfg)(
            params, manual_dp.init_shard_state(params), batch)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    err = max(float((a - b).abs().max())
              for a, b in zip(tree_leaves(got), tree_leaves(want)))
    if not err <= 1e-6:
        fail(f"manual_dp at world size 1 differs from make_train_step by "
             f"{err}")
    print(f"manual_dp (NCCL, world size 1; one reduce-scatter, one "
          f"all-gather) vs make_train_step, internlm2-smoke f32 on the "
          f"card: parameters max abs diff {err:.3g}, loss "
          f"{float(gm['loss']):.6f} / {float(wm['loss']):.6f} [{card}]")


def check_quickstart(card) -> None:
    """Phase 10f: ``examples.quickstart`` on the card against its CPU run:
    the warehouse's facts within the transform's 1e-5."""
    import io
    import numpy as np
    from repro_torch.examples import quickstart
    runs = {}
    for device in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runs[device] = quickstart.main(["--device", device])
        if device == "cuda":
            print(buf.getvalue().rstrip())
    gpu, cpu = (runs[d].warehouse.canonical_fact_table()
                for d in ("cuda", "cpu"))
    if gpu.shape != cpu.shape or not np.allclose(gpu, cpu, rtol=1e-5,
                                                 atol=1e-5):
        fail("quickstart's warehouse on the card differs from the CPU run")
    print(f"quickstart on the card [{card}]: {len(gpu)} facts within 1e-5 "
          f"of the CPU run (max abs diff "
          f"{float(np.abs(gpu - cpu).max()):.3g})")


def main() -> None:
    t_start = time.perf_counter()
    card = phase_card()
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    results = [check_hash_join(rng, dev), check_hash_join_pair(rng, dev),
               check_transform_kpi(rng, dev), check_segment_kpi(rng, dev),
               check_fold(rng, dev), check_gather_stats_many(rng, dev, card)]
    for r in results:
        print(f"  {r['name']}: {r['ms']:.7f} ms kernel, {r['plain_ms']:.7f} "
              f"ms plain (device, CUDA graph), {r['issue_ms']:.7f} ms per "
              f"host-issued wrapper call, bound {r['bound_ms']:.7f} ms "
              f"({r['bound_by']}) [{card}]")
    print("  TorchBackend.fold_segments_many per fold cycle (host clock, "
          "compaction + staging + upload + launch + copy back + sync): "
          + ", ".join(f"{d} x 1024-row deltas into the 4 views "
                      f"{backend_fold_ms(dev, rng, d):.4f} ms"
                      for d in (1, 5)) + f" [{card}]")
    check_uploads(rng, dev, card)

    # the sequential main path (phase 3/4)
    reset_launch_counts()
    gpu = run_main_path("cuda")
    seq_counts = launch_counts()
    rows = gpu[0].warehouse.rows_loaded
    print(f"main path on the card: {rows} records loaded in "
          f"{gpu[3]:.3f} s of streaming = {rows / gpu[3]:.1f} records/s "
          f"[{card}]; backend dispatches {gpu[0].backend.op_dispatches}, "
          f"host syncs {gpu[0].backend.host_syncs}")
    cpu = run_main_path("cpu")
    print(f"the same path with the plain versions on this machine's CPU: "
          f"{rows / cpu[3]:.1f} records/s (host CPU, not a card number)")
    compare_main_path(gpu, cpu)
    print(f"sequential path launches: {seq_counts}")
    missing = [k for k in ETL_KERNELS if k != "segment_rollup"
               and seq_counts[k] <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    check_main_path_caches(gpu[0], rng)
    profile_run("main path", lambda: run_main_path("cuda"), card)

    # the complex model's path (phase 4): the single-table probe
    reset_launch_counts()
    cx_gpu, cx_done = run_complex("cuda")
    complex_counts = launch_counts()
    cx_cpu, _ = run_complex("cpu")
    if complex_counts["hash_join"] <= 0:
        fail("hash_join never launched on the complex model's path")
    cx_facts = cx_gpu.warehouse.canonical_fact_table()
    if cx_facts.tobytes() != cx_cpu.warehouse.canonical_fact_table(
            ).tobytes() or not np.isfinite(cx_facts).all():
        fail("complex model facts on the card differ from the CPU run's")
    print(f"complex model (join depth 8): {cx_done} records, facts "
          f"byte-identical to the CPU run; launches {complex_counts}")

    # the cluster path (phase 5): every ETL kernel must launch in it
    reset_launch_counts()
    clu = run_cluster_pre_extracted()
    cluster_counts = launch_counts()
    missing = [k for k in ETL_KERNELS if cluster_counts[k] <= 0]
    if missing:
        fail(f"kernels never launched on the cluster path: {missing}")
    print(f"cluster path launches: {cluster_counts}")
    check_cluster_pre_extracted(clu, gpu, cpu, card)
    run_cluster_live(gpu, card)
    profile_run("cluster (a)", run_cluster_pre_extracted, card)
    # the sharded serving plane on the card (phase 5c)
    sharded_counts = check_cluster_sharded(run_cluster_sharded(), clu, cpu,
                                           card)
    missing = [k for k in ETL_KERNELS if k != "segment_rollup"
               and sharded_counts[k] <= 0]
    if missing:
        fail(f"kernels never launched on the sharded cluster path: "
             f"{missing}")
    print(f"sharded cluster path launches: {sharded_counts}")

    results.append(check_segment_rollup(rng, dev, clu[0], card))  # phase 6
    r = results[-1]
    print(f"  segment_rollup: {r['ms']:.7f} ms kernel, {r['plain_ms']:.7f} "
          f"ms plain (device, CUDA graph), {r['issue_ms']:.7f} ms per "
          f"host-issued call, index_add_ {r['library_ms']:.7f} ms, bound "
          f"{r['bound_ms']:.7f} ms ({r['bound_by']}) at {r['shape']}; "
          f"{r['cluster_facts_ms']:.7f} ms at the cluster's facts [{card}]")
    check_durability(clu)                                      # phase 7

    gen = torch.Generator(device=dev).manual_seed(0)           # phase 8
    results += check_flash(dev, gen, card) + check_gla(dev, gen, card)
    lm_counts, f32_counts = {}, {}                             # phase 9
    for arch in LM_ARCHS:
        path = LM_PATHS[arch]
        serve_counts, f32 = run_lm(arch, dev, card)
        lm_counts[path] = by_design(serve_counts)
        f32_counts[path + "_f32_prefill"] = by_design(f32)
    fn_times = check_function_grads(dev, gen, card)            # phase 10
    smoke_train_parity(dev, card)
    train_counts = {}
    for arch in TRAIN_ARCHS:
        train_counts["train_" + arch.split("-")[0]] = by_design(
            run_train(arch, dev, card, fn_times))
    lm_run = run_train_lm(card)
    train_counts["train_lm"] = {**lm_run, **by_design(lm_run)}
    check_manual_dp(dev, card)
    check_quickstart(card)
    for name, t in fn_times.items():
        next(r for r in results if r["name"] == name).update(
            train_forward_ms=t["fwd_ms"], recompute_backward_ms=t["bwd_ms"],
            function_fwd_bwd_ms=t["fn_ms"],
            plain_fwd_bwd_ms=t["plain_fwd_bwd_ms"])

    src = "src/repro_torch/kernels/segment_kpi/csrc/segment_kpi.cu"
    fused = "src/repro_torch/kernels/segment_kpi/csrc/transform_kpi.cu"
    tpu = "src/repro/kernels/segment_kpi/segment_kpi.py"
    hj = ("src/repro_torch/kernels/hash_join/csrc/hash_join.cu",
          "src/repro/kernels/hash_join/hash_join.py:73")
    sources = {"hash_join": hj, "hash_join_pair": hj,
               "transform_kpi": (fused, f"{tpu}:226"),
               "segment_kpi": (fused, f"{tpu}:226"),
               "fold_segments_many": (src, f"{tpu}:180"),
               "gather_stats_many": (src, f"{tpu}:152"),
               "segment_rollup": (src, f"{tpu}:205"),
               **{name: (f"src/repro_torch/kernels/flash_attention/csrc/"
                         f"{name}.cu",
                         "src/repro/kernels/flash_attention/"
                         "flash_attention.py:77")
                  for name in ("flash_attention", "flash_attention_tc")},
               "gla_chunk": ("src/repro_torch/kernels/gla_chunk/csrc/"
                             "gla_chunk.cu",
                             "src/repro/kernels/gla_chunk/gla_chunk.py:82"),
               "gla_chunk_ssd": ("src/repro_torch/kernels/gla_chunk/csrc/"
                                 "gla_ssd.cu",
                                 "src/repro/kernels/gla_chunk/gla_chunk.py:82"),
               "gla_chunk_rwkv6": ("src/repro_torch/kernels/gla_chunk/csrc/"
                                   "gla_rwkv6.cu",
                                   "src/repro/kernels/gla_chunk/gla_chunk.py"
                                   ":82")}
    kernels = []
    for r in results:
        name = r["name"]
        path, replaces = sources[name]
        by_path = {"sequential": seq_counts.get(name, 0),
                   "cluster": cluster_counts.get(name, 0),
                   "sharded_cluster": sharded_counts.get(name, 0),
                   COMPLEX_PATH: complex_counts.get(name, 0),
                   **{p: c.get(name, 0) for p, c in lm_counts.items()},
                   **{p: c.get(name, 0) for p, c in f32_counts.items()},
                   **{p: c.get(name, 0) for p, c in train_counts.items()}}
        # the ETL kernels' main path is the cluster, the single-table
        # probe's the complex model; the LM designs' the six serve runs
        # (the bf16 designs), the six f32 prefills
        # (the CUDA-core and serial designs) and the training runs
        if name in OFF_PATH:
            launches = 0
            if any(by_path.values()):
                fail(f"{name} launched on a path: {by_path}")
        elif name in ETL_KERNELS:
            launches = by_path["cluster"]
        elif name == "hash_join":
            launches = by_path[COMPLEX_PATH]
        else:
            launches = sum(c[name] for c in (*lm_counts.values(),
                                             *f32_counts.values(),
                                             *train_counts.values()))
            if name == "gla_chunk_rwkv6" and (
                    lm_counts["lm_rwkv6"][name] <= 0
                    or lm_counts["lm_rwkv6"]["gla_chunk"] != 0):
                fail(f"rwkv6's serve path launched "
                     f"{lm_counts['lm_rwkv6']}: the RWKV6 design must take "
                     f"every gla call, the serial design none")
            if name == "flash_attention_tc" and any(
                    lm_counts[p][name] <= 0 for p in (
                        "lm_qwen2moe", "lm_qwen2vl", "lm_whisper")):
                fail("flash_attention_tc missing on a serve path")
        if launches <= 0 and name not in OFF_PATH:
            fail(f"{name} never launched on its path")
        kernels.append({"name": name, "route": "cuda", "source": path,
                        "replaces": replaces, "launches": launches,
                        "launches_by_path": by_path,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "issue_ms": r["issue_ms"],
                        "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        **{key: r[key] for key in (
                            "zamba2", "whisper_encoder", "qwen2_vl",
                            "shape", "scratch_bytes", "cluster_facts_ms",
                            "batch_ms", "dashboard", "dashboard_4_shards",
                            "train_forward_ms", "recompute_backward_ms",
                            "function_fwd_bwd_ms", "plain_fwd_bwd_ms")
                           if key in r}})
    print(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s, "
          f"the kernels' build included [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
