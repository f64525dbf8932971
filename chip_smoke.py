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
10. training: (a) the LM kernels' autograd Functions at the six
   families' training shapes (a microbatch of 1: internlm2's, qwen2-vl's
   GQA group 7 [1, 28 / 4, 2048, 128] and qwen2-moe's [1, 16, 2048, 128]
   causal attention, whisper's full [1, 12, 1500, 64], causal [1, 12,
   416, 64] and cross (416 queries, 1500 keys) attention, zamba2's
   Mamba2 and rwkv6's RWKV6 regime [1, 2048, 64, 64] with the bonus u;
   bf16): the forward within the kernels' bounds on the design the
   model takes, every input gradient (u's too) bitwise autograd's
   through the plain version (the backward recomputes it), the kernel
   forward and the recompute backward timed; (b) one ``make_train_step``
   of the six families' f32 smoke configs, card against CPU within 1e-4;
   (c) batch 8 x 2048 tokens in 8 microbatches, remat on, seeded bf16
   weights, at full width, one path for the six families (``run_train``):
   internlm2-1.8b and zamba2-1.2b whole, 3 steps, then rwkv6-7b at 15 of
   32 layers, qwen2-vl-7b at 12 of 28, qwen2-moe-a2.7b at 5 of 24
   (``TRAIN_CUTS``: the deepest whose dry-run peak is at most 70 GiB) and
   whisper-small whole (12 + 12 layers, 8 x 416 tokens, 1500 frames
   each), 2 steps; the first step counted and held against the dry run
   (phase 11's checks), the others timed: every gradient leaf finite and
   not all zero (qwen2-moe: every routed expert's slice of every layer,
   the 4 padded experts' exactly zero), the loss finite, the LM kernels'
   launches per step checked (two per attention / gla call and
   microbatch: the forward, then its recompute), step ms, train
   tokens/s, 6·N·tokens per step time over the bf16 dense peak (N: the
   active parameters), peak memory, the recompute backwards' share at
   (a)'s times (the room for the four cuts made by phases 12-16's
   two-rank jobs sharing one pool of ranks, ``RankPool``, spawned once,
   and phase 11's traces moved off the main process); (d)
   ``examples.train_lm`` (ETL-fed) for 30 steps: the loss falls,
   transform_kpi launched, its checkpoint restores bitwise; (e)
   ``manual_dp`` over NCCL at world size 1 against ``make_train_step``;
   (f) ``examples.quickstart`` on the card against its CPU run;
11. the dry run held against the card (``launch.dryrun``,
   ``launch.step_analysis``), its ``meta`` traces run in a spawned CPU
   process started before phase 9 (the six train steps first, the
   prefills last; the times it finished each are printed): phase 10c's
   first step of each of the six families, and for internlm2-1.8b and
   zamba2-1.2b phase 9's prefill (4 x 2048), run once more on the card
   under ``analyze_step`` with seeded weights: (a) operations, bytes,
   aten ops and kernel calls equal, exactly; (b) the dry run's peak
   estimate within 15% of the card's ``max_memory_allocated`` over the
   step; (c) its roofline bound over phase 10c's / 9's measured time at
   most 1.05. The (arch x shape) matrix runs from the CLI (``--all``),
   not here;
12. the model axis: internlm2-1.8b, zamba2-1.2b and qwen2-moe-a2.7b at
   full width (at 8 of 24, 12 of 38 and 8 of 24 layers,
   ``TP_SERVE_LAYERS``: room for phase 17),
   seeded bf16 weights, prefill 4 x 2048 and 8
   decode steps, first unsharded on the card (then freed), then on two
   ranks (processes on the one card, spawned once for phases 12-16's
   two-rank jobs, each job its own gloo group, gloo staging the CUDA
   tensors through the host; ``models/sharding.py``: heads, kv heads, MLP
   columns, experts and vocab over a (1, 2) mesh) fed the same tokens:
   every step's logits within 0.02 x max(|logits|, 1) of the unsharded
   run's, or, where the model's own rounding witness (the ranks'
   row-parallel arithmetic at one rank) misses that bound too, within
   1.25x the witness's mean error; the greedy tokens' agreement; the
   same in f32 (qwen2-moe at 8 of 24 layers), every step within 1e-3 x
   max(|logits|, 1); rank 0's launches at half the heads, by the
   wrappers' counts, the calls' shapes and torch.profiler, and its card
   time by kind; each rank's peak memory within 15% of the dry run's
   ``--cards 2 --model 2`` reckoning. Two ranks share one card's SMs:
   their times are no tensor-parallel speedup. Before them, the
   tensor-core flash and the SSD gla at the local head counts of M = 2
   (the ranks'), 4 and 16 (GQA group 7 with one kv head; one head; 4
   Mamba2 heads) against their plain versions, and a rank's
   row-parallel products against the product of f32 copies;
13. training under the model axis: the tensor-core flash and the SSD gla
   at the training local shapes of M = 2 (a microbatch of 1 x 2048 at
   half the heads of internlm2, qwen2-moe, qwen2-vl and zamba2) within
   2e-2 of their plain versions, their autograd Functions' gradients
   bitwise the plain versions'; then internlm2-1.8b and zamba2-1.2b at
   full width (at 4 of 24 and 12 of 38 layers, to make room for phase
   17), seeded bf16 weights, remat, one step of 2 x
   2048 in 2 microbatches: unsharded on the card (and under the rounding
   witness; then freed), then one ``manual_dp`` step on two gloo ranks
   over a (1, 2) mesh: each rank's loss and grad norm within 1e-2 of the
   unsharded step's (or 1.25x the witness's miss), every gradient leaf
   finite and nonzero, rank 0's launches and its issued collectives
   exactly the dry run's ``--cards 2 --model 2`` plan, each rank's peak
   within 15% of that cell's reckoning; and in f32 at full width
   (internlm2 at 4, zamba2 at 6, qwen2-moe at 2 layers) each rank's
   gradient leaves within 1e-4 x max |g| of the unsharded card
   gradient's slice;
14. rwkv6-7b and whisper-small under the model axis: the RWKV6 gla design
   at rwkv6's local heads (32 / 16 / 4 of 64 at a prefill of 4 x 2048,
   32 at a training microbatch of 1 x 2048) and the serial design in f32
   at both, both flash designs at whisper's (6 / 3 / 1 of 12) in its
   full, causal and cross regimes and at its training microbatch of 1,
   against their plain versions, and a rank holding
   no heads launching nothing; then phase 12's serving check (whisper:
   4 x 1500 frames and a 416-token prompt; rwkv6 at 8 of 32 layers, its
   f32 run too) and phase 13's training check (rwkv6 at 4 of 32 layers,
   whisper at full depth on 2 x 416 tokens; f32 cuts: rwkv6 at 2 layers,
   whisper at full depth) for both models on two gloo ranks;
15. the K/V cache's sequence split round-robin over ranks ("kv_seq",
   ``models/sharding.py``), under the reference cells' rules: the
   tensor-core flash at each rank's (q heads, kv heads) of qwen2-vl-7b
   over 8 ranks, and it and the SSD gla at zamba2-1.2b's 1 x 32,768
   prefill, against their plain versions; then qwen2-vl-7b at full width
   and 4 of 28 layers over (data 1, model 8) gloo ranks on the card
   (decode_32k's rule: its 4 kv heads fewer than 8, the sequence on
   "model", each rank holding every kv head at its positions) and
   zamba2-1.2b at 12 of 38 layers over (data 2, model 1) (long_500k's
   rule:
   the batch of 1 whole on each data rank, the shared attention's
   sequence on "data"), 4 x 2048 and 1 x 32,768 prompts, ``fill_cache``
   and 8 decode steps, in bf16 and f32, held as phase 12 holds its runs
   (the rounding witness at 8 ranks), every rank's cache leaves the
   layout's reckoning and the collectives of its prefill and of each
   decode step exactly the dry run's plans;
16. the model axis's other two layouts of the reference's rules, on two
   gloo ranks as phases 12-14 (their unsharded card runs kept and reused):
   the tensor-core flash and the SSD gla at the shapes these layouts give
   a rank (``layout_kernel_shapes``), in bf16 and f32, with the autograd
   Functions' gradients; then ``second_matmul="col"`` serving of
   internlm2-1.8b (at phase 12's 8 layers) and whisper-small (``wo`` and
   ``w_down`` split by
   output column: their input and output all-gathered), held as phase 12
   holds its runs but within the bound with no witness (no row-parallel
   sum is left), beside the row layout's reading, every decode step's
   collectives too exactly the plan, each rank's column-split leaves at
   the reference spec's bytes; then one ``manual_dp`` step under
   ``seq_parallel`` (internlm2-1.8b and zamba2-1.2b: the residual's
   positions over the ranks, each block's gathers and reduce-scatters)
   and under ``col`` (internlm2-1.8b), held as phase 13 holds its steps
   (cuts: zamba2 at 12 of 38 layers, internlm2 at 4 of 24 in both
   layouts, phase 13's depths), the
   leaves both ranks hold whole with bitwise equal gradients, internlm2's
   seq_parallel loss and grad norm reported beside phase 13's row step's
   bit for bit, and an f32 cut of each (internlm2 at 4 layers, zamba2 at
   6);
17. the data axis's last two layouts on four gloo ranks (no kernel of
   its own: the kernels see phase 13's shapes): (a) fsdp (ZeRO-3, each
   parameter's "embed" dim over "data", gathered per block and use,
   reduce-scattered in f32 in the backward) over (data 2, model 2),
   internlm2-1.8b at full depth and zamba2-1.2b at 12 of 38 layers, bf16,
   remat, one ``manual_dp`` step of 4 x 2048 (2 microbatches of 1 x 2048
   per data rank) unsplit, then with fsdp on the same ranks from the same
   state: the loss bitwise, the grad norm within 1e-5 relative, every
   updated leaf within one bf16 ulp of the unsplit step's part (from
   warm moments; a leaf several pieces read, zamba2's shared block, in
   ulps of its largest element: the unsplit step sums its applications'
   bf16 gradients in bf16), an f32 cut of each (internlm2 at 4 layers,
   zamba2 at 6; 2 x 2048, one microbatch per data rank) with its gradient
   shards (the first moment of a step from zero moments) within 1e-6 x
   their max, rank 0's collectives exactly the dry run's ``--cards 4
   --model 2 --override fsdp=true`` plan, each rank's peak within 15% of
   its reckoning beside the unsplit step's, the same launches; (b) the
   multi-pod mesh (pod 2, data 2, model 1), internlm2-1.8b at 8 of 24
   layers, 4 x 2048 (one microbatch of 1 x 2048 per data rank), without
   fsdp and
   with it, held against the same ranks as (data 4, model 1): the loss
   bitwise, the grad norm within 1e-5 relative, each step's collectives
   its ``--multi-pod`` plan. The dry run's cells are traced while the
   ranks run.

The line before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX and nothing of
the JAX package.
"""
import contextlib
import functools
import json
import math
import queue
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


# The whole run has to end inside 1,200 s, the kernels' build included.
# It took ~460 s with phases 1-11, then 630-1000 s as the model and data
# axes' phases 12-17 came (each spawn of ranks ~8 s of imports and a CUDA
# context). Phases 12-16's two-rank jobs now share one pool of ranks,
# phase 11's meta traces run in a process of their own while the card
# works, and phase 10c's first step is also phase 11's train check (no
# second training run): that pays for phase 10c's four other families,
# 753-961 s (PERF.md, section 5, keeps the per-phase times).
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
# decode steps of the profiled serve run (the timed one takes LM_DECODE):
# reading the profiler's events back costs host time in proportion
LM_PROFILE_DECODE = 8
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
    """Least time for one attention call: the package's own count of it
    (``flash_attention.ops.work``: each input read once and the output
    written once, 4·B·Hq·Sq·Skv·D flops, half of that causal at Sq =
    Skv) over HBM and the input dtype's peak."""
    import torch
    from repro_torch.kernels.flash_attention.ops import work
    flops, n_bytes = work(q, k, v, causal)
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


def check_gla(dev, gen, card) -> list:
    """Both gla_chunk designs against the plain version: f32 in both
    regimes (the serial design, 2e-4), then zamba2's bf16 Mamba2 inputs
    (the SSD design: out 2e-2, final state 2e-4) at S 2048, 2044 and 1000,
    with and without an initial state; then both designs timed side by
    side on zamba2's bf16 shape. Returns the two designs' records."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.gla_chunk.ops import CHUNK, gla
    from repro_torch.kernels.gla_chunk.ops import work as gla_work
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
    ops, n_bytes = gla_work(q, k, v, lw, inclusive=True)
    b_ms, b_by = bound(n_bytes, ops, BF16_FLOP_PER_S)
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
              f"{n_bytes} B, {ops:.4g} operations at the "
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
    version's, the bound (``gla_chunk.ops.work``'s bytes / 3.35 TB/s or
    its operations at the bf16 peak) and the RWKV6 design's chunk-state
    scratch; its three kernels under the profiler. Returns (the serial design's max error and
    timed record, the RWKV6 design's record)."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.gla_chunk.ops import CHUNK, gla
    from repro_torch.kernels.gla_chunk.ops import work as gla_work
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
    ops, n_bytes = gla_work(r, k, v, lw, u, inclusive=False)
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
    """Phase 9 for one model. Returns the serve run's launch counts, the
    f32 prefill's and the serve run's prefill seconds."""
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
    out_prefill_s = out["prefill_s"]
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
    prof = profile_run(f"serve {arch} ({LM_PROFILE_DECODE} decode steps)",
                       lambda: serve(model, params, prompts,
                                     gen_len=LM_PROFILE_DECODE + 1,
                                     max_len=prompt + LM_PROFILE_DECODE,
                                     frames=frames), card, ranges)
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
    return counts, f32_counts, out_prefill_s


# ----------------------------------------------------------------- phase 10
TRAIN_ARCHS = ("internlm2-1.8b", "zamba2-1.2b")
# the four other families, trained at full width with the same batch,
# microbatches and remat, each at the deepest depth whose dry-run peak is
# at most TRAIN_CUT_GIB: room under the card's 80 GiB for phase 11's 15%
# (None: whole; tests/test_torch_train_cells.py holds each cut against
# the dry run, the cut + 1 above the limit)
TRAIN_CUTS = {"rwkv6-7b": 15, "qwen2-vl-7b": 12, "qwen2-moe-a2.7b": 5,
              "whisper-small": None}
TRAIN_CUT_GIB = 70
LORA_B_STD = 0.05                  # rwkv6's w_lora_b (run_train)
# each trained model's path in the kernels record
TRAIN_PATHS = {arch: path.replace("lm_", "train_")
               for arch, path in LM_PATHS.items()}
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
# steps of a phase 10c cell: the first counted, the others timed
# (internlm2 and zamba2 whole: the median of two; a cut: one)
TRAIN_STEPS, CUT_STEPS = 3, 2
TRAIN_LM_STEPS = 30
SMOKE_TOL = 1e-4
# phase 10b's families that start from warm moments: from zero moments a
# step moves each element by about lr x sign(g), and rwkv6-smoke has
# near-zero gradients whose sign the card's order of summation flips
# (three leaves 5.9e-4 apart on an H100, the loss within 4.8e-7)
SMOKE_WARM = ("rwkv6-7b",)


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


# phase 10a's attention regimes at a training microbatch of 1: (regime,
# arch, query length, key length, causal); whisper's cross-attention
# reads the encoder's 1500 frames
TRAIN_FLASH = (("internlm2", "internlm2-1.8b", TRAIN_SEQ, TRAIN_SEQ, True),
               ("qwen2-vl", "qwen2-vl-7b", TRAIN_SEQ, TRAIN_SEQ, True),
               ("qwen2-moe", "qwen2-moe-a2.7b", TRAIN_SEQ, TRAIN_SEQ, True),
               ("whisper full", "whisper-small", 1500, 1500, False),
               ("whisper causal", "whisper-small", WHISPER_PROMPT,
                WHISPER_PROMPT, True),
               ("whisper cross", "whisper-small", WHISPER_PROMPT, 1500,
                False))
# the first regime of each kernel keeps the record's flat train keys
TRAIN_FN_MAIN = {"flash_attention_tc": "internlm2",
                 "gla_chunk_ssd": "zamba2", "gla_chunk_rwkv6": "rwkv6"}


def function_cases(dev, gen) -> list:
    """Phase 10a's cases: (regime, kernel, inputs, output gradient, the
    inputs as the model hands them over, the Function, its plain version,
    the bare kernel call, tolerance) at the training shapes of a
    microbatch of 1: every attention regime of ``TRAIN_FLASH`` (bf16 [1,
    S, H, D] activations read as [1, H, S, D]), zamba2's Mamba2 ([1, 2048,
    64, 64] bf16, q and k shared by the heads, an f32 decay per (token,
    head)) and rwkv6's RWKV6 regime ([1, 2048, 64, 64] bf16 r, k, v, the
    f32 per-channel decay and bonus u as phase 8 draws them)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gla_chunk import ops as gl
    from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref, gla_ssd_ref
    from repro_torch.models import build_model
    bf16 = torch.bfloat16
    tol = FLASH_TOL["bfloat16"]
    cases = []

    def flash_args(x):
        return tuple(t.transpose(1, 2) for t in x)

    for regime, arch, sq, skv, causal in TRAIN_FLASH:
        cfg = build_model(arch).cfg
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        x0 = [lm_rand((1, n, h, d), dev, bf16, gen)
              for n, h in ((sq, hq), (skv, hkv), (skv, hkv))]
        go = lm_rand((1, hq, sq, d), dev, bf16, gen)
        cases.append((regime, "flash_attention_tc", x0, go, flash_args,
                      functools.partial(fa.attention, causal=causal),
                      functools.partial(attention_ref, causal=causal),
                      functools.partial(fa.mha, causal=causal), tol))
    mz = build_model("zamba2-1.2b").cfg
    h, dk = mz.ssm.n_ssm_heads, mz.ssm.state_size
    dv = mz.ssm.expand * mz.d_model // h
    x0 = [lm_rand((1, TRAIN_SEQ, 1, dk), dev, bf16, gen),
          lm_rand((1, TRAIN_SEQ, 1, dk), dev, bf16, gen),
          lm_rand((1, TRAIN_SEQ, h, dv), dev, bf16, gen),
          -torch.exp(lm_rand((1, TRAIN_SEQ, h, 1), dev, torch.float32, gen))]

    def ssd_args(x):
        s = TRAIN_SEQ
        return (x[0].expand(1, s, h, dk), x[1].expand(1, s, h, dk), x[2],
                x[3].expand(1, s, h, dk))

    cases.append(("zamba2", "gla_chunk_ssd", x0,
                  lm_rand((1, TRAIN_SEQ, h, dv), dev, bf16, gen), ssd_args,
                  lambda *a: gl.gla_fn(*a, inclusive=True)[0],
                  lambda *a: gla_ssd_ref(*a)[0],
                  lambda *a: gl.gla(*a, inclusive=True)[0], tol))
    mr = build_model("rwkv6-7b").cfg
    h = mr.ssm.n_ssm_heads
    dk = mr.d_model // h
    cases.append(("rwkv6", "gla_chunk_rwkv6",
                  list(rwkv6_gla_inputs(1, TRAIN_SEQ, h, dk, dev, gen)),
                  lm_rand((1, TRAIN_SEQ, h, dk), dev, bf16, gen), tuple,
                  lambda *a: gl.gla_fn(*a, inclusive=False)[0],
                  lambda *a: gla_chunk_ref(*a, inclusive=False)[0],
                  lambda *a: gl.gla(*a, inclusive=False)[0], tol))
    return cases


def check_function_grads(dev, gen, card) -> dict:
    """Phase 10a: ``FlashAttentionFn`` and ``GlaChunkFn`` against autograd
    through their plain versions at the six families' training shapes
    (``function_cases``: internlm2's, qwen2-vl's (GQA group 7) and
    qwen2-moe's causal attention, whisper's full, causal and cross
    attention, zamba2's Mamba2 and rwkv6's RWKV6 regime, bonus ``u``
    included): the forward within the kernels' bounds on the design the
    model's call takes, every input gradient bitwise the plain version's
    (the backward recomputes it); the kernel forward, the Function's
    forward + backward and the recompute backward alone timed. Returns
    {regime: times and the kernel's name}."""
    import torch
    from repro_torch.kernels import launch_counts
    out = {}
    for (regime, name, x0, g, args, fn, plain, kernel,
         tol) in function_cases(dev, gen):
        leaves = {}
        outs = {}
        for side, f in (("fn", fn), ("plain", plain)):
            x = [t.clone().requires_grad_() for t in x0]
            before = launch_counts()
            outs[side] = f(*args(x))
            if side == "fn":
                design_moved(before, launch_counts(), name, 1,
                             f"{regime} {name} Function forward")
            leaves[side] = torch.autograd.grad(outs[side], x, g)
        torch.cuda.synchronize()
        err = max_err(outs["fn"].detach(), outs["plain"].detach(), tol,
                      f"{regime} {name} Function forward")
        if not all(a.dtype == b.dtype and bool(torch.equal(a, b))
                   for a, b in zip(leaves["fn"], leaves["plain"])):
            fail(f"{regime} {name}: the Function's input gradients differ "
                 f"from the plain version's")
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
        out[regime] = {"kernel": name, "fwd_ms": fwd_ms, "fn_ms": fn_ms,
                       "bwd_ms": bwd_ms, "plain_fwd_bwd_ms": plain_ms,
                       "max_abs_err": err,
                       "shapes": [list(t.shape) for t in args(x0)]}
        print(f"{name} Function at {regime}'s training shape "
              f"{[list(t.shape) for t in args(x0)]}: forward within {tol} "
              f"of the plain version (max abs err {err:.3g}), every input "
              f"gradient bitwise the plain version's; kernel forward "
              f"{fwd_ms:.4f} ms (device, CUDA graph), the Function's forward"
              f" + backward {fn_ms:.4f} ms, its recompute backward alone "
              f"{bwd_ms:.4f} ms, the plain version's forward + backward "
              f"{plain_ms:.4f} ms (CUDA events) [{card}]")
        del x
        torch.cuda.empty_cache()
    return out


def smoke_train_parity(dev, card) -> None:
    """Phase 10b: one ``make_train_step`` of the six families' f32 smoke
    configs on the card against the CPU (whisper with seeded frames),
    from zero moments (``SMOKE_WARM``'s from warm ones, elementwise
    functions of the parameters): loss, grad norm and updated parameters
    within 1e-4."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, AdamWState, init_state
    from repro_torch.train.train_step import make_train_step

    def warm(p):
        return AdamWState(
            step=torch.full((), 3, dtype=torch.int32,
                            device=tree_leaves(p)[0].device),
            mu=tree_map(lambda t: t.float() * 1e-3, p),
            nu=tree_map(lambda t: t.float().square() * 1e-4 + 1e-6, p))

    for arch in LM_ARCHS:
        moments = warm if arch in SMOKE_WARM else init_state
        model = build_model(arch, smoke=True)
        cfg = model.cfg
        params = tree_map(lambda t: t.float(),
                          model.init(torch.Generator().manual_seed(0)))
        rng = np.random.default_rng(2)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64)))
        batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (4, cfg.enc_seq, cfg.d_model), dtype=np.float32))
        step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1,
                                                  total_steps=10))
        gp = tree_map(lambda t: t.to(dev, copy=True), params)
        cp, _, cm = step(params, moments(params), batch)   # in place
        gp, _, gm = step(gp, moments(gp),
                         {k: v.to(dev) for k, v in batch.items()})
        errs = {k: abs(float(gm[k]) - float(cm[k])) for k in
                ("loss", "grad_norm")}
        errs["params"] = max(float((a.cpu() - b).abs().max())
                             for a, b in zip(tree_leaves(gp),
                                             tree_leaves(cp)))
        if not all(e <= SMOKE_TOL for e in errs.values()):
            fail(f"{arch}-smoke train step on the card differs from the "
                 f"CPU's: {errs}")
        print(f"{arch}-smoke f32 train step, card vs CPU, from "
              f"{'warm' if arch in SMOKE_WARM else 'zero'} moments: loss "
              f"{float(gm['loss']):.6f}, max abs differences {errs} (tol "
              f"{SMOKE_TOL}) [{card}]")


def train_layers(model):
    """(attention calls, gla calls) of one forward of a trained model:
    internlm2's attention layers; zamba2's shared block's applications
    and Mamba2 layers; rwkv6's RWKV6 layers; whisper's encoder layers and
    its decoder's self- and cross-attention."""
    cfg = model.cfg
    if cfg.family == "hybrid":
        return model.n_shared_apps(), cfg.n_layers
    if cfg.family == "ssm":
        return 0, cfg.n_layers
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers, 0
    return cfg.n_layers, 0


def train_expected(model) -> dict:
    """The LM kernels' launches of one train step: each layer's forward
    runs twice per microbatch, once, then again under remat in the
    backward (bf16: the tensor-core, SSD and RWKV6 designs)."""
    n_attn, n_gla = train_layers(model)
    n_mb = model.cfg.microbatches
    ssm = model.cfg.family == "ssm"
    return {"flash_attention": 2 * n_mb * n_attn,
            "flash_attention_tc": 2 * n_mb * n_attn,
            "gla_chunk": 2 * n_mb * n_gla,
            "gla_chunk_ssd": 0 if ssm else 2 * n_mb * n_gla,
            "gla_chunk_rwkv6": 2 * n_mb * n_gla if ssm else 0}


def recompute_step_ms(model, fn_times: dict) -> float:
    """The LM kernels' recompute backwards of one train step at phase
    10a's times: one backward per attention and gla call per microbatch,
    each at its family's regime (zamba2's shared attention at
    internlm2's, the one flash Function timed at a dense shape)."""
    cfg = model.cfg
    L = cfg.n_layers

    def bwd(regime):
        return fn_times[regime]["bwd_ms"]

    per_mb = {"dense": lambda: L * bwd("internlm2"),
              "hybrid": lambda: (model.n_shared_apps() * bwd("internlm2")
                                 + L * bwd("zamba2")),
              "ssm": lambda: L * bwd("rwkv6"),
              "moe": lambda: L * bwd("qwen2-moe"),
              "vlm": lambda: L * bwd("qwen2-vl"),
              "encdec": lambda: (cfg.n_enc_layers * bwd("whisper full")
                                 + L * (bwd("whisper causal")
                                        + bwd("whisper cross")))}
    return cfg.microbatches * per_mb[cfg.family]()


def active_params(model) -> int:
    """Parameters a token runs through: all of them, but for a MoE only
    its top-k routed experts of each layer (the shared experts, the
    router, attention, embedding and head included; the padded experts
    out)."""
    from repro_torch.models.param import count_params
    cfg = model.cfg
    n = count_params(model.defs)
    if cfg.moe is not None:
        moe = cfg.moe
        n -= (cfg.n_layers * (moe.padded_experts - moe.top_k) * 3
              * cfg.d_model * moe.d_ff_expert)
    return n


def train_cell_model(arch: str):
    """A phase 10c cell's full-width model, at its ``TRAIN_CUTS`` cut
    where it has one."""
    import dataclasses
    from repro_torch.models import Model, build_model
    cfg = build_model(arch).cfg
    if TRAIN_CUTS.get(arch):
        cfg = dataclasses.replace(cfg, n_layers=TRAIN_CUTS[arch])
    return Model(cfg)


def train_cell_batch(model, dev, gen) -> dict:
    """A cell's seeded batch as the dry run lays it out
    (``launch.specs.train_batch_specs``): tokens and targets [8, 2048]
    (whisper [8, 416] and its frames [8, 1500, 768] bf16; qwen2-vl its
    text M-RoPE positions [8, 2048, 3])."""
    import torch
    cfg = model.cfg
    seq = tpt_seq(model)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, seq), generator=gen,
                         device=dev)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (TRAIN_BATCH, cfg.enc_seq, cfg.d_model), generator=gen,
            device=dev).to(torch.bfloat16)
    if cfg.pos_scheme == "mrope":
        batch["positions"] = torch.arange(
            seq, dtype=torch.int32, device=dev)[None, :, None].expand(
                TRAIN_BATCH, seq, 3).contiguous()
    return batch


def expert_grads(model, grads) -> tuple:
    """A MoE's expert leaves (and its router's columns): the (layer,
    routed expert) slices whose gradient is all zero, and the padded
    experts' slices that are not (their gradient is zero by
    construction: routing masks them)."""
    from repro_torch.models.param import tree_leaves, tree_paths
    n = model.cfg.moe.n_experts
    dead, live = [], []
    for (path, d), g in zip(tree_paths(model.defs), tree_leaves(grads)):
        if "experts" in d.axes:                  # [L, E, ...]
            got = g[:, :n].ne(0).flatten(2).any(-1)
            pad = bool(g[:, n:].ne(0).any())
        elif path[-1] == "router":               # [L, D, E]
            got = g[..., :n].ne(0).any(1)
            pad = bool(g[..., n:].ne(0).any())
        else:
            continue
        dead += [(path, int(i), int(j)) for i, j in (~got).nonzero()]
        if pad:
            live.append(path)
    return dead, live


def run_train(arch: str, dev, card: str, fn_times: dict, dry: dict,
              steps: int) -> dict:
    """Phase 10c for one family, with its phase 11 check: the full-width
    model, whole or at its ``TRAIN_CUTS`` cut (seeded bf16 weights drawn
    on the card; rwkv6's zero-init ``w_lora_b`` drawn at std
    ``LORA_B_STD``, as the CPU tests draw it, so that the decay LoRA's
    ``w_lora_a`` has a gradient), batch 8 x 2048 (whisper 8 x 416 with
    1500 frames each) in the config's 8 microbatches with remat on,
    ``steps`` steps. The first runs under ``analyze_step`` with a
    ``compress_fn`` hook reading every gradient leaf (its reads outside
    the count): each leaf finite and not all zero, and for qwen2-moe each
    routed expert's slice of each layer (and router column) nonzero, the
    4 padded experts' exactly zero; held against the dry run's trace of
    the same cell (``dry``, traced meanwhile in the spawned
    ``trace_cells``): (a) operations, bytes, aten ops and kernel calls
    equal, (b) its peak within 15% of the card's over the step. The
    others are timed, their median the step time: (c) the dry run's bound
    over it at most 1.05; step ms, train tokens/s, 6·N·tokens over the
    bf16 dense peak (N the active parameters), the recompute backwards'
    share at phase 10a's times of the family's regimes. Every step's loss
    finite and its launches ``train_expected``'s. Returns the launches of
    all the steps."""
    import torch
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts
    from repro_torch.launch.step_analysis import analyze_step
    from repro_torch.models.param import tree_leaves
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train.train_step import make_train_step
    model = train_cell_model(arch)
    cfg = model.cfg
    if not cfg.remat or cfg.microbatches != 8:
        fail(f"{arch}: expected remat on and 8 microbatches")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    if cfg.family == "ssm":
        lora_b = params["layers"]["tm"]["w_lora_b"]
        lora_b.copy_(torch.randn(lora_b.shape, generator=gen, device=dev)
                     * LORA_B_STD)
    opt = init_state(params)
    batch = train_cell_batch(model, dev, gen)
    bad, experts = [], None

    def inspect(grads):
        with (_build.COUNTER.inside_kernel() if _build.COUNTER is not None
              else contextlib.nullcontext()):
            for i, g in enumerate(tree_leaves(grads)):
                if not bool(torch.isfinite(g).all()) or not bool(
                        (g != 0).any()):
                    bad.append(i)
            nonlocal experts
            if cfg.moe is not None:
                experts = expert_grads(model, grads)
        return grads

    checked = make_train_step(model, AdamWConfig(), compress_fn=inspect)
    plain = make_train_step(model, AdamWConfig())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    (params, opt, met), got = analyze_step(checked, params, opt, batch)
    losses = [float(met["loss"])]
    times = [time.perf_counter() - t0]
    step_peak = torch.cuda.max_memory_allocated(dev) - base
    counts = [lm_launches(launch_counts())]
    for _ in range(steps - 1):
        reset_launch_counts()
        t0 = time.perf_counter()
        params, opt, met = plain(params, opt, batch)
        losses.append(float(met["loss"]))         # syncs
        times.append(time.perf_counter() - t0)
        counts.append(lm_launches(launch_counts()))
    peak = torch.cuda.max_memory_allocated(dev)
    n_leaves = len(tree_leaves(params))
    del params, opt, batch, met
    torch.cuda.empty_cache()
    if bad:
        fail(f"{arch}: gradient leaves {bad} are not finite or all zero")
    if experts is not None and (experts[0] or experts[1]):
        fail(f"{arch}: routed expert slices with no gradient {experts[0]}; "
             f"padded experts with one in {experts[1]}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{arch}: train loss not finite: {losses}")
    want = train_expected(model)
    if any(c != want for c in counts):
        fail(f"{arch}: train steps launched {counts}, expected {want} each")
    step_s = statistics.median(times[1:])
    timed = ("the second" if steps == 2
             else f"the median of steps 2-{steps}")
    seq = tpt_seq(model)
    tokens = TRAIN_BATCH * seq
    n_active = active_params(model)
    share = 6 * n_active * tokens / step_s / BF16_FLOP_PER_S
    recompute_ms = recompute_step_ms(model, fn_times)
    cut = (f"{cfg.n_layers} of {build_model_layers(arch)} layers"
           if TRAIN_CUTS.get(arch) else f"whole ({cfg.n_layers} layers)")
    moe = ("; every routed expert's slice of every layer (and router "
           "column) with a gradient, the padded experts' exactly zero"
           if cfg.moe is not None else "")
    print(f"{arch} train [{card}]: {cut}"
          + (f" + {cfg.n_enc_layers} encoder layers over {cfg.enc_seq} "
             f"frames" if cfg.n_enc_layers else "")
          + f", d_model {cfg.d_model}, batch {TRAIN_BATCH} x {seq} in "
          f"{cfg.microbatches} microbatches, remat on; 0 of {n_leaves} "
          f"gradient leaves non-finite or all zero{moe}; losses "
          f"{[round(x, 4) for x in losses]}; step ms "
          f"{[round(t * 1e3, 3) for t in times]} (the first counted under "
          f"analyze_step; {timed} {step_s * 1e3:.3f} ms) = "
          f"{tokens / step_s:.1f} train tokens/s; N = "
          f"{n_active / 1e9:.4f} B {'active ' if cfg.moe is not None else ''}"
          f"parameters, 6·N·tokens / step time over the bf16 dense peak "
          f"(989 TFLOP/s) = {share:.4f}; peak memory {peak / 2**30:.2f} GiB; "
          f"launches per step {counts[-1]}; the LM kernels' recompute "
          f"backwards at phase 10a's times {recompute_ms:.3f} ms = "
          f"{recompute_ms / (step_s * 1e3):.4f} of a step")
    hold_dry(arch, "train", dry, got, step_peak, step_s, counts[0], want,
             card, TRAIN_BATCH, seq)
    return {k: sum(c[k] for c in counts) for k in LM_KEYS}


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


# ----------------------------------------------------------------- phase 11
PEAK_TOL = 0.15                    # the dry run's peak vs the card's
SHARE_MAX = 1.05                   # bound / measured above this: impossible


def dry_cells() -> list:
    """The cells phase 11's checks hold against the card, as (kind, arch,
    batch, sequence, layers or None), in the order they are needed: the
    six families' train steps (phase 10c, ``run_train``), then
    internlm2's and zamba2's prefills (``check_dryrun``)."""
    cells = [("train", arch, TRAIN_BATCH,
              WHISPER_PROMPT if arch == "whisper-small" else TRAIN_SEQ,
              TRAIN_CUTS.get(arch)) for arch in (*TRAIN_ARCHS, *TRAIN_CUTS)]
    return cells + [("prefill", arch, LM_BATCH, LM_PROMPT, None)
                    for arch in TRAIN_ARCHS]


def trace_cells(cells: list, q) -> None:
    """A spawned CPU process (it touches no card): each of ``cells``
    (``dry_cells``) built by the dry run (``launch.dryrun.build_cell`` at
    the cell's batch, sequence and depth) and traced on ``meta`` tensors
    (``analyze_cell``); puts ((kind, arch), what phase 11 reads and the
    wall-clock time it finished) on ``q`` as each finishes."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ShapeSuite
    from repro_torch.launch import dryrun
    for kind, arch, batch_n, seq, layers in cells:
        suite = ShapeSuite(f"phase_{kind}", seq, batch_n, kind)
        fn, args, meta, comm = dryrun.build_cell(
            arch, suite.name, suite=suite,
            overrides={"n_layers": layers} if layers else None)
        t0 = time.perf_counter()
        dry = dryrun.analyze_cell(fn, args, meta, comm)
        q.put(((kind, arch), {
            "cost": dry["cost"], "kernels": dry["kernels"],
            "memory": dry["memory"], "roofline": dry["roofline"],
            "trace_s": time.perf_counter() - t0, "done_at": time.time()}))


class Tracer:
    """``trace_cells`` in a spawned process, started before phase 9 so
    that its host work runs while the card works; ``get`` waits for a
    cell's result, ``close`` prints when each cell finished, in seconds
    of the script since ``wall0`` (its start on the wall clock): the
    host-timed windows before the last overlapped the tracing."""

    def __init__(self, wall0: float):
        import multiprocessing
        mp = multiprocessing.get_context("spawn")
        self.cells = dry_cells()
        self.q = mp.Queue()
        self.done = {}
        self.t0 = time.perf_counter()
        self.wall0 = wall0
        self.proc = mp.Process(target=trace_cells, args=(self.cells, self.q),
                               daemon=True)
        self.proc.start()

    def get(self, kind: str, arch: str, timeout: float = 600) -> dict:
        while (kind, arch) not in self.done:
            try:
                key, res = self.q.get(timeout=10)
                self.done[key] = res
            except queue.Empty:
                if self.proc.exitcode not in (None, 0):
                    fail(f"the dry run's tracer exited with "
                         f"{self.proc.exitcode}")
                if time.perf_counter() - self.t0 > timeout:
                    self.proc.kill()
                    fail(f"the dry run's tracer took over {timeout} s")
        return self.done[(kind, arch)]

    def close(self, card: str) -> None:
        self.proc.join(60)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
        done = {f"{kind} {arch}": round(r["done_at"] - self.wall0, 1)
                for (kind, arch), r in self.done.items()}
        print(f"the dry run's tracer (one CPU process) finished its cells at"
              f" {done} s of the script, the last at {max(done.values())} s "
              f"[{card}]")


def hold_dry(arch: str, kind: str, dry: dict, got: dict, peak: int,
             measured_s: float, counts: dict, want: dict, card: str,
             batch_n: int, seq: int) -> None:
    """Phase 11's three checks of one cell: (a) the card run's operations,
    bytes, aten ops and kernel calls (``analyze_step``'s ``got``) equal the
    dry run's; (b) the dry run's peak estimate within 15% of the card's
    ``peak`` over the step; (c) its roofline bound over the measured
    ``measured_s`` at most 1.05; and the run's LM launches ``want``."""
    if counts != want:
        fail(f"{arch} {kind} under analyze_step launched {counts}, "
             f"expected {want}")
    cost = dry["cost"]
    same = (got["flops"] == cost["flops_per_device"]
            and got["bytes"] == cost["bytes_per_device"]
            and got["ops"] == cost["ops"]
            and got["kernels"] == dry["kernels"])
    if not same:
        fail(f"{arch} {kind}: the card run counted {got['flops']} "
             f"operations, {got['bytes']} B, {got['ops']} ops, kernels "
             f"{got['kernels']}; the dry run {cost}, {dry['kernels']}")
    est = dry["memory"]["peak_estimate_bytes"]
    if not abs(est - peak) <= PEAK_TOL * peak:
        fail(f"{arch} {kind}: the dry run's peak estimate {est} B is not "
             f"within {PEAK_TOL:.0%} of the card's {peak} B")
    roof = dry["roofline"]
    share = roof["bound_s"] / measured_s
    if not share <= SHARE_MAX:
        fail(f"{arch} {kind}: roofline bound {roof['bound_s']} s over "
             f"the measured {measured_s} s = {share} > {SHARE_MAX}: an "
             f"impossible reading")
    print(f"{arch} dry run of the {kind} [{batch_n} x {seq}] held "
          f"against the card [{card}]: traced on meta in "
          f"{dry['trace_s']:.2f} s (host, in a spawned process while the "
          f"card worked); (a) operations {got['flops']} and bytes "
          f"{got['bytes']} ({got['ops']} ops, kernels "
          f"{ {k: v['calls'] for k, v in got['kernels'].items()} }) "
          f"equal on the card and on meta; (b) peak estimate "
          f"{est / 2**30:.3f} GiB vs the card's max_memory_allocated "
          f"{peak / 2**30:.3f} GiB ({est / peak - 1:+.4f}); (c) roofline "
          f"bound {roof['bound_s'] * 1e3:.3f} ms ({roof['dominant']}: "
          f"compute {roof['t_compute_s'] * 1e3:.3f}, memory "
          f"{roof['t_memory_s'] * 1e3:.3f} ms) over the measured "
          f"{measured_s * 1e3:.3f} ms = {share:.4f}; launches {counts}")


def check_dryrun(arch: str, dev, card: str, prefill_s: float,
                 tracer: Tracer) -> dict:
    """Phase 11 for phase 9's prefill (4 x 2048) of one model (phase 10c
    holds the train steps, ``run_train``): traced by the dry run on
    ``meta`` tensors (``tracer``, while phase 9 ran) and run once on the
    card under ``launch.step_analysis.analyze_step`` (untimed: the
    counting adds host work), with fresh seeded weights, held by
    ``hold_dry``: the card's peak counted from ``reset_peak_memory_stats``,
    less what was allocated before the weights were drawn; the bound over
    phase 9's measured ``prefill_s``. Returns the launches."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.step_analysis import analyze_step
    from repro_torch.models import build_model
    from repro_torch.train.serve_step import make_prefill_step
    model = build_model(arch)
    dry = tracer.get("prefill", arch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    toks = torch.randint(0, model.cfg.vocab, (LM_BATCH, LM_PROMPT),
                         generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    out, got = analyze_step(make_prefill_step(model), params,
                            {"tokens": toks})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    counts = lm_launches(launch_counts())
    del out, params, toks
    torch.cuda.empty_cache()
    hold_dry(arch, "prefill", dry, got, peak, prefill_s, counts,
             lm_expected(model), card, LM_BATCH, LM_PROMPT)
    return counts


JOB_DONE = "job done"               # a pool rank's last word on a job


def pool_rank(rank: int, jobs, q) -> None:
    """A rank of a ``RankPool``: takes (target, port, args) jobs off its
    queue in turn, runs ``target(rank, port, *args, q)``, gives its card
    memory back to the main process and says ``JOB_DONE``, until a
    None."""
    import gc
    import torch
    while True:
        job = jobs.get()
        if job is None:
            return
        target, port, args = job
        target(rank, port, *args, q)
        gc.collect()
        torch.cuda.empty_cache()
        q.put(JOB_DONE)


class RankPool:
    """``world`` processes spawned once on the one card (``pool_rank``),
    which take the phases' jobs in turn: each ``run`` is one job of every
    rank, a gloo group on a free localhost port of its own. The spawn,
    the imports and a CUDA context cost each process ~8 s once, not once
    per job. The processes are daemons: they end with this one."""

    def __init__(self, world: int):
        import multiprocessing
        mp = multiprocessing.get_context("spawn")
        self.world = world
        self.q = mp.Queue()
        self.jobs = [mp.Queue() for _ in range(world)]
        self.procs = [mp.Process(target=pool_rank, args=(r, self.jobs[r],
                                                         self.q), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, target, args: tuple, items: int, timeout: float,
            what: str, meanwhile=None) -> tuple:
        """Every rank runs ``target(rank, port, *args, queue)``; returns
        (the ``items`` reports they put on the queue, the seconds from
        the job's start to the last rank's end of it, its memory given
        back). ``meanwhile()``, where given, runs
        here once the job has started. A rank that fails, or a job slower
        than ``timeout``, fails the run, the processes stopped."""
        import socket
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        t0 = time.perf_counter()
        for jobs in self.jobs:
            jobs.put((target, port, args))
        if meanwhile is not None:
            meanwhile()
        got, done, broken = [], 0, None
        while (len(got) < items or done < self.world) and broken is None:
            try:
                item = self.q.get(timeout=10)
                if item == JOB_DONE:
                    done += 1
                else:
                    got.append(item)
            except queue.Empty:
                if any(p.exitcode is not None for p in self.procs):
                    broken = "a rank failed"
                elif time.perf_counter() - t0 > timeout:
                    broken = f"the ranks took over {timeout} s"
        seconds = time.perf_counter() - t0
        if broken:
            codes = [p.exitcode for p in self.procs]
            self.close(wait=0)
            fail(f"{what} on {self.world} ranks: {broken} (exit codes "
                 f"{codes})")
        return got, seconds

    def close(self, wait: float = 60) -> None:
        """Ends the processes (``wait`` seconds each to finish their
        job), killing any still alive."""
        for jobs, p in zip(self.jobs, self.procs):
            if p.is_alive():
                jobs.put(None)
        for p in self.procs:
            p.join(wait)
            if p.is_alive():
                p.kill()
                p.join()
        if any(p.exitcode not in (0, -9) for p in self.procs) and wait:
            fail(f"a rank of a pool of {self.world} exited with "
                 f"{[p.exitcode for p in self.procs]}")


POOLS = {}                         # TP_RANKS -> the shared RankPool
# what a shared pool's job time holds: its ranks' spawn only in the first
POOL_NOTE = ("imports and weights included; the two-rank pool's spawn in "
             "its first job, phase 12's")
SPAWN_NOTE = "spawn, imports and weights included"


def spawn_ranks(target, world: int, args: tuple, items: int,
                timeout: float, what: str, meanwhile=None) -> tuple:
    """``target(rank, port, *args, queue)`` in ``world`` processes on the
    one card (``RankPool.run``): a world of ``TP_RANKS`` in the pool that
    phases 12-16 share (spawned at its first job, ended by
    ``close_pools``), any other in a pool of its own, ended after the
    job."""
    if world == TP_RANKS:
        if world not in POOLS:
            POOLS[world] = RankPool(world)
        return POOLS[world].run(target, args, items, timeout, what,
                                meanwhile)
    pool = RankPool(world)
    got = pool.run(target, args, items, timeout, what, meanwhile)
    pool.close()
    return got


def close_pools() -> None:
    while POOLS:
        POOLS.popitem()[1].close()


# ----------------------------------------------------------------- phase 12
TP_ARCHS = ("internlm2-1.8b", "zamba2-1.2b", "qwen2-moe-a2.7b")
TP_PATHS = {"internlm2-1.8b": "tp_internlm2", "zamba2-1.2b": "tp_zamba2",
            "qwen2-moe-a2.7b": "tp_qwen2moe", "rwkv6-7b": "tp_rwkv6",
            "whisper-small": "tp_whisper"}
TP_RANKS, TP_DECODE = 2, 8
TP_TIMEOUT_S = 600                 # the two ranks' whole run
# a bf16 miss of the bound is held within this many times the model's
# own rounding witness, mean over the steps (phase 9's rule for rwkv6)
TP_WITNESS_SLACK = 1.25
# the kernels' device names (one ssd_scan_kernel per gla_ssd call)
TP_PROFILED = {"flash_attention_tc": "flash_tc_kernel",
               "gla_chunk_ssd": "ssd_scan_kernel",
               "gla_chunk_rwkv6": "rwkv6_scan_kernel"}


# the two-rank serving runs' depths (phases 12, 14 and 16; full width):
# cut to make room for phase 17 within the script's time (their
# full-depth runs took 83.0 / 58.9 / 49.0 s of two gloo ranks on one
# H100); whisper-small stays whole
TP_SERVE_LAYERS = {"internlm2-1.8b": 8, "zamba2-1.2b": 12,
                   "qwen2-moe-a2.7b": 8, "rwkv6-7b": 8}


def tp_model(arch: str):
    """The full-width model of a two-rank serving run, at
    ``TP_SERVE_LAYERS``' depth."""
    import dataclasses
    from repro_torch.models import Model, build_model
    model = build_model(arch)
    n = TP_SERVE_LAYERS.get(arch)
    return Model(dataclasses.replace(model.cfg, n_layers=n)) if n else model


class Kept:
    """What phases 12-14 keep for phase 16, whose layouts run the same
    weights, tokens and steps: the unsharded card runs their ranks are
    held against (``serve``: {arch: ``tp_unsharded``'s}; ``train``:
    {(arch, layers): ``tpt_unsharded``'s}) and the row layout's readings
    phase 16 reports beside its own (``row``)."""

    def __init__(self):
        self.serve, self.train, self.row = {}, {}, {}


def layout_name(layout) -> str:
    """A layout override's name in the paths and notes: "row" (the
    default), "col" or "seq_parallel"."""
    if not layout:
        return "row"
    return "seq_parallel" if layout.get("seq_parallel") else "col"


def tp_prompt(model) -> int:
    """The prompt length of a two-rank run: whisper's 416-token decoder
    prompt, the others' 2048."""
    return WHISPER_PROMPT if model.cfg.family == "encdec" else LM_PROMPT


def tp_draw(model, dev, ctx=None, rows: int = LM_BATCH, prompt: int = 0):
    """Phase 9's seeded bf16 weights (this rank's slices of them under
    ``ctx``, drawn leaf by leaf) and the prefill's batch drawn after them
    from the same generator: the prompts [4, 2048] (whisper's [4, 416]
    and its frames [4, 1500, 768], as phase 9 draws them; ``rows`` x
    ``prompt`` where given)."""
    import torch
    from repro_torch.models.sharding import NULL_CTX
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, ctx or NULL_CTX)
    batch = {"tokens": torch.randint(0, cfg.vocab,
                                     (rows, prompt or tp_prompt(model)),
                                     generator=gen, device=dev)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((rows, cfg.enc_seq, cfg.d_model),
                                      generator=gen, device=dev).to(
                                          torch.bfloat16)
    return params, batch


def tp_steps(model, params, batch, feed=None, ctx=None) -> dict:
    """Prefill the batch's prompts, then 8 decode steps fed ``feed`` [4,
    8] (None: the greedy tokens as they come). Returns the prefill's
    last-position logits and each step's, full (gathered over the ranks
    under ``ctx``), f32 numpy, and the greedy tokens [4, 9]; under
    ``ctx`` also the prefill's seconds, decode seconds and peak bytes
    over the prefill, and, where ``ctx``'s ``comm`` records them
    (``TptComm``), the collectives the prefill step issued (its greedy
    token's all-gather included) and those of each decode step; and the
    shapes of the prefill's cache leaves and of the filled cache's."""
    import torch
    from repro_torch.examples.serve_lm import fill_cache
    from repro_torch.models.param import tree_leaves
    from repro_torch.models.sharding import NULL_CTX
    from repro_torch.train.serve_step import greedy, make_decode_step
    ctx = ctx or NULL_CTX
    prompts = batch["tokens"]
    rows, n = prompts.shape
    dev = prompts.device
    issued = getattr(ctx.comm, "issued", None)
    if issued is not None:
        issued.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    logits, pre, _ = model.forward(params, batch, mode="prefill", ctx=ctx)
    torch.cuda.synchronize()
    out = {"prefill_s": time.perf_counter() - t0,
           "peak": torch.cuda.max_memory_allocated(dev)}
    got, toks = [logits[:, -1]], [greedy(model, logits[:, -1], ctx)]
    if issued is not None:
        out["prefill_issued"] = list(issued)
        out["decode_issued"] = []
    del logits
    cache = fill_cache(model.init_cache(rows, n + TP_DECODE, dev, ctx),
                       pre)
    out["prefill_cache"] = [tuple(t.shape) for t in tree_leaves(pre)]
    out["cache"] = [tuple(t.shape) for t in tree_leaves(cache)]
    del pre
    decode = make_decode_step(model, ctx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TP_DECODE):
        tok = toks[-1] if feed is None else feed[:, i]
        if issued is not None:
            issued.clear()
        nxt, lg, cache = decode(params, cache, tok[:, None].long(), n + i)
        if issued is not None:
            out["decode_issued"].append(list(issued))
        got.append(lg)
        toks.append(nxt)
    torch.cuda.synchronize()
    out["decode_s"] = time.perf_counter() - t0
    del cache
    out["logits"] = [model.gather_logits(t.float(), ctx).cpu().numpy()
                     for t in got]
    out["tokens"] = torch.stack(toks, 1).long().cpu().numpy()
    return out


@contextlib.contextmanager
def rounding_witness(pieces=None):
    """The two ranks' arithmetic at one rank: every row-parallel site
    (``wo``, the MLPs' ``w_down``, Mamba2's ``out_proj``) computed as two
    partial products over the halves of its inner dim in x's dtype (as
    each of the two ranks computes its half), summed in f32 and rounded
    once; the MoE's routed and shared sums are f32 in either case
    (``moe_ffn``'s one ending). ``pieces(rows, axis)``: the ranks' row
    counts instead of the halves (``rank_pieces``). Yields the list of
    the sites it computed: empty means the model no longer reached the
    patch."""
    from repro_torch.models import blocks, layers
    saved = blocks.row_parallel, layers.row_parallel
    calls = []

    def halves(x, w, ctx, axis, **_):
        h = w.shape[0] - w.shape[0] // 2      # rank 0 the larger share
        sizes = pieces(w.shape[0], axis) if pieces else [h, w.shape[0] - h]
        calls.append(tuple(w.shape))
        acc, lo = None, 0
        for n in sizes:
            part = (x[..., lo:lo + n].contiguous() @ w[lo:lo + n]).float()
            acc = part if acc is None else acc + part
            lo += n
        return acc.to(x.dtype)
    blocks.row_parallel = layers.row_parallel = halves
    try:
        yield calls
    finally:
        blocks.row_parallel, layers.row_parallel = saved


def tp_f32(model, params, batch):
    """The model, its weights and the batch (whisper's frames) in f32 for
    phase 12's and 14's f32 checks (qwen2-moe cut to its first 8 layers,
    as phase 9's f32 check, and rwkv6 to its first ``TP_RWKV6_F32_LAYERS``:
    f32 weights of all their layers would not leave room for two
    ranks)."""
    from repro_torch.models.param import tree_map
    cut = {"moe": MOE_F32_LAYERS, "ssm": TP_RWKV6_F32_LAYERS}.get(
        model.cfg.family)
    if cut:
        model, params = first_layers(model, params, cut)
    return model, tree_map(lambda t: t.float(), params), {
        k: t.float() if t.is_floating_point() else t
        for k, t in batch.items()}


def f32_cut(model) -> str:
    """The depth cut of ``tp_f32``, as a note."""
    cut = {"moe": MOE_F32_LAYERS, "ssm": TP_RWKV6_F32_LAYERS}.get(
        model.cfg.family)
    return f" ({cut} of {model.cfg.n_layers} layers)" if cut else ""


def tp_unsharded(arch: str, dev) -> dict:
    """The unsharded card runs phase 12 holds the ranks against, as numpy
    (the ranks get them by value): bf16 (free-running greedy decode) and
    its rounding witness fed the same tokens, then the same in f32
    (``tp_f32``). Frees the model before it returns."""
    import torch
    model = tp_model(arch)
    params, batch = tp_draw(model, dev)
    out = {"prompts": batch["tokens"].cpu().numpy(),
           "bf16": tp_steps(model, params, batch)}
    feed = torch.from_numpy(out["bf16"]["tokens"][:, :TP_DECODE]).to(dev)
    with rounding_witness() as sites:
        out["witness"] = tp_steps(model, params, batch, feed)
    if not sites:
        fail(f"{arch}: the rounding witness reached no row-parallel site")
    f_model, params, batch = tp_f32(model, params, batch)
    out["f32"] = tp_steps(f_model, params, batch)
    del params, batch, feed
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def tp_rank(rank: int, port: int, archs: tuple, refs: dict, layout: dict,
            q) -> None:
    """One of the two ranks of phase 12, 14 or 16 (a spawned process on
    the one card; gloo stages its CUDA tensors through the host), under
    the ``layout`` overrides of the reference's rules (phase 16:
    ``second_matmul="col"``): for each model of ``archs``,
    its slices of the seeded weights (the ranks draw in turn, so that one
    full leaf at a time is in flight on the card), the prefill and the
    decode steps fed the unsharded run's tokens (bf16, then f32:
    ``tp_f32``), the logits all-gathered over the vocab, the bf16 run
    under ``torch.profiler`` (its times include the profiler's cost).
    Rank 0 reports them, its launches, the kernel calls' shapes and the
    profiler's kernel counts; every rank its peak memory over the bf16
    prefill (from before its weights were drawn), its times and the bytes
    it holds of each leaf whose columns are on "embed_out"."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.gla_chunk import ops as gl
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.param import tree_leaves, tree_paths
    from repro_torch.models.sharding import ShardingCtx, default_rules
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=TP_RANKS, rank=rank)
    try:
        ctx = ShardingCtx(make_mesh((1, TP_RANKS), ("data", "model")),
                          default_rules(**layout), comm=TptComm())
        shapes = []
        saved = fa.mha, gl.gla

        def mha(q_, k, v, **kw):
            shapes.append(("flash", tuple(q_.shape), tuple(k.shape)))
            return saved[0](q_, k, v, **kw)

        def gla(q_, k, v, *a, **kw):
            shapes.append(("gla", tuple(q_.shape), tuple(v.shape)))
            return saved[1](q_, k, v, *a, **kw)

        for arch in archs:
            ref = refs[arch]
            model = tp_model(arch)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(dev)
            for r in range(TP_RANKS):       # one rank draws at a time
                if r == rank:
                    params, batch = tp_draw(model, dev, ctx)
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()   # the full leaves' blocks
                dist.barrier()
            if not bool((batch["tokens"].cpu().numpy()
                         == ref["prompts"]).all()):
                raise RuntimeError(f"{arch}: rank {rank} drew other prompts "
                                   f"than the unsharded run")
            shapes.clear()
            reset_launch_counts()
            fa.mha, gl.gla = mha, gla
            feed = torch.from_numpy(ref["bf16"]["tokens"]).to(dev)
            try:
                # phase 16 runs unprofiled: reading the profiler back
                # costs seconds, and phase 12 / 14 time these paths
                with (contextlib.nullcontext() if layout else
                      profile(activities=[ProfilerActivity.CUDA])) as prof:
                    got = tp_steps(model, params, batch, feed, ctx)
            finally:
                fa.mha, gl.gla = saved
            got["peak"] -= base
            counts = lm_launches(launch_counts())
            spans = [] if prof is None else [
                (e.name, e.time_range.start, e.time_range.end)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
            names = [n for n, _, _ in spans]
            out = {"rank": rank, "arch": arch, "bf16": got,
                   "launches": counts, "shapes": sorted(set(shapes)),
                   "calls": len(shapes),
                   "pair_bytes": {
                       path: x.numel() * x.element_size()
                       for (path, d), x in zip(tree_paths(model.defs),
                                               tree_leaves(params))
                       if "embed_out" in d.axes},
                   "profiled": {k: sum(n in e for e in names)
                                for k, n in TP_PROFILED.items()},
                   "traced": bool(names), "device": device_split(spans)}
            f_model, params, batch = tp_f32(model, params, batch)
            feed = torch.from_numpy(ref["f32"]["tokens"]).to(dev)
            out["f32"] = tp_steps(f_model, params, batch, feed, ctx)
            if rank != 0:                   # the logits are rank 0's to send
                for key in ("bf16", "f32"):
                    if key in out:
                        out[key] = {k: v for k, v in out[key].items()
                                    if k not in ("logits", "tokens")}
            q.put(out)
            del params, batch, feed, got
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            dist.barrier()
    finally:
        dist.destroy_process_group()


# cuBLAS's GEMM kernels by name (Hopper's nvjet and the xmma / CUTLASS
# families; the f32 ones among them read "sgemm" or f32 inputs)
GEMM_MARKS = ("gemm", "nvjet", "xmma", "cutlass")
F32_GEMM_MARKS = ("sgemm", "f32f32_f32f32", "_tf32", "simt")


def device_split(spans) -> dict:
    """A profiled run's CUDA kernels ((name, start us, end us)): the
    card's busy time (the union of the spans), the summed time of the
    cuBLAS GEMMs and of the f32 ones among them, of the copies and casts
    (``copy_``/``to`` kernels) and the largest kernels (name, calls, us)."""
    busy, end = 0.0, float("-inf")
    for _, lo, hi in sorted(spans, key=lambda t: t[1]):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    per = {}
    for name, lo, hi in spans:
        c, t = per.get(name, (0, 0.0))
        per[name] = (c + 1, t + hi - lo)

    def total(pred):
        return sum(t for n, (_, t) in per.items() if pred(n.lower()))
    gemm = total(lambda n: any(m in n for m in GEMM_MARKS))
    return {"busy_us": busy, "gemm_us": gemm,
            "f32_gemm_us": total(lambda n: any(m in n for m in GEMM_MARKS)
                                 and any(m in n for m in F32_GEMM_MARKS)),
            "copy_us": total(lambda n: "copy" in n),
            "top": [(n[:70], c, t) for n, (c, t) in
                    sorted(per.items(), key=lambda kv: -kv[1][1])[:6]]}


def tp_local_shapes(model) -> set:
    """The flash and gla calls' (q, k or v) shapes on rank 0 of two:
    half the heads of each attention, Mamba2 and RWKV6 layer (whisper:
    its encoder's full attention over the frames, its decoder's causal
    self-attention and its cross-attention from the prompt and from each
    decode step's token)."""
    cfg = model.cfg
    hd, m = cfg.resolved_head_dim, TP_RANKS
    if cfg.family == "ssm":
        h = cfg.ssm.n_ssm_heads // m
        dk = cfg.d_model // cfg.ssm.n_ssm_heads
        return {("gla", (LM_BATCH, LM_PROMPT, h, dk),
                 (LM_BATCH, LM_PROMPT, h, dk))}
    if cfg.family == "encdec":
        h, e, p = cfg.n_heads // m, cfg.enc_seq, WHISPER_PROMPT
        return {("flash", (LM_BATCH, h, sq, hd), (LM_BATCH, h, skv, hd))
                for sq, skv in ((e, e), (p, p), (p, e), (1, e))}
    out = {("flash", (LM_BATCH, cfg.n_heads // m, LM_PROMPT, hd),
            (LM_BATCH, cfg.n_kv_heads // m, LM_PROMPT, hd))}
    if cfg.family == "hybrid":
        from repro_torch.models.blocks import mamba_dims
        _, nh, dv, st = mamba_dims(cfg)
        out.add(("gla", (LM_BATCH, LM_PROMPT, nh // m, st),
                 (LM_BATCH, LM_PROMPT, nh // m, dv)))
    return out


# the model axis's local shapes beyond the two-rank runs': (label, B,
# Hq, Hkv, S, D) for flash, (label, B, S, H, dk, dv) for gla_ssd
TP_LOCAL_FLASH = (("qwen2-vl at M = 4: GQA group 7, one kv head",
                   LM_BATCH, 7, 1, LM_PROMPT, 128),
                  ("qwen2-vl at M = 16, rank 3: q heads 6, 7 read kv 0, 1",
                   LM_BATCH, 2, 2, LM_PROMPT, 128),
                  ("internlm2 at M = 16: one q and one kv head",
                   LM_BATCH, 1, 1, LM_PROMPT, 128))
TP_LOCAL_GLA = (("zamba2 at M = 16: 4 Mamba2 heads", LM_BATCH, LM_PROMPT,
                 4, 64, 64),)


def tp_kernel_shapes() -> tuple:
    """(flash, gla) in ``TP_LOCAL_FLASH`` / ``TP_LOCAL_GLA``'s form: the
    shapes rank 0 of the two-rank runs gives the kernels
    (``tp_local_shapes``), then the M = 4 and 16 ones."""
    from repro_torch.models import build_model
    flash, gla = [], []
    for arch in TP_ARCHS:
        for kind, a, b in sorted(tp_local_shapes(build_model(arch))):
            label = f"{arch} at M = {TP_RANKS}"
            if kind == "flash":
                flash.append((label, a[0], a[1], b[1], a[2], a[3]))
            else:
                gla.append((label, a[0], a[1], a[2], a[3], b[3]))
    return tuple(flash) + TP_LOCAL_FLASH, tuple(gla) + TP_LOCAL_GLA


def tp_train_shapes() -> tuple:
    """(flash, gla) as ``tp_kernel_shapes``: the shapes training at M = 2
    gives the kernels on a rank, a microbatch of 1 x 2048 (the dense, MoE,
    VLM and hybrid families' attention at half the q and kv heads; zamba2's
    Mamba2 at half its heads)."""
    from repro_torch.models import build_model
    from repro_torch.models.blocks import mamba_dims
    flash, gla = [], []
    for arch in TPT_SHAPE_ARCHS:
        cfg = build_model(arch).cfg
        label = f"{arch} training at M = {TP_RANKS}, microbatch 1"
        flash.append((label, 1, cfg.n_heads // TP_RANKS,
                      cfg.n_kv_heads // TP_RANKS, TRAIN_SEQ,
                      cfg.resolved_head_dim))
        if cfg.family == "hybrid":
            _, nh, dv, st = mamba_dims(cfg)
            gla.append((label, 1, TRAIN_SEQ, nh // TP_RANKS, st, dv))
    return tuple(flash), tuple(gla)


def function_grads_bitwise(fn, plain, x0, go, what: str) -> None:
    """The kernel's autograd Function against autograd through its plain
    version on the same inputs: every input gradient bitwise equal (the
    Function's backward recomputes the plain version)."""
    import torch
    grads = []
    for f in (fn, plain):
        x = [t.detach().clone().requires_grad_() for t in x0]
        grads.append(torch.autograd.grad(f(*x), x, go))
    if not all(a.dtype == b.dtype and bool(torch.equal(a, b))
               for a, b in zip(*grads)):
        fail(f"{what}: the Function's input gradients differ from the "
             f"plain version's")


def attention_ref_by_head(q, k, v):
    """The plain causal attention one kv head's group at a time (the
    same function; its f32 scores of a 32,768-token sequence are 4 GiB
    per head)."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = q.shape[1] // k.shape[1]
    return torch.cat([attention_ref(q[:, h * g:(h + 1) * g], k[:, h:h + 1],
                                    v[:, h:h + 1])
                      for h in range(k.shape[1])], 1)


def check_local_kernels(dev, gen, train: bool = False, shapes=None,
                        f32: bool = False) -> None:
    """The tensor-core flash and the SSD gla at the head counts the model
    axis gives ranks (``tp_kernel_shapes``: the two-rank runs' at M = 2,
    and M = 4 and 16's; with ``train``, ``tp_train_shapes``; ``shapes``
    in their form instead, phase 15's ``kv_kernel_shapes``), against
    their plain versions (out 2e-2, gla's final state 2e-4), each call
    taken by its design; their ``work`` formulas scale with the heads
    (the full model's count over M). With ``train`` or ``f32`` the same
    shapes also in f32, the dtype of phases 13's and 15's f32 runs: the
    CUDA-core flash within 2e-5 and the serial gla within 2e-4 of their
    plain versions; with ``train``, in both dtypes, the autograd
    Functions' input gradients, bitwise the plain versions'."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention.ops import attention, mha
    from repro_torch.kernels.flash_attention.ops import work as flash_work
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gla_chunk.ops import gla, gla_fn
    from repro_torch.kernels.gla_chunk.ops import work as gla_work
    from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref, gla_ssd_ref
    flash_shapes, gla_shapes = shapes or (
        tp_train_shapes() if train else tp_kernel_shapes())
    grads = ("; the Function's input gradients bitwise the plain "
             "version's" if train else "")
    for dtype in ((torch.bfloat16, torch.float32) if train or f32
                  else (torch.bfloat16,)):
        name = str(dtype).split(".")[1]
        bf16 = dtype == torch.bfloat16
        f_design = "flash_attention_tc" if bf16 else "flash_attention (f32)"
        g_design = "gla_chunk_ssd" if bf16 else "gla_chunk (serial, f32)"
        out_tol = FLASH_TOL["bfloat16"] if bf16 else GLA_TOL
        for label, b, hq, hkv, s_, d in flash_shapes:
            q, k, v = flash_inputs(b, hq, hkv, s_, d, dtype, dev, gen)
            before = launch_counts()
            out = mha(q, k, v)
            after = launch_counts()
            design_moved(before, after, "flash_attention", 1, label)
            design_moved(before, after, "flash_attention_tc", int(bf16),
                         label)
            plain = attention_ref_by_head if s_ > 8192 else attention_ref
            err = max_err(out, plain(q, k, v), FLASH_TOL[name],
                          f"{f_design} {label}")
            one = flash_work(q[:, :1], k[:, :1], v[:, :1])[0]
            if flash_work(q, k, v)[0] != hq * one:
                fail(f"flash work at {label} is not {hq} x one head's")
            if train:
                function_grads_bitwise(
                    lambda *x: attention(*x, causal=True),
                    lambda *x: attention_ref(*x, causal=True), (q, k, v),
                    torch.randn(q.shape, generator=gen, device=dev).to(dtype),
                    f"FlashAttentionFn {name} at {label}")
            print(f"{f_design} at {label} (q {tuple(q.shape)}, k/v "
                  f"{tuple(k.shape)}): within {FLASH_TOL[name]} of the plain "
                  f"version, max abs err {err:.3g}{grads}")
        for label, b, s_, h, dk, dv in gla_shapes:
            q, k, v, lw = gla_inputs(b, s_, h, dk, dv, dtype, dev, gen,
                                     mamba=True)
            before = launch_counts()
            out, fin = gla(q, k, v, lw, inclusive=True)
            after = launch_counts()
            design_moved(before, after, "gla_chunk", 1, label)
            design_moved(before, after, "gla_chunk_ssd", int(bf16), label)
            design_moved(before, after, "gla_chunk_rwkv6", 0, label)
            r_out, r_fin = gla_chunk_ref(q, k, v, lw, inclusive=True)
            err = max(max_err(out, r_out, out_tol, label),
                      max_err(fin, r_fin, GLA_TOL, label + " final state"))
            one = gla_work(q[:, :, :1], k[:, :, :1], v[:, :, :1],
                           lw[:, :, :1], inclusive=True)[0]
            if gla_work(q, k, v, lw, inclusive=True)[0] != h * one:
                fail(f"gla work at {label} is not {h} x one head's")
            if train:
                def shared(x):
                    # the model's zero-stride views of B, C and the decay
                    return (x[0].expand(b, s_, h, dk),
                            x[1].expand(b, s_, h, dk), x[2],
                            x[3].expand(b, s_, h, dk))
                plain = ((lambda *x: gla_ssd_ref(*shared(x))[0]) if bf16
                         else (lambda *x: gla_chunk_ref(
                             *shared(x), inclusive=True)[0]))
                function_grads_bitwise(
                    lambda *x: gla_fn(*shared(x), inclusive=True)[0], plain,
                    (q[:, :, :1], k[:, :, :1], v, lw[..., :1]),
                    torch.randn(v.shape, generator=gen, device=dev).to(dtype),
                    f"GlaChunkFn {name} at {label}")
            print(f"{g_design} at {label} (q/k/v {tuple(v.shape)}): out "
                  f"within {out_tol}, final state within {GLA_TOL} of the "
                  f"plain version, max abs err {err:.3g}{grads}")


def tp_row_sites(model) -> list:
    """The row-parallel products of one prefill on a rank of two:
    (site, inner dim on the rank, calls per prefill). Their output is
    d_model wide."""
    cfg, m = model.cfg, TP_RANKS
    wo, n = cfg.n_heads * cfg.resolved_head_dim // m, cfg.n_layers
    if cfg.family == "hybrid":
        from repro_torch.models.blocks import mamba_dims
        apps = model.n_shared_apps()
        return [("out_proj", mamba_dims(cfg)[0] // m, n), ("wo", wo, apps),
                ("w_down", cfg.d_ff // m, apps)]
    if cfg.moe is not None:
        return [("wo", wo, n), ("shared w_down", cfg.moe.n_shared_experts
                                * cfg.moe.d_ff_expert // m, n)]
    return [("wo", wo, n), ("w_down", cfg.d_ff // m, n)]


def check_row_products(model, plan, dev, gen, card: str) -> str:
    """A rank's row-parallel partial products at one prefill's shapes
    ([4 x 2048, K / 2] @ [K / 2, d_model], ``tp_row_sites``; their count
    held against the dry run's ``plan``): the bf16 GEMM the ranks run
    against the product of f32 copies (the design before it: an f32 GEMM
    off the tensor cores, TF32 off), device ms per call (CUDA graph) and
    their max abs difference over 2^-8 x max(|product|, 1) (the bf16
    partial's one rounding); summed over one prefill's calls."""
    import torch
    cfg, rows = model.cfg, LM_BATCH * LM_PROMPT
    sites = tp_row_sites(model)
    act = 4 * rows * cfg.d_model
    n_plan = sum(c["op"] == "all_reduce" and c["result_bytes"] == act
                 for c in plan)
    if n_plan != 1 + sum(c for _, _, c in sites):      # + the embedding's
        fail(f"{cfg.arch}: {sites} are not the dry run's {n_plan - 1} "
             f"row-parallel all-reduces")
    new_ms = old_ms = 0.0
    notes = []
    for site, k, calls in sites:
        x = lm_rand((rows, k), dev, torch.bfloat16, gen)
        w = lm_rand((k, cfg.d_model), dev, torch.bfloat16, gen) * k ** -0.5
        got, want = x @ w, x.float() @ w.float()
        rel = float((got.float() - want).abs().max()) / (
            2 ** -8 * max(float(want.abs().max()), 1.0))
        if not rel <= 1.0:
            fail(f"the bf16 partial product at {site} [{rows}, {k}] @ "
                 f"[{k}, {cfg.d_model}]: {rel:.4f} of 2^-8 x max")
        t_new = graph_ms(lambda: x @ w, reps=3, rounds=3)
        t_old = graph_ms(lambda: x.float() @ w.float(), reps=3, rounds=3)
        new_ms, old_ms = new_ms + calls * t_new, old_ms + calls * t_old
        notes.append(f"{site} K/2 = {k} x {calls}: {t_new:.4f} vs "
                     f"{t_old:.4f} ms ({rel:.4f} of the bound)")
        del x, w, got, want
    return (f"row-parallel products per prefill on a rank [{card}]: bf16 "
            f"GEMM {new_ms:.3f} ms, f32 copies' GEMM {old_ms:.3f} ms "
            f"({'; '.join(notes)})")


def tp_errors(got: dict, want: dict, bound: float) -> list:
    """Per step (the prefill's last position, then each decode step) the
    max |got - want| over ``bound`` x max(|want|, 1)."""
    return [float(abs(a - b).max()) / (bound * max(float(abs(b).max()), 1.0))
            for a, b in zip(got["logits"], want["logits"])]


def check_tp(dev, card: str, archs: tuple = TP_ARCHS,
             row_products: bool = True, layout=None, kept=None) -> dict:
    """Phase 12 (and phase 14, ``archs`` rwkv6-7b and whisper-small): for
    internlm2-1.8b, zamba2-1.2b and qwen2-moe-a2.7b at
    full width and depth, the unsharded card runs (then freed), then two
    gloo ranks on the one card (tensor- and expert-parallel, vocab-parallel
    logits) fed the same tokens. Held: (a) in bf16, every step's logits
    within 0.02 x max(|logits|, 1) of the unsharded run's or, where the
    model's own rounding witness (``rounding_witness``: the two ranks'
    row-parallel sums at one rank, summed in another order than the
    unsplit GEMM's) misses that bound too, the mean over the steps within
    1.25x the witness's; the greedy tokens' agreement and the ranks'
    distance from the witness reported; (b) in f32 (qwen2-moe at its
    first 8 layers, rwkv6 at its first 8), every step's logits within
    1e-3 x max(|logits|, 1);
    (c) rank 0's launches (the bf16 designs; in decode only whisper's
    cross-attention), at half
    the heads (the calls' shapes, as many calls as launches) and as
    torch.profiler counts them, and its prefill step's collectives
    exactly the dry run's plan; (d) each rank's peak memory over the
    bf16 prefill within 15% of the dry run's ``--cards 2 --model 2``
    reckoning. Also, with ``row_products`` (phase 12), the row-parallel
    products against the design before them (``check_row_products``),
    and rank 0's device time by kind
    (``device_split``). Phase 16 runs internlm2-1.8b and whisper-small so
    under ``layout`` ``second_matmul="col"``, against phases 12's and 14's
    unsharded runs (``kept``, a ``Kept``): its bf16 logits within the
    bound (no
    row-parallel sum is left to witness: each output column is one whole
    product), beside the row layout's reading; also every decode step's
    collectives exactly the dry run's plan, and each rank's bytes of the
    leaves split by output column the reference's spec's. A rank's
    failure fails the run. Returns rank 0's bf16 launches per model (its
    path in the kernels record)."""
    import torch
    from repro_torch.configs import ShapeSuite
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.param import tree_paths
    from repro_torch.models.sharding import ShardingCtx, default_rules
    gen = torch.Generator(device=dev).manual_seed(12)
    name = layout_name(layout)
    kept = kept or Kept()
    refs, peaks, rows = {}, {}, {}
    for arch in archs:
        t0 = time.perf_counter()
        cached = arch in kept.serve
        if not cached:
            kept.serve[arch] = tp_unsharded(arch, dev)
        refs[arch] = kept.serve[arch]
        n = tp_prompt(tp_model(arch))
        print(f"{arch} unsharded references on the card (bf16, its rounding"
              f" witness, f32: prefill {LM_BATCH} x {n}, {TP_DECODE} "
              f"decode steps each) "
              + ("kept from the row layout's phase" if cached else
                 f"in {time.perf_counter() - t0:.2f} s"))
        suite = ShapeSuite("tp_prefill", n, LM_BATCH, "prefill")
        fn, args, meta, comm = dryrun.build_cell(
            arch, suite.name, cards=TP_RANKS, model=TP_RANKS, suite=suite,
            overrides={**(layout or {}),
                       "n_layers": tp_model(arch).cfg.n_layers})
        peaks[arch] = dryrun.analyze_cell(fn, args, meta, comm)
        peaks[arch]["plan"] = [(c["op"], c["dtype"], c["result_bytes"],
                                c["group"]) for c in comm.plan]
        del fn, args
        if layout:                    # a decode step's plan, and the spec
            model = tp_model(arch)
            ctx0 = ShardingCtx(make_mesh((1, TP_RANKS), ("data", "model"),
                                         rank=0), default_rules(**layout))
            step = ShapeSuite("tp_decode", n + TP_DECODE, LM_BATCH, "decode")
            peaks[arch]["decode_plan"] = [
                (c["op"], c["dtype"], c["result_bytes"], c["group"])
                for c in dryrun.model_axis_plan(model, step, LM_BATCH, ctx0)]
            peaks[arch]["spec_bytes"] = {
                path: d.dtype.itemsize * math.prod(
                    -(-k // ctx0._axis_size(ax))
                    for ax, k in zip(ctx0.spec_for_shape(d.axes, d.shape),
                                     d.shape))
                for path, d in tree_paths(model.defs)
                if "embed_out" in d.axes}
        rows[arch] = (check_row_products(tp_model(arch), comm.plan, dev,
                                         gen, card) if row_products else
                      "row-parallel products not timed (phase 12 times "
                      "them)")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    items, seconds = spawn_ranks(tp_rank, TP_RANKS, (archs, refs,
                                                     layout or {}),
                                 TP_RANKS * len(archs), TP_TIMEOUT_S,
                                 f"serving {', '.join(archs)} ({name})")
    got = {(r["arch"], r["rank"]): r for r in items}
    print(f"serving {', '.join(archs)}: {TP_RANKS} gloo ranks on the one "
          f"card ran "
          f"{len(archs)} models in {seconds:.1f} s "
          f"({POOL_NOTE})")
    counts = {}
    for arch in archs:
        ref, r0 = refs[arch], got[(arch, 0)]
        model = tp_model(arch)
        # (a) bf16, against the bound or the model's rounding witness
        errs = tp_errors(r0["bf16"], ref["bf16"], 0.02)
        wit = tp_errors(ref["witness"], ref["bf16"], 0.02)
        mean, wmean = sum(errs) / len(errs), sum(wit) / len(wit)
        if layout:
            row = kept.row.get(arch)
            if not max(errs) < 1.0:
                fail(f"{arch} two ranks under {name} (bf16): logits differ "
                     f"from the unsharded run's by {max(errs):.4f} of 0.02 "
                     f"x max(|logits|, 1) (the row layout's "
                     f"{row and max(row)})")
            held = (f"within the bound (mean {mean:.4f}; the row layout's "
                    + (f"{[round(e, 4) for e in row]}, mean "
                       f"{sum(row) / len(row):.4f}" if row else "not run")
                    + ")")
        elif max(errs) < 1.0:
            held = "within the bound"
        elif max(wit) >= 1.0 and mean <= TP_WITNESS_SLACK * wmean:
            held = (f"MISSED in bf16, as the model's own rounding witness "
                    f"misses it (at most {max(wit):.4f} of the bound): mean "
                    f"over the steps {mean:.4f}, {mean / wmean:.4f}x the "
                    f"witness's {wmean:.4f} (held within "
                    f"{TP_WITNESS_SLACK}x)")
        else:
            fail(f"{arch} two ranks (bf16): logits differ from the unsharded"
                 f" run's by {max(errs):.4f} of 0.02 x max(|logits|, 1) "
                 f"(mean {mean:.4f}); the rounding witness by {max(wit):.4f}"
                 f" (mean {wmean:.4f})")
        agree = float((r0["bf16"]["tokens"] == ref["bf16"]["tokens"]).mean())
        near = max(tp_errors(r0["bf16"], ref["witness"], 0.02))
        # (b) f32
        f32 = tp_errors(r0["f32"], ref["f32"], 1e-3)
        pre, dec = f32[0], f32[1:]
        if not max(f32) <= 1.0:
            fail(f"{arch} two ranks (f32): prefill {pre:.4f}, decode steps "
                 f"at most {max(dec):.4f} of 1e-3 x max(|logits|, 1)")
        f32_agree = float((r0["f32"]["tokens"] == ref["f32"]["tokens"]
                           ).mean())
        f32_note = (f"; in f32{f32_cut(model)} the prefill's logits "
                    f"{pre:.4f} of "
                    f"1e-3 x max(|logits|, 1), the decode steps' at most "
                    f"{max(dec):.4f} of it (greedy tokens agree "
                    f"{f32_agree:.4f})")
        # (c) launches at the local shapes
        want = lm_expected(model, decode_steps=TP_DECODE)
        if r0["launches"] != want:
            fail(f"{arch} rank 0 launched {r0['launches']} (prefill and "
                 f"{TP_DECODE} decode steps); expected {want}")
        if set(r0["shapes"]) != tp_local_shapes(model) or \
                r0["calls"] != (r0["launches"]["flash_attention"]
                                + r0["launches"]["gla_chunk"]):
            fail(f"{arch} rank 0's {r0['calls']} kernel calls had shapes "
                 f"{r0['shapes']}, expected {tp_local_shapes(model)} and "
                 f"one call per launch ({r0['launches']})")
        if layout:
            traced = "not profiled (phases 12 and 14 profile these paths)"
        elif r0["traced"]:
            for key, n in r0["profiled"].items():
                if n != want[key]:
                    fail(f"{arch}: the profiler saw {n} {key} launches on "
                         f"rank 0, the counters {want[key]}")
            d, run = r0["device"], r0["bf16"]
            wall = (run["prefill_s"] + run["decode_s"]) * 1e3
            traced = (f"the profiler counted {r0['profiled']}; rank 0's "
                      f"card busy {d['busy_us'] / 1e3:.3f} ms of the bf16 "
                      f"run's {wall:.1f} ms, cuBLAS "
                      f"GEMMs {d['gemm_us'] / 1e3:.3f} ms (f32 ones "
                      f"{d['f32_gemm_us'] / 1e3:.3f}), copies and casts "
                      f"{d['copy_us'] / 1e3:.3f} ms; largest "
                      + ", ".join(f"{n} {c} x {t / c:.1f} us"
                                  for n, c, t in d["top"]))
        else:
            traced = "the profiler recorded no CUDA events (not measured)"
        plan = peaks[arch]["plan"]
        if r0["bf16"]["prefill_issued"] != plan:
            fail(f"{arch} rank 0's prefill issued "
                 f"{r0['bf16']['prefill_issued']}, the dry run's plan is "
                 f"{plan}")
        extra = ""
        if layout:
            step_plan = peaks[arch]["decode_plan"]
            for k, issued in enumerate(r0["bf16"]["decode_issued"]):
                if issued != step_plan:
                    fail(f"{arch} rank 0's decode step {k} under {name} "
                         f"issued {issued}, the dry run's plan is "
                         f"{step_plan}")
            want_bytes = peaks[arch]["spec_bytes"]
            for rank in range(TP_RANKS):
                if got[(arch, rank)]["pair_bytes"] != want_bytes:
                    fail(f"{arch} rank {rank} holds "
                         f"{got[(arch, rank)]['pair_bytes']} B of the leaves "
                         f"split by column; the reference's spec "
                         f"{want_bytes}")
            extra = (f"; each of its {TP_DECODE} decode steps' "
                     f"{len(step_plan)} collectives exactly the plan; each "
                     f"rank's {', '.join(want_bytes)} at the reference "
                     f"spec's bytes ({sum(want_bytes.values())} B)")
        else:
            kept.row[arch] = errs
        # (d) memory against the dry run's reckoning
        est = peaks[arch]["memory"]["peak_estimate_bytes"]
        for rank in range(TP_RANKS):
            peak = got[(arch, rank)]["bf16"]["peak"]
            if not abs(est - peak) <= PEAK_TOL * peak:
                fail(f"{arch} rank {rank}: peak {peak} B over the prefill, "
                     f"the dry run's --cards 2 --model 2 reckoning {est} B: "
                     f"not within {PEAK_TOL:.0%}")
        runs = [got[(arch, k)]["bf16"] for k in range(TP_RANKS)]
        times = "; ".join(
            f"rank {k}: prefill {r['prefill_s'] * 1e3:.1f} ms, decode "
            f"{r['decode_s'] / TP_DECODE * 1e3:.2f} ms/step, peak "
            f"{r['peak'] / 2**30:.3f} GiB ({r['peak'] / est - 1:+.4f})"
            for k, r in enumerate(runs))
        print(f"{arch} on two ranks (tensor/expert-parallel, {name}, gloo) "
              f"vs the unsharded card run [{card}]: bf16 logits per step "
              f"{[round(e, 4) for e in errs]} of 0.02 x max(|logits|, 1) "
              f"(the rounding witness {[round(e, 4) for e in wit]}; the "
              f"ranks from the witness at most {near:.4f}): {held}; "
              f"greedy tokens agree {agree:.4f} ({LM_BATCH} x "
              f"{TP_DECODE + 1}){f32_note}; rank 0 launched "
              f"{r0['launches']} (prefill and {TP_DECODE} decode steps) at "
              f"shapes {r0['shapes']}; its prefill's {len(plan)} "
              f"collectives exactly the dry run's plan{extra}; {traced}; "
              f"the dry "
              f"run reckons "
              f"{est / 2**30:.3f} GiB per rank ({times}); {rows[arch]}. "
              f"Two ranks share "
              f"one card's SMs and gloo stages every all-reduce through the "
              f"host: these times are no tensor-parallel speedup")
        counts[TP_PATHS[arch] if not layout else
               f"{name}_{arch.split('-')[0]}"] = r0["launches"]
    return counts


# ----------------------------------------------------------------- phase 13
# (arch, layers; 0: full depth). internlm2 at 4 of 24 layers and zamba2
# at 12 of 38 (two shared-attention applications) make room for phase
# 17 within the script's time: two gloo ranks on one H100 took 22.7 /
# 11.9 s for the full-depth steps and 17.8 s for internlm2 at 8 layers,
# and phase 17 trains internlm2 at full depth
TPT_ARCHS = (("internlm2-1.8b", 4), ("zamba2-1.2b", 12))
# the families' training local shapes (``tp_train_shapes``)
TPT_SHAPE_ARCHS = ("internlm2-1.8b", "qwen2-moe-a2.7b", "qwen2-vl-7b",
                   "zamba2-1.2b")
TPT_BATCH, TPT_MB = 2, 2           # one step: 2 x 2048 in 2 microbatches
TPT_REL = 1e-2                     # bf16 loss / grad norm, ranks vs one card
# f32 gradients at full width, cut in depth: zamba2 at 6 layers so that
# its shared attention block runs once (at 4 it would not)
TPT_F32 = (("internlm2-1.8b", 4), ("zamba2-1.2b", 6),
           ("qwen2-moe-a2.7b", 2))
TPT_F32_TOL = 1e-4
TPT_TIMEOUT_S = 600


def tpt_model(arch: str, layers: int = 0):
    """The full-width model with 2 microbatches (and ``layers`` layers)."""
    import dataclasses
    from repro_torch.models import Model, build_model
    cfg = dataclasses.replace(build_model(arch).cfg, microbatches=TPT_MB)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return Model(cfg)


def tpt_seq(model) -> int:
    """A training sequence's tokens: whisper's 416 (its decoder prompt),
    the others' 2048."""
    return WHISPER_PROMPT if model.cfg.family == "encdec" else TRAIN_SEQ


def tpt_batch(model, dev, rows: int = TPT_BATCH) -> dict:
    """The step's seeded tokens [rows, 2048] (whisper's [rows, 416], and
    its frames [rows, 1500, 768] drawn after them) and their next
    tokens."""
    import torch
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(13)
    toks = torch.randint(0, cfg.vocab, (TPT_BATCH, tpt_seq(model)),
                         generator=gen, device=dev)
    out = {"tokens": toks[:rows], "targets": torch.roll(toks, -1, 1)[:rows]}
    if cfg.family == "encdec":
        out["frames"] = torch.randn((TPT_BATCH, cfg.enc_seq, cfg.d_model),
                                    generator=gen, device=dev).to(
                                        torch.bfloat16)[:rows]
    return out


def tpt_unsharded(arch: str, dev, layers: int = 0) -> dict:
    """The unsharded card step phase 13 holds the ranks against (seeded
    bf16 weights, ``make_train_step``, zero moments), then the same under
    ``rounding_witness`` (the ranks' row-parallel sums at one rank), each
    from freshly drawn weights: loss, grad norm and step seconds. Frees
    what it drew."""
    import torch
    from repro_torch.models.param import tree_leaves
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train.train_step import make_train_step
    model = tpt_model(arch, layers)
    out = {}
    for name, patch in (("bf16", contextlib.nullcontext),
                        ("witness", rounding_witness)):
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        step = make_train_step(model, AdamWConfig())
        opt = init_state(params)
        batch = tpt_batch(model, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with patch() as sites:
            _, opt, met = step(params, opt, batch)
            got = {k: float(met[k]) for k in ("loss", "grad_norm")}
        got["step_s"] = time.perf_counter() - t0
        # the leaves whose gradient is zero (a step from zero moments
        # leaves mu = (1 - b1) x the clipped gradient): rwkv6's w_lora_a
        # at init, behind the zero-init w_lora_b
        got["zero"] = [i for i, m in enumerate(tree_leaves(opt.mu))
                       if not bool((m != 0).any())]
        if name == "witness" and not sites:
            fail(f"{arch}: the rounding witness reached no row-parallel "
                 f"site in training")
        out[name] = got
        del params, opt, batch, met
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out


class TptComm:
    """Phase 13's, 14's and 15's collectives over gloo, each recorded as
    (op, dtype, result bytes, group size) as it is issued; the
    reduce-scatter and the all-gather into one tensor staged through host
    tensors explicitly (gloo's all-reduce, list all-gather and
    all-to-all take CUDA tensors themselves)."""

    def __init__(self):
        self.issued = []

    def _rec(self, op, t, group):
        import torch.distributed as dist
        self.issued.append((op, str(t.dtype), t.numel() * t.element_size(),
                            dist.get_world_size(group)))

    def all_reduce(self, t, group=None, op=None):
        import torch.distributed as dist
        self._rec("all_reduce", t, group)
        dist.all_reduce(t, group=group, **({} if op is None else {"op": op}))

    def reduce_scatter_tensor(self, out, inp, group=None):
        import torch.distributed as dist
        self._rec("reduce_scatter_tensor", out, group)
        host = out.cpu()
        dist.reduce_scatter_tensor(host, inp.cpu(), group=group)
        out.copy_(host)

    def all_gather_into_tensor(self, out, inp, group=None):
        import torch
        import torch.distributed as dist
        self._rec("all_gather_into_tensor", out, group)
        host = torch.empty(out.shape, dtype=out.dtype)
        dist.all_gather_into_tensor(host, inp.cpu(), group=group)
        out.copy_(host)

    def all_gather(self, out, t, group=None):
        import torch.distributed as dist
        self.issued.append(("all_gather", str(t.dtype), sum(
            o.numel() * o.element_size() for o in out),
            dist.get_world_size(group)))
        dist.all_gather(out, t, group=group)

    def all_to_all_single(self, out, inp, group=None):
        import torch.distributed as dist
        self._rec("all_to_all_single", out, group)
        dist.all_to_all_single(out, inp, group=group)


def tpt_rank(rank: int, port: int, archs: tuple, f32_cuts: tuple,
             q) -> None:
    """One of the two ranks of phase 13, 14 or 16 (a spawned process on
    the one card, a (1, 2) mesh over gloo). An entry of ``archs`` or
    ``f32_cuts`` is (arch, layers) or (arch, layers, the layout overrides
    of the reference's rules it runs under: phase 16's). (a) For each
    entry of ``archs`` (phase 13: internlm2-1.8b and zamba2-1.2b at full
    depth)
    at full width in bf16 with remat: its slices of the seeded
    weights (the ranks draw in turn), zero moments, one ``manual_dp``
    step of the 2 x 2048 batch in 2 microbatches; its metrics, step
    seconds, peak memory over the step (from before its weights), the
    kernels' launches, the collectives it issued, the gradient leaves
    that were not finite or all zero (read from the first moment the step
    leaves) and a digest of the first moment of each leaf every rank
    holds whole (equal gradients give equal moments). (b) For each f32
    cut of
    ``f32_cuts``: in turn, the unsharded gradient of one microbatch
    (1 x 2048) on this rank from the full weights, kept as its slices;
    then its own gradient under the model axis (``sync_grads``), each
    leaf's max |difference| over max |unsharded slice|."""
    sys.path.insert(0, str(ROOT / "src"))
    import hashlib
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.param import (tree_leaves, tree_map,
                                          tree_unflatten)
    from repro_torch.models.sharding import ShardingCtx, default_rules
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import manual_dp
    from repro_torch.train.train_step import (loss_and_grads, make_loss_fn,
                                              sync_grads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=TP_RANKS, rank=rank)
    try:
        comm = TptComm()
        mesh = make_mesh((1, TP_RANKS), ("data", "model"))

        def ctx_of(lay):
            return ShardingCtx(mesh, default_rules(**(lay[0] if lay else {})),
                               comm=comm)
        for arch, layers, *lay in archs:
            ctx, tag = ctx_of(lay), layout_name(lay and lay[0])
            model = tpt_model(arch, layers)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(dev)
            for r in range(TP_RANKS):       # one rank draws at a time
                if r == rank:
                    params = model.init(
                        torch.Generator(device=dev).manual_seed(0), ctx)
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                dist.barrier()
            opt = manual_dp.init_shard_state(params, ctx=ctx)
            batch = tpt_batch(model, dev)
            step = manual_dp.make_manual_dp_train_step(
                model, AdamWConfig(), comm=comm, ctx=ctx)
            comm.issued.clear()
            reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            got = {k: float(met[k]) for k in ("loss", "grad_norm")}
            torch.cuda.synchronize()
            out = {"rank": rank, "arch": arch, "kind": "bf16", "tag": tag,
                   **got,
                   "step_s": time.perf_counter() - t0,
                   "peak": torch.cuda.max_memory_allocated(dev) - base,
                   "launches": lm_launches(launch_counts()),
                   "issued": list(comm.issued)}
            # a step from zero moments leaves mu = (1 - b1) x the clipped
            # gradient: a leaf's gradient is finite and nonzero where its
            # part of mu is (a data axis of 1: the shard is the bucket)
            mus = manual_dp.FlatLayout(params, 1, 0).views(opt.mu)
            out["nonfinite"] = [i for i, m in enumerate(mus)
                                if not bool(torch.isfinite(m).all())]
            out["zero"] = [i for i, m in enumerate(mus)
                           if not bool((m != 0).any())]
            out["leaves"] = len(mus)
            defs = tree_leaves(model.defs)
            out["whole_mu"] = {
                i: hashlib.sha256(m.cpu().numpy().tobytes()).hexdigest()
                for i, (m, d) in enumerate(zip(mus, defs))
                if ctx._holding(d.axes, d.shape, d.parts)[0] is None}
            q.put(out)
            del params, opt, batch, met, step, mus
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            dist.barrier()
        for arch, layers, *lay in f32_cuts:
            ctx, tag = ctx_of(lay), layout_name(lay and lay[0])
            model = tpt_model(arch, layers)
            defs = tree_leaves(model.defs)
            batch = tpt_batch(model, dev, rows=1)
            reset_launch_counts()
            for r in range(TP_RANKS):       # the unsharded runs in turn
                if r == rank:
                    full = tree_map(lambda t: t.float(), model.init(
                        torch.Generator(device=dev).manual_seed(0)))
                    batch = {k: t.float() if t.is_floating_point() else t
                             for k, t in batch.items()}
                    g, (_, loss1, aux1) = loss_and_grads(
                        make_loss_fn(model), full, batch)
                    want = [ctx.shard(x, d.axes, d.parts).clone()
                            for x, d in zip(g, defs)]
                    local = tree_unflatten(model.defs, [
                        ctx.shard(x, d.axes, d.parts).clone()
                        for x, d in zip(tree_leaves(full), defs)])
                    del full, g
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                dist.barrier()
            unsharded = lm_launches(launch_counts())
            reset_launch_counts()
            grads, (_, loss, aux) = loss_and_grads(
                make_loss_fn(model, ctx), local, batch)
            grads = sync_grads(grads, model, ctx)
            errs = [float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(grads, want)]
            worst = max(range(len(errs)), key=errs.__getitem__)
            q.put({"rank": rank, "arch": arch, "kind": "f32", "tag": tag,
                   "layers": layers, "loss": float(loss),
                   "unsharded_loss": float(loss1), "aux": float(aux),
                   "unsharded_aux": float(aux1), "worst": errs[worst],
                   "worst_leaf": f"{defs[worst].axes} #{worst}",
                   "launches": lm_launches(launch_counts()),
                   "unsharded_launches": unsharded})
            del grads, want, local, batch
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            dist.barrier()
    finally:
        dist.destroy_process_group()


def tpt_f32_expected(model) -> dict:
    """Launches of one f32 forward and backward of one microbatch on the
    CUDA-core flash and serial gla designs (the cut configs keep the
    config's remat: each layer's kernels run again in the backward)."""
    n_attn, n_gla = train_layers(model)
    runs = 2 if model.cfg.remat else 1
    return {"flash_attention": runs * n_attn, "flash_attention_tc": 0,
            "gla_chunk": runs * n_gla, "gla_chunk_ssd": 0,
            "gla_chunk_rwkv6": 0}


def check_tp_train(dev, card: str, archs: tuple = TPT_ARCHS,
                   f32_cuts: tuple = TPT_F32, kept=None) -> dict:
    """Phase 13: training under the model axis, two gloo ranks on the one
    card. For internlm2-1.8b and
    zamba2-1.2b at full width and depth in bf16 with remat, the unsharded
    card step and its rounding witness (then freed) and the dry run's
    ``--cards 2 --model 2`` cell of the same step, then the two ranks
    (``tpt_rank``). Held: (a) each rank's loss and grad norm within 1e-2
    (relative) of the unsharded step's or, where the rounding witness
    misses that too, within 1.25x the witness's difference; every
    gradient leaf finite, and all zero on the ranks exactly where it is in
    the unsharded step (none for these two; rwkv6's ``w_lora_a`` at init,
    behind its zero-init ``w_lora_b``); (b) in f32 (``TPT_F32``'s cuts),
    every rank's gradient leaves within 1e-4 x max |g| of the unsharded
    card gradient's slice; (c) each rank's peak within 15% of the dry
    run's reckoning; rank 0's launches (2 microbatches x 2 with remat per
    attention and Mamba2 layer) and its collectives, exactly the dry
    run's plan. Phase 14 holds rwkv6-7b (at ``TPT14_RWKV6_LAYERS``
    layers: the depth the dry run's ``--cards 2 --model 2`` reckoning
    lets two ranks on one card hold) and whisper-small (full depth, 2 x
    416 tokens and their frames) so, with its f32 cuts
    (``TPT14_F32``); phase 16 holds internlm2-1.8b and zamba2-1.2b under
    ``seq_parallel`` and internlm2-1.8b under ``second_matmul="col"``
    (``TPT16``, ``TPT16_F32``: entries with their layout) against phase
    13's unsharded steps (``kept``, a ``Kept``), each rank's leaves held
    whole
    with bitwise equal gradients on both ranks, and reports the loss and
    grad norm beside phase 13's row layout's, bit for bit. Returns rank
    0's launches per path."""
    import torch
    from repro_torch.configs import ShapeSuite
    from repro_torch.launch import dryrun
    from repro_torch.models.param import tree_paths
    kept = kept or Kept()
    refs, cells = {}, {}
    for arch, layers, *lay in archs:
        t0 = time.perf_counter()
        layout, tag = (lay[0] if lay else {}), layout_name(lay and lay[0])
        cached = (arch, layers) in kept.train
        if not cached:
            kept.train[(arch, layers)] = tpt_unsharded(arch, dev, layers)
        refs[(arch, layers)] = kept.train[(arch, layers)]
        seq = tpt_seq(tpt_model(arch))
        suite = ShapeSuite("tp_train", seq, TPT_BATCH, "train")
        fn, args, meta, comm = dryrun.build_cell(
            arch, suite.name, cards=TP_RANKS, model=TP_RANKS, suite=suite,
            overrides={"microbatches": TPT_MB, **layout,
                       **({"n_layers": layers} if layers else {})})
        cells[(arch, layers, tag)] = (
            dryrun.analyze_cell(fn, args, meta, comm),
            [(c["op"], c["dtype"], c["result_bytes"], c["group"])
             for c in comm.plan])
        del fn, args
        print(f"{arch} unsharded train step on the card (bf16, remat, "
              f"{TPT_BATCH} x {seq} in {TPT_MB} microbatches"
              + (f", {layers} layers" if layers else "") + ") and its "
              f"rounding witness"
              + (" kept from phase 13" if cached else "")
              + f", and the dry run's --cards 2 --model 2 cell ({tag}), in "
              f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    names = ", ".join(f"{a[0]} ({layout_name(a[2:] and a[2])})"
                      for a in archs)
    items, seconds = spawn_ranks(
        tpt_rank, TP_RANKS, (archs, f32_cuts),
        TP_RANKS * (len(archs) + len(f32_cuts)), TPT_TIMEOUT_S,
        f"training {names}")
    got = {(r["arch"], r["kind"], r["rank"], r["tag"]): r for r in items}
    print(f"training {names}: {TP_RANKS} gloo "
          f"ranks on the one card trained "
          f"{len(archs)} models and {len(f32_cuts)} f32 cuts in "
          f"{seconds:.1f} s ({POOL_NOTE})")
    counts = {}
    for arch, layers, *lay in archs:
        tag = layout_name(lay and lay[0])
        ref, (cell, plan) = refs[(arch, layers)], cells[(arch, layers, tag)]
        model = tpt_model(arch, layers)
        ranks = [got[(arch, "bf16", k, tag)] for k in range(TP_RANKS)]
        notes = []
        for key in ("loss", "grad_norm"):
            want = ref["bf16"][key]
            wit = abs(ref["witness"][key] - want) / abs(want)
            for k, r in enumerate(ranks):
                rel = abs(r[key] - want) / abs(want)
                if rel <= TPT_REL:
                    held = "within 1e-2"
                elif wit > TPT_REL and rel <= TP_WITNESS_SLACK * wit:
                    held = (f"MISSED 1e-2 in bf16, as the rounding witness "
                            f"misses it ({wit:.3g}): within "
                            f"{TP_WITNESS_SLACK}x the witness")
                else:
                    fail(f"{arch} rank {k} (bf16): {key} {r[key]} vs the "
                         f"unsharded step's {want} (relative {rel:.3g}); "
                         f"the rounding witness {ref['witness'][key]} "
                         f"({wit:.3g})")
                notes.append(f"rank {k} {key} {r[key]:.6f} (relative "
                             f"{rel:.3g}, {held})")
            notes.append(f"unsharded {key} {want:.6f}, witness "
                         f"{ref['witness'][key]:.6f} (relative {wit:.3g})")
        row = kept.row.get(("train", arch, layers))
        if tag == "row":
            kept.row[("train", arch, layers)] = [
                (r["loss"], r["grad_norm"]) for r in ranks]
        elif row:
            notes.append("against phase 13's row layout: " + "; ".join(
                f"rank {k} loss {bitwise(r['loss'], rl)}, grad norm "
                f"{bitwise(r['grad_norm'], rg)}"
                for k, (r, (rl, rg)) in enumerate(zip(ranks, row))))
        if ranks[0]["whole_mu"] != ranks[1]["whole_mu"]:
            bad = [i for i in ranks[0]["whole_mu"]
                   if ranks[0]["whole_mu"][i] != ranks[1]["whole_mu"].get(i)]
            fail(f"{arch} ({tag}): the leaves {bad} every rank holds whole "
                 f"got different gradients on the two ranks")
        notes.append(f"the {len(ranks[0]['whole_mu'])} leaves both ranks "
                     f"hold whole got bitwise equal gradients")
        # a leaf may be all zero only where the unsharded step's is too
        zero = ref["bf16"]["zero"]
        for k, r in enumerate(ranks):
            if r["nonfinite"] or r["zero"] != zero:
                fail(f"{arch} rank {k}: gradient leaves {r['nonfinite']} of "
                     f"{r['leaves']} not finite, {r['zero']} all zero (the "
                     f"unsharded step's all zero: {zero})")
        if zero:
            paths = [p for p, _ in tree_paths(model.defs)]
            notes.append(f"gradient leaves all zero on the ranks as in the "
                         f"unsharded step: {[paths[i] for i in zero]} (its "
                         f"zero-init partner leaves it no gradient at init)")
        r0 = ranks[0]
        want = train_expected(model)
        if r0["launches"] != want:
            fail(f"{arch} rank 0 launched {r0['launches']} in its train "
                 f"step; expected {want}")
        if r0["issued"] != plan:
            fail(f"{arch} rank 0 issued {len(r0['issued'])} collectives, "
                 f"not the dry run's plan of {len(plan)}")
        est = cell["memory"]["peak_estimate_bytes"]
        for k, r in enumerate(ranks):
            if not abs(est - r["peak"]) <= PEAK_TOL * r["peak"]:
                fail(f"{arch} rank {k}: peak {r['peak']} B over the train "
                     f"step, the dry run's --cards 2 --model 2 reckoning "
                     f"{est} B: not within {PEAK_TOL:.0%}")
        n_ar = sum(c[0] == "all_reduce" for c in plan)
        mib = sum(c[2] for c in plan) / 2**20
        times = "; ".join(
            f"rank {k}: step {r['step_s'] * 1e3:.1f} ms, peak "
            f"{r['peak'] / 2**30:.3f} GiB ({r['peak'] / est - 1:+.4f})"
            for k, r in enumerate(ranks))
        cut = (f" at {layers} of {build_model_layers(arch)} layers"
               if layers else "")
        print(f"{arch}{cut} train step on two ranks (tensor-parallel, "
              f"{tag}, manual_dp over a (1, 2) mesh, gloo) vs the unsharded "
              f"card "
              f"step [{card}]: {'; '.join(notes)}; every "
              f"{'other ' if zero else ''}gradient leaf finite "
              f"and nonzero ({r0['leaves']} per rank); rank 0 launched "
              f"{r0['launches']}; its {len(plan)} collectives ({n_ar} "
              f"all-reduces, {mib:.2f} MiB of results) exactly the dry "
              f"run's plan; the dry run reckons {est / 2**30:.3f} GiB per "
              f"rank ({times}); the unsharded step "
              f"{ref['bf16']['step_s'] * 1e3:.1f} ms. Two ranks share one "
              f"card's SMs and gloo stages every collective through the "
              f"host: no tensor-parallel speedup")
        short = arch.split("-")[0]
        counts[f"tp_train_{short}" if tag == "row" else
               f"{tag}_train_{short}"] = r0["launches"]
    for arch, layers, *lay in f32_cuts:
        tag = layout_name(lay and lay[0])
        model = tpt_model(arch, layers)
        ranks = [got[(arch, "f32", k, tag)] for k in range(TP_RANKS)]
        for k, r in enumerate(ranks):
            if not r["worst"] <= TPT_F32_TOL:
                fail(f"{arch} at {layers} layers in f32, rank {k}: gradient "
                     f"leaf {r['worst_leaf']} {r['worst']:.3g} x max |g| "
                     f"from the unsharded card gradient's slice")
            if abs(r["loss"] - r["unsharded_loss"]) > TPT_F32_TOL * abs(
                    r["unsharded_loss"]):
                fail(f"{arch} at {layers} layers in f32, rank {k}: loss "
                     f"{r['loss']} vs {r['unsharded_loss']}")
        r0 = ranks[0]
        want = tpt_f32_expected(model)
        if r0["launches"] != want:
            fail(f"{arch} f32 rank 0 launched {r0['launches']}; expected "
                 f"{want}")
        print(f"{arch} at {layers} of {build_model_layers(arch)} "
              f"(decoder) layers, full width, f32, on two ranks ({tag}) "
              f"[{card}]: "
              f"every gradient leaf "
              f"within 1e-4 x max |g| of the unsharded card gradient's "
              f"slice (worst {max(r['worst'] for r in ranks):.3g}, "
              f"{r0['worst_leaf']} on rank 0); loss {r0['loss']:.6f} vs "
              f"{r0['unsharded_loss']:.6f}, aux {r0['aux']:.6g} vs "
              f"{r0['unsharded_aux']:.6g}; rank 0 launched {r0['launches']}")
        short = arch.split("-")[0]
        counts[f"tp_train_{short}_f32" if tag == "row" else
               f"{tag}_train_{short}_f32"] = r0["launches"]
    return counts


def bitwise(got: float, want: float) -> str:
    """Whether ``got`` is ``want`` to the bit, else by how much it
    differs."""
    if got == want:
        return "bitwise equal"
    return (f"differs by {got - want:.3g} (relative "
            f"{abs(got - want) / abs(want):.3g})")


# ----------------------------------------------------------------- phase 14
TP14_ARCHS = ("rwkv6-7b", "whisper-small")
# rwkv6's f32 serving check at full width, cut in depth: f32 weights of
# its 32 layers (30 GB) would not leave room for the unsharded run's
# activations beside two ranks' slices
TP_RWKV6_F32_LAYERS = 8
# rwkv6's bf16 train step at 4 of 32 layers (the dry run's --cards 2
# --model 2 reckoning is 25.67 GiB per rank at 8 layers, 36.01 at 12,
# two ranks on the one card), cut to make room for phase 17: two gloo
# ranks on one H100 took 28.2 s for the 8-layer step
TPT14_RWKV6_LAYERS = 4
TPT14 = (("rwkv6-7b", TPT14_RWKV6_LAYERS), ("whisper-small", 0))
TPT14_F32 = (("rwkv6-7b", 2), ("whisper-small", 12))
# the local head counts of M = 2, 4 and 16: rwkv6-7b's 64 heads,
# whisper-small's 12 (at M = 16 ranks 0-11 hold one, 12-15 none)
TP14_RWKV6_HEADS = (32, 16, 4)
TP14_WHISPER_HEADS = (6, 3, 1)


def check_local_kernels_14(dev, gen) -> None:
    """Phase 14's kernels at the shapes the model axis gives rank 0 of
    rwkv6-7b and whisper-small, against their plain versions: the RWKV6
    gla design (bf16; lag-1 read, bonus u, per-channel decay) at a
    prefill of 4 x 2048 at 32, 16 and 4 heads and at a training
    microbatch of 1 x 2048 at 32, out within 2e-2 and the final state
    within 2e-4, and the serial design in f32 (the f32 cuts' dtype) at
    the prefill's and the microbatch's shapes at 32 heads (out and state
    within 2e-4); both flash designs (bf16 tensor-core within 2e-2, f32
    CUDA-core within 2e-5) in whisper's regimes, serving at 6, 3 and 1
    heads (the encoder's full attention [4, h, 1500, 64], the decoder's
    causal [4, h, 416, 64], its cross-attention from 416 queries and
    from 1, a decode step, against the 1500 frames' keys) and training's
    microbatch at 6 heads (full [1, 6, 1500, 64], causal [1, 6, 416, 64],
    cross [1, 6, 416, 64] against [1, 6, 1500, 64]). Each call taken by
    its design; at the training shapes the autograd Functions' input
    gradients also bitwise the plain versions'. Then a rank holding no
    heads: the model's attention (``models.attention.attend_prefill``)
    on 0 heads launches nothing, and the kernel's wrapper still refuses
    0 kv heads."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention.ops import attention, mha
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gla_chunk.ops import gla, gla_fn
    from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref
    from repro_torch.models import build_model
    from repro_torch.models.attention import attend_prefill
    r_cfg, w_cfg = (build_model(a).cfg for a in TP14_ARCHS)
    dk = r_cfg.d_model // r_cfg.ssm.n_ssm_heads
    grads = "; the Function's input gradients bitwise the plain version's"
    cases = [(f"rwkv6 prefill at M = {64 // h}", LM_BATCH, h,
              torch.bfloat16, False) for h in TP14_RWKV6_HEADS]
    cases += [("rwkv6 training microbatch at M = 2", 1, 32, torch.bfloat16,
               True),
              ("rwkv6 prefill at M = 2, f32 (serial design)", LM_BATCH, 32,
               torch.float32, False),
              ("rwkv6 training microbatch at M = 2, f32 (serial design)", 1,
               32, torch.float32, True)]
    for label, b, h, dtype, train in cases:
        bf16 = dtype == torch.bfloat16
        r, k, v, lw, u = rwkv6_gla_inputs(b, LM_PROMPT, h, dk, dev, gen)
        r, k, v = (t.to(dtype) for t in (r, k, v))
        before = launch_counts()
        out, fin = gla(r, k, v, lw, u, inclusive=False)
        after = launch_counts()
        design_moved(before, after, "gla_chunk", 1, label)
        design_moved(before, after, "gla_chunk_rwkv6", int(bf16), label)
        design_moved(before, after, "gla_chunk_ssd", 0, label)
        r_out, r_fin = gla_chunk_ref(r, k, v, lw, u, inclusive=False)
        tol = FLASH_TOL["bfloat16"] if bf16 else GLA_TOL
        err = max(max_err(out, r_out, tol, label),
                  max_err(fin, r_fin, GLA_TOL, label + " final state"))
        if train:
            function_grads_bitwise(
                lambda *x: gla_fn(*x, inclusive=False)[0],
                lambda *x: gla_chunk_ref(*x, inclusive=False)[0],
                (r, k, v, lw, u),
                torch.randn(v.shape, generator=gen, device=dev).to(dtype),
                f"GlaChunkFn at {label}")
        print(f"gla_chunk {'RWKV6' if bf16 else 'serial'} design at {label}"
              f" (r/k/v {tuple(v.shape)}): out within {tol}, final state "
              f"within {GLA_TOL} of the plain version, max abs err "
              f"{err:.3g}{grads if train else ''}")
        del r, k, v, lw, u, out, fin, r_out, r_fin
    hd, e, p = w_cfg.resolved_head_dim, w_cfg.enc_seq, WHISPER_PROMPT
    regimes = (("encoder, full", e, e, False), ("decoder, causal", p, p, True),
               ("cross", p, e, False), ("cross, a decode step", 1, e, False))
    # (batch, heads, regimes, train): serving at M = 2, 4, 16, then the
    # training microbatch at M = 2 (no decode step)
    runs = [(LM_BATCH, h, regimes, False) for h in TP14_WHISPER_HEADS]
    runs.append((1, TP14_WHISPER_HEADS[0], regimes[:3], True))
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        bf16 = dtype == torch.bfloat16
        worst = 0.0
        for b, h, regs, train in runs:
            for regime, sq, skv, causal in regs:
                label = (f"whisper {'training ' if train else ''}{regime} "
                         f"at M = {12 // h} ({h} heads, batch {b}), {name}")
                q = lm_rand((b, sq, h, hd), dev, dtype, gen).transpose(1, 2)
                k, v = (lm_rand((b, skv, h, hd), dev, dtype,
                                gen).transpose(1, 2) for _ in range(2))
                before = launch_counts()
                out = mha(q, k, v, causal=causal)
                after = launch_counts()
                design_moved(before, after, "flash_attention", 1, label)
                design_moved(before, after, "flash_attention_tc", int(bf16),
                             label)
                worst = max(worst, max_err(out, attention_ref(
                    q, k, v, causal=causal), FLASH_TOL[name], label))
                if train:
                    function_grads_bitwise(
                        lambda *x, c=causal: attention(*x, causal=c),
                        lambda *x, c=causal: attention_ref(*x, causal=c),
                        (q, k, v), torch.randn(q.shape, generator=gen,
                                               device=dev).to(dtype),
                        f"FlashAttentionFn at {label}")
        print(f"flash_attention {'tensor-core' if bf16 else 'CUDA-core'} "
              f"design ({name}) at whisper-small's local heads "
              f"{TP14_WHISPER_HEADS} (M = 2, 4, 16), full [{LM_BATCH}, h, "
              f"{e}, {hd}], causal [{LM_BATCH}, h, {p}, {hd}], cross from "
              f"{p} and 1 queries against {e} keys, and training's "
              f"microbatch at {TP14_WHISPER_HEADS[0]} heads (full [1, "
              f"{TP14_WHISPER_HEADS[0]}, {e}, {hd}], causal, cross from "
              f"{p} queries): within {FLASH_TOL[name]} of the plain "
              f"version, max abs err {worst:.3g}{grads} at the training "
              f"shapes")
    q0 = lm_rand((LM_BATCH, p, 0, hd), dev, torch.bfloat16, gen)
    k0 = lm_rand((LM_BATCH, e, 0, hd), dev, torch.bfloat16, gen)
    before = launch_counts()
    out = attend_prefill(q0, k0, k0, causal=False)
    if launch_counts() != before or out.shape != q0.shape:
        fail("a rank holding no heads launched the attention kernel")
    try:
        mha(q0.transpose(1, 2), k0.transpose(1, 2), k0.transpose(1, 2))
    except ValueError:
        pass
    else:
        fail("flash_attention's wrapper took 0 kv heads")
    print("a rank holding no heads (whisper-small at M = 16, ranks 12-15): "
          "the model's attention launched nothing and returned its empty "
          "output; the kernel's wrapper refuses 0 kv heads")


# ----------------------------------------------------------------- phase 15
# the K/V cache's sequence split round-robin over ranks ("kv_seq"): (arch,
# its layers cut to (0: all), (data, model) ranks on the one card, rows,
# prompt, the reference cell whose rule splits it). qwen2-vl-7b's 4 kv
# heads are fewer than 8 ranks, so decode_32k's rule puts the sequence on
# "model" (its kv heads whole on every rank, its 28 q heads 4 / 4 / 4 / 4
# / 3 / 3 / 3 / 3); long_500k's rule holds zamba2-1.2b's batch of 1 whole
# on each data rank and puts its shared attention's sequence on "data"
# (zamba2 at 12 of 38 layers, two shared-attention applications: room
# for phase 17)
KV_JOBS = (("qwen2-vl-7b", 4, (1, 8), LM_BATCH, LM_PROMPT, "decode_32k"),
           ("zamba2-1.2b", 12, (2, 1), 1, 32768, "long_500k"))
KV_PATHS = {"qwen2-vl-7b": "kv_qwen2vl", "zamba2-1.2b": "kv_zamba2"}
KV_TIMEOUT_S = 600                 # one job's ranks, spawn to exit


def kv_model(arch: str, layers: int):
    """``arch`` at full width, its first ``layers`` layers (0: all)."""
    import dataclasses
    from repro_torch.models import Model, build_model
    model = build_model(arch)
    if layers:
        model = Model(dataclasses.replace(model.cfg, n_layers=layers))
    return model


def kv_ctx(model, job, rank=None, comm=None):
    """A rank's context of ``job``: its mesh (process-free with ``rank``)
    under the reference cell's rules (``launch.dryrun.cell_rules``)."""
    from repro_torch.configs import SHAPE_SUITES
    from repro_torch.launch.dryrun import cell_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import ShardingCtx
    _, _, shape, _, _, cell = job
    return ShardingCtx(make_mesh(shape, ("data", "model"), rank=rank),
                       cell_rules(model.cfg, SHAPE_SUITES[cell], shape[1]),
                       comm=comm)


def rank_pieces(model, m: int):
    """``rounding_witness``'s pieces for ``m`` ranks: a row-parallel
    weight's rows as the ranks hold them (by whole heads over "heads",
    by rows over "ff")."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import ShardingCtx, default_rules
    ctx = ShardingCtx(make_mesh((1, m), ("data", "model"), rank=0),
                      default_rules())
    hd = model.cfg.resolved_head_dim

    def pieces(rows, axis):
        unit = hd if axis == "heads" else 1
        return [len(ctx.indices(axis, rows // unit, at=i)) * unit
                for i in range(m)]
    return pieces


@contextlib.contextmanager
def split_decode_witness(m: int, pv_f32: bool = False):
    """A split cache's decode arithmetic at one rank: every decode step's
    ``attend_decode`` over the unsharded cache computed in ``m``
    round-robin pieces (piece ``r`` positions ``r, r + m, ...``, copied
    contiguous as a rank holds them) and combined as the ranks combine
    them: f32 logits per piece, the max over the pieces, the f32 sum of
    their sums of exponentials in rank order, each piece's probabilities
    rounded to the compute dtype times its V, the pieces' products summed
    in f32 and rounded once. ``pv_f32``: each piece's product kept in
    f32 (its bf16 factors are exact there) in place of rounded to the
    compute dtype, which leaves the split softmax sums as the one
    difference from the unsplit decode. Yields the list of the calls it
    computed: empty means the model no longer reached the patch."""
    import torch
    from repro_torch.models import attention, blocks
    saved = blocks.attend_decode
    calls = []

    def pieces(q, k_cache, v_cache, *, cache_len, ctx):
        b, _, hq, d = q.shape
        hkv = k_cache.shape[2]
        calls.append(tuple(k_cache.shape))
        dt = torch.promote_types(q.dtype, k_cache.dtype)
        qg = q.reshape(b, hkv, hq // hkv, d).to(dt)
        logits, vs = [], []
        for r in range(m):
            k_r = k_cache[:, r::m].contiguous().to(dt)
            lg = torch.einsum("bhgd,bkhd->bhgk", qg, k_r).float() * d ** -0.5
            valid = (torch.arange(k_r.shape[1], device=q.device) * m + r
                     < cache_len)
            logits.append(lg.masked_fill(~valid, attention.NEG_INF))
            vs.append(v_cache[:, r::m].contiguous().to(dt))
        top = torch.stack([lg.amax(-1, keepdim=True) for lg in logits]
                          ).amax(0)
        es = [torch.exp(lg - top) for lg in logits]
        total = es[0].sum(-1, keepdim=True)
        for e in es[1:]:
            total = total + e.sum(-1, keepdim=True)
        out = None
        for e, v_r in zip(es, vs):
            probs = (e / total).to(dt)
            part = (torch.einsum("bhgk,bkhd->bhgd", probs.float(), v_r.float())
                    if pv_f32 else
                    torch.einsum("bhgk,bkhd->bhgd", probs, v_r).float())
            out = part if out is None else out + part
        return out.to(dt).reshape(b, 1, hq, d).to(q.dtype)
    blocks.attend_decode = pieces
    try:
        yield calls
    finally:
        blocks.attend_decode = saved


def kv_kernel_shapes() -> tuple:
    """(flash, gla) in ``TP_LOCAL_FLASH`` / ``TP_LOCAL_GLA``'s form at
    the shapes phase 15's ranks give the kernels: qwen2-vl's prefill at
    each rank's (q heads, kv heads) of 8, zamba2's shared attention and
    Mamba2 layers at 1 x 32,768 with every head (model axis 1)."""
    from repro_torch.models.blocks import kv_parts, mamba_dims
    flash, gla = [], []
    for job in KV_JOBS:
        arch, layers, shape, rows, prompt, _ = job
        model = kv_model(arch, layers)
        cfg = model.cfg
        seen = set()
        for m in range(shape[1]):
            ctx = kv_ctx(model, job, rank=m)
            hq = len(ctx.indices("heads", cfg.n_heads))
            hkv = len(ctx.indices("kv_heads", cfg.n_kv_heads,
                                  kv_parts(cfg)))
            if hq and (hq, hkv) not in seen:       # a head-less rank none
                seen.add((hq, hkv))
                flash.append((f"{arch} prefill, rank {m} of {shape}", rows,
                              hq, hkv, prompt, cfg.resolved_head_dim))
        if cfg.family == "hybrid":
            _, nh, dv, st = mamba_dims(cfg)
            gla.append((f"{arch} prefill at {shape}", rows, prompt,
                        nh // shape[1], st, dv))
    return tuple(flash), tuple(gla)


def kv_plans(model, job) -> tuple:
    """The dry run's plans (``model_axis_plan``) of rank 0's prefill and
    of one decode step of ``job``, as ``TptComm`` records them."""
    from repro_torch.configs import ShapeSuite
    from repro_torch.launch import dryrun
    _, _, shape, rows, prompt, _ = job
    ctx = kv_ctx(model, job, rank=0)
    out = []
    for suite in (ShapeSuite("kv_prefill", prompt, rows, "prefill"),
                  ShapeSuite("kv_decode", prompt + TP_DECODE, rows,
                             "decode")):
        out.append([(c["op"], c["dtype"], c["result_bytes"], c["group"])
                    for c in dryrun.model_axis_plan(model, suite, rows, ctx)])
    return tuple(out)


def kv_unsharded(job, dev) -> dict:
    """The unsharded card runs phase 15 holds ``job``'s ranks against
    (``tp_unsharded``'s): bf16 free-running; its rounding witness, fed the
    same tokens: the ranks' arithmetic at one rank (``rounding_witness``'s
    row-parallel pieces at the job's model axis, none at 1, and
    ``split_decode_witness``'s decode at the cache's M pieces); the same
    with each piece's PV product kept in f32 (``witness_f32_pv``); f32."""
    import torch
    arch, layers, shape, rows, prompt, _ = job
    model = kv_model(arch, layers)
    m_seq = kv_ctx(model, job, rank=0).size("kv_seq")
    params, batch = tp_draw(model, dev, rows=rows, prompt=prompt)
    out = {"prompts": batch["tokens"].cpu().numpy(),
           "bf16": tp_steps(model, params, batch)}
    feed = torch.from_numpy(out["bf16"]["tokens"][:, :TP_DECODE]).to(dev)
    for key, pv_f32 in (("witness", False), ("witness_f32_pv", True)):
        with contextlib.ExitStack() as stack:
            sites = (stack.enter_context(rounding_witness(
                rank_pieces(model, shape[1]))) if shape[1] > 1 else [None])
            calls = stack.enter_context(split_decode_witness(m_seq, pv_f32))
            out[key] = tp_steps(model, params, batch, feed)
        if not sites or not calls:
            fail(f"{arch}: the rounding witness reached no row-parallel "
                 f"site ({len(sites)}) or decode ({len(calls)})")
    f_model, params, batch = tp_f32(model, params, batch)
    out["f32"] = tp_steps(f_model, params, batch)
    del params, batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def kv_rank(rank: int, port: int, job: tuple, ref: dict, q) -> None:
    """One of phase 15's gloo ranks of ``job`` on the one card: its
    slices of the seeded weights (the ranks draw in turn), the prefill and
    decode steps fed the unsharded run's tokens in bf16, then in f32,
    each run's launches, collectives and cache shapes. Rank (0, 0) reports
    the logits too; every rank its peak over the bf16 prefill."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    arch, layers, shape, rows, prompt, _ = job
    world = shape[0] * shape[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        model = kv_model(arch, layers)
        ctx = kv_ctx(model, job, comm=TptComm())
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        for r in range(world):              # one rank draws at a time
            if r == rank:
                params, batch = tp_draw(model, dev, ctx, rows, prompt)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            dist.barrier()
        if not bool((batch["tokens"].cpu().numpy() == ref["prompts"]).all()):
            raise RuntimeError(f"{arch}: rank {rank} drew other prompts "
                               f"than the unsharded run")
        out = {"rank": rank, "coord": (ctx.mesh.coord("data"),
                                       ctx.mesh.coord("model"))}
        for key in ("bf16", "f32"):
            if key == "f32":
                model, params, batch = tp_f32(model, params, batch)
            feed = torch.from_numpy(ref[key]["tokens"]).to(dev)
            reset_launch_counts()
            got = tp_steps(model, params, batch, feed, ctx)
            out[key + "_launches"] = lm_launches(launch_counts())
            if rank != 0:                   # the logits are rank 0's to send
                got = {k: v for k, v in got.items()
                       if k not in ("logits", "tokens")}
            out[key] = got
        out["bf16"]["peak"] -= base
        q.put(out)
        del params, batch
    finally:
        dist.destroy_process_group()


def check_kv_seq(dev, card: str) -> dict:
    """Phase 15: for each of ``KV_JOBS`` the unsharded card runs (then
    freed), then the job's gloo ranks on the one card fed the same
    tokens, the cache's sequence split round-robin. Held: (a) bf16
    logits of the prefill and every decode step within 0.02 x
    max(|logits|, 1) of the unsharded run's, or, where the rounding
    witness (``kv_unsharded``: the ranks' arithmetic at one rank) misses
    that too, their mean within 1.25x the witness's; the witness with
    f32 PV products and the ranks' distance from the witness reported;
    f32 within 1e-3 x max(|logits|, 1); (b) every
    rank's cache leaves (the prefill's, and the filled cache's of prompt
    + 8 positions) of the shapes ``local_defs`` reckons: its round-robin
    positions, its kv heads whole where the sequence shares their axis;
    (c) the collectives every rank's prefill and each decode step issued
    exactly the dry run's plans; (d) rank 0's launches those of one
    prefill (no kernel in decode). Returns rank 0's launches per run
    (bf16 and f32) by path."""
    import torch
    from repro_torch.models.param import local_defs, tree_leaves, tree_paths
    counts = {}
    for job in KV_JOBS:
        arch, layers, shape, rows, prompt, cell = job
        model = kv_model(arch, layers)
        t0 = time.perf_counter()
        ref = kv_unsharded(job, dev)
        print(f"phase 15 {arch} ({model.cfg.n_layers} layers) unsharded "
              f"references on the card (bf16, its rounding witness twice "
              f"(the ranks' PV products, then f32 ones), f32: prefill "
              f"{rows} x {prompt}, {TP_DECODE} decode steps each) in "
              f"{time.perf_counter() - t0:.2f} s")
        plans = kv_plans(model, job)
        world = shape[0] * shape[1]
        items, seconds = spawn_ranks(kv_rank, world, (job, ref), world,
                                     KV_TIMEOUT_S,
                                     f"phase 15 {arch} over {shape}")
        got = {r["rank"]: r for r in items}
        r0 = got[0]
        # (a) logits
        errs = tp_errors(r0["bf16"], ref["bf16"], 0.02)
        mean = sum(errs) / len(errs)
        wit = tp_errors(ref["witness"], ref["bf16"], 0.02)
        wmean = sum(wit) / len(wit)
        if max(errs) < 1.0:
            held = "within the bound"
        elif max(wit) >= 1.0 and mean <= TP_WITNESS_SLACK * wmean:
            held = (f"MISSED in bf16, as the rounding witness misses it (at "
                    f"most {max(wit):.4f}): mean {mean:.4f}, "
                    f"{mean / wmean:.4f}x the witness's")
        else:
            fail(f"{arch} over {shape} (bf16): logits per step "
                 f"{[round(e, 4) for e in errs]} of 0.02 x max(|logits|, 1) "
                 f"(mean {mean:.4f}); the rounding witness {max(wit):.4f} "
                 f"(mean {wmean:.4f})")
        pv = tp_errors(ref["witness_f32_pv"], ref["bf16"], 0.02)
        near = tp_errors(r0["bf16"], ref["witness"], 0.02)
        f32 = tp_errors(r0["f32"], ref["f32"], 1e-3)
        if not max(f32) <= 1.0:
            fail(f"{arch} over {shape} (f32): logits {max(f32):.4f} of "
                 f"1e-3 x max(|logits|, 1)")
        agree = float((r0["bf16"]["tokens"] == ref["bf16"]["tokens"]).mean())
        # (b) cache shapes, (c) collectives, per rank
        pre_plan, dec_plan = plans
        cache_bytes = []
        for rank in sorted(got):
            r = got[rank]
            ctx = kv_ctx(model, job, rank=rank)
            for key, n in (("prefill_cache", prompt),
                           ("cache", prompt + TP_DECODE)):
                want = [d.shape for d in tree_leaves(local_defs(
                    model.cache_defs(rows, n), ctx))]
                if r["bf16"][key] != want:
                    fail(f"{arch} rank {rank}: {key} leaves "
                         f"{r['bf16'][key]}, the layout reckons {want}")
            if r["bf16"]["prefill_issued"] != pre_plan or any(
                    step != dec_plan for step in r["bf16"]["decode_issued"]):
                fail(f"{arch} rank {rank} issued {r['bf16']['prefill_issued']}"
                     f" in the prefill and {r['bf16']['decode_issued']} in "
                     f"decode; the dry run's plans are {pre_plan} and "
                     f"{dec_plan}")
            leaves = dict(zip([p for p, _ in tree_paths(model.cache_defs(
                rows, prompt + TP_DECODE))], r["bf16"]["cache"]))
            kv_leaf = "shared/k" if "shared/k" in leaves else "k"
            cache_bytes.append(
                f"rank {r['coord']}: {kv_leaf} {leaves[kv_leaf]} = "
                f"{math.prod(leaves[kv_leaf]) * 2} B, peak "
                f"{r['bf16']['peak'] / 2**30:.3f} GiB")
        # (d) launches
        for key, bf16 in (("bf16", True), ("f32", False)):
            want = lm_expected(model, bf16=bf16)
            if r0[key + "_launches"] != want:
                fail(f"{arch} rank 0 launched {r0[key + '_launches']} in "
                     f"{key}; expected {want}")
        counts[KV_PATHS[arch]] = r0["bf16_launches"]
        counts[KV_PATHS[arch] + "_f32"] = r0["f32_launches"]
        runs = [got[k]["bf16"] for k in sorted(got)]
        print(f"phase 15 {arch} ({model.cfg.n_layers} layers) over "
              f"(data, model) = {shape}, {cell}'s rule (the cache's "
              f"sequence round-robin over "
              f"{kv_ctx(model, job, rank=0).mesh_axes('kv_seq')[0]}), gloo "
              f"ranks on the one card vs the unsharded card run [{card}]: "
              f"bf16 logits per step {[round(e, 4) for e in errs]} of 0.02 "
              f"x max(|logits|, 1): {held}; the rounding witness (the "
              f"ranks' arithmetic at one rank: row-parallel sums in "
              f"{shape[1]} pieces, the decode in "
              f"{kv_ctx(model, job, rank=0).size('kv_seq')} round-robin "
              f"pieces) {[round(e, 4) for e in wit]}, with "
              f"each piece's PV product kept in f32 "
              f"{[round(e, 4) for e in pv]}; the ranks from the witness "
              f"{[round(e, 4) for e in near]}; greedy tokens agree "
              f"{agree:.4f}; f32 at most {max(f32):.4f} of 1e-3 x "
              f"max(|logits|, 1); every rank's cache the layout's "
              f"reckoning, its prefill's {len(pre_plan)} and each decode "
              f"step's {len(dec_plan)} collectives the dry run's plans; "
              f"rank 0 launched {r0['bf16_launches']} (bf16), "
              f"{r0['f32_launches']} (f32); ranks ran in {seconds:.1f} s "
              f"({POOL_NOTE if world == TP_RANKS else SPAWN_NOTE}; rank 0 "
              f"prefill {runs[0]['prefill_s'] * 1e3:.1f} ms, decode "
              f"{runs[0]['decode_s'] / TP_DECODE * 1e3:.2f} ms/step, gloo: "
              f"no tensor-parallel speedup)")
        for line in cache_bytes:
            print(f"phase 15 {arch} cache and peak, {line} [{card}]")
        del ref
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------- phase 16
# the model axis's other two layouts of the reference's rules: col
# serving (internlm2: every pair's second matmul; whisper: self- and
# cross-attention wo and the GELU w_down at 6 of 12 heads per rank), then
# training under seq_parallel (internlm2; zamba2: Mamba2 and the shared
# attention on a split sequence) and col (internlm2), each with an f32 cut
COL = {"second_matmul": "col"}
SEQ_PARALLEL = {"seq_parallel": True}
TP16_ARCHS = ("internlm2-1.8b", "whisper-small")
# zamba2 at 12 of 38 layers (two shared-attention applications) and
# internlm2 at 4 of 24 (both layouts), phase 13's depths: the
# seq_parallel step is read against phase 13's row step bit for bit, and
# phase 13's unsharded card steps serve both (two gloo ranks on one H100
# took 17.7 / 32.5 / 37.3 s for the full-depth steps)
TPT16 = (("internlm2-1.8b", 4, SEQ_PARALLEL),
         ("zamba2-1.2b", 12, SEQ_PARALLEL), ("internlm2-1.8b", 4, COL))
TPT16_F32 = (("internlm2-1.8b", 4, SEQ_PARALLEL),
             ("zamba2-1.2b", 6, SEQ_PARALLEL), ("internlm2-1.8b", 4, COL))


def layout_kernel_shapes() -> tuple:
    """(flash, gla) in ``TP_LOCAL_FLASH`` / ``TP_LOCAL_GLA``'s form at the
    shapes phase 16's ranks give the kernels: col serving at M = 2
    (internlm2's prefill; whisper's causal decoder self-attention, its
    full and cross regimes at these heads phase 14's), and training at M
    = 2, where sequence parallelism gathers every position before each
    attention and scan (internlm2's and zamba2's microbatch of 1 x
    2048)."""
    from repro_torch.models import build_model
    from repro_torch.models.blocks import mamba_dims
    i_cfg, w_cfg, z_cfg = (build_model(a).cfg for a in (
        "internlm2-1.8b", "whisper-small", "zamba2-1.2b"))
    m = TP_RANKS
    flash = [("internlm2 col serving at M = 2", LM_BATCH, i_cfg.n_heads // m,
              i_cfg.n_kv_heads // m, LM_PROMPT, i_cfg.resolved_head_dim),
             ("whisper col serving at M = 2, decoder", LM_BATCH,
              w_cfg.n_heads // m, w_cfg.n_kv_heads // m, WHISPER_PROMPT,
              w_cfg.resolved_head_dim)]
    gla = []
    for cfg in (i_cfg, z_cfg):
        label = f"{cfg.arch} training at M = 2 (gathered sequence)"
        flash.append((label, 1, cfg.n_heads // m, cfg.n_kv_heads // m,
                      TRAIN_SEQ, cfg.resolved_head_dim))
    _, nh, dv, st = mamba_dims(z_cfg)
    gla.append((f"{z_cfg.arch} training at M = 2 (gathered sequence)", 1,
                TRAIN_SEQ, nh // m, st, dv))
    return tuple(flash), tuple(gla)


# ----------------------------------------------------------------- phase 17
# the data axis's last two layouts: fsdp (ZeRO-3, "embed" over "data")
# over a (data 2, model 2) mesh and the multi-pod mesh (pod 2, data 2,
# model 1), four gloo ranks on the one card. A job: (arch, layers, mesh
# shape, fsdp, f32); its steps run one after another on the same ranks
FS_RANKS = 4
FS_MESH, POD_MESH, FLAT_MESH = (2, 2), (2, 2, 1), (4, 1)
# the steps' rows of 2048 tokens, one microbatch of 1 x 2048 per row a
# data rank holds: (a) 4 (2 microbatches per data rank), its f32 cuts 2
# and (b) 4 (one each; fsdp's gathers and reduce-scatters are issued per
# microbatch, and four ranks' gloo collectives bound the phase's time)
FS_BATCH, FS_F32_BATCH, POD_BATCH = 4, 2, 4
FS_ARCHS = (("internlm2-1.8b", 0), ("zamba2-1.2b", 12))
FS_F32 = (("internlm2-1.8b", 4), ("zamba2-1.2b", 6))
POD_ARCH, POD_LAYERS = "internlm2-1.8b", 8
FS_REL = 1e-5                      # bf16 grad norm, fsdp vs unsplit
FS_F32_TOL = 1e-6                  # f32 gradient shards, x max |g|
FS_TIMEOUT_S = 600


def fs_jobs() -> list:
    """Phase 17's steps in order, each (arch, layers, mesh shape, fsdp,
    f32, rows): per arch the unsplit step, then the fsdp step from the
    same weights and batch; then the f32 cuts alike; then the multi-pod
    steps beside the same ranks as one data axis."""
    jobs = []
    for arch, layers in FS_ARCHS:
        jobs += [(arch, layers, FS_MESH, f, False, FS_BATCH)
                 for f in (False, True)]
    for arch, layers in FS_F32:
        jobs += [(arch, layers, FS_MESH, f, True, FS_F32_BATCH)
                 for f in (False, True)]
    jobs += [(POD_ARCH, POD_LAYERS, mesh, f, False, POD_BATCH)
             for mesh, f in ((POD_MESH, False), (POD_MESH, True),
                             (FLAT_MESH, False))]
    return jobs


def fs_job_name(job) -> str:
    arch, layers, mesh, fsdp, f32, _ = job
    return (f"{arch}{f' at {layers} layers' if layers else ''} over "
            f"{'x'.join(map(str, mesh))}{' fsdp' if fsdp else ''}"
            f"{' f32' if f32 else ''}")


def fs_model(job):
    """A job's model: full width, its depth, one microbatch of 1 x 2048
    per row a data rank holds."""
    import dataclasses
    from repro_torch.models import Model
    arch, layers, mesh, _, _, rows = job
    model = tpt_model(arch, layers)
    mb = rows // math.prod(mesh[:-1])
    return Model(dataclasses.replace(model.cfg, microbatches=mb))


def fs_cell(job):
    """The dry run's cell of a job's step (``--cards 4 --model M``,
    ``--override fsdp=true``, ``--multi-pod``) at its batch: (the
    analysis, the plan as the ranks record it)."""
    from repro_torch.configs import ShapeSuite
    from repro_torch.launch import dryrun
    arch, layers, mesh, fsdp, _, rows = job
    suite = ShapeSuite("fs_train", TRAIN_SEQ, rows, "train")
    fn, args, meta, comm = dryrun.build_cell(
        arch, suite.name, cards=FS_RANKS, model=mesh[-1], suite=suite,
        multi_pod=len(mesh) == 3,
        overrides={"microbatches": fs_model(job).cfg.microbatches,
                   "fsdp": fsdp,
                   **({"n_layers": layers} if layers else {})})
    res = dryrun.analyze_cell(fn, args, meta, comm)
    return res, [(c["op"], c["dtype"], c["result_bytes"], c["group"])
                 for c in comm.plan]


def fs_rank(rank: int, port: int, jobs: list, q) -> None:
    """One of phase 17's four ranks (a spawned process on the one card,
    gloo). Per job, in turn: its slices of the seeded weights (the ranks
    draw one at a time; f32 jobs cast them), zero moments, one
    ``manual_dp`` step of its rows in 2 microbatches; its metrics, step
    seconds, peak memory over the step (from before its weights), the
    kernels' launches and the collectives it issued. The unsplit step's
    updated leaves are kept (on the host) and the fsdp step's that follows
    is held against them: per leaf the largest distance in bf16 ulps of
    the unsplit value (bf16), or the largest difference of the first
    moment over the unsplit one's largest (f32: from zero moments the
    first moment is (1 - b1) x the clipped gradient), both in the rank's
    part of the "embed" dim; the bucket's shards of the moment are
    all-gathered over the data axis to be compared."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.models.sharding import ShardingCtx, default_rules
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import manual_dp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=FS_RANKS, rank=rank)
    try:
        comm = TptComm()
        meshes = {m: make_mesh(m, ("pod", "data", "model")[-len(m):])
                  for m in (FS_MESH, POD_MESH, FLAT_MESH)}
        kept = None
        for job in jobs:
            t_job = time.perf_counter()
            arch, layers, shape, fsdp, f32, rows = job
            mesh = meshes[shape]
            ctx = ShardingCtx(mesh, default_rules(len(shape) == 3,
                                                  fsdp=fsdp), comm=comm)
            model = fs_model(job)
            defs = tree_leaves(model.defs)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(dev)
            for r in range(FS_RANKS):       # one rank draws at a time
                if r == rank:
                    params = model.init(
                        torch.Generator(device=dev).manual_seed(0), ctx)
                    if f32:
                        params = tree_map(lambda t: t.float(), params)
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                dist.barrier()
            opt = manual_dp.init_shard_state(params, ctx=ctx, model=model)
            if shape == FS_MESH and not f32:
                fs_warm(opt, params, model, ctx)
            batch = fs_rows(model, dev, rows)
            if f32:
                batch = {k: t.float() if t.is_floating_point() else t
                         for k, t in batch.items()}
            batch = {k: ctx.shard(t, ("batch",) + (None,) * (t.dim() - 1))
                     for k, t in batch.items()}
            step = manual_dp.make_manual_dp_train_step(
                model, AdamWConfig(), comm=comm, ctx=ctx)
            comm.issued.clear()
            reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            got = {k: float(met[k]) for k in ("loss", "grad_norm")}
            torch.cuda.synchronize()
            out = {"rank": rank, "job": job, **got,
                   "step_s": time.perf_counter() - t0,
                   "peak": torch.cuda.max_memory_allocated(dev) - base,
                   "launches": lm_launches(launch_counts()),
                   "issued": list(comm.issued)}
            leaves = tree_leaves(params)
            split = manual_dp.split_leaves(model, ctx)
            lay = manual_dp.StepLayout(leaves, split, ctx.size("batch"),
                                       ctx.index("batch"))
            if shape != FS_MESH:          # (b): held against (data 4)
                held = None
            elif f32:
                # the first moment per leaf: the bucket's shards
                # all-gathered over the data axis, the fsdp leaves' own
                main, z3 = lay.moments(opt.mu)
                parts = [torch.empty_like(main) for _ in range(
                    ctx.size("batch"))]
                dist.all_gather(parts, main, group=mesh.group("data"))
                bucket = torch.cat(parts)
                whole = manual_dp.FlatLayout(
                    [leaves[i] for i in lay.main_idx], 1, 0)
                mine = [None] * len(leaves)
                for i, v in zip(lay.main_idx, whole.views(bucket)):
                    mine[i] = v.view(leaves[i].shape)
                if lay.zero3 is not None:
                    for i, v in zip(lay.zero3_idx, lay.zero3.views(z3)):
                        mine[i] = v.view(leaves[i].shape)
                held = [m.clone() for m in mine]
            else:
                held = [x.clone() for x in leaves]
            if held is None:
                pass
            elif not fsdp:
                kept = held
            else:
                # (leaf, its worst, where) of the leaves one piece reads
                # once (0) and of those read more than once (1): zamba2's
                # shared block, applied twice, whose gradient the unsplit
                # step sums over the applications in bf16 (autograd into
                # the bf16 leaf), the fsdp step in f32
                worst = [(0.0, None), (0.0, None)]
                reread = fs_reread(model)
                for i, (d, a, b) in enumerate(zip(defs, held, kept)):
                    dim = ctx.embed_dim(d.axes, d.shape)
                    if dim is not None:
                        lo, hi = ctx.range("embed", d.shape[dim])
                        b = b.narrow(dim, lo, hi - lo)
                    if f32:
                        err = float((a - b).abs().max()) / max(
                            float(b.abs().max()), 1e-30)
                    elif i in reread:  # in ulps of the leaf's largest
                        _, e = torch.frexp(b.float().abs().max())
                        one = torch.ones_like(e, dtype=torch.float32)
                        err = float((a.float() - b.float()).abs().max()
                                    / torch.ldexp(one, e - 8))
                    else:               # in ulps of each element
                        top = torch.maximum(a.float().abs(),
                                            b.float().abs())
                        _, e = torch.frexp(top)
                        ulp = torch.ldexp(torch.ones_like(top), e - 8)
                        err = float(((a.float() - b.float()).abs()
                                     / ulp).max())
                    k = int(i in reread and not f32)
                    if err >= worst[k][0]:
                        worst[k] = (err, f"{d.axes} #{i}")
                out.update(worst=worst[0][0], worst_leaf=worst[0][1],
                           reread_worst=worst[1][0],
                           reread_leaf=worst[1][1], reread=len(reread),
                           split=sum(split), leaves=len(leaves))
                kept = None
            out["job_s"] = time.perf_counter() - t_job
            q.put(out)
            del params, opt, batch, met, step, leaves, held
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            dist.barrier()
    finally:
        dist.destroy_process_group()


def fs_reread(model) -> set:
    """The leaves (``tree_leaves`` positions) that several pieces of a
    forward read: zamba2's shared block where it is applied more than
    once, a tied embedding table."""
    from repro_torch.models.param import tree_paths
    return {i for i, (path, _) in enumerate(tree_paths(model.defs))
            if (path.startswith("shared/") and model.n_shared_apps() > 1)
            or (path == "embed" and model.cfg.tie_embeddings)}


def fs_warm(opt, params, model, ctx) -> None:
    """Warm moments for a bf16 step of phase 17, elementwise functions of
    the rank's parameters (so the unsplit and the fsdp layouts hold the
    same values wherever each holds them): mu = 1e-3 x p, nu = 1e-4 x p^2
    + 1e-6, step 3. From zero moments one step moves each element by
    about lr x sign(g), so a gradient summed in another order (zamba2's
    shared block, read twice: the unsplit step adds its applications'
    bf16 gradients in bf16, the fsdp step in f32) would move near-zero
    gradients by whole learning-rate steps."""
    import torch
    from repro_torch.models.param import tree_leaves
    from repro_torch.train import manual_dp
    leaves = tree_leaves(params)
    lay = manual_dp.StepLayout(leaves, manual_dp.split_leaves(model, ctx),
                               ctx.size("batch"), ctx.index("batch"))
    mu, nu = lay.moments(opt.mu), lay.moments(opt.nu)
    for k, (flat, idx) in enumerate(((lay.main, lay.main_idx),
                                     (lay.zero3, lay.zero3_idx))):
        for j, a, b, o in (flat.segments() if flat is not None else ()):
            x = leaves[idx[j]].reshape(-1)[a:b].float()
            mu[k][o:o + b - a].copy_(x).mul_(1e-3)
            nu[k][o:o + b - a].copy_(x).square_().mul_(1e-4).add_(1e-6)
    opt.step.fill_(3)


def fs_rows(model, dev, rows: int) -> dict:
    """``rows`` seeded sequences of 2048 tokens and their next tokens."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(17)
    toks = torch.randint(0, model.cfg.vocab, (rows, TRAIN_SEQ),
                         generator=gen, device=dev)
    return {"tokens": toks, "targets": torch.roll(toks, -1, 1)}


def check_fsdp_multi_pod(card: str) -> dict:
    """Phase 17: four gloo ranks on the one card run ``fs_jobs``, while
    the dry run's cells of their bf16 steps are traced here. Held: (a)
    fsdp over (data 2, model 2), internlm2-1.8b at full depth and
    zamba2-1.2b at 12 of 38 layers in bf16 with remat, against the
    unsplit ``manual_dp`` step on the same ranks from the same state: the
    loss bitwise, the grad norm within 1e-5 relative, every updated leaf
    within one bf16 ulp of the unsplit step's part (both from the warm
    moments of ``fs_warm``; a leaf several pieces read in ulps of its
    largest element, ``fs_reread``); the f32 cuts (internlm2 at 4
    layers, zamba2 at 6; 2 x 2048): every gradient leaf (the first
    moment) within 1e-6 x its max; rank 0's collectives exactly the dry
    run's ``--cards 4 --model 2 --override fsdp=true`` plan (and the
    unsplit step's its own), each rank's peak within 15% of its cell's
    reckoning (printed beside the unsplit step's), rank 0's
    flash_attention_tc / gla_ssd launches those of the unsplit step. (b)
    The multi-pod mesh (pod 2, data 2, model 1), internlm2-1.8b at 8 of
    24 layers, without fsdp and with it, against the same ranks as (data
    4, model 1): the loss bitwise (reported), the grad norm within 1e-5
    relative, each step's collectives its ``--multi-pod`` plan. Returns
    rank 0's launches per path."""
    import torch
    jobs = fs_jobs()
    cells = {}

    def trace():
        for job in jobs:
            if not job[4]:
                cells[job] = fs_cell(job)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    items, seconds = spawn_ranks(fs_rank, FS_RANKS, (jobs,),
                                 FS_RANKS * len(jobs), FS_TIMEOUT_S,
                                 "phase 17 (fsdp, multi-pod)",
                                 meanwhile=trace)
    got = {(tuple(r["job"]), r["rank"]): r for r in items}
    print(f"phase 17: {FS_RANKS} gloo ranks on the one card ran "
          f"{len(jobs)} steps in {seconds:.1f} s (spawn, imports and "
          f"weights included), the dry run's {len(cells)} cells traced "
          f"meanwhile")
    counts = {}
    for k, job in enumerate(jobs):
        arch, layers, shape, fsdp, f32, rows = job
        ranks = [got[(tuple(job), r)] for r in range(FS_RANKS)]
        r0, name = ranks[0], fs_job_name(job)
        if len({(r["loss"], r["grad_norm"]) for r in ranks}) != 1:
            fail(f"{name}: the ranks' metrics differ: "
                 f"{[(r['loss'], r['grad_norm']) for r in ranks]}")
        notes = [f"loss {r0['loss']:.6f}, grad norm {r0['grad_norm']:.6f}"]
        if not f32:
            cell, plan = cells[job]
            if r0["issued"] != plan:
                fail(f"{name}: rank 0 issued {len(r0['issued'])} "
                     f"collectives, not the dry run's plan of {len(plan)}")
            est = cell["memory"]["peak_estimate_bytes"]
            for i, r in enumerate(ranks):
                if not abs(est - r["peak"]) <= PEAK_TOL * r["peak"]:
                    fail(f"{name} rank {i}: peak {r['peak']} B over the "
                         f"step, the dry run's reckoning {est} B: not "
                         f"within {PEAK_TOL:.0%}")
            notes.append(
                f"{len(plan)} collectives exactly the dry run's plan "
                f"({sum(c[2] for c in plan) / 2**20:.2f} MiB of results)")
            notes.append("peaks " + ", ".join(
                f"{r['peak'] / 2**30:.3f}" for r in ranks)
                + f" GiB, the dry run {est / 2**30:.3f} GiB ("
                + ", ".join(f"{r['peak'] / est - 1:+.4f}" for r in ranks)
                + ")")
        notes.append("step " + ", ".join(f"{r['step_s'] * 1e3:.1f}"
                                         for r in ranks)
                     + f" ms (the job, weights to checks, "
                     f"{r0['job_s']:.1f} s on rank 0)")
        if fsdp and shape == FS_MESH:
            plain = jobs[k - 1]
            want = [got[(tuple(plain), r)] for r in range(FS_RANKS)]
            for i, (r, w) in enumerate(zip(ranks, want)):
                if r["loss"] != w["loss"]:
                    fail(f"{name} rank {i}: loss {r['loss']} vs the "
                         f"unsplit step's {w['loss']}: not bitwise")
                rel = abs(r["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                if not rel <= FS_REL:
                    fail(f"{name} rank {i}: grad norm {r['grad_norm']} vs "
                         f"{w['grad_norm']} (relative {rel:.3g})")
                bound = FS_F32_TOL if f32 else 1.0
                if not r["worst"] <= bound:
                    fail(f"{name} rank {i}: leaf {r['worst_leaf']} "
                         + (f"{r['worst']:.3g} x max |g|" if f32 else
                            f"{r['worst']:.3g} bf16 ulps")
                         + " from the unsplit step's")
                if not r["reread_worst"] <= 1.0:
                    fail(f"{name} rank {i}: leaf {r['reread_leaf']} (read "
                         f"by several pieces) {r['reread_worst']:.3g} bf16 "
                         f"ulps of its largest element from the unsplit "
                         f"step's")
            if r0["launches"] != want[0]["launches"]:
                fail(f"{name}: rank 0 launched {r0['launches']}, the "
                     f"unsplit step {want[0]['launches']}")
            worst = max(r["worst"] for r in ranks)
            notes.append(
                f"vs the unsplit step on the same ranks: loss bitwise, "
                f"grad norm relative {max(abs(r['grad_norm'] - w['grad_norm']) / w['grad_norm'] for r, w in zip(ranks, want)):.3g}, "
                + (f"every first moment within {worst:.3g} x its max"
                   if f32 else f"every updated leaf within {worst:.3g} "
                   f"bf16 ulps")
                + f" ({r0['split']} of {r0['leaves']} leaves split over "
                f"data; worst {r0['worst_leaf']} on rank 0)"
                + (f"; the {r0['reread']} leaves several pieces read (the "
                   f"unsplit step sums their gradient over the pieces in "
                   f"bf16, fsdp in f32) within "
                   f"{max(r['reread_worst'] for r in ranks):.3g} bf16 ulps "
                   f"of each leaf's largest element ({r0['reread_leaf']})"
                   if r0["reread"] and not f32 else "")
                + "; unsplit peaks "
                + ", ".join(f"{w['peak'] / 2**30:.3f}" for w in want)
                + f" GiB; launches {r0['launches']} both")
        if shape == FLAT_MESH:
            for pj in (jobs[k - 2], jobs[k - 1]):
                pod = [got[(tuple(pj), r)] for r in range(FS_RANKS)]
                for i, (r, w) in enumerate(zip(pod, ranks)):
                    if r["loss"] != w["loss"]:
                        fail(f"{fs_job_name(pj)} rank {i}: loss "
                             f"{r['loss']} vs (data 4)'s {w['loss']}: not "
                             f"bitwise")
                    rel = abs(r["grad_norm"] - w["grad_norm"]) / \
                        w["grad_norm"]
                    if not rel <= FS_REL:
                        fail(f"{fs_job_name(pj)} rank {i}: grad norm "
                             f"{r['grad_norm']} vs (data 4)'s "
                             f"{w['grad_norm']} (relative {rel:.3g})")
                notes.append(
                    f"{fs_job_name(pj)}: loss {bitwise(pod[0]['loss'], r0['loss'])}, "
                    f"grad norm relative "
                    f"{abs(pod[0]['grad_norm'] - r0['grad_norm']) / r0['grad_norm']:.3g}")
        if not f32:
            want = train_expected(fs_model(job))
            if r0["launches"] != want:
                fail(f"{name}: rank 0 launched {r0['launches']}; expected "
                     f"{want}")
        print(f"phase 17 {name} [{card}]: " + "; ".join(notes))
        short = arch.split("-")[0]
        path = ("fsdp" if fsdp else "dp") + ("_pod" if len(shape) == 3
                                             else "") + "_train_" + short
        counts[path + ("_f32" if f32 else "")
               + ("_flat" if shape == FLAT_MESH else "")] = r0["launches"]
    return counts


def build_model_layers(arch: str) -> int:
    from repro_torch.models import build_model
    return build_model(arch).cfg.n_layers


def main() -> None:
    t_start, wall0 = time.perf_counter(), time.time()
    card = phase_card()
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def stamp(phases: str) -> None:
        print(f"phases {phases} done at {time.perf_counter() - t_start:.1f}"
              f" s [{card}]")

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
    stamp("1-2")

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
    stamp("3-4")

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
    stamp("5-7")

    gen = torch.Generator(device=dev).manual_seed(0)           # phase 8
    results += check_flash(dev, gen, card) + check_gla(dev, gen, card)
    stamp("8")
    tracer = Tracer(wall0)        # phase 11's meta traces, meanwhile
    lm_counts, f32_counts, prefill_s = {}, {}, {}              # phase 9
    for arch in LM_ARCHS:
        path = LM_PATHS[arch]
        serve_counts, f32, prefill_s[arch] = run_lm(arch, dev, card)
        lm_counts[path] = by_design(serve_counts)
        f32_counts[path + "_f32_prefill"] = by_design(f32)
    stamp("9")
    fn_times = check_function_grads(dev, gen, card)            # phase 10
    smoke_train_parity(dev, card)
    train_counts = {}                                          # and 11
    for arch in (*TRAIN_ARCHS, *TRAIN_CUTS):
        train_counts[TRAIN_PATHS[arch]] = by_design(run_train(
            arch, dev, card, fn_times, tracer.get("train", arch),
            TRAIN_STEPS if arch in TRAIN_ARCHS else CUT_STEPS))
    lm_run = run_train_lm(card)
    train_counts["train_lm"] = {**lm_run, **by_design(lm_run)}
    check_manual_dp(dev, card)
    check_quickstart(card)
    stamp("10")
    for arch in TRAIN_ARCHS:                                   # phase 11
        train_counts["dryrun_" + arch.split("-")[0]] = by_design(
            check_dryrun(arch, dev, card, prefill_s[arch], tracer))
    tracer.close(card)
    print("the dry run's (arch x shape) matrix at one card runs from the "
          "CLI (python -m repro_torch.launch.dryrun --all), not here: its "
          "six train cells trace for longer than the 60 s of host time "
          "this phase may take (see the trace times above); PERF.md holds "
          "its table")
    check_local_kernels(dev, torch.Generator(                  # phase 12
        device=dev).manual_seed(12))
    stamp("11")
    kept = Kept()
    tp_counts = {path: by_design(c)
                 for path, c in check_tp(dev, card, kept=kept).items()}
    stamp("12")
    check_local_kernels(dev, torch.Generator(                  # phase 13
        device=dev).manual_seed(13), train=True)
    tp_counts.update({path: by_design(c) for path, c in check_tp_train(
        dev, card, kept=kept).items()})
    stamp("13")
    t14 = time.perf_counter()                                  # phase 14
    check_local_kernels_14(dev, torch.Generator(device=dev).manual_seed(14))
    tp_counts.update({path: by_design(c) for path, c in check_tp(
        dev, card, archs=TP14_ARCHS, row_products=False,
        kept=kept).items()})
    tp_counts.update({path: by_design(c) for path, c in check_tp_train(
        dev, card, archs=TPT14, f32_cuts=TPT14_F32, kept=kept).items()})
    print(f"phase 14 (rwkv6-7b and whisper-small under the model axis) in "
          f"{time.perf_counter() - t14:.1f} s [{card}]")
    t15 = time.perf_counter()                                  # phase 15
    check_local_kernels(dev, torch.Generator(device=dev).manual_seed(15),
                        shapes=kv_kernel_shapes(), f32=True)
    tp_counts.update({path: by_design(c)
                      for path, c in check_kv_seq(dev, card).items()})
    print(f"phase 15 (the K/V cache's sequence split: qwen2-vl-7b over 8 "
          f"ranks, zamba2-1.2b over 2 data ranks) in "
          f"{time.perf_counter() - t15:.1f} s [{card}]")
    t16 = time.perf_counter()                                  # phase 16
    check_local_kernels(dev, torch.Generator(device=dev).manual_seed(16),
                        train=True, shapes=layout_kernel_shapes())
    tp_counts.update({path: by_design(c) for path, c in check_tp(
        dev, card, archs=TP16_ARCHS, row_products=False, layout=COL,
        kept=kept).items()})
    tp_counts.update({path: by_design(c) for path, c in check_tp_train(
        dev, card, archs=TPT16, f32_cuts=TPT16_F32, kept=kept).items()})
    print(f"phase 16 (second_matmul=\"col\" serving and training, "
          f"seq_parallel training) in {time.perf_counter() - t16:.1f} s "
          f"[{card}]")
    close_pools()                 # the two-rank pool's last job was 16's
    t17 = time.perf_counter()                                  # phase 17
    tp_counts.update({path: by_design(c) for path, c in
                      check_fsdp_multi_pod(card).items()})
    print(f"phase 17 (fsdp over (data 2, model 2), the multi-pod mesh "
          f"(pod 2, data 2, model 1)) in {time.perf_counter() - t17:.1f} s "
          f"[{card}]")
    for regime, t in fn_times.items():
        r = next(r for r in results if r["name"] == t["kernel"])
        times = {"train_forward_ms": t["fwd_ms"],
                 "recompute_backward_ms": t["bwd_ms"],
                 "function_fwd_bwd_ms": t["fn_ms"],
                 "plain_fwd_bwd_ms": t["plain_fwd_bwd_ms"]}
        if TRAIN_FN_MAIN[t["kernel"]] == regime:
            r.update(times)
        r.setdefault("train_regimes", {})[regime] = {
            **times, "shapes": t["shapes"], "max_abs_err": t["max_abs_err"]}

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
                   **{p: c.get(name, 0) for p, c in train_counts.items()},
                   **{p: c.get(name, 0) for p, c in tp_counts.items()}}
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
                                             *train_counts.values(),
                                             *tp_counts.values()))
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
            # the training cells each design must take
            need = {"flash_attention_tc": ("train_qwen2vl",
                                           "train_qwen2moe",
                                           "train_whisper"),
                    "gla_chunk_rwkv6": ("train_rwkv6",)}.get(name, ())
            if any(train_counts[p][name] <= 0 for p in need):
                fail(f"{name} missing on a training path: {train_counts}")
            # the bf16 two-rank paths each design must take
            need = {"flash_attention_tc": ("internlm2", "zamba2", "qwen2moe",
                                           "whisper"),
                    "gla_chunk_ssd": ("zamba2",),
                    "gla_chunk_rwkv6": ("rwkv6",)}.get(name, ())
            if any(c[name] <= 0 for p, c in tp_counts.items()
                   if not p.endswith("_f32")
                   and p.split("_")[-1] in need):
                fail(f"{name} missing on a two-rank path: {tp_counts}")
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
                            "function_fwd_bwd_ms", "plain_fwd_bwd_ms",
                            "train_regimes")
                           if key in r}})
    print(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s, "
          f"the kernels' build included [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
