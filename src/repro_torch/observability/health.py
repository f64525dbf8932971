"""`ClusterHealth` snapshots: one structured dict per call — the
observation vector a future autoscaling controller consumes (ROADMAP
item 4: a control loop needs freshness percentiles, backlog, and
per-worker load collected in ONE place, at ONE instant).

Builders are duck-typed over ``ConcurrentCluster`` / ``DODETLPipeline``
(no imports of the runtime — the runtime imports us). The snapshot is
designed to be taken on a LIVE cluster while rebalances, repartitions
and checkpoints run concurrently:

* it takes NO stage or commit locks (never blocks or deadlocks the data
  plane — a health poll must be safe at any frequency);
* every scalar is a single GIL-atomic field read (counters are plain
  ints with one writer — readable mid-increment without tearing) and
  every percentile comes from a recorder that locks only its chunk
  list;
* the partition assignment is copied ONCE per snapshot (with a retry
  around the copy, since a concurrent rebalance may resize the dict
  mid-iteration), and all per-worker partition / commit-lag views are
  derived from that one copy — so ownership and lag never mix two
  different rebalance generations within one snapshot.

Schema (``build_cluster_health``)::

    {
      "generated_at": <perf_counter seconds>,
      "wall_s":       <seconds since cluster start>,
      "workers": {name: {"alive", "partitions", "records_done",
                         "records_fetched", "throughput_rps", "in_flight",
                         "transform_q", "load_q", "buffer",
                         "dead_lettered", "credits_available",
                         "heartbeat_max_age_s",
                         "cache_rows", "freshness": {p50/p95/p99_ms, n}}},
      "freshness":  cluster-merged p50/p95/p99 (ms),
      "staleness":  serving-side percentiles (or None),
      "serving":    {"epoch", "pending_deltas"} (or None),
      "backlog":    {"operational_lag", "extraction_lag", "buffered"},
      "commit_lag": {topic: {partition: records}},
      "routing_epoch": int,
      "cache": {"rows", "retention_last_migration"},
      "checkpoint": {"steps", "last_step", "age_s"} (or None),
      "control":   {"enabled", "degraded", "breaker_open", "suspects",
                    "evictions", "restarts", "dead_lettered", ...} —
                    ControlPlane.snapshot() when a control plane is
                    attached, a static same-shape stub otherwise,
      "mesh":      sharded serving plane: {"n_shards", "device_mesh",
                    "routing_epoch", "fold_rows", "fold_rows_imbalance",
                    "owned_segments", "merge": {bytes, dispatches},
                    "reowns", "segments_moved"} — ShardedViewEngine's
                    mesh_report() when sharded, a same-shape stub
                    otherwise,
      "counters":  merged registry counters (pipeline + process-global),
    }
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from repro_torch.observability.registry import global_registry


def _copy_assignment(assignment) -> Dict[int, str]:
    """One atomic-enough copy of {partition: owner}: retried because a
    concurrent rebalance can resize the dict mid-copy."""
    src = assignment.assignment
    for _ in range(16):
        try:
            return dict(src)
        except RuntimeError:        # "dict changed size during iteration"
            continue
    return dict(src)                # last try: let a persistent race raise


def merged_counters(pipe) -> Dict[str, int]:
    """The one-read-path counter view: the pipeline registry's totals
    plus the process-global registry (backend dispatch counters)."""
    out = dict(global_registry().counters())
    out.update(pipe.metrics.counters())
    return out


def _commit_lags(pipe, assignment: Dict[int, str],
                 group_of: Dict[str, str]) -> Dict[str, Dict[int, int]]:
    """Per topic -> partition: high watermark minus the OWNER's committed
    offset, all owners resolved against one assignment copy."""
    q = pipe.queue
    out: Dict[str, Dict[int, int]] = {}
    for topic in pipe.operational_topics:
        t = q.topics[topic]
        lags: Dict[int, int] = {}
        for p, owner in assignment.items():
            g = group_of.get(owner)
            committed = q.committed(g, topic, p) if g else 0
            lags[p] = max(0, t.high_watermark(p) - committed)
        out[topic] = lags
    return out


def build_cluster_health(cluster) -> Dict:
    """``ConcurrentCluster.health()``: see the module docstring schema."""
    pipe = cluster.pipe
    now = time.perf_counter()
    wall = (now - cluster._t_start) if cluster._t_start else 0.0
    assignment = _copy_assignment(cluster.assignment)
    runtimes = dict(cluster.runtimes)
    group_of = {n: rt.worker.group for n, rt in runtimes.items()}

    workers: Dict[str, Dict] = {}
    total_buffered = 0
    total_cache_rows = 0
    total_dead_lettered = 0
    for name, rt in runtimes.items():
        w = rt.worker
        buffered = len(w.buffer)
        dead_lettered = len(w.dead_letter)
        cache_rows = w.equipment.n_rows + w.quality.n_rows
        total_dead_lettered += dead_lettered
        if not rt.dead:
            total_buffered += buffered
            total_cache_rows += cache_rows
        hb_ages = [rt.heartbeat_age(s) for s in rt.hb]
        workers[name] = {
            "alive": rt.alive,
            "partitions": sorted(p for p, o in assignment.items()
                                 if o == name),
            "records_done": rt.records_done,
            "records_fetched": rt.records_fetched,
            "throughput_rps": round(rt.records_done / wall, 3)
            if wall > 0 else 0.0,
            "in_flight": rt.in_flight(),
            "transform_q": rt.transform_q.qsize(),
            "load_q": rt.load_q.qsize(),
            "buffer": buffered,
            "dead_lettered": dead_lettered,
            "credits_available": rt.credits.available,
            "heartbeat_max_age_s": round(max(hb_ages), 4) if hb_ages
            else None,
            "cache_rows": cache_rows,
            "cache": {"equipment": w.equipment.stats(),
                      "quality": w.quality.stats()},
            "freshness": rt.latency.percentiles(drain=False),
        }

    commit_lag = _commit_lags(pipe, assignment, group_of)
    operational_lag = sum(lag for lags in commit_lag.values()
                          for lag in lags.values())
    extraction_lag = cluster._extraction_lag()

    staleness: Optional[Dict] = None
    serving: Optional[Dict] = None
    engine = cluster.serving
    if engine is not None:
        snap = engine.snapshot()
        staleness = engine.staleness(drain=False)
        serving = {"epoch": snap.epoch,
                   "pending_deltas": engine.pending(),
                   "data_age_ms": round(snap.staleness_ms(), 3)}

    # sharded serving plane: per-shard fold rows / owned segments /
    # merge traffic (the shard-imbalance signal the control plane's
    # observation vector consumes); a same-shape stub when the engine is
    # unsharded, following the `control` stub idiom below
    if engine is not None and hasattr(engine, "mesh_report"):
        mesh = engine.mesh_report()
    else:
        mesh = {"n_shards": 1, "device_mesh": False, "routing_epoch": 0,
                "fold_rows": [], "fold_rows_imbalance": 1.0,
                "owned_segments": {}, "merge": {"bytes": 0,
                                                "dispatches": 0},
                "reowns": 0, "segments_moved": 0}

    # control plane: the supervisor/controller's own snapshot when one is
    # attached; a same-shape stub otherwise so consumers (and the
    # controller's own drills) never branch on schema
    ctrl = getattr(cluster, "control", None)
    if ctrl is not None:
        control = ctrl.snapshot()
    else:
        control = {"enabled": False, "crashed": False, "degraded": False,
                   "breaker_open": False, "suspects": [],
                   "evictions": 0, "restarts": 0, "restart_failures": 0,
                   "dead_lettered": total_dead_lettered}

    checkpoint: Optional[Dict] = None
    rec = cluster.recovery
    if rec is not None:
        last_at = getattr(rec, "last_checkpoint_at", None)
        checkpoint = {
            "steps": getattr(rec, "checkpoints_taken", 0),
            "last_step": getattr(rec, "last_checkpoint_step", None),
            "age_s": round(now - last_at, 6) if last_at else None,
        }

    return {
        "generated_at": now,
        "wall_s": round(wall, 4),
        "workers": workers,
        "freshness": cluster.freshness(drain=False),
        "staleness": staleness,
        "serving": serving,
        "backlog": {"operational_lag": operational_lag,
                    "extraction_lag": extraction_lag,
                    "buffered": total_buffered},
        "commit_lag": commit_lag,
        "routing_epoch": pipe.current_routing().epoch,
        "cache": {"rows": total_cache_rows,
                  "retention_last_migration":
                      cluster.last_migration.get("cache_retention")
                      if cluster.last_migration else None},
        "checkpoint": checkpoint,
        "control": control,
        "mesh": mesh,
        "counters": merged_counters(pipe),
    }


def build_pipeline_health(pipe) -> Dict:
    """``DODETLPipeline.health()``: the sequential runtime's subset of
    the cluster schema (no stage threads, so queue depths / freshness
    lanes are absent; throughput comes from each worker's StageMetrics)."""
    now = time.perf_counter()
    assignment = _copy_assignment(pipe.assignment)
    group_of = {w.name: w.group for w in pipe.workers}

    workers: Dict[str, Dict] = {}
    total_buffered = 0
    total_cache_rows = 0
    for w in pipe.workers:
        buffered = len(w.buffer)
        cache_rows = w.equipment.n_rows + w.quality.n_rows
        total_buffered += buffered
        total_cache_rows += cache_rows
        workers[w.name] = {
            "partitions": sorted(p for p, o in assignment.items()
                                 if o == w.name),
            "records_done": w.metrics.records,
            "throughput_rps": round(w.metrics.rate, 3),
            "buffer": buffered,
            "cache_rows": cache_rows,
        }

    commit_lag = _commit_lags(pipe, assignment, group_of)
    operational_lag = sum(lag for lags in commit_lag.values()
                          for lag in lags.values())

    return {
        "generated_at": now,
        "workers": workers,
        "backlog": {"operational_lag": operational_lag,
                    "buffered": total_buffered},
        "commit_lag": commit_lag,
        "routing_epoch": pipe.current_routing().epoch,
        "cache": {"rows": total_cache_rows},
        "counters": merged_counters(pipe),
    }


__all__ = ["build_cluster_health", "build_pipeline_health",
           "merged_counters"]
