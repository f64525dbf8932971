"""Exactly-once crash recovery: consistent capture + cold-restart restore.

``RecoveryCoordinator`` owns one ``DurabilityJournal`` and the two halves
of the durability contract:

* **capture** — snapshot the data plane at a *commit boundary*. The
  capture takes the Change Tracker's extraction lock plus every live
  worker's commit lock (``extra_locks``, sorted by the caller), so the
  journaled broker content, committed offsets, warehouse chunk log,
  listener offsets, late buffers and cache watermarks are all consistent
  with each other: no listener is mid-publish, no worker is between its
  warehouse load and its offset commit. Read-ahead positions are
  deliberately NOT captured (a restart abandons them — the same contract
  a worker death has always had), and the serving front is read lock-free
  (it is an immutable epoch whose ``deltas_folded`` can never exceed the
  warehouse commit seq captured under the same locks, because folds only
  consume published commits).

* **restore** — rebuild a FRESH pipeline from the journal: broker logs +
  compaction indexes + routing epochs, committed offsets, the full
  chunk log, listener offsets, partition assignment, late buffers,
  caches (re-dumped from the restored compacted topics, then the
  checkpointed watermarks reinstated — the re-dump advances the
  watermark past records the crashed process had not pumped yet, which
  would release late-buffer records early), and the serving fold state.
  The view engine resumes from its checkpointed epoch and the warehouse
  replays ONLY the chunk-log suffix past ``deltas_folded`` — recovery
  work is O(suffix since last checkpoint), never O(history).

Everything a consumer re-reads after restore sits between the committed
offset and the broker high watermark: records fetched-but-uncommitted at
the crash. Their warehouse loads (if any happened) are *gone* — the
warehouse rolled back to the checkpoint+committed-suffix state — so
reprocessing them is exactly-once, not at-least-once.

Imports of ``repro_torch.core.pipeline`` are lazy (inside functions):
``pipeline`` imports ``repro_torch.durability.faults``, which initializes
this package — a module-level import back into ``pipeline`` would cycle.
"""
from __future__ import annotations

import contextlib
import copy
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.durability.journal import DurabilityJournal

_EMPTY_MARKS: Dict[str, Any] = {"chunk_seq": 0, "broker_lengths": {}}


class RecoveryCoordinator:
    """Checkpoint scheduling + restore against one journal. Thread-safe:
    ``checkpoint`` serializes under its own lock (concurrent callers
    queue; each step's incremental marks stay consistent)."""

    def __init__(self, journal: DurabilityJournal):
        self.journal = journal
        self._lock = threading.Lock()
        self._marks: Optional[Dict[str, Any]] = None   # cumulative, journaled
        # health-snapshot surface: how many steps this coordinator took,
        # when the last one landed (perf_counter — compare against "now"
        # for checkpoint age) and at which journal step
        self.checkpoints_taken = 0
        self.restores_done = 0
        self.last_checkpoint_at: Optional[float] = None
        self.last_checkpoint_step: Optional[int] = None

    def _current_marks(self) -> Dict[str, Any]:
        if self._marks is None:
            self._marks = self.journal.last_totals() or copy.deepcopy(
                _EMPTY_MARKS)
        return self._marks

    # ----------------------------------------------------------------- capture
    def capture(self, pipe, engine=None, extra_locks=(), abort=None
                ) -> Optional[Dict[str, Any]]:
        """One consistent snapshot of the data plane (see module doc).
        ``extra_locks`` are the live workers' commit locks — the caller
        (the concurrent cluster) supplies them in a FIXED sort order so
        two concurrent captures cannot deadlock; the sequential runtime
        passes none (nothing runs between its steps). ``abort``: asked
        once every lock is held; True returns None, no snapshot (the
        cluster's "a fault has tripped": a load stage that died between
        its warehouse load and its offset commit released its lock to a
        capture already waiting for it, and that state — loaded, not
        committed — must never be journaled)."""
        marks = self._current_marks()
        with contextlib.ExitStack() as stack:
            stack.enter_context(pipe.tracker.lock)
            for lk in extra_locks:
                stack.enter_context(lk)
            if abort is not None and abort():
                return None
            state: Dict[str, Any] = {
                "broker": pipe.queue.export_state(
                    since=marks.get("broker_lengths")),
                "warehouse": pipe.warehouse.export_state(
                    int(marks.get("chunk_seq", 0))),
                "serving": (engine.export_fold_state()
                            if engine is not None else None),
                "workers": {
                    w.name: {
                        "buffer": w.buffer.export_state(),
                        "dead_letter": w.dead_letter.export_state(),
                        "watermarks": {
                            "equipment": int(w.equipment.watermark),
                            "quality": int(w.quality.watermark),
                        },
                    } for w in pipe.workers},
                "listeners": {l.table.name: int(l.offset)
                              for l in pipe.tracker.listeners},
                "assignment": {
                    "n_partitions": int(pipe.assignment.n_partitions),
                    "owners": {str(p): o for p, o in
                               pipe.assignment.assignment.items()},
                },
            }
        return state

    def checkpoint(self, pipe, engine=None, extra_locks=(), abort=None
                   ) -> Optional[int]:
        """Capture + append one incremental journal step. Returns the
        step number, or None where ``abort`` stopped the capture (see
        ``capture``). The cumulative marks only advance after the step is
        durably renamed in — a crash mid-write leaves the marks (and the
        next checkpoint's increments) exactly where they were."""
        with self._lock:
            prev = copy.deepcopy(self._current_marks())
            state = self.capture(pipe, engine=engine,
                                 extra_locks=extra_locks, abort=abort)
            if state is None:
                return None
            totals = {
                "chunk_seq": int(state["warehouse"]["seq"]),
                "broker_lengths": {
                    topic: [int(n) for n in meta["lengths"]]
                    for topic, meta in state["broker"]["meta"].items()},
            }
            step = self.journal.append(state, totals, prev)
            self._marks = totals
            self.checkpoints_taken += 1
            self.last_checkpoint_at = time.perf_counter()
            self.last_checkpoint_step = step
            pipe.metrics.shard("coordinator").counter(
                "pipeline.checkpoints").inc()
            return step

    # ----------------------------------------------------------------- restore
    def restore(self, pipe, engine=None,
                state: Optional[Dict[str, Any]] = None
                ) -> Optional[Dict[str, Any]]:
        """Cold-restart restore into a FRESH pipeline (and optionally a
        fresh view engine). Returns an info dict — ``step``,
        ``commit_seq``, ``replayed_chunks`` (the serving suffix) — or
        None when the journal is empty (nothing to restore; the pipeline
        simply starts cold)."""
        if state is None:
            state = self.journal.load()
        if state is None:
            return None
        # 1. broker first: logs, compaction, routing epochs, committed
        #    offsets — everything below consults routing or offsets
        pipe.queue.restore_broker_state(state["broker"])
        # 2. warehouse BEFORE any serving attach (chunks land silently)
        pipe.warehouse.restore_state(state["warehouse"])
        # 3. extraction frontier
        for l in pipe.tracker.listeners:
            if l.table.name in state["listeners"]:
                l.offset = int(state["listeners"][l.table.name])
        # 4. partition ownership (business-key filters depend on it)
        asg = state["assignment"]
        if int(asg["n_partitions"]) > pipe.assignment.n_partitions:
            pipe.assignment.grow(int(asg["n_partitions"]))
        pipe.assignment.assignment = {int(p): o
                                      for p, o in asg["owners"].items()}
        pipe._apply_assignment()
        # 5. workers: late buffers, caches (re-dump from the restored
        #    compacted topics), then the checkpointed watermarks — the
        #    re-dump sets the watermark to the snapshot's max txn_time,
        #    which may cover master records the crashed process had not
        #    pumped yet; releasing late records against that watermark
        #    would diverge from the uninterrupted run
        for w in pipe.workers:
            ws = state["workers"].get(w.name)
            if ws is None:
                continue
            w.buffer = _restore_buffer(ws["buffer"], pipe.cfg.buffer_capacity)
            w.transformer.buffer = w.buffer
            # quarantined records' offsets are committed — losing the DLQ
            # across a restore would silently lose the records themselves
            w.dead_letter = _restore_dead_letter(ws.get("dead_letter"))
            w.reset_caches(pipe.master_topic_map, pipe.cfg.n_business_keys)
            w.equipment.watermark = int(ws["watermarks"]["equipment"])
            w.quality.watermark = int(ws["watermarks"]["quality"])
        # 6. serving: resume the checkpointed epoch, replay only the
        #    chunk-log suffix past it
        replayed = 0
        if engine is not None:
            serving = state.get("serving")
            folded = 0
            if serving is not None:
                engine.restore_fold_state(serving)
                folded = int(serving["deltas_folded"])
            replayed = int(state["warehouse"]["seq"]) - folded
            pipe.warehouse.attach_serving(engine, replay_from=folded)
        self._marks = copy.deepcopy(state["_totals"])
        self.restores_done += 1
        pipe.metrics.shard("coordinator").counter(
            "pipeline.restores").inc()
        return {"step": int(state["_step"]),
                "commit_seq": int(state["warehouse"]["seq"]),
                "replayed_chunks": replayed}


def recover_pipeline(cfg, source, journal: DurabilityJournal, *,
                     engine=None, join_depth: int = 1, device: str = "cuda",
                     fault=None, n_workers: int = 1
                     ) -> Tuple[Any, RecoveryCoordinator,
                                Optional[Dict[str, Any]]]:
    """Cold restart in one call: build a fresh ``DODETLPipeline`` shaped
    like the journaled one (same worker names — consumer groups derive
    from them, so the committed offsets must land on matching groups) and
    restore into it. Returns ``(pipeline, coordinator, info)``; ``info``
    is None when the journal was empty.

    ``device`` places the recovered pipeline's backend (``cfg.backend``,
    else torch): ``cuda`` unless the caller asks for the CPU. The journal
    holds host arrays only, so one written by either package, on either
    device, restores here.

    ``source`` is the surviving system of record (the CDC log outlives
    the ETL deployment — the paper's premise); ``cfg`` must match the
    crashed deployment's config. ``n_workers`` only applies when the
    journal is empty (a crash before the first checkpoint): a journaled
    state dictates the worker set, a cold start needs the caller to
    restate the deployment shape.
    """
    from repro_torch.core.pipeline import DODETLPipeline  # lazy: cycle
    coord = RecoveryCoordinator(journal)
    state = journal.load()
    names = sorted(state["workers"]) if state else None
    pipe = DODETLPipeline(cfg, source,
                          n_workers=(len(names) if names else n_workers),
                          join_depth=join_depth, fault=fault,
                          device=device)
    if names and [w.name for w in pipe.workers] != names:
        # recreate the journaled worker set (e.g. post-failover names)
        pipe.workers = [pipe._new_worker(n, join_depth) for n in names]
        pipe._apply_assignment()
    info = coord.restore(pipe, engine=engine, state=state) \
        if state is not None else None
    return pipe, coord, info


def _restore_buffer(state: Dict[str, Any], capacity: int):
    from repro_torch.core.buffer import OperationalMessageBuffer
    return OperationalMessageBuffer.restore(state, capacity)


def _restore_dead_letter(state: Optional[Dict[str, Any]]):
    from repro_torch.core.buffer import DeadLetterBuffer
    return DeadLetterBuffer.restore(state)
