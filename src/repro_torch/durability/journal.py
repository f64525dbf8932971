"""Durability journal: the data plane's incremental checkpoint log.

One ``append`` writes one ``step_N`` directory through
``repro_torch.train.checkpoint.save`` — atomic tmp-dir + fsync + rename,
with a sha256 per leaf — so a torn write can never be mistaken for a
valid step. A step carries:

* the NEW broker records per (topic, partition) since the previous step
  (one concatenated column set per partition — safe because master-topic
  compaction is last-writer-wins by txn_time, associative over
  concatenation) and the NEW warehouse chunks (the commit-log suffix);
* the FULL small state every step: committed offsets, routing tables +
  live history horizons, publish/key-load counters, listener offsets,
  late buffers, per-worker cache watermarks, serving fold state,
  partition assignment, warehouse counters. Re-writing these is cheap
  (KBs) and makes every step self-describing for that state;
* a chain record: the previous step's totals (warehouse commit seq,
  per-partition broker lengths). ``load`` verifies the chain, so a step
  whose predecessor was lost is detected, not silently replayed over a
  gap.

Monotone int64 leaf columns (lsn, txn_time) are delta-encoded before the
write — ``np.diff`` + int32 downcast, the ``train/compression.py``
delta-coding idiom applied to the chunk-log suffix — which halves the
dominant leaves in the (uncompressed) npz container.

``load`` walks steps oldest-first, validating every leaf checksum. Torn
or corrupt steps at the TAIL are pruned (the crash window: nothing after
them can exist); corruption in the MIDDLE of the chain raises — the
journal is then not a consistent prefix and silently skipping would
violate exactly-once.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.durability.faults import (CHECKPOINT_MID_WRITE,
                                           FaultInjector, NULL_INJECTOR)
from repro_torch.observability.registry import global_registry
from repro_torch.train import checkpoint as ckpt

_JOURNAL_SEQ = itertools.count()

_LEAF = "__leaf__"      # placeholder key marking an extracted array leaf


def _delta_encode(a: np.ndarray) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Delta-encode a 1-D int64 array when the diffs fit int32 (monotone
    LSN/txn columns always do); otherwise store raw. Exact roundtrip."""
    if a.ndim == 1 and a.dtype == np.int64 and len(a) >= 8:
        d = np.diff(a)
        if len(d) and np.abs(d).max() < (1 << 31):
            return d.astype(np.int32), {"enc": "d32", "first": int(a[0]),
                                        "n": int(len(a))}
        if not len(d):
            return d.astype(np.int32), {"enc": "d32", "first": int(a[0]),
                                        "n": int(len(a))}
    return a, {"enc": "raw"}


def _delta_decode(leaf: np.ndarray, meta: Dict[str, Any]) -> np.ndarray:
    if meta.get("enc") != "d32":
        return leaf
    out = np.empty(meta["n"], np.int64)
    out[0] = meta["first"]
    if meta["n"] > 1:
        out[1:] = meta["first"] + np.cumsum(leaf.astype(np.int64))
    return out


def _extract_leaves(node, leaves: List[np.ndarray]):
    """Replace every ndarray in a nested dict/list structure with a
    ``{_LEAF: index, ...enc meta}`` placeholder, collecting the (possibly
    delta-encoded) arrays into ``leaves``. Scalars/str/None pass through
    as JSON."""
    if isinstance(node, np.ndarray):
        enc, meta = _delta_encode(node)
        idx = len(leaves)
        leaves.append(enc)
        return {_LEAF: idx, **meta}
    if isinstance(node, dict):
        return {k: _extract_leaves(v, leaves) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_extract_leaves(v, leaves) for v in node]
    if isinstance(node, (np.integer,)):
        return int(node)
    if isinstance(node, (np.floating,)):
        return float(node)
    return node


def _collect_leaf_ids(node, out: set):
    """Leaf indices reachable from a layout subtree (placeholders only)."""
    if isinstance(node, dict):
        if _LEAF in node:
            out.add(node[_LEAF])
            return
        for v in node.values():
            _collect_leaf_ids(v, out)
    elif isinstance(node, list):
        for v in node:
            _collect_leaf_ids(v, out)


def _inject_leaves(node, leaves: List[np.ndarray]):
    if isinstance(node, dict):
        if _LEAF in node:
            leaf = leaves[node[_LEAF]]
            return None if leaf is None else _delta_decode(leaf, node)
        return {k: _inject_leaves(v, leaves) for k, v in node.items()}
    if isinstance(node, list):
        return [_inject_leaves(v, leaves) for v in node]
    return node


class DurabilityJournal:
    """Append-only directory of checkpoint steps (``step_0``, ``step_1``,
    ...). Thread-compatible: one checkpointer appends at a time (the
    RecoveryCoordinator serializes appends under its own lock)."""

    def __init__(self, root: str, fault: FaultInjector = NULL_INJECTOR):
        self.root = str(root)
        self.fault = fault
        os.makedirs(self.root, exist_ok=True)
        # one registry shard per journal INSTANCE (same idiom as compute
        # backends): per-instance values stay isolated, merged reads sum
        # process-wide journal activity
        shard = global_registry().shard(f"journal#{next(_JOURNAL_SEQ)}")
        self.metrics = shard
        self._c_steps = shard.counter("journal.steps_appended")
        self._c_loads = shard.counter("journal.loads")
        self._c_pruned = shard.counter("journal.steps_pruned")

    # ------------------------------------------------------------------ write
    def steps(self) -> List[int]:
        return ckpt.step_numbers(self.root)

    def _dir_for(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def append(self, state: Dict[str, Any],
               totals: Dict[str, Any], prev: Dict[str, Any]) -> int:
        """Write one incremental step. ``state`` is the captured nested
        dict (arrays anywhere); ``totals`` are the post-step cumulative
        marks (chunk seq, broker lengths); ``prev`` the pre-step marks —
        the chain link ``load`` validates. Returns the step number."""
        steps = self.steps()
        step = (steps[-1] + 1) if steps else 0
        leaves: List[np.ndarray] = []
        layout = _extract_leaves(state, leaves)
        extra = {"layout": layout, "totals": totals, "prev": prev}
        fault = self.fault
        ckpt.save(self._dir_for(step), step, leaves, extra,
                  pre_commit=lambda: fault.trip(CHECKPOINT_MID_WRITE))
        self._c_steps.inc()
        return step

    def last_totals(self) -> Optional[Dict[str, Any]]:
        """Cumulative marks as of the newest complete step (manifest
        extras only — a step dir is only visible post-rename, so its
        manifest is always whole)."""
        for step in reversed(self.steps()):
            try:
                with open(os.path.join(self._dir_for(step),
                                       "manifest.json")) as f:
                    return json.load(f)["extra"]["totals"]
            except (OSError, KeyError, json.JSONDecodeError):
                continue
        return None

    # ------------------------------------------------------------------- read
    def load(self) -> Optional[Dict[str, Any]]:
        """Reassemble the accumulated state from every valid step.

        Returns None for an empty journal. The result is the LAST step's
        small state plus the across-step concatenation of broker segments
        (per topic/partition, in step order) and warehouse chunks, with
        ``_totals`` (cumulative marks) and ``_step`` (newest step number)
        attached. Tail corruption prunes; mid-chain corruption raises."""
        ckpt.sweep_tmp(self.root)        # crash leftovers are never valid
        steps = self.steps()
        if not steps:
            return None
        restored: List[Tuple[int, Dict[str, Any], Dict[str, Any]]] = []
        failed_at: Optional[int] = None
        for s in steps:
            try:
                # non-final steps: only their broker segments and
                # warehouse chunks are consumed downstream — restore just
                # those leaves (the final step's FULL small state is what
                # the recovered pipeline resumes from). Skipped leaves
                # are never validated, but never read either; structural
                # corruption (a torn zip) still raises here.
                only = None
                if s != steps[-1]:
                    with open(os.path.join(self._dir_for(s),
                                           "manifest.json")) as f:
                        layout = json.load(f)["extra"]["layout"]
                    only = set()
                    _collect_leaf_ids(layout["broker"]["segments"], only)
                    _collect_leaf_ids(layout["warehouse"]["chunks"], only)
                _, leaves, extra = ckpt.restore(self._dir_for(s),
                                                only=only)
            except Exception:
                failed_at = s
                break
            restored.append((s, _inject_leaves(extra["layout"], leaves),
                             extra))
        if failed_at is not None:
            later = [s for s in steps if s > failed_at]
            if later:
                raise IOError(
                    f"journal step {failed_at} corrupt with later steps "
                    f"{later} present: not a consistent prefix")
            # tail crash: drop the torn step, recover from the prefix
            shutil.rmtree(self._dir_for(failed_at), ignore_errors=True)
            self._c_pruned.inc()
        self._c_loads.inc()
        if not restored:
            return None
        # chain validation + accumulation
        segments: Dict[str, Dict[int, List[Dict[str, np.ndarray]]]] = {}
        chunks: List[np.ndarray] = []
        expected = {"chunk_seq": 0, "broker_lengths": {}}
        for s, state, extra in restored:
            prev = extra["prev"]
            if prev["chunk_seq"] != expected["chunk_seq"]:
                raise IOError(
                    f"journal chain broken at step {s}: expects chunk seq "
                    f"{prev['chunk_seq']}, accumulated "
                    f"{expected['chunk_seq']}")
            for topic, seg in state["broker"]["segments"].items():
                for p_str, cols in seg.items():
                    if cols is None or not len(cols.get("row_key", ())):
                        continue
                    segments.setdefault(topic, {}).setdefault(
                        int(p_str), []).append(cols)
            chunks.extend(state["warehouse"]["chunks"])
            expected = extra["totals"]
        last = restored[-1][1]
        last["broker"]["segments"] = segments
        last["warehouse"]["chunks"] = chunks
        last["_totals"] = restored[-1][2]["totals"]
        last["_step"] = restored[-1][0]
        return last
