"""Atomic checkpoint steps for the durability journal.

The part of the reference package's train checkpoint that the journal
uses, in the same file layout: a step directory holds ``leaves.npz``
(``leaf_<i>`` per array) and ``manifest.json`` (step, leaf count, the
flat-list structure string, per-leaf shape, dtype and sha256 prefix, and
the caller's ``extra``). Writes go to a tmp dir, are fsynced, then renamed
into place, so a torn write is never mistaken for a valid step. The
journal only ever checkpoints a FLAT LIST of host arrays (its tree layout
travels in ``extra``), so no pytree library is needed; a journal written
by either package loads in the other.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# strict step-dir name: a crash mid-save leaves `step_N.tmp-<pid>-<ns>`
# siblings behind, which ALSO start with "step_"
_STEP_DIR = re.compile(r"^step_(\d+)$")


def _flat_treedef(n: int) -> str:
    """The structure string of a flat list of ``n`` leaves, as the
    reference writes it."""
    return "PyTreeDef([" + ", ".join(["*"] * n) + "])"


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:                      # platform without dir-fd fsync
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save(path: str, step: int, leaves: Sequence[Any],
         extra: Optional[Dict[str, Any]] = None,
         pre_commit=None) -> str:
    """Atomic checkpoint write of a flat list of arrays. Returns the final
    directory.

    ``pre_commit``, if given, runs after the tmp dir is fully written and
    fsynced but BEFORE the atomic rename — the seam where a crash leaves a
    complete-but-invisible checkpoint (the fault injector's
    ``checkpoint.mid_write`` point)."""
    if not isinstance(leaves, (list, tuple)):
        raise TypeError("save takes a flat list of arrays")
    host_leaves = [np.asarray(x) for x in leaves]
    tmp = f"{path}.tmp-{os.getpid()}-{time.time_ns()}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": int(step), "n_leaves": len(host_leaves),
                "treedef": _flat_treedef(len(host_leaves)), "leaves": [],
                "extra": extra or {}}
    with open(os.path.join(tmp, "leaves.npz"), "wb") as f:
        np.savez(f, **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
        f.flush()
        os.fsync(f.fileno())
    for i, a in enumerate(host_leaves):
        manifest["leaves"].append({
            "i": i, "shape": list(a.shape), "dtype": str(a.dtype),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()[:16],
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if pre_commit is not None:
        pre_commit()
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")
    return path


def restore(path: str, only=None
            ) -> Tuple[int, List[Optional[np.ndarray]], Dict[str, Any]]:
    """Read one step as the flat leaf LIST it was saved as, validating
    every read leaf's checksum (raises ``IOError`` on corruption; a torn
    zip raises from ``np.load``). Returns ``(step, leaves, extra)``.

    ``only``: an index set — leaves outside it are returned as None
    without being read or validated (the journal skips the dead
    small-state leaves of non-final steps this way)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    wanted = None if only is None else set(only)
    leaves: List[Optional[np.ndarray]] = []
    with np.load(os.path.join(path, "leaves.npz")) as data:
        for rec in manifest["leaves"]:
            if wanted is not None and rec["i"] not in wanted:
                leaves.append(None)
                continue
            a = data[f"leaf_{rec['i']}"]
            digest = hashlib.sha256(a.tobytes()).hexdigest()[:16]
            if digest != rec["sha256"]:
                raise IOError(f"checkpoint leaf {rec['i']} checksum "
                              "mismatch")
            leaves.append(a)
    if len(leaves) != manifest["n_leaves"]:
        raise IOError(f"checkpoint has {len(leaves)} leaves, manifest "
                      f"says {manifest['n_leaves']}")
    return manifest["step"], leaves, manifest.get("extra", {})


def step_numbers(root: str) -> List[int]:
    """Sorted step numbers of every complete (renamed-into-place) step dir
    under ``root``; tmp leftovers and stray files are ignored."""
    if not os.path.isdir(root):
        return []
    steps = []
    for d in os.listdir(root):
        m = _STEP_DIR.match(d)
        if m and os.path.exists(os.path.join(root, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def sweep_tmp(root: str) -> int:
    """Remove crash leftovers: `*.tmp-*` dirs from saves that never reached
    their rename. Returns the number removed."""
    if not os.path.isdir(root):
        return 0
    n = 0
    for d in os.listdir(root):
        if ".tmp-" in d:
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)
            n += 1
    return n


def latest_step(root: str) -> Optional[int]:
    steps = step_numbers(root)
    return steps[-1] if steps else None
