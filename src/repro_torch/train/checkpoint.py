"""Atomic checkpoint steps: the durability journal's flat leaf lists and
the trainer's parameter and optimizer trees, with rolling async saves.

The reference package's ``train/checkpoint.py`` file layout: a step
directory holds ``leaves.npz`` (``leaf_<i>`` per array) and
``manifest.json`` (step, leaf count, a structure string, per-leaf shape,
dtype and sha256 prefix, and the caller's ``extra``). Writes go to a tmp
dir, are fsynced, then renamed into place, so a torn write is never
mistaken for a valid step. Trees flatten in the reference's leaf order —
dict keys sorted, ``AdamWState`` (any tuple or list) in field order — so
either package restores the other's checkpoint.

A bf16 leaf is stored as the reference stores it: its 2-byte payload
(numpy writes an ``ml_dtypes`` bfloat16 array with descr ``|V2``) and
``"bfloat16"`` in the manifest. numpy cannot tell that payload's type on
load, so ``restore`` takes each leaf's dtype from ``tree_like`` (else
from the manifest) and views the payload as ``torch.bfloat16``.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# strict step-dir name: a crash mid-save leaves `step_N.tmp-<pid>-<ns>`
# siblings behind, which ALSO start with "step_"
_STEP_DIR = re.compile(r"^step_(\d+)$")
_BF16 = "bfloat16"


def flatten(tree) -> Tuple[list, str]:
    """(leaves, structure string) in the reference's order: dict keys
    sorted, tuples and lists (``AdamWState``) in order; any other object
    is a leaf. The string mimics the reference's ``str(treedef)``."""
    leaves: list = []

    def walk(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return f"{type(t).__name__}(" + ", ".join(
                f"{f}={walk(x)}" for f, x in zip(t._fields, t)) + ")"
        if isinstance(t, (list, tuple)):
            inner = ", ".join(walk(x) for x in t)
            return f"[{inner}]" if isinstance(t, list) else f"({inner})"
        leaves.append(t)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def unflatten(tree_like, leaves: list):
    """``tree_like``'s structure with ``leaves`` (``flatten``'s order)."""
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(fill(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(fill(x) for x in t)
        return next(it)

    return fill(tree_like)


def to_host(x) -> np.ndarray:
    """A host copy of a leaf (never a view: the caller may update the
    source in place right after). A bf16 tensor becomes its 2-byte payload
    (``|V2``), as the reference's bf16 arrays are stored."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.to("cpu", copy=True).numpy()
        return a.view("V2") if x.dtype == torch.bfloat16 else a
    return np.array(x, copy=True)


def _dtype_name(a: np.ndarray) -> str:
    """The manifest's dtype: a 2-byte payload is a bf16 leaf's."""
    return _BF16 if a.dtype == np.dtype("V2") else str(a.dtype)


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


def save(path: str, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None,
         pre_commit=None) -> str:
    """Atomic checkpoint write of a tree (a flat list of arrays is one).
    Returns the final directory.

    ``pre_commit``, if given, runs after the tmp dir is fully written and
    fsynced but BEFORE the atomic rename — the seam where a crash leaves a
    complete-but-invisible checkpoint (the fault injector's
    ``checkpoint.mid_write`` point)."""
    leaves, treedef = flatten(tree)
    host_leaves = [to_host(x) if isinstance(x, torch.Tensor)
                   else np.asarray(x) for x in leaves]
    tmp = f"{path}.tmp-{os.getpid()}-{time.time_ns()}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": int(step), "n_leaves": len(host_leaves),
                "treedef": treedef, "leaves": [], "extra": extra or {}}
    with open(os.path.join(tmp, "leaves.npz"), "wb") as f:
        np.savez(f, **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
        f.flush()
        os.fsync(f.fileno())
    for i, a in enumerate(host_leaves):
        manifest["leaves"].append({
            "i": i, "shape": list(a.shape), "dtype": _dtype_name(a),
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


def _as_tensor(a: np.ndarray, like, dtype_name: str) -> torch.Tensor:
    """A loaded leaf as a tensor of ``like``'s dtype and device (a 2-byte
    payload read as bf16 where ``like`` or the manifest says so)."""
    want = like.dtype if isinstance(like, torch.Tensor) else None
    if want == torch.bfloat16 or (want is None and dtype_name == _BF16):
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if isinstance(like, torch.Tensor):
        if tuple(t.shape) != tuple(like.shape):
            raise IOError(f"checkpoint leaf of shape {tuple(t.shape)}, "
                          f"expected {tuple(like.shape)}")
        t = t.to(device=like.device, dtype=like.dtype)
    return t


def restore(path: str, tree_like: Any = None, only=None
            ) -> Tuple[int, Any, Dict[str, Any]]:
    """Read one step, validating every read leaf's checksum (raises
    ``IOError`` on corruption; a torn zip raises from ``np.load``).
    Returns ``(step, leaves or tree, extra)``.

    ``tree_like`` None: the flat leaf LIST as saved, numpy arrays (the
    journal's mode). Else a tree of ``tree_like``'s structure whose leaves
    are tensors of its leaves' dtypes on their devices.

    ``only`` (flat-list mode only): an index set — leaves outside it are
    returned as None without being read or validated (the journal skips
    the dead small-state leaves of non-final steps this way)."""
    if only is not None and tree_like is not None:
        raise ValueError("partial restore is a flat-list-mode feature")
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
    if tree_like is None:
        return manifest["step"], leaves, manifest.get("extra", {})
    like, _ = flatten(tree_like)
    if len(like) != len(leaves):
        raise IOError(f"checkpoint has {len(leaves)} leaves, expected "
                      f"{len(like)}")
    tensors = [_as_tensor(a, ref, rec["dtype"]) for a, ref, rec in
               zip(leaves, like, manifest["leaves"])]
    return manifest["step"], unflatten(tree_like, tensors), \
        manifest.get("extra", {})


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


class CheckpointManager:
    """Rolling checkpoints of a train state under ``root``: ``step_<n>``
    directories, the newest ``keep_last`` kept, saved synchronously or on
    a background thread."""

    def __init__(self, root: str, keep_last: int = 3):
        self.root = root
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(root, exist_ok=True)

    def dir_for(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def save_sync(self, step: int, tree: Any,
                  extra: Optional[Dict[str, Any]] = None) -> str:
        out = save(self.dir_for(step), step, tree, extra)
        self._gc()
        return out

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot ``tree`` to host copies now (the next train step
        updates the parameters in place), then write on a thread."""
        self.wait()
        leaves, _ = flatten(tree)
        host = unflatten(tree, [to_host(x) for x in leaves])

        def work():
            try:
                save(self.dir_for(step), step, host, extra)
                self._gc()
            except Exception as e:          # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the background write, re-raising its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, tree_like: Any = None
                       ) -> Optional[Tuple[int, Any, Dict[str, Any]]]:
        """Restore the newest valid checkpoint, falling back past torn or
        corrupt ones (truncated leaves, checksum mismatches) to the newest
        step that verifies. Returns None when nothing restorable exists."""
        self.wait()
        for step in reversed(step_numbers(self.root)):
            try:
                return restore(self.dir_for(step), tree_like)
            except Exception:        # torn/corrupt (a truncated npz raises
                continue             # BadZipFile): try the previous step
        return None

    def _gc(self) -> None:
        for s in step_numbers(self.root)[:-self.keep_last]:
            shutil.rmtree(self.dir_for(s), ignore_errors=True)
