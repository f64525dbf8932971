"""Build the CUDA sources of ``repro_torch.kernels``, load them, and check
the wrappers' arguments and launch results.

Each source under ``kernels/*/csrc/`` exposes a plain C launch function
(pointers and sizes in, ``cudaError_t`` out), so it compiles with ``nvcc``
alone in seconds — no PyTorch headers — and binds through ``ctypes``. The
shared libraries land in ``build/repro_torch/`` at the repository root,
named by a hash of the source and the flags: an edited source rebuilds, an
unchanged one loads from the earlier build. All missing sources compile
at once, one ``nvcc`` process each.

Nothing here runs at import time; the first CUDA launch of a wrapper in
``ops.py`` calls ``library``. ``on_cuda``, ``check`` and ``raise_on`` are
the argument and error checks every wrapper shares.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch"

# sm_90a: Hopper with its architecture-specific instructions. -fmad=false
# keeps every multiply and add separately rounded, as the reference's
# numpy/XLA ops are; no --use_fast_math, so division stays IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

SOURCES: Dict[str, Path] = {
    "hash_join": _KERNELS / "hash_join" / "csrc" / "hash_join.cu",
    "segment_kpi": _KERNELS / "segment_kpi" / "csrc" / "segment_kpi.cu",
}

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on "
                           "PATH or set CUDA_HOME")
    return str(path)


def lib_path(name: str) -> Path:
    """Where the library built from the current source of ``name`` lives."""
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all ``nvcc``
    processes started together. Returns the wall seconds spent. The
    compiler's register/shared-memory report goes to ``<lib>.log``."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, src in SOURCES.items():
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=log,
                                stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, out, log))
    failed = []
    for name, proc, tmp, out, log in jobs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (rc {rc}, see {out.with_suffix('.log')})")
    if failed:
        raise RuntimeError("nvcc failed: " + ", ".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel package ``name``, built first if
    needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build_all()
            lib = _LOADED[name] = ctypes.CDLL(str(path))
        return lib


def on_cuda(t: torch.Tensor, op: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{op} runs on cpu or cuda, not {t.device}")
    return True


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: Sequence[Optional[int]], device: torch.device) -> None:
    """Raise unless ``t`` lies on ``device`` with ``dtype``, is contiguous
    and has ``shape`` (a ``None`` entry matches any size)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple('*' if s is None else s for s in shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on(err: int, op: str) -> None:
    """Raise on the non-zero ``cudaError_t`` a launch function returned."""
    if err:
        raise RuntimeError(f"{op} kernel launch failed: cudaError {err}")
