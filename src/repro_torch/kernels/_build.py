"""Build the CUDA sources of ``repro_torch.kernels``, load them, and check
the wrappers' arguments and launch results.

Each kernel package's ``csrc/`` holds one or more ``.cu`` sources (and
the ``.cuh`` headers they share); each source exposes a plain C launch
function (pointers and sizes in, ``cudaError_t`` out), so it compiles with
``nvcc`` alone in seconds — no PyTorch headers — and binds through
``ctypes``. All ``.cu`` files of one ``csrc/`` link into that package's one
shared library, in ``build/repro_torch/`` at the repository root, named by
a hash of every file under ``csrc/`` and the flags: an edit to any source
or header rebuilds, an unchanged tree loads from the earlier build. All
missing libraries compile at once, one ``nvcc`` process each.

Nothing here runs at import time; the first CUDA launch of a wrapper in
``ops.py`` calls ``library``. ``on_cuda``, ``check`` and ``raise_on`` are
the argument and error checks every wrapper shares; ``no_graph_inputs``
and ``recompute_grads`` serve the LM kernels' autograd Functions; ``count_launch`` is the
one place a wrapper's launch counter moves, under a lock (the concurrent
runtime's stage threads launch at the same time).

``COUNTER`` is the work counter of a step under analysis
(``launch.step_analysis.analyze_step``) or None. The LM kernel wrappers
check it once per call; while it is set they run through
``counted_call``, which records the call's work by the kernel's own
formula (its ``ops.work``) and hides the ops inside the call from the
counter, whichever route runs: the launch, the plain version on the CPU,
or the ``meta`` route (outputs allocated, nothing launched).
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
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch"

# sm_90a: Hopper with its architecture-specific instructions; no
# --use_fast_math, so division and expf stay IEEE-accurate.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# -fmad=false keeps every multiply and add separately rounded, as the
# reference's numpy/XLA ops are: the ETL kernels are bitwise their plain
# versions. The LM kernels are held to a tolerance and keep FMA
# contraction.
BITWISE = ("-fmad=false",)

# kernel package -> its csrc/ directory
SOURCES: Dict[str, Path] = {name: _KERNELS / name / "csrc" for name in (
    "hash_join", "segment_kpi", "flash_attention", "gla_chunk")}
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {"hash_join": BITWISE,
                                           "segment_kpi": BITWISE}

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


def flags(name: str) -> Tuple[str, ...]:
    """The nvcc flags source ``name`` is built with."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def sources(name: str) -> Tuple[Path, ...]:
    """The ``.cu`` files that link into the library of ``name``."""
    return tuple(sorted(SOURCES[name].glob("*.cu")))


def lib_path(name: str) -> Path:
    """Where the library built from the current ``csrc/`` tree and flags
    of ``name`` lives."""
    h = hashlib.sha256(" ".join(flags(name)).encode())
    for f in sorted(p for p in SOURCES[name].rglob("*") if p.is_file()):
        h.update(f.relative_to(SOURCES[name]).as_posix().encode() + b"\0")
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all ``nvcc``
    processes started together. Returns the wall seconds spent. The
    compiler's register/shared-memory report goes to ``<lib>.log``."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in SOURCES:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        proc = subprocess.Popen([_nvcc(), *flags(name), "-o", str(tmp),
                                 *map(str, sources(name))], stdout=log,
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


def no_graph_inputs(op: str, fn: str, *tensors) -> None:
    """Raise when grad mode is on and one of ``tensors`` requires grad: a
    kernel writes its output through raw pointers, so that output would
    carry no gradient. ``fn`` names the differentiable entry point."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{op} has no gradient of its own: an input "
                           f"requires grad, call {fn} (its autograd "
                           f"Function) instead")


def recompute_grads(plain, saved, needs_grad, grad_outputs) -> list:
    """The backward of an LM kernel's autograd Function: run ``plain`` (the
    kernel's plain version) under autograd on detached copies of the saved
    inputs and return ``torch.autograd.grad`` of its outputs, one entry
    per saved input (None where ``needs_grad`` is false or the input
    is None)."""
    inputs = [None if t is None else t.detach().requires_grad_(bool(n))
              for t, n in zip(saved, needs_grad)]
    with torch.enable_grad():
        outs = plain(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    want = [i for i, (t, n) in enumerate(zip(inputs, needs_grad))
            if t is not None and n]
    pairs = [(o, g) for o, g in zip(outs, grad_outputs)
             if g is not None and o.requires_grad]
    grads = [None] * len(inputs)
    if want and pairs:
        got = torch.autograd.grad([o for o, _ in pairs],
                                  [inputs[i] for i in want],
                                  [g for _, g in pairs], allow_unused=True)
        for i, g in zip(want, got):
            grads[i] = g
    return grads


def recompute_scratch(key, plain, saved, needs_grad, grad_outputs) -> int:
    """The bytes ``recompute_grads(plain, saved, ...)`` holds at its peak
    beyond the gradients it returns (the plain version's activations and
    its backward's temporaries), measured once per ``key`` (the call's
    shapes and flags) and ``COUNTER`` by running it on ``meta`` copies
    under a ``StepCounter`` of its own: the scratch a backward's counted
    call reckons, the same on every device."""
    def meta(t):
        return None if t is None else torch.empty_like(t, device="meta")

    cache = COUNTER.recompute_scratch
    if key not in cache:
        from repro_torch.launch.step_analysis import StepCounter
        counter = StepCounter()
        with COUNTER.inside_kernel(), counter:
            grads = recompute_grads(plain, [meta(t) for t in saved],
                                    needs_grad,
                                    [meta(g) for g in grad_outputs])
        counter.close()
        out = sum(g.numel() * g.element_size() for g in grads
                  if g is not None)
        cache[key] = max(counter.peak - out, 0)
    return cache[key]


def raise_on(err: int, op: str) -> None:
    """Raise on the non-zero ``cudaError_t`` a launch function returned."""
    if err:
        raise RuntimeError(f"{op} kernel launch failed: cudaError {err}")


# guards every read-modify-write of the wrappers' ``launches`` dicts: a
# bare ``+= 1`` from two stage threads can lose a count
COUNT_LOCK = threading.Lock()


def count_launch(launches: Dict[str, int], *ops: str) -> None:
    """Add one to ``launches[op]`` for each of ``ops`` (called right after
    a launch succeeded; a design's own count moves with its wrapper's)."""
    with COUNT_LOCK:
        for op in ops:
            launches[op] += 1


# the work counter of a step under analysis, or None (set and cleared by
# ``launch.step_analysis.analyze_step``)
COUNTER = None


def stored_bytes(t: Optional[torch.Tensor]) -> int:
    """Bytes a tensor's storage holds for it: broadcast (zero-stride) axes
    count once; 0 for None."""
    if t is None:
        return 0
    n = 1
    for size, st in zip(t.shape, t.stride()):
        if st != 0:
            n *= size
    return n * t.element_size()


def counted_call(name: str, run: Callable, work: Callable,
                 scratch: int = 0):
    """``run()`` as one kernel call of ``COUNTER``: the ops inside it are
    not counted; ``work(outputs) -> (flops, bytes)`` is recorded for it,
    and its outputs (and ``scratch`` bytes, live only during the call)
    enter the counter's live bytes."""
    counter = COUNTER
    with counter.inside_kernel():
        out = run()
    flops, n_bytes = work(out)
    counter.record_kernel(name, flops, n_bytes, scratch, out)
    return out


def like(t: torch.Tensor, g: Optional[torch.Tensor]
         ) -> Optional[torch.Tensor]:
    """``g`` in the layout ``torch.empty_like(t)`` has (a copy where it
    differs): what a kernel route allocates, so that every route hands
    the same layout to the ops after it."""
    if g is None or g.stride() == torch.empty_like(t, device="meta").stride():
        return g
    return torch.empty_like(t).copy_(g)
