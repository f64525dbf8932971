"""Work, traffic and memory of one eager step, counted op by op: the
port's counterpart of the JAX package's ``launch/hlo_analysis.py``.

The JAX package compiles a step and parses the partitioned HLO. An eager
PyTorch step has no HLO: ``analyze_step`` runs it once under one
``TorchDispatchMode`` and counts each aten op it dispatches, on any
device — ``meta`` tensors for the dry run (nothing allocated, no card),
CPU or CUDA tensors to hold the count against a real run.

  * operations: outside a kernel call, ``torch.utils.flop_counter``'s
    formulas (matmuls, convolutions, attention ops: 2 per multiply-add,
    as HLO dot flops are counted); an LM kernel call (``flash_attention``,
    ``gla_chunk`` and their autograd Functions' backwards) counts its
    wrapper's ``work`` formula, and the ops its route runs inside the call
    (the plain version on the CPU, the outputs' allocation on the card and
    on ``meta``) are not counted again;
  * bytes: the inputs plus the outputs of every non-view op outside the
    kernels (broadcast axes once), plus the kernels' bytes. Eager PyTorch
    materializes every op's output, so each op is a boundary: the
    counterpart of HLO's materialization boundaries. An in-place op's
    destination counts as read and as written;
  * peak live bytes: every storage the step's arguments hold, and every
    storage an op allocates while it lives (a kernel call's outputs, and
    its scratch during the call, by its formula) — the JAX package's
    argument + output + temp split of ``memory_analysis``;
  * collectives: the step's plan (``train/manual_dp.py``'s
    ``collective_plan``, ``launch/dryrun.py``'s ``model_axis_plan``), as
    the JAX package reports them, with its ring multipliers over each
    one's group. A collective a real run issues (``c10d`` ops) is neither
    an operation nor bytes here: it is the plan's.

``roofline_terms`` keeps the JAX function's signature and keys with an
H100 SXM's constants. Nothing here imports a CUDA module.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build
from repro_torch.kernels._build import stored_bytes

# H100 SXM (per card)
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                  # B/s, HBM3
LINK_BW = 450e9                   # B/s, NVLink 4, each direction
CARD_BYTES = 80 * 2**30           # device memory

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all")

_aten = torch.ops.aten
# ops that move no data: allocation, a host scalar, and a view whose
# schema does not say so; and the metadata queries a mode may be asked
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.new_empty.default,
         _aten.new_empty_strided.default, _aten._unsafe_view.default,
         _aten._local_scalar_dense.default}
_META_QUERIES = {_aten.sym_is_contiguous.default, _aten.is_contiguous.default,
                 _aten.is_contiguous.memory_format,
                 _aten.is_strides_like_format.default,
                 _aten.is_non_overlapping_and_dense.default,
                 _aten.size.default, _aten.sym_size.default,
                 _aten.stride.default, _aten.sym_stride.default,
                 _aten.storage_offset.default,
                 _aten.sym_storage_offset.default, _aten.numel.default,
                 _aten.sym_numel.default, _aten.dim.default,
                 torch.ops.prim.layout.default}
_VIEW: Dict[Any, bool] = {}


def _moves_nothing(func) -> bool:
    """Whether ``func`` moves no data: a view (it returns an alias of an
    input without writing it) or one of ``_FREE``."""
    got = _VIEW.get(func)
    if got is None:
        got = _VIEW[func] = func in _FREE or any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns)
    return got


def _tensors(tree) -> Iterable[torch.Tensor]:
    """The tensors of nested tuples, lists and dicts (NamedTuples too)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _wire_multiplier(kind: str, n: int) -> float:
    """Per-device ring wire bytes as a multiple of the RESULT size (the
    JAX package's ``hlo_analysis._wire_multiplier``)."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind == "all-gather":
        return (n - 1) / n          # result is the gathered buffer
    if kind == "reduce-scatter":
        return float(n - 1)         # result is the local shard
    if kind == "all-to-all":
        return (n - 1) / n          # all but the piece a rank keeps
    return 1.0


def collective_summary(issued: List[Dict[str, Any]], world: int
                       ) -> Dict[str, Dict[str, float]]:
    """Collectives in the JAX package's format: per kind the count, the
    result bytes, the ring wire bytes per device and the largest group
    (a collective's ``group`` size where it names one, else ``world``)."""
    out: Dict[str, Dict[str, float]] = {}
    for c in issued:
        n = c.get("group", world)
        rec = out.setdefault(c["kind"], {"count": 0, "result_bytes": 0.0,
                                         "wire_bytes": 0.0, "max_group": 0})
        rec["count"] += 1
        rec["result_bytes"] += c["result_bytes"]
        rec["wire_bytes"] += c["result_bytes"] * _wire_multiplier(
            c["kind"], n)
        rec["max_group"] = max(rec["max_group"], n)
    return out


class StepCounter(TorchDispatchMode):
    """Counts operations and bytes of every op dispatched under it, and
    the live bytes of the storages the step holds (see the module's
    docstring). The LM kernel wrappers report their calls through
    ``inside_kernel`` and ``record_kernel`` (``kernels/_build.py``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.op_flops: Dict[str, int] = defaultdict(int)
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.depth = 0
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}
        self._finalizers: List[weakref.finalize] = []
        self._lock = threading.Lock()
        # an LM kernel backward's recompute scratch per call shape
        # (``kernels._build.recompute_scratch``)
        self.recompute_scratch: Dict[tuple, int] = {}

    # ------------------------------------------------------------ memory
    def track(self, t: torch.Tensor, n_bytes: Optional[int] = None) -> None:
        """Count ``t``'s storage as live until it is freed (once per
        storage; ``n_bytes`` defaults to the storage's size)."""
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            if key in self._held:
                return
            n = st.nbytes() if n_bytes is None else n_bytes
            self._held[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
        self._finalizers.append(weakref.finalize(st, self._free, key))

    def _free(self, key: int) -> None:
        with self._lock:
            self.live -= self._held.pop(key, 0)

    def close(self) -> None:
        """Stop following the storages that are still live."""
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()

    # ----------------------------------------------------------- kernels
    @contextlib.contextmanager
    def inside_kernel(self):
        """Ops dispatched inside are neither counted nor tracked: they run
        with the dispatch modes set aside, so that a plain version's
        thousands of ops (a kernel backward's recompute) cost no Python
        dispatch each."""
        self.depth += 1
        try:
            with _disable_current_modes():
                yield
        finally:
            self.depth -= 1

    def record_kernel(self, name: str, flops: int, n_bytes: int,
                      scratch: int, out) -> None:
        """One kernel call: its formula's operations and bytes; its
        outputs live from now on, its scratch only during the call."""
        rec = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                             "bytes": 0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += n_bytes
        self.flops += flops
        self.bytes += n_bytes
        outs = [t for t in _tensors(out)]
        new = sum(t.numel() * t.element_size() for t in outs)
        with self._lock:
            self.peak = max(self.peak, self.live + new + scratch)
        for t in outs:
            self.track(t, t.numel() * t.element_size())

    # --------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META_QUERIES:
            return NotImplemented
        if self.depth or func.namespace == "c10d":
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry:
            # as FlopCounterMode: count what an op decomposes into
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        for t in outs:
            self.track(t)
        if _moves_nothing(func):
            return out
        self.ops += 1
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            self.op_flops[str(packet)] += f
        self.bytes += (sum(stored_bytes(t) for t in _tensors((args, kwargs)))
                       + sum(stored_bytes(t) for t in outs))
        return out


def analyze_step(fn, *args, collectives: Optional[List[Dict]] = None,
                 world: int = 1, **kwargs) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(*args, **kwargs)`` once under a ``StepCounter`` (and as
    ``kernels._build.COUNTER``). Returns (fn's result, the analysis):
    ``flops`` and ``bytes`` (per device), the part outside the kernels,
    each kernel's calls, operations and bytes, operations per aten op,
    ``memory`` (argument, output and temporary bytes and
    ``peak_estimate_bytes``) and ``collectives`` (``collective_summary``
    of ``collectives``, the plan of the step's collectives, at ``world``
    ranks)."""
    if _build.COUNTER is not None:
        raise RuntimeError("a step is already under analysis")
    counter = StepCounter()
    for t in _tensors((args, kwargs)):
        counter.track(t)
    arguments = counter.live
    _build.COUNTER = counter
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        _build.COUNTER = None
    # the result's storages the step allocated (not its arguments')
    new = ({t.untyped_storage()._cdata for t in _tensors(out)}
           - {t.untyped_storage()._cdata for t in _tensors((args, kwargs))})
    output = sum(counter._held.get(key, 0) for key in new)
    counter.close()
    k_flops = sum(r["flops"] for r in counter.kernels.values())
    k_bytes = sum(r["bytes"] for r in counter.kernels.values())
    analysis = {
        "flops": counter.flops, "bytes": counter.bytes, "ops": counter.ops,
        "flops_outside_kernels": counter.flops - k_flops,
        "bytes_outside_kernels": counter.bytes - k_bytes,
        "kernels": counter.kernels,
        "op_flops": dict(counter.op_flops),
        "memory": {
            "argument_size_in_bytes": arguments,
            "output_size_in_bytes": output,
            "temp_size_in_bytes": max(counter.peak - arguments - output, 0),
            "alias_size_in_bytes": 0,
            "peak_estimate_bytes": counter.peak},
        "collectives": collective_summary(collectives or [], world),
    }
    return out, analysis


def roofline_terms(*, global_flops: float, device_bytes: float,
                   collective_wire_bytes: float, n_chips: int
                   ) -> Dict[str, object]:
    """Three roofline terms in seconds per step (per-card denominators),
    the JAX package's ``hlo_analysis.roofline_terms`` with an H100 SXM's
    dense bf16 peak, HBM3 rate and NVLink rate per direction."""
    t_compute = global_flops / (n_chips * PEAK_FLOPS_BF16)
    t_memory = device_bytes / HBM_BW
    t_collective = collective_wire_bytes / LINK_BW
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_collective)), key=lambda kv: kv[1])[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "bound_s": max(t_compute, t_memory, t_collective),
    }
