"""Parameter definition machinery.

Every parameter is declared once as a ``ParamDef`` carrying its shape, its
*logical* axis names and an init rule; one tree of ParamDefs (nested
dicts) gives the materialized parameters (``tree_init``) and the decode
cache (``Model.init_cache``). The trees have the JAX package's structure
and leaf shapes, stacked ``[L, ...]`` layer axis included, so weights
carry across leaf for leaf (``models/convert.py``).

Logical axis vocabulary (the reference's; the port shards nothing yet):
  "vocab", "embed", "heads", "kv_heads", "head_dim", "ff", "layers",
  "state", "batch", "seq", None
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

Shape = Tuple[int, ...]
Axes = Tuple[Optional[str], ...]

_TRUNC = 2.0                       # truncated normal on [-2, 2]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Shape
    axes: Axes
    init: str = "normal"      # "normal" | "zeros" | "ones"
    scale: float = 1.0
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the same
    structure, passed leaf by leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure whose leaves are ``leaves``, given in
    ``tree_leaves`` order (sorted keys)."""
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        return next(it)

    out = fill(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def _truncated_normal(shape: Shape, generator: torch.Generator
                      ) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], f32, on the generator's
    device: the inverse CDF of a uniform draw over [Phi(-2), Phi(2)]."""
    lo = math.erf(-_TRUNC / math.sqrt(2.0))
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    x.uniform_(lo, -lo, generator=generator)
    return x.erfinv_().mul_(math.sqrt(2.0)).clamp_(-_TRUNC, _TRUNC)


def _materialize(defn: ParamDef, generator: torch.Generator) -> torch.Tensor:
    dev = generator.device
    if defn.init == "zeros":
        return torch.zeros(defn.shape, dtype=defn.dtype, device=dev)
    if defn.init == "ones":
        return torch.ones(defn.shape, dtype=defn.dtype, device=dev)
    # truncated-normal fan-in scaling
    fan_in = defn.shape[-2] if len(defn.shape) >= 2 else defn.shape[-1]
    std = defn.scale / math.sqrt(max(fan_in, 1))
    return (_truncated_normal(defn.shape, generator) * std).to(defn.dtype)


def tree_init(defs, generator: torch.Generator) -> Any:
    """Materialize a tree of ParamDefs on ``generator.device``, drawing the
    leaves in sorted-key order from the one generator (the JAX package
    draws from ``jax.random``, so the numbers differ: tests carry the
    reference's weights across with ``models/convert.py``)."""
    if isinstance(defs, dict):
        return {k: tree_init(defs[k], generator) for k in sorted(defs)}
    return _materialize(defs, generator)


def count_params(defs) -> int:
    return int(sum(math.prod(d.shape) for d in tree_leaves(defs)))
