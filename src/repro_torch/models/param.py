"""Parameter definition machinery.

Every parameter is declared once as a ``ParamDef`` carrying its shape, its
*logical* axis names and an init rule; one tree of ParamDefs (nested
dicts) gives the materialized parameters (``tree_init``), their
``meta``-tensor stand-ins (``tree_abstract``, what the dry run traces)
and the decode cache (``Model.init_cache``). The trees have the JAX package's structure
and leaf shapes, stacked ``[L, ...]`` layer axis included, so weights
carry across leaf for leaf (``models/convert.py``).

From the same tree and a ``models.sharding.ShardingCtx``: the
PartitionSpecs (``tree_specs``, the reference's function), one rank's
slices of a full tree (``shard_tree``), its local ParamDefs
(``local_defs``: the shapes the dry run allocates on ``meta``) and its
weights drawn directly (``tree_init(..., ctx)``: each full leaf drawn
in turn from the one generator and cut to the rank's slice, so every
rank holds the slices of the one full tree and no more than one full
leaf at a time). A ParamDef's ``parts`` describe how its head-axis dim
is packed (``sharding.Part``), so it is split by meaning; one marked
``read_by_heads`` is held whole although each rank reads only its
heads' channels of it, and one marked ``per_position`` is applied on
the residual position by position (partial gradients under sequence
parallelism).

Logical axis vocabulary (the reference's, mapped to mesh axes by
``models/sharding.py``'s rules):
  "vocab", "embed", "heads", "kv_heads", "head_dim", "ff", "ff_expert",
  "experts", "layers", "state", "batch", "seq", "kv_seq", None
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.models.sharding import NULL_CTX, Part, ShardingCtx

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
    parts: Optional[Tuple[Part, ...]] = None   # packing of the head dim
    # held whole on every rank, each rank of the model axis reading only
    # its heads' channels of the last dim (RWKV6's per-channel vectors):
    # a rank's gradient is partial, summed over the model axis once per
    # step (``ShardingCtx.sum_shared``)
    read_by_heads: bool = False
    # applied on the residual position by position (a norm's gain and
    # bias, attention's output bias, zamba2's fuse): under sequence
    # parallelism a rank applies it to its positions only, so its
    # gradient is partial, summed over the model axis once per step
    per_position: bool = False

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


def tree_paths(tree, prefix: str = "") -> list:
    """(path "a/b/c", leaf) pairs in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


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
    return _truncated_normal(defn.shape, generator).mul_(std).to(defn.dtype)


def tree_init(defs, generator: torch.Generator,
              ctx: ShardingCtx = NULL_CTX) -> Any:
    """Materialize a tree of ParamDefs on ``generator.device``, drawing the
    leaves in sorted-key order from the one generator (the JAX package
    draws from ``jax.random``, so the numbers differ: tests carry the
    reference's weights across with ``models/convert.py``). With a
    sharded ``ctx``, each leaf is cut to this rank's slice as it is drawn
    (the slices of the tree drawn without one)."""
    if isinstance(defs, dict):
        return {k: tree_init(defs[k], generator, ctx) for k in sorted(defs)}
    full = _materialize(defs, generator)
    local = ctx.shard(full, defs.axes, defs.parts)
    return full if local is full else local.clone()


def tree_abstract(defs) -> Any:
    """A tree of ``meta`` tensors of each ParamDef's shape and dtype: no
    memory, no values (the JAX package's ``ShapeDtypeStruct`` stand-ins,
    ``models/param.py:tree_abstract``)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), defs)


def tree_specs(defs, rules, mesh=None):
    """Logical-axis names -> a PartitionSpec (a tuple of mesh axes per
    dim) via the rule table, the reference's function: with ``mesh``
    given (anything with ``axis_names`` and ``shape``), a mesh axis is
    dropped for any dim *smaller* than the axis size."""
    ctx = ShardingCtx(mesh=mesh, rules=rules)
    return tree_map(lambda d: ctx.spec_for_shape(d.axes, d.shape)
                    if mesh is not None else ctx.spec(d.axes), defs)


def local_defs(defs, ctx: ShardingCtx):
    """The ParamDefs of this rank's slices (no ``parts``: they describe
    full leaves)."""
    return tree_map(lambda d: dataclasses.replace(
        d, shape=ctx.local_shape(d.axes, d.shape, d.parts), parts=None),
        defs)


def shard_tree(params, defs, ctx: ShardingCtx):
    """This rank's slices of a full tree ``params`` shaped as ``defs``
    (views where a slice is a contiguous range)."""
    return tree_map(lambda p, d: ctx.shard(p, d.axes, d.parts), params,
                    defs)


def count_params(defs) -> int:
    return int(sum(math.prod(d.shape) for d in tree_leaves(defs)))
