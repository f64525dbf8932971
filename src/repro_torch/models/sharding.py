"""Sharding context: one table mapping *logical* axis names to mesh axes
(the JAX package's ``models/sharding.py``), and the explicit layout a
PyTorch process needs to hold its own part of every tensor.

The rule table (``default_rules``) and the spec functions (``spec``,
``spec_for_shape``) are the reference's, option for option: what GSPMD
reads there, ``models/param.py:tree_specs`` reads here. GSPMD then
partitions a program itself; an eager PyTorch rank instead holds slices
and issues collectives, so the context adds:

  * ``range(axis, n)`` — this rank's units of a dim of ``n`` units along
    a logical axis: contiguous, uneven where ``n`` does not divide, rank 0
    taking the largest share (28 q heads over 16 ranks: 2 each on ranks
    0-11, 1 on ranks 12-15); a head axis may have fewer units than ranks
    (whisper-small's 12 heads over 16: one each on ranks 0-11, none on
    ranks 12-15, whose attention is then skipped);
  * ``indices(axis, n, parts)`` — the same by meaning for a packed dim
    (``Part``): Mamba2's ``in_proj`` columns [z | x | B | C | dt] give z,
    x and dt by head and B, C whole to every rank; kv heads follow the q
    heads (a rank holds the kv heads its q heads read, one per q head where
    they read them unevenly). The K/V cache's sequence ("kv_seq") is dealt
    round-robin instead: rank ``r`` of ``M`` holds positions ``r, r + M,
    r + 2M, ...`` at local index ``p // M`` (the first ``n % M`` ranks one
    more, as ``range`` counts), so that a prefill's cache and a longer
    preallocated one agree position for position and the decode's write
    moves round the ranks;
  * ``leaf_indices(axes, shape, parts)`` — this rank's indices along each
    dim of a leaf: a leaf whose "kv_seq" shares a mesh axis with its
    "kv_heads" holds its kv heads whole (the reference's spec drops the
    kv heads there, fewer than the ranks; as many or more would name the
    mesh axis twice, which raises);
  * ``shard(x, axes, parts)`` — this rank's slice of a full tensor;
  * ``constrain(x, axes, full)`` — asserts a local tensor has the layout
    the rules give, raising on a mismatch (with no mesh it is the
    identity, as the reference's);
  * ``reduce`` / ``all_gather`` / ``gather`` / ``gather_split`` /
    ``reduce_scatter`` / ``scatter`` / ``all_to_all`` over a logical
    axis's mesh axes, issued through ``comm`` (``torch.distributed`` by
    default; the dry run passes ``launch.dryrun.RecordedCollectives``). A
    collective over mesh axes of size 1 is not issued. Partial sums are
    reduced in f32 and rounded once to their dtype; parts of an uneven
    split are padded to the largest for the collective.

Training differentiates through the layout with Megatron's pair of
autograd Functions over a logical axis:

  * ``reduce`` — forward the f32 all-reduce, backward the identity: a sum
    of partials whose result every rank then uses alike (row-parallel
    outputs, the vocab-parallel embedding, the cross-entropy's sums);
  * ``copy`` — forward the identity, backward the f32 all-reduce: a
    replicated tensor that rank-local (split) computation consumes (the
    normed input of column-parallel weights, Mamba2's B and C, the MoE's
    gates);
  * ``gather`` — forward the all-gather of the ranks' parts of a dim,
    backward the rank's slice of the gradient (RWKV6's channel-mix gate
    ``r``, whose product with the replicated ``kv`` every rank then
    computes alike; under sequence parallelism the positions that
    replicated computation reads whole: ``whole``);
  * ``gather_split`` — the same all-gather, for computation that differs
    per rank (each multiplies it by its own columns): backward the f32
    reduce-scatter of the ranks' partial gradients, each rank keeping
    its part (``second_matmul="col"``'s input, sequence parallelism's
    input of each column-parallel matmul: ``enter``);
  * ``reduce_scatter`` — forward the f32 reduce-scatter of partial sums,
    each rank keeping its part, backward the all-gather of the gradient
    (sequence parallelism's row-parallel outputs: ``leave``);
  * ``scatter`` — forward the rank's part of a tensor every rank holds
    alike, backward the all-gather of the gradient.

The Functions keep one invariant: on every rank the gradient of every replicated
activation is the whole gradient, so the gradient of a replicated leaf
(a norm weight, the router, B and C's columns) comes out whole and
bitwise equal on every rank. A kv head several ranks hold (the model
axis above the kv heads, or q heads split unevenly) gets a partial
gradient on each holder, and so does a leaf held whole of which each
rank reads only its heads' channels (RWKV6's per-channel vectors,
``ParamDef.read_by_heads``); under sequence parallelism so does each
leaf applied on the residual position by position, of which each rank
sees its positions only (``ParamDef.per_position``: the norms' gains and
biases, attention's ``bo``, zamba2's ``fuse``): ``sum_shared`` adds
them all once per step, in one all-reduce.
``held_pieces`` gives how many ranks of the model axis hold each part of
a leaf, which the global norm divides by (a leaf split over data under
fsdp is partitioned there: each element counts on its one data rank).
``batch_local`` is the context of ``train/manual_dp.py``'s forward:
"batch" not split, each rank's microbatch its own, as the reference's
forward under ``NULL_CTX`` inside ``shard_map``.

The port honours the mesh axes of "batch", "heads", "kv_heads",
"heads2", "ff", "ff2", "experts", "vocab", "act_vocab" (TP, EP,
vocab-parallel embedding and logits, and the data axis), "kv_seq"
(the K/V cache's sequence, round-robin over "model" where the kv heads
are fewer than the model axis, over "data" at long_500k; a decode
combines the ranks' positions by log-sum-exp, ``models/attention.py``),
"embed_out" (``second_matmul="col"``: the output columns of each pair's
second matmul, ``wo`` and the MLPs' ``w_down``; ``layers.row_parallel``)
and "seq" (sequence parallelism, in training: between blocks the
residual holds the rank's contiguous positions, rank 0 taking the
largest share; ``for_seq`` gives the context the full length, ``enter``
/ ``whole`` / ``leave`` are a block's gathers and its reduce-scatter).
Under "seq" the logits keep the vocab-parallel columns of the
unembedding (``logits_layout``), where the reference's rules hold their
vocab whole. "embed" (fsdp, training): each parameter's input dim over
"data" beside its model-axis slice (``embed_dim``; held whole where the
dim is smaller than the axis, as the reference's spec drops it); the
model puts a piece's leaves together with ``gather_params`` (per dtype
one all-gather; backward one f32 reduce-scatter, its result never
rounded to the parameters' dtype: a ``ParamShard``'s f32 stand-in takes
it). On the multi-pod mesh "batch" is ("pod", "data"): a rank's rows are
``pod x data + data_index``'s, its collectives over the mesh's "pod+data"
group. Any other logical axis on a mesh axis of size > 1 raises
``NotImplementedError``.

Default rule table (single pod, mesh ("data", "model")):
    batch      -> data            DP: batch / business-key partitions
    seq        -> None            (or "model" under sequence-parallel resid)
    embed      -> None            (or "data" under FSDP for params)
    heads      -> model           TP attention
    kv_heads   -> model
    ff         -> model           TP mlp
    ff_expert  -> None            (expert-parallel already splits experts)
    experts    -> model           EP
    vocab      -> model
    layers     -> None
    state      -> None
    kv_seq     -> None            (or "model": SP KV cache for 500k decode)

Multi-pod meshes extend "batch" to ("pod", "data").
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]            # mesh axes per dim (a PartitionSpec)

# logical axes the explicit layout splits
SPLIT_AXES = ("batch", "heads", "kv_heads", "heads2", "ff", "ff2",
              "experts", "vocab", "act_vocab", "kv_seq", "embed_out", "seq",
              "embed")
# the row axis of a pair's second matmul -> the axis of its input's columns
PAIRED = {"heads2": "heads", "ff2": "ff"}
# the axes dealt round-robin (rank r of M holds units r, r + M, ...; a
# rank may hold none of a cache shorter than the ranks)
ROUND_ROBIN = ("kv_seq",)
# the axes a rank may hold no units of (a head-less rank skips its
# attention, contributing zero to the row-parallel sum)
HEAD_AXES = ("heads", "kv_heads", "heads2")


def default_rules(multi_pod: bool = False, *,
                  fsdp: bool = False,
                  seq_parallel: bool = False,
                  second_matmul: str = "row",
                  kv_seq_shard: bool = False) -> Dict[str, Any]:
    batch = ("pod", "data") if multi_pod else "data"
    rules: Dict[str, Any] = {
        "batch": batch,
        "seq": "model" if seq_parallel else None,
        "embed": "data" if fsdp else None,   # param input dim (FSDP/ZeRO-3)
        "act_embed": None,                   # activation feature dim
        # logits vocab dim: TP normally; under SP the seq dim owns "model"
        "act_vocab": None if seq_parallel else "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ff": "model",
        # second matmul of each pair (wo / w_down): "row" = Megatron
        # (input dim sharded, output all-reduced); "col" = output-dim
        # sharded (activation gathers instead of weight gathers)
        "ff2": "model" if second_matmul == "row" else None,
        "heads2": "model" if second_matmul == "row" else None,
        "embed_out": "model" if second_matmul == "col" else None,
        "ff_expert": None,
        "experts": "model",
        "vocab": "model",
        "layers": None,
        "state": None,
        "kv_seq": "model" if kv_seq_shard else None,
        None: None,
    }
    return rules


@dataclasses.dataclass(frozen=True)
class Part:
    """One segment of a packed dim: ``width`` elements holding ``units``
    units split over the ranks (heads, experts; 0: the segment is whole on
    every rank). ``kv_of``: the segment is ``units`` kv heads read by
    ``kv_of`` q heads, held as the q heads' split needs them."""
    width: int
    units: int = 0
    kv_of: int = 0


def split_range(n: int, parts: int, i: int) -> Tuple[int, int]:
    """Part ``i`` of ``n`` units over ``parts``: contiguous, the first
    ``n % parts`` parts one unit larger."""
    base, extra = divmod(n, parts)
    start = i * base + min(i, extra)
    return start, start + base + (i < extra)


def kv_heads_read(n_q: int, n_kv: int, q0: int, q1: int) -> List[int]:
    """The kv heads q heads [q0, q1) read, in local order: each once when
    every one of them is read by as many of the q heads (a uniform local
    GQA group), else one per q head (group 1)."""
    group = n_q // n_kv
    per_q = [q // group for q in range(q0, q1)]
    heads = sorted(set(per_q))
    counts = {h: per_q.count(h) for h in heads}
    if len(set(counts.values())) == 1:
        return heads
    return per_q


@dataclasses.dataclass
class ShardingCtx:
    mesh: Any = None
    rules: Dict[str, Any] = dataclasses.field(default_factory=default_rules)
    comm: Any = None              # collectives; None: torch.distributed
    seq: int = 0                  # the positions "seq" splits (``for_seq``)

    # ------------------------------------------------ the reference's specs
    def spec(self, axes: Sequence[Optional[str]]) -> Spec:
        return tuple(self.rules.get(a, None) for a in axes)

    @property
    def _axis_sizes(self) -> Dict[str, int]:
        cached = self.__dict__.get("_axis_sizes_cache")
        if cached is None:
            cached = {} if self.mesh is None else \
                dict(zip(self.mesh.axis_names, self.mesh.shape))
            self.__dict__["_axis_sizes_cache"] = cached
        return cached

    def _axis_size(self, mesh_axes) -> int:
        if mesh_axes is None:
            return 1
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        size = 1
        for a in mesh_axes:
            size *= self._axis_sizes.get(a, 1)
        return size

    def mesh_axes(self, axis: Optional[str]) -> Tuple[str, ...]:
        """The mesh axes of size > 1 a logical axis is split over."""
        mesh_axes = None if self.mesh is None else self.rules.get(axis)
        if mesh_axes is None:
            return ()
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        return tuple(a for a in mesh_axes if self._axis_sizes.get(a, 1) > 1)

    def shares_axis(self, a: Optional[str], b: Optional[str]) -> bool:
        """Whether logical axes ``a`` and ``b`` are split over a common
        mesh axis."""
        return bool(set(self.mesh_axes(a)) & set(self.mesh_axes(b)))

    def spec_for_shape(self, axes: Sequence[Optional[str]],
                       shape: Sequence[int]) -> Spec:
        """Like ``spec`` but drops a mesh axis whenever the tensor dim is
        *smaller* than it (the reference's rule)."""
        out = []
        for a, dim in zip(axes, shape):
            mesh_axes = self.rules.get(a, None)
            if mesh_axes is not None and dim < self._axis_size(mesh_axes):
                mesh_axes = None
            out.append(mesh_axes)
        return tuple(out)

    # ----------------------------------------------------- explicit layout
    def size(self, axis: Optional[str]) -> int:
        """Ranks a logical axis is split over (1 without a mesh)."""
        if self.mesh is None:
            return 1
        return self._axis_size(self.rules.get(axis, None))

    def index(self, axis: Optional[str]) -> int:
        """This rank's coordinate along a logical axis's mesh axes
        (row-major over several)."""
        mesh_axes = None if self.mesh is None else self.rules.get(axis)
        if mesh_axes is None:
            return 0
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        i = 0
        for a in mesh_axes:
            i = i * self._axis_sizes.get(a, 1) + self.mesh.coord(a)
        return i

    def _split(self, axis: Optional[str]) -> bool:
        """Whether this layout splits ``axis`` (raises for a mesh layout
        the port does not have)."""
        if self.size(axis) == 1:
            return False
        if axis not in SPLIT_AXES:
            raise NotImplementedError(
                f"logical axis {axis!r} on mesh axes {self.rules[axis]!r}: "
                f"the port does not split it (ROADMAP A)")
        return True

    def range(self, axis: Optional[str], n: int,
              at: Optional[int] = None) -> Tuple[int, int]:
        """This rank's units [start, stop) of a dim of ``n`` units (``at``:
        those of the rank at that coordinate along ``axis`` instead)."""
        if not self._split(axis):
            return 0, n
        if axis in ROUND_ROBIN:
            raise ValueError(f"{axis!r} is dealt round-robin: its units are "
                             f"no range (``indices`` gives them)")
        parts = self.size(axis)
        if n < parts and axis not in HEAD_AXES:
            raise NotImplementedError(
                f"{n} units of {axis!r} over {parts} ranks: a rank would "
                f"hold none")
        return split_range(n, parts, self.index(axis) if at is None else at)

    def indices(self, axis: Optional[str], n: int,
                parts: Optional[Sequence[Part]] = None,
                at: Optional[int] = None) -> List[int]:
        """This rank's elements of a dim of ``n`` elements along ``axis``,
        by ``parts`` (default: ``n`` units of one element; ``at`` as in
        ``range``)."""
        if not self._split(axis):
            return list(range(n))
        if axis in ROUND_ROBIN:
            return list(range(self.index(axis) if at is None else at, n,
                              self.size(axis)))
        parts = parts or (Part(n, n),)
        if sum(p.width for p in parts) != n:
            raise ValueError(f"parts {parts} do not cover {n} elements")
        out, base = [], 0
        for p in parts:
            w = p.width // p.units if p.units else p.width
            if not p.units:
                units = [0]
            elif p.kv_of:
                q0, q1 = self.range(axis, p.kv_of, at)
                units = kv_heads_read(p.kv_of, p.units, q0, q1)
            else:
                units = list(range(*self.range(axis, p.units, at)))
            for u in units:
                out.extend(range(base + u * w, base + (u + 1) * w))
            base += p.width
        return out

    def leaf_axes(self, axes: Sequence[Optional[str]],
                  shape: Sequence[Optional[int]]
                  ) -> Tuple[Optional[str], ...]:
        """``axes`` as this layout splits a leaf of ``shape``: "kv_heads"
        held whole (None) where the leaf's "kv_seq" shares a mesh axis with
        it, as the reference's ``spec_for_shape`` drops the kv heads there
        (fewer than the ranks). Raises where they are as many as the ranks
        or more, and where "kv_seq" shares a mesh axis with the leaf's
        "batch" (the ranks of that axis would hold different rows and the
        decode would combine them): the reference's spec would name the
        mesh axis twice. "embed" (fsdp) is held whole where the dim is
        smaller than its mesh axes (the reference's ``spec_for_shape``)."""
        if "embed" in axes and self.size("embed") > 1:
            axes = tuple(None if a == "embed" and n is not None
                         and n < self.size("embed") else a
                         for a, n in zip(axes, shape))
        if "kv_seq" in axes and "batch" in axes and \
                self.shares_axis("kv_seq", "batch"):
            raise ValueError(
                f"the cache's sequence and its batch both on mesh axes "
                f"{self.mesh_axes('kv_seq')}: the reference's spec would "
                f"name the axis twice")
        if "kv_seq" not in axes or "kv_heads" not in axes or \
                not self.shares_axis("kv_seq", "kv_heads"):
            return tuple(axes)
        n = shape[list(axes).index("kv_heads")]
        if n is not None and n >= self.size("kv_heads"):
            raise ValueError(
                f"{n} kv heads and the cache's sequence both on mesh axes "
                f"{self.mesh_axes('kv_heads')} of {self.size('kv_heads')} "
                f"ranks: the reference's spec would name the axis twice")
        return tuple(None if a == "kv_heads" else a for a in axes)

    def leaf_indices(self, axes: Sequence[Optional[str]],
                     shape: Sequence[int],
                     parts: Optional[Sequence[Part]] = None
                     ) -> List[List[int]]:
        """This rank's indices along each dim of a leaf of ``shape``
        (``parts``: the packing of its head-axis dim, ``head_dim`` of the
        ParamDef; ``leaf_axes``' kv heads whole)."""
        hd = head_dim(axes)
        return [self.indices(a, n, parts if i == hd else None)
                for i, (a, n) in enumerate(zip(self.leaf_axes(axes, shape),
                                               shape))]

    def local_shape(self, axes: Sequence[Optional[str]],
                    shape: Sequence[int],
                    parts: Optional[Sequence[Part]] = None) -> Tuple[int, ...]:
        """The local shape of a full ``shape`` (``parts`` as in
        ``leaf_indices``)."""
        return tuple(len(i) for i in self.leaf_indices(axes, shape, parts))

    def shard(self, x: torch.Tensor, axes: Sequence[Optional[str]],
              parts: Optional[Sequence[Part]] = None) -> torch.Tensor:
        """This rank's slice of the full tensor ``x`` (a view where every
        split dim is a contiguous range, else a gathered copy)."""
        if len(axes) != x.dim():
            raise ValueError(f"axes {axes} for shape {tuple(x.shape)}")
        for i, idx in enumerate(self.leaf_indices(axes, x.shape, parts)):
            # (a rank's kv heads read unevenly may repeat one and count as
            # many as the dim: 28 q heads over 8 ranks, rank 1 [0, 0, 0, 1])
            if idx == list(range(x.shape[i])):
                continue
            if not idx or idx == list(range(idx[0], idx[0] + len(idx))):
                x = x.narrow(i, idx[0] if idx else 0, len(idx))
            else:
                x = x.index_select(i, torch.tensor(idx, device=x.device))
        return x

    def constrain(self, x: torch.Tensor, axes: Sequence[Optional[str]],
                  full: Sequence[Optional[int]],
                  parts: Optional[Sequence[Part]] = None) -> torch.Tensor:
        """``x`` unchanged; with a mesh, raises unless ``x`` is this rank's
        part of a tensor of shape ``full`` (None: a dim not checked;
        ``parts`` as in ``local_shape``)."""
        if self.mesh is None:
            return x
        if len(axes) != x.dim() or len(full) != x.dim():
            raise ValueError(f"axes {axes} / full {full} for "
                             f"{tuple(x.shape)}")
        hd = head_dim(axes)
        for i, (a, n) in enumerate(zip(self.leaf_axes(axes, full), full)):
            if n is None:
                continue
            want = len(self.indices(a, n, parts if i == hd else None))
            if x.shape[i] != want:
                raise ValueError(
                    f"dim {i} ({a!r}) of {tuple(x.shape)} is {x.shape[i]}; "
                    f"the layout gives this rank {want} of {n}")
        return x

    # --------------------------------------------------------- collectives
    def _comm(self):
        if self.comm is not None:
            return self.comm
        import torch.distributed as dist
        return dist

    def _group(self, axis: str):
        """The group of this rank along a logical axis's mesh axes of size
        > 1 (several: the mesh's group of them together, "pod+data")."""
        return self.mesh.group("+".join(self.mesh_axes(axis)))

    def _reduced(self, x: torch.Tensor, axis: str, *, fresh: bool = False,
                 op: str = "sum") -> torch.Tensor:
        """The all-reduce (``op``: "sum" or "max") of ``x`` over the ranks
        of ``axis`` in f32, rounded once to ``x``'s dtype. The buffer is
        ``x`` itself where ``x`` is f32 and contiguous, unless ``fresh``
        (a tensor autograd may hold); the ranks' layouts of a tensor may
        differ, and the collective reads memory in order."""
        buf = x.float().contiguous()
        if fresh and buf is x:
            buf = buf.clone()
        kw = {}
        if op == "max":
            import torch.distributed as dist
            kw["op"] = dist.ReduceOp.MAX
        self._comm().all_reduce(buf, group=self._group(axis), **kw)
        return buf.to(x.dtype)

    def reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``x`` over the ranks of ``axis`` (f32, rounded once to
        ``x``'s dtype); its gradient the identity: each rank's partial
        gets the whole gradient of the sum, which every rank uses alike.
        ``x`` itself where the axis is not split."""
        if self.size(axis) == 1:
            return x
        if not torch.is_grad_enabled():
            return self._reduced(x, axis)
        return _Reduce.apply(x, self, axis)

    def copy(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` (replicated over the ranks of ``axis``) as split
        computation consumes it: the identity, whose gradient is the sum
        of the ranks' partial gradients (an f32 all-reduce in the
        backward). ``x`` itself where no graph is recorded."""
        if self.size(axis) == 1 or not (torch.is_grad_enabled()
                                        and x.requires_grad):
            return x
        return _Copy.apply(x, self, axis)

    def reduce_max(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The elementwise max of ``x`` over the ranks of ``axis``, with no
        gradient (the cross-entropy's shift, a split cache's row maxima)."""
        if self.size(axis) == 1:
            return x.detach()
        return self._reduced(x.detach(), axis, fresh=True, op="max")

    def batch_local(self) -> "ShardingCtx":
        """This layout with "batch" not split: each rank's batch its own
        (``manual_dp``'s forward)."""
        return dataclasses.replace(self, rules={**self.rules,
                                                "batch": None})

    # ---------------------------------------------- fsdp (ZeRO-3) leaves
    def embed_dim(self, axes: Sequence[Optional[str]],
                  shape: Sequence[int]) -> Optional[int]:
        """The dim of a parameter leaf of ``shape`` that "embed" splits
        over the data axis (fsdp), or None: the rule holds it whole, its
        mesh axes are of size 1, or the dim is smaller than them."""
        if self.size("embed") == 1:
            return None
        for i, a in enumerate(self.leaf_axes(axes, shape)):
            if a == "embed":
                return i
        return None

    def param_packs(self, defs) -> List["Pack"]:
        """The gathers of a tree of ParamDefs (full shapes; nested dicts):
        its leaves that "embed" splits, in ``tree_leaves`` order, one
        ``Pack`` per dtype (in order of first appearance), each moved by
        one collective. Empty where the layout splits no "embed"."""
        if self.size("embed") == 1:
            return []
        cache = self.__dict__.setdefault("_packs_cache", {})
        if id(defs) in cache and cache[id(defs)][0] is defs:
            return cache[id(defs)][1]
        n = self.size("embed")
        packs: Dict[torch.dtype, Pack] = {}
        for path, d in _def_paths(defs):
            dim = self.embed_dim(d.axes, d.shape)
            if dim is None:
                continue
            pack = packs.setdefault(d.dtype, Pack(d.dtype, n, [], [0] * n))
            # the rank's data group shares its model-axis slice
            local = list(self.local_shape(d.axes, d.shape, d.parts))
            shapes = []
            for r in range(n):
                lo, hi = self.range("embed", d.shape[dim], at=r)
                shapes.append(tuple(local[:dim] + [hi - lo]
                                    + local[dim + 1:]))
            offsets = list(pack.sizes)
            for r in range(n):
                pack.sizes[r] += math.prod(shapes[r])
            pack.leaves.append(PackLeaf(path, dim, shapes, offsets))
        cache[id(defs)] = (defs, list(packs.values()))
        return cache[id(defs)][1]

    def gather_params(self, tree, defs):
        """``tree`` (a layer's or a piece's parameters, nested dicts) with
        every leaf of ``defs`` (its ParamDefs, full shapes; ``tree`` may
        hold more keys, left as they are) that "embed" splits put
        together over the data axis: per ``param_packs`` one all-gather
        in the leaves' dtype, the ranks' parts concatenated along the
        dim. Its backward (where a graph is recorded) is one f32
        reduce-scatter of the ranks' partial gradients, each rank keeping
        its part in f32, never rounded to the parameters' dtype: a leaf
        held as a ``ParamShard`` gets it through its f32 stand-in. ``tree``
        itself where the layout splits no "embed"."""
        packs = self.param_packs(defs)
        if not packs:
            return tree
        out = _copy_dicts(tree)
        for pack in packs:
            held = [_at(tree, leaf.path) for leaf in pack.leaves]
            values = [h.value if isinstance(h, ParamShard) else h
                      for h in held]
            inputs = [h.grad if isinstance(h, ParamShard) else h
                      for h in held]
            if torch.is_grad_enabled() and any(x.requires_grad
                                               for x in inputs):
                full = _GatherParams.apply(self, pack, values, *inputs)
            else:
                full = self._gathered_pack(values, pack)
            for leaf, x in zip(pack.leaves, full):
                _set(out, leaf.path, x)
        return out

    def _gathered_pack(self, values, pack) -> List[torch.Tensor]:
        """One all-gather of a ``Pack``'s leaves (this rank's parts,
        ``values``) laid out flat one after another, each rank's padded to
        the largest; every leaf's parts concatenated along its dim."""
        width = max(pack.sizes)
        me = self.index("embed")
        buf = values[0].new_zeros(width)    # the values' dtype
        for leaf, v in zip(pack.leaves, values):
            o = leaf.offsets[me]
            buf[o:o + v.numel()].copy_(v.reshape(-1))
        out = buf.new_empty(pack.n * width)
        self._comm().all_gather_into_tensor(out, buf,
                                            group=self._group("embed"))
        full = []
        for leaf in pack.leaves:
            parts = [out[r * width + o:r * width + o + math.prod(shape)]
                     .view(shape) for r, (o, shape) in
                     enumerate(zip(leaf.offsets, leaf.shapes))]
            full.append(torch.cat(parts, leaf.dim))
        return full

    def _scattered_pack(self, grads, pack) -> List[torch.Tensor]:
        """The f32 reduce-scatter of the ranks' gradients of a ``Pack``'s
        gathered leaves (None: zero), laid out as ``_gathered_pack`` sends
        them: this rank's part of each leaf's summed gradient, in f32."""
        width = max(pack.sizes)
        g0 = next(g for g in grads if g is not None)
        buf = g0.new_zeros(pack.n * width, dtype=torch.float32)
        for leaf, g in zip(pack.leaves, grads):
            if g is None:
                continue
            at = 0
            for r, (o, shape) in enumerate(zip(leaf.offsets, leaf.shapes)):
                n = shape[leaf.dim]
                buf[r * width + o:r * width + o + math.prod(shape)].view(
                    shape).copy_(g.narrow(leaf.dim, at, n))
                at += n
        out = buf.new_empty(width)
        self._comm().reduce_scatter_tensor(out, buf,
                                           group=self._group("embed"))
        me = self.index("embed")
        return [out[leaf.offsets[me]:leaf.offsets[me]
                    + math.prod(leaf.shapes[me])].view(leaf.shapes[me])
                for leaf in pack.leaves]

    # ------------------------------------------- sequence parallelism
    def for_seq(self, n: int) -> "ShardingCtx":
        """This layout for a forward over ``n`` positions: where it splits
        "seq", a context holding the full length (the parts of an uneven
        split differ, and the collectives pad them); else itself. The
        sequence must share its mesh axis with the heads': a block's
        gathers and reduce-scatter replace its collectives over them."""
        if self.size("seq") == 1 or self.seq == n:
            return self
        if not self.shares_axis("seq", "heads"):
            raise NotImplementedError(
                f"the sequence on {self.rules['seq']!r}, the heads on "
                f"{self.rules.get('heads')!r}: sequence parallelism runs on "
                f"the heads' mesh axis")
        return dataclasses.replace(self, seq=n)

    def enter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """A block's normed input ``x`` as computation split over ``axis``
        consumes it (each rank multiplies it by its own columns):
        ``copy``, or where the layout splits "seq" (``x`` the rank's
        positions) every position gathered (``gather_split``: the
        reduce-scatter of the ranks' partial gradients)."""
        if self.size("seq") > 1:
            return self.gather_split(x, "seq", self.seq, dim=1)
        return self.copy(x, axis)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` over every position: where the layout splits "seq", the
        ranks' positions all-gathered with the rank's slice as the
        gradient (``gather``: what reads it is computed alike on every
        rank before a ``copy``, as the MoE's router, Mamba2's B and C,
        RWKV6's token shift); else ``x``."""
        if self.size("seq") > 1:
            return self.gather(x, "seq", self.seq, dim=1)
        return x

    def leave(self, y: torch.Tensor, axis: str) -> torch.Tensor:
        """The ranks' partial sums ``y`` over ``axis`` summed: ``reduce``,
        or where the layout splits "seq", ``reduce_scatter`` over it (each
        rank keeps its positions; where ``axis`` is not split, the
        positions of a whole ``y``)."""
        if self.size("seq") == 1:
            return self.reduce(y, axis)
        if self.size(axis) == 1:
            return self.own_positions(y)
        return self.reduce_scatter(y, "seq", self.seq, dim=1)

    def own_positions(self, y: torch.Tensor) -> torch.Tensor:
        """The rank's positions of ``y`` (every position, alike on every
        rank) where the layout splits "seq" (``scatter``); else ``y``."""
        if self.size("seq") == 1:
            return y
        return self.scatter(y, "seq", self.seq, dim=1)

    def logits_layout(self) -> "ShardingCtx":
        """The layout of the logits: this one, except where it splits
        "seq" and holds the logits' vocab whole ("act_vocab" -> None, the
        reference's rules under sequence parallelism): the port keeps the
        unembedding's vocab-parallel columns ("act_vocab" on "vocab"'s
        mesh axes) after gathering the sequence, so no rank gathers the
        vocab-split table."""
        if self.size("seq") == 1 or \
                self.rules.get("act_vocab") == self.rules.get("vocab"):
            return self
        return dataclasses.replace(self, rules={
            **self.rules, "act_vocab": self.rules.get("vocab")})

    # ------------------------------------------------- leaves held twice
    def _holding(self, axes: Sequence[Optional[str]], shape: Sequence[int],
                 parts: Optional[Sequence[Part]] = None):
        """(the dim the model axis splits or None, this rank's indices
        along it, every rank's count of each index along it)."""
        model = self.rules.get("heads")
        hd = head_dim(axes)
        for i, (a, n) in enumerate(zip(axes, shape)):
            # "embed" (fsdp) partitions a leaf over the data axis: each
            # element held by one data rank, counted once there
            if a == "embed" or not self._split(a):
                continue
            if self.rules.get(a) != model:
                raise NotImplementedError(
                    f"a parameter dim on {a!r} ({self.rules.get(a)!r}), "
                    f"not the model axis {model!r}")
            p = parts if i == hd else None
            total = collections.Counter()
            for j in range(self.size(a)):
                total.update(self.indices(a, n, p, at=j))
            return i, self.indices(a, n, p), total
        return None, None, None

    def held_pieces(self, x: torch.Tensor, axes: Sequence[Optional[str]],
                    shape: Sequence[int],
                    parts: Optional[Sequence[Part]] = None
                    ) -> List[Tuple[torch.Tensor, int]]:
        """``x`` (of this rank's local shape of a leaf ``shape`` over
        ``axes``) cut along the dim the model axis splits into views, each
        with the number of ranks of the model axis holding its elements
        (a kv head a rank holds twice counts twice; a leaf the model axis
        does not split is one piece, held by every rank of it)."""
        dim, mine, total = self._holding(axes, shape, parts)
        if dim is None:
            return [(x, self.size("heads"))]
        if not mine:                    # a rank holding none of its heads
            return [(x, 1)]
        out, start = [], 0
        for i in range(1, len(mine) + 1):
            if i == len(mine) or total[mine[i]] != total[mine[start]]:
                out.append((x.narrow(dim, start, i - start),
                            total[mine[start]]))
                start = i
        return out

    def shared_leaves(self, defs: Sequence) -> List[Tuple[int, int,
                                                         List[int]]]:
        """The ParamDefs of ``defs`` with a kv head that several copies
        hold (on one rank or several), those held whole that each rank
        reads only by its heads' channels (``read_by_heads``) and, where
        the layout splits "seq", those each rank applies to its positions
        only (``per_position``): (position, the kv dim or 0, this rank's
        indices along it), for ``sum_shared``."""
        picks = []
        seq = self.size("seq") > 1
        if seq and not self.shares_axis("seq", "heads"):
            raise NotImplementedError("sequence parallelism off the heads' "
                                      "mesh axis")
        for i, d in enumerate(defs):
            if d.read_by_heads or (seq and d.per_position):
                if self.size("heads") > 1:      # the rank's dim 0, whole
                    n = self.local_shape(d.axes, d.shape, d.parts)[0]
                    picks.append((i, 0, list(range(n))))
                continue
            if not any(p.kv_of for p in d.parts or ()):
                continue
            dim, mine, total = self._holding(d.axes, d.shape, d.parts)
            if dim is not None and max(total.values()) > 1:
                picks.append((i, dim, mine))
        return picks

    def shared_shape(self, d, dim: int, mine: Sequence[int]) -> List[int]:
        """The shape a ``shared_leaves`` pick of ParamDef ``d`` has in
        ``sum_shared``'s buffer: the rank's local shape, full along the kv
        dim ``dim`` (a leaf held whole: the rank's own, ``mine``)."""
        shape = list(self.local_shape(d.axes, d.shape, d.parts))
        shape[dim] = d.shape[dim] if any(p.kv_of for p in d.parts or ()) \
            else len(mine)
        return shape

    def sum_shared(self, grads: List[torch.Tensor], defs: Sequence
                   ) -> List[torch.Tensor]:
        """``grads`` (this rank's, one per ParamDef of ``defs``, in order)
        with the gradient of each kv head that several copies hold summed
        over them all (each holder's is partial: the q heads it serves),
        and that of each ``read_by_heads`` leaf over the ranks (each
        rank's is its heads' channels), and under sequence parallelism
        each ``per_position`` leaf's (each rank's is its positions'),
        written back into every copy: one
        f32 all-reduce over the model axis of those leaves, full along
        their kv dim. Other leaves are returned as they are."""
        picks = self.shared_leaves(defs)
        if not picks:
            return grads
        shapes = [self.shared_shape(defs[i], dim, mine)
                  for i, dim, mine in picks]
        flat = torch.zeros(sum(math.prod(s) for s in shapes),
                           dtype=torch.float32,
                           device=grads[picks[0][0]].device)
        fulls, base = [], 0
        for shape in shapes:
            fulls.append(flat[base:base + math.prod(shape)].view(shape))
            base += math.prod(shape)
        runs = [_runs(mine) for _, _, mine in picks]
        for (i, dim, _), full, rs in zip(picks, fulls, runs):
            for local, glob, n in rs:
                full.narrow(dim, glob, n).add_(
                    grads[i].narrow(dim, local, n).float())
        flat = self._reduced(flat, "heads")
        out = list(grads)
        for (i, dim, _), full, rs in zip(picks, fulls, runs):
            g = torch.empty_like(grads[i])
            for local, glob, n in rs:
                g.narrow(dim, local, n).copy_(full.narrow(dim, glob, n))
            out[i] = g
        return out

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = -1,
                   full: Optional[int] = None,
                   parts: Optional[Sequence[Part]] = None
                   ) -> List[torch.Tensor]:
        """Every rank's ``x`` along ``axis``, in rank order. ``full``: the
        size of the dim ``dim`` split over the ranks (by ``parts``, as in
        ``indices``), whose parts may differ (each is padded to the
        largest for the collective, then cut back); None: every rank's
        ``x`` has this one's shape."""
        n = self.size(axis)
        if n == 1:
            return [x]
        dim = dim % x.dim()
        sizes = ([x.shape[dim]] * n if full is None else
                 [len(self.indices(axis, full, parts, at=i))
                  for i in range(n)])
        pad = list(x.shape)
        pad[dim] = max(sizes) - x.shape[dim]
        buf = torch.cat([x, x.new_zeros(pad)], dim) if pad[dim] else \
            x.contiguous()
        out = [torch.empty_like(buf) for _ in range(n)]
        self._comm().all_gather(out, buf, group=self._group(axis))
        return [t.narrow(dim, 0, s) for t, s in zip(out, sizes)]

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Piece ``x[i]`` to the rank at coordinate ``i`` along ``axis``,
        and piece ``i`` of the result from it (one ``all_to_all_single``;
        ``x``'s leading dim is the axis's size)."""
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        self._comm().all_to_all_single(out, x.contiguous(),
                                       group=self._group(axis))
        return out

    def gather(self, x: torch.Tensor, axis: str, full: int,
               parts: Optional[Sequence[Part]] = None,
               dim: int = -1) -> torch.Tensor:
        """The ranks' parts ``x`` of a dim ``dim`` (the last by default)
        of ``full`` elements split over ``axis`` (by ``parts``, contiguous
        in rank order) put together: one all-gather, in ``x``'s dtype. Its
        gradient is the rank's slice of the gradient, which every rank
        holds whole (the result is replicated and every rank consumes it
        alike). ``x`` itself where the axis is not split."""
        if self.size(axis) == 1:
            return x
        return _Gather.apply(x, self, axis, full, parts, dim)

    def gather_split(self, x: torch.Tensor, axis: str, full: int,
                     parts: Optional[Sequence[Part]] = None,
                     dim: int = -1) -> torch.Tensor:
        """``gather``'s all-gather, for computation that differs per rank
        (each multiplies the result by its own columns): its gradient is
        the sum of the ranks' partial gradients, of which each rank keeps
        its part (one f32 reduce-scatter, rounded once to ``x``'s dtype).
        ``x`` itself where the axis is not split."""
        if self.size(axis) == 1:
            return x
        return _GatherSplit.apply(x, self, axis, full, parts, dim)

    def reduce_scatter(self, x: torch.Tensor, axis: str, full: int,
                       dim: int = -1) -> torch.Tensor:
        """The sum over the ranks of ``axis`` of their ``x`` (a dim
        ``dim`` of ``full`` elements, whole on every rank), of which each
        rank keeps its part: one f32 reduce-scatter (the parts padded to
        the largest), rounded once to ``x``'s dtype. Its gradient is the
        all-gather of the ranks' parts of the gradient. ``x`` itself where
        the axis is not split."""
        if self.size(axis) == 1:
            return x
        return _ReduceScatter.apply(x, self, axis, full, dim)

    def scatter(self, x: torch.Tensor, axis: str, full: int,
                dim: int = -1) -> torch.Tensor:
        """The rank's part of a dim ``dim`` of ``full`` elements of ``x``,
        which every rank holds alike; its gradient is the all-gather of
        the ranks' parts of the gradient. ``x`` itself where the axis is
        not split."""
        if self.size(axis) == 1:
            return x
        return _Scatter.apply(x, self, axis, full, dim)

    def _reduce_scattered(self, x: torch.Tensor, axis: str, full: int,
                          dim: int, parts: Optional[Sequence[Part]] = None
                          ) -> torch.Tensor:
        """``reduce_scatter``'s value: the ranks' parts of ``x``'s dim
        ``dim`` laid out one after another along a new leading dim in f32,
        each padded to the largest, reduce-scattered, the padding cut."""
        n = self.size(axis)
        dim = dim % x.dim()
        sizes = [len(self.indices(axis, full, parts, at=i)) for i in range(n)]
        shape = list(x.shape)
        shape[dim] = max(sizes)
        buf = x.new_zeros([n] + shape, dtype=torch.float32)
        at = 0
        for i, size in enumerate(sizes):
            buf[i].narrow(dim, 0, size).copy_(x.narrow(dim, at, size))
            at += size
        # flat: a reduce-scatter splits the leading dim of its input
        out = buf.new_empty(math.prod(shape))
        self._comm().reduce_scatter_tensor(out, buf.view(-1),
                                           group=self._group(axis))
        return out.view(shape).narrow(dim, 0, sizes[self.index(axis)]).to(
            x.dtype)


class ParamShard:
    """A parameter leaf held as this rank's part of its "embed" dim
    (fsdp) where a step takes its gradient: ``value``, the part, and
    ``grad``, an f32 stand-in of its shape (zero strides: no memory) that
    autograd differentiates, so that the gradient the gather's
    reduce-scatter leaves stays f32. ``unbind`` and indexing act on both,
    as on a stacked [L, ...] leaf."""
    __slots__ = ("value", "grad")

    def __init__(self, value: torch.Tensor, grad: torch.Tensor):
        self.value, self.grad = value, grad

    @classmethod
    def of(cls, value: torch.Tensor) -> "ParamShard":
        """``value`` (detached) with a fresh stand-in that requires grad."""
        stand_in = torch.zeros((), dtype=torch.float32, device=value.device)
        return cls(value.detach(),
                   stand_in.expand(value.shape).requires_grad_())

    def unbind(self, dim: int = 0) -> List["ParamShard"]:
        return [ParamShard(v, g) for v, g in zip(self.value.unbind(dim),
                                                 self.grad.unbind(dim))]

    def __getitem__(self, i) -> "ParamShard":
        return ParamShard(self.value[i], self.grad[i])


@dataclasses.dataclass(frozen=True)
class PackLeaf:
    """A leaf of a ``Pack``: its path in the tree ("a/b"), the dim "embed"
    splits, every rank's shape of it and its offset in every rank's flat
    part of the pack."""
    path: str
    dim: int
    shapes: List[Tuple[int, ...]]
    offsets: List[int]


@dataclasses.dataclass
class Pack:
    """The leaves one parameter gather moves, all of ``dtype``, over ``n``
    ranks; ``sizes``: each rank's elements of them."""
    dtype: torch.dtype
    n: int
    leaves: List[PackLeaf]
    sizes: List[int]


def _def_paths(defs, prefix: str = ""):
    """(path, ParamDef) of a tree of ParamDefs, in ``tree_leaves`` order."""
    if isinstance(defs, dict):
        return [x for k in sorted(defs)
                for x in _def_paths(defs[k], f"{prefix}{k}/")]
    return [(prefix[:-1], defs)]


def _copy_dicts(tree):
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def _at(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _set(tree, path: str, x) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree[k]
    tree[last] = x


def _runs(idx: Sequence[int]) -> List[Tuple[int, int, int]]:
    """Local indices ``idx`` (global index per local position) as runs
    (local start, global start, length) of consecutive indices."""
    out = []
    for pos, g in enumerate(idx):
        if out and out[-1][1] + out[-1][2] == g:
            out[-1][2] += 1
        else:
            out.append([pos, g, 1])
    return [tuple(r) for r in out]


class _Reduce(torch.autograd.Function):
    """``ShardingCtx.reduce``: all-reduce forward, identity backward."""

    @staticmethod
    def forward(fctx, x, sctx, axis):
        return sctx._reduced(x, axis, fresh=fctx.needs_input_grad[0])

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    """``ShardingCtx.copy``: identity forward, all-reduce backward."""

    @staticmethod
    def forward(fctx, x, sctx, axis):
        fctx.sctx, fctx.axis = sctx, axis
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return fctx.sctx._reduced(g, fctx.axis, fresh=True), None, None


class _Gather(torch.autograd.Function):
    """``ShardingCtx.gather``: all-gather forward, the rank's slice
    backward."""

    @staticmethod
    def forward(fctx, x, sctx, axis, full, parts, dim):
        fctx.idx, fctx.dim = sctx.indices(axis, full, parts), dim
        return torch.cat(sctx.all_gather(x, axis, dim, full, parts), dim)

    @staticmethod
    def backward(fctx, g):
        lo, n = fctx.idx[0] if fctx.idx else 0, len(fctx.idx)
        return g.narrow(fctx.dim, lo, n), None, None, None, None, None


class _GatherSplit(torch.autograd.Function):
    """``ShardingCtx.gather_split``: all-gather forward, the f32
    reduce-scatter of the gradient backward."""

    @staticmethod
    def forward(fctx, x, sctx, axis, full, parts, dim):
        fctx.args = (sctx, axis, full, dim, parts)
        return torch.cat(sctx.all_gather(x, axis, dim, full, parts), dim)

    @staticmethod
    def backward(fctx, g):
        return (fctx.args[0]._reduce_scattered(g, *fctx.args[1:]),
                None, None, None, None, None)


class _GatherParams(torch.autograd.Function):
    """``ShardingCtx.gather_params``' Function for one ``Pack``: the
    all-gather of its leaves forward (from ``values``; the differentiable
    inputs are their stand-ins, or the parts themselves), the f32
    reduce-scatter of their gradients backward."""

    @staticmethod
    def forward(fctx, sctx, pack, values, *inputs):
        fctx.sctx, fctx.pack = sctx, pack
        return tuple(sctx._gathered_pack(values, pack))

    @staticmethod
    def backward(fctx, *grads):
        return (None, None, None,
                *fctx.sctx._scattered_pack(grads, fctx.pack))


class _ReduceScatter(torch.autograd.Function):
    """``ShardingCtx.reduce_scatter``: the f32 reduce-scatter forward, the
    all-gather of the gradient backward."""

    @staticmethod
    def forward(fctx, x, sctx, axis, full, dim):
        fctx.args = (sctx, axis, full, dim)
        return sctx._reduce_scattered(x, axis, full, dim)

    @staticmethod
    def backward(fctx, g):
        sctx, axis, full, dim = fctx.args
        return (torch.cat(sctx.all_gather(g, axis, dim, full), dim),
                None, None, None, None)


class _Scatter(torch.autograd.Function):
    """``ShardingCtx.scatter``: the rank's part forward, the all-gather of
    the gradient backward."""

    @staticmethod
    def forward(fctx, x, sctx, axis, full, dim):
        fctx.args = (sctx, axis, full, dim)
        lo, hi = sctx.range(axis, full)
        return x.narrow(dim, lo, hi - lo).clone()

    @staticmethod
    def backward(fctx, g):
        sctx, axis, full, dim = fctx.args
        return (torch.cat(sctx.all_gather(g, axis, dim, full), dim),
                None, None, None, None)


def held_differently(d, ctx: ShardingCtx) -> Optional[Dict[str, Any]]:
    """Whether rank 0 holds a ParamDef ``d`` in other bytes than the
    reference's layout gives a card (its spec, each split dim padded to
    an even split, as GSPMD pads): None, or the reason and both byte
    counts. Raises for a difference no rule of the layout explains."""
    item = torch.empty((), dtype=d.dtype).element_size()
    mine = math.prod(ctx.local_shape(d.axes, d.shape, d.parts)) * item
    ref = item
    for mesh_axes, n in zip(ctx.spec_for_shape(d.axes, d.shape), d.shape):
        ref *= -(-n // ctx._axis_size(mesh_axes))
    if mine == ref:
        return None
    reasons = []
    for p in d.parts or ():
        size = ctx.size(d.axes[head_dim(d.axes)])
        if p.units and p.units < size:
            reasons.append(f"fewer heads than ranks: ranks 0-{p.units - 1} "
                           f"hold one whole head each, the other "
                           f"{size - p.units} none and skip the attention "
                           f"(the reference cuts the columns into "
                           f"{size} even pieces of heads)")
        if p.kv_of:
            reasons.append("kv heads are held whole, as the rank's q heads "
                           "read them (the reference splits the kv "
                           "columns, cutting heads where the model axis "
                           "exceeds them)")
        elif not p.units:
            reasons.append("B and C (one state shared by every head) are "
                           "whole on every rank, z, x and dt split by head "
                           "(the reference splits the packed columns "
                           "contiguously)")
        elif p.units % size:
            reasons.append("whole heads are split unevenly, rank 0 taking "
                           "the largest share (the reference pads the "
                           "columns to an even split)")
    if not reasons:
        raise ValueError(f"{d}: {mine} B on rank 0, the reference's layout "
                         f"{ref} B, and no rule says why")
    return {"reason": "; ".join(dict.fromkeys(reasons)), "bytes": mine,
            "reference_bytes": ref}


def head_dim(axes: Sequence[Optional[str]]) -> Optional[int]:
    """The dim a ParamDef's ``parts`` describe: its first head axis."""
    for i, a in enumerate(axes):
        if a in ("heads", "kv_heads", "heads2"):
            return i
    return None


NULL_CTX = ShardingCtx()
