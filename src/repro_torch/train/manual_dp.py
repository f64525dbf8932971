"""Manual data-parallel training step with ZeRO-sharded moments, over
``torch.distributed`` — the JAX package's ``train/manual_dp.py``
(``shard_map`` with a deferred reduce-scatter) on one process per card,
beside a model axis or without one.

Each rank runs its microbatch loop on its part of the batch with no
traffic over the data axis, accumulating f32 gradients into one flat
bucket (every parameter leaf it holds, in ``tree_leaves`` order, padded
to a multiple of the data axis's size). Then, once per step, the
gradient crosses the data axis exactly once as one
``reduce_scatter_tensor`` (the mean over the data ranks), each rank
applies AdamW to its own shard of the bucket with its own shard of the
f32 moments (ZeRO), and the updated shard returns exactly once as one
``all_gather_into_tensor``. One ``all_reduce`` of two scalars over every
rank (the loss and the shard's sum of squared gradients, each element
over the ranks of the model axis holding it) gives the loss and the
global norm. Wire bytes per step over data: the bucket in f32 out, the
parameters back — independent of the number of microbatches. The
reported loss is the reference's: cross-entropy plus aux, the mean over
ranks and microbatches.

Under a model axis (a ``ShardingCtx`` on a ("data", "model") mesh, the
reference's TP/EP left automatic inside the manual data axis): the
bucket holds the rank's slices, the reduce-scatter and the all-gather
run over the rank's data group, and the forward runs under
``ctx.batch_local()`` (each rank's microbatch its own, so the MoE's load
balance is the microbatch's, as the reference's forward under
``NULL_CTX`` inside ``shard_map``). Before the bucket is reduced, each
kv head that several ranks hold has its gradient summed over them
(``ShardingCtx.sum_shared``). So a moment's shard on a rank is its ZeRO
shard over data of the rank's slice over the model axis: the counterpart
of the reference's ``scatter_dims`` / ``merge_specs``.

Under fsdp (``ctx`` splits "embed" over "data": ZeRO-3) the step has
two kinds of leaves (``StepLayout``): those held whole over data go
through the bucket as above; the data-split leaves' gradients arrive per
microbatch, reduce-scattered over "data" in f32 by the model's parameter
gathers (``ShardingCtx.gather_params``), into a flat f32 accumulator of
the rank's shards, and AdamW updates the shards in place with moments of
their size (no gather follows: the parameters stay split).

On the multi-pod mesh ("pod", "data", "model") the data axes are
("pod", "data"): the bucket is reduce-scattered over "pod", then
"data", so a rank's shard is number ``pod x data + data_index`` (the
reference's), the mean divides by pod x data, and the updated shard is
all-gathered over "data", then "pod". With fsdp there too, the
parameters stay on "data" and the moments on ("pod", "data"), as the
reference's rules hold them: once per step the accumulator is
reduce-scattered over "pod", AdamW runs on the 1 / (pod x data) piece,
and the piece is all-gathered over "pod" into the data shard.

NCCL on cards, gloo on the CPU (the tests). ``collective_plan`` states
the step's collectives, their sizes, axes and group sizes; the step
issues them through a ``Collectives`` (``torch.distributed``), and the
dry run (``launch/dryrun.py``) traces it with a recorder in its place and
holds what it issued against the plan.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves, tree_unflatten
from repro_torch.models.sharding import NULL_CTX, ParamShard, ShardingCtx
from repro_torch.optim import AdamWConfig, AdamWState
from repro_torch.optim.adamw import (CHUNK, held_square_sum, held_weight,
                                    step_scalars, update_leaf)
from repro_torch.train.train_step import (_split_microbatches,
                                          loss_and_grads, make_loss_fn)


class FlatLayout:
    """Where each parameter leaf lies in the flat bucket, and this rank's
    shard of it."""

    def __init__(self, params, world: int, rank: int, device=None):
        leaves = params if isinstance(params, list) else tree_leaves(params)
        self.sizes = [p.numel() for p in leaves]
        self.n = sum(self.sizes)
        self.padded = -(-self.n // world) * world
        self.shard = self.padded // world
        self.lo = rank * self.shard
        dtypes = {p.dtype for p in leaves}
        # the gathered parameters travel in their own dtype where all
        # share one, else in f32 (which holds any of them exactly)
        self.dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32
        self.device = leaves[0].device if leaves else device

    def flat(self, leaves, dtype) -> torch.Tensor:
        """The leaves concatenated into one padded bucket of ``dtype``."""
        out = torch.zeros(self.padded, dtype=dtype, device=self.device)
        for view, x in zip(self.views(out), leaves):
            view.copy_(x.reshape(-1))
        return out

    def views(self, flat: torch.Tensor) -> list:
        """Per-leaf flat views of a bucket."""
        return list(torch.split(flat[:self.n], self.sizes))

    def mine(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a bucket."""
        return flat[self.lo:self.lo + self.shard]

    def segments(self) -> List[Tuple[int, int, int, int]]:
        """The leaves' parts in this rank's shard: (leaf, start, stop in
        the leaf's flat elements, offset in the shard), in order."""
        out, base = [], 0
        for i, n in enumerate(self.sizes):
            a, b = max(self.lo, base), min(self.lo + self.shard, base + n)
            if a < b:
                out.append((i, a - base, b - base, a - self.lo))
            base += n
        return out


def collective_plan(params, world: int, model: int = 1, pod: int = 1,
                    split: Sequence[bool] = ()) -> List[Dict[str, Any]]:
    """The collectives one step issues over a data axis of ``world``
    ranks (beside a model axis of ``model``, under a "pod" axis of
    ``pod`` where it is > 1, the multi-pod mesh; ``params``: a rank's,
    ``split``: per leaf whether fsdp holds it split over "data"), in
    order, each as {"op": the ``torch.distributed`` call, "kind",
    "dtype", "result_bytes": the tensor it leaves on a rank, "axis" and
    "group": the mesh axes it runs over and their ranks}: the f32 bucket
    of the leaves held whole over data reduce-scattered over "pod", then
    "data" (its result one rank's shard); the fsdp leaves' f32 shard
    accumulators reduce-scattered over "pod" (multi-pod only); one
    all-reduce of two f32 scalars over every rank (the loss and the
    shards' squared norm); the updated bucket shards all-gathered over
    "data", then "pod", in the parameters' dtype (its result the whole
    bucket), and the fsdp leaves' pieces over "pod". The kv heads' sum
    before them is ``model_axis_plan``'s, and so are the fsdp leaves'
    gathers and reduce-scatters."""
    lay = StepLayout(tree_leaves(params), split, world * pod, 0, pod)
    axes = [("pod", pod)] if pod > 1 else []
    axes.append(("data", world))
    sizes = [n for _, n in axes]
    every = {"axis": "+".join(a for a, n in axes + [("model", model)]
                              if n > 1) or "data",
             "group": math.prod(sizes) * model}
    out, left = [], lay.main.padded
    for a, n in axes:
        left //= n
        out.append({"op": "reduce_scatter_tensor", "kind": "reduce-scatter",
                    "dtype": str(torch.float32), "result_bytes": 4 * left,
                    "axis": a, "group": n})
    if lay.zero3 is not None and pod > 1:
        out.append({"op": "reduce_scatter_tensor", "kind": "reduce-scatter",
                    "dtype": str(torch.float32),
                    "result_bytes": 4 * lay.zero3.shard, "axis": "pod",
                    "group": pod})
    out.append({"op": "all_reduce", "kind": "all-reduce",
                "dtype": str(torch.float32), "result_bytes": 8, **every})
    item = lay.main.dtype.itemsize
    for a, n in reversed(axes):
        left *= n
        out.append({"op": "all_gather_into_tensor", "kind": "all-gather",
                    "dtype": str(lay.main.dtype), "result_bytes": item * left,
                    "axis": a, "group": n})
    if lay.zero3 is not None and pod > 1:
        out.append({"op": "all_gather_into_tensor", "kind": "all-gather",
                    "dtype": str(lay.zero3.dtype),
                    "result_bytes": lay.zero3.dtype.itemsize
                    * lay.zero3.padded, "axis": "pod", "group": pod})
    return out


class StepLayout:
    """The two kinds of leaves of a step: those held whole over the data
    axes go through one flat bucket (``main``: a ``FlatLayout`` over
    every data rank, pod-major), those fsdp holds split over "data"
    (``split``) through a flat f32 accumulator of their shards
    (``zero3``: a ``FlatLayout`` over "pod", whose shard is the whole
    accumulator without one; None where no leaf is split). The moments
    are one flat f32 tensor of ``size``: the bucket's shard, then the
    accumulator's."""

    def __init__(self, leaves, split: Sequence[bool], world: int, rank: int,
                 pod: int = 1):
        split = list(split) or [False] * len(leaves)
        self.split = split
        self.main_idx = [i for i, s in enumerate(split) if not s]
        self.zero3_idx = [i for i, s in enumerate(split) if s]
        per_pod = world // pod
        self.main = FlatLayout([leaves[i] for i in self.main_idx], world,
                               rank, device=leaves[0].device)
        self.zero3 = FlatLayout([leaves[i] for i in self.zero3_idx], pod,
                                rank // per_pod) if self.zero3_idx else None
        self.size = self.main.shard + (self.zero3.shard if self.zero3
                                       else 0)

    def moments(self, flat: torch.Tensor):
        """(the bucket's part, the accumulator's part) of a moment."""
        return flat[:self.main.shard], flat[self.main.shard:]

    def shard_of(self, leaves) -> torch.Tensor:
        """This rank's flat moment (``size`` elements, f32) of per-leaf
        tensors of the rank's parameter shapes (``ctx.shard`` of a full
        moment tree): what ``init_shard_state`` gives zeros of."""
        out = [self.main.mine(self.main.flat([leaves[i] for i in
                                              self.main_idx],
                                             torch.float32))]
        if self.zero3 is not None:
            out.append(self.zero3.mine(self.zero3.flat(
                [leaves[i] for i in self.zero3_idx], torch.float32)))
        return torch.cat(out)


def split_leaves(model: Model, ctx: ShardingCtx) -> List[bool]:
    """Per leaf (``tree_leaves`` order) whether the layout holds it split
    over the data axis ("embed" under fsdp)."""
    return [ctx.embed_dim(d.axes, d.shape) is not None
            for d in tree_leaves(model.defs)]


class Collectives:
    """The collectives of the step and of the model axis
    (``ShardingCtx``'s ``comm``) through ``torch.distributed``, each over
    the group it is given."""

    def reduce_scatter_tensor(self, out: torch.Tensor, inp: torch.Tensor,
                              group=None):
        dist.reduce_scatter_tensor(out, inp, op=dist.ReduceOp.SUM,
                                   group=group)

    def all_reduce(self, t: torch.Tensor, group=None, op=None):
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op,
                        group=group)

    def all_gather_into_tensor(self, out: torch.Tensor, inp: torch.Tensor,
                               group=None):
        dist.all_gather_into_tensor(out, inp, group=group)

    def all_gather(self, out_list, t: torch.Tensor, group=None):
        dist.all_gather(out_list, t, group=group)


def _groups(group, ctx: ShardingCtx):
    """(the data axes as [(name, group, size, this rank's coordinate)],
    outermost first: "pod" on a multi-pod mesh, then "data"; the group of
    every rank; the data ranks in all; this rank's place among them,
    pod-major): a mesh's under a sharded ``ctx``, else ``group`` (the
    world where None)."""
    if ctx.mesh is not None:
        mesh = ctx.mesh
        axes = [(a, mesh.group(a), mesh.shape[mesh.axis_names.index(a)],
                 mesh.coord(a)) for a in ("pod", "data")
                if a in mesh.axis_names]
    else:
        axes = [("data", group, dist.get_world_size(group),
                 dist.get_rank(group))]
    world, rank = 1, 0
    for _, _, n, c in axes:
        world, rank = world * n, rank * n + c
    every = ctx.mesh.world_group() if ctx.mesh is not None else group
    return axes, every, world, rank


def _pod(axes) -> int:
    return next((n for a, _, n, _ in axes if a == "pod"), 1)


def init_shard_state(params, group=None, ctx: ShardingCtx = NULL_CTX,
                     model: Optional[Model] = None) -> AdamWState:
    """Step 0 and zero f32 moments for this rank's shards (of its slices'
    bucket under a model axis; and of its fsdp accumulator, for which the
    ``model`` must be given)."""
    axes, _, world, rank = _groups(group, ctx)
    leaves = tree_leaves(params)
    lay = StepLayout(leaves, _split_of(model, ctx, leaves), world, rank,
                     _pod(axes))
    z = lambda: torch.zeros(lay.size, dtype=torch.float32,
                            device=leaves[0].device)
    return AdamWState(torch.zeros((), dtype=torch.int32,
                                  device=leaves[0].device), z(), z())


def _split_of(model, ctx: ShardingCtx, leaves) -> List[bool]:
    if ctx.size("embed") == 1:
        return [False] * len(leaves)
    if model is None:
        raise ValueError("fsdp: the moments' layout needs the model (its "
                         "leaves split over \"data\")")
    return split_leaves(model, ctx)


def abstract_zero_opt_state(params, world: int, pod: int = 1,
                            split: Sequence[bool] = ()) -> AdamWState:
    """``init_shard_state``'s shapes and dtypes on ``meta`` (the JAX
    package's ``train/manual_dp.py:abstract_zero_opt_state``): the step
    and one rank's f32 moment shards (``params``: a rank's, ``world``:
    the "data" axis's size, ``pod``: the "pod" axis's, ``split``: the
    fsdp leaves, as ``collective_plan``)."""
    lay = StepLayout(tree_leaves(params), split, world * pod, 0, pod)
    z = lambda: torch.empty(lay.size, dtype=torch.float32, device="meta")
    return AdamWState(torch.empty((), dtype=torch.int32, device="meta"),
                      z(), z())


def make_manual_dp_train_step(model: Model, opt_cfg: AdamWConfig,
                              group=None, comm=None,
                              ctx: ShardingCtx = NULL_CTX) -> Callable:
    """``step(params, shard_state, batch) -> (params, shard_state,
    metrics)``: ``batch`` is this rank's part of the global batch,
    ``shard_state`` this rank's ZeRO shard (``init_shard_state``). The
    parameters (replicated over data; under a sharded ``ctx`` the rank's
    slices, under fsdp its parts of the "embed" dims) are updated in
    place on every rank. Metrics: the loss (cross-entropy + aux) and the
    global grad norm, each the same on every rank, and the learning rate.
    ``comm`` (default ``Collectives()``) issues the collectives of
    ``collective_plan``; it has their three methods (a ``group=`` each)."""
    cfg = model.cfg
    loss_fn = make_loss_fn(model, ctx.batch_local())
    comm = Collectives() if comm is None else comm
    axes, every, world, rank = _groups(group, ctx)
    pod = _pod(axes)
    pod_group = next((g for a, g, _, _ in axes if a == "pod"), None)
    defs = tree_leaves(model.defs)

    def step(params, opt: AdamWState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        leaves = tree_leaves(params)
        lay = StepLayout(leaves, _split_of(model, ctx, leaves), world, rank,
                         pod)
        main, zero3 = lay.main, lay.zero3
        dev = leaves[0].device
        n_mb = max(cfg.microbatches, 1)
        bucket = torch.zeros(main.padded, dtype=torch.float32, device=dev)
        views = [None] * len(leaves)
        for i, v in zip(lay.main_idx, main.views(bucket)):
            views[i] = v.view(leaves[i].shape)
        if zero3 is not None:
            # the fsdp leaves' gradients arrive reduce-scattered over
            # "data" in f32, once per microbatch (the gathers' backward)
            acc = torch.zeros(zero3.padded, dtype=torch.float32, device=dev)
            for i, v in zip(lay.zero3_idx, zero3.views(acc)):
                views[i] = v.view(leaves[i].shape)
        live = tree_unflatten(params, [
            ParamShard.of(x) if s else x.detach().requires_grad_()
            for x, s in zip(leaves, lay.split)])
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for mb in _split_microbatches(batch, n_mb):
            grads, (total, _, _) = loss_and_grads(loss_fn, params, mb, live)
            for view, g in zip(views, grads):
                view.add_(g.to(torch.float32))
            loss_sum += total
            del grads
        # the kv heads several ranks hold: their partials summed, once
        for view, got in zip(views, ctx.sum_shared(views, defs)):
            if got is not view:
                view.copy_(got)
        # ---- the one reduction: ZeRO reduce-scatter over each data axis
        # in turn ("pod", then "data"), then the mean
        bucket.div_(n_mb)
        g = bucket
        for _, grp, n, _ in axes:
            out = torch.empty(g.numel() // n, dtype=torch.float32,
                              device=dev)
            comm.reduce_scatter_tensor(out, g, group=grp)
            g = out
        g.div_(world)
        del bucket, views, live
        gz = None
        if zero3 is not None:
            acc.div_(n_mb)
            gz = acc
            if pod > 1:       # the moments' 1 / (pod x data) piece
                gz = torch.empty(zero3.shard, dtype=torch.float32,
                                 device=dev)
                comm.reduce_scatter_tensor(gz, acc, group=pod_group)
                del acc
            gz.div_(world)
        # loss and the global norm: the shards partition the bucket and
        # the accumulators; under a model axis each element weighs 1 /
        # its holders, and the loss (every model rank's alike) 1 / the
        # model axis's size. Leaf by leaf: no temporary of a shard's size
        m = ctx.size("heads")
        parts = [(main, lay.main_idx, g)]
        if zero3 is not None:
            parts.append((zero3, lay.zero3_idx, gz))
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        for flat, idx, grad in parts:
            for j, a, b, o in flat.segments():
                i = idx[j]
                sq = sq + held_square_sum(
                    grad[o:o + b - a], held_weight(leaves[i], defs[i], ctx),
                    a)
        scalars = torch.stack([loss_sum / (n_mb * m), sq])
        comm.all_reduce(scalars, group=every)
        loss, gnorm = scalars[0] / world, torch.sqrt(scalars[1])
        scale = torch.clamp(opt_cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        new_step = opt.step + 1
        lr, b1c, b2c = step_scalars(opt_cfg, new_step)
        # ---- AdamW on this rank's shards, leaf by leaf; decay on
        # matrices only
        mu, nu = lay.moments(opt.mu), lay.moments(opt.nu)
        for k, (flat, idx, grad) in enumerate(parts):
            in_place = flat is zero3 and pod == 1
            send = None if in_place else torch.zeros(
                flat.shard, dtype=flat.dtype, device=dev)
            for j, a, b, o in flat.segments():
                x = leaves[idx[j]]
                if in_place:         # the fsdp shard itself (the whole
                    # leaf: the accumulator is the segments' one shard)
                    part = x.view(-1) if x.is_contiguous() else \
                        x.reshape(-1)
                else:
                    part = send[o:o + b - a]
                    part.copy_(x.reshape(-1)[a:b])
                # in chunks: the update's f32 temporaries stay bounded
                # whichever leaves a rank's shard holds whole
                for c in range(0, b - a, CHUNK):
                    e = min(c + CHUNK, b - a)
                    update_leaf(opt_cfg, part[c:e], grad[o + c:o + e],
                                mu[k][o + c:o + e], nu[k][o + c:o + e],
                                scale=scale, lr=lr, b1c=b1c, b2c=b2c,
                                decay=x.dim() >= 2)
                if in_place and not x.is_contiguous():
                    with torch.no_grad():
                        x.copy_(part.view(x.shape))
            if in_place:
                continue
            # ---- the updated shard gathered back: over "data", then
            # "pod" (the fsdp pieces over "pod" alone)
            gather = reversed(axes) if flat is main else \
                [(None, pod_group, pod, None)]
            for _, grp, n, _ in gather:
                full = torch.empty(send.numel() * n, dtype=flat.dtype,
                                   device=dev)
                comm.all_gather_into_tensor(full, send, group=grp)
                send = full
            with torch.no_grad():
                for j, view in enumerate(flat.views(send)):
                    x = leaves[idx[j]]
                    x.copy_(view.reshape(x.shape))
            del send
        del g, gz
        return params, AdamWState(new_step, opt.mu, opt.nu), \
            {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return step
