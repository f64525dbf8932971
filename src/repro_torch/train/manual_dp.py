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

NCCL on cards, gloo on the CPU (the tests). ``collective_plan`` states
the step's collectives, their sizes, axes and group sizes; the step
issues them through a ``Collectives`` (``torch.distributed``), and the
dry run (``launch/dryrun.py``) traces it with a recorder in its place and
holds what it issued against the plan.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves
from repro_torch.models.sharding import NULL_CTX, ShardingCtx
from repro_torch.optim import AdamWConfig, AdamWState
from repro_torch.optim.adamw import (held_square_sum, held_weight,
                                    step_scalars, update_leaf)
from repro_torch.train.train_step import (_split_microbatches,
                                          loss_and_grads, make_loss_fn)


class FlatLayout:
    """Where each parameter leaf lies in the flat bucket, and this rank's
    shard of it."""

    def __init__(self, params, world: int, rank: int):
        leaves = tree_leaves(params)
        self.sizes = [p.numel() for p in leaves]
        self.n = sum(self.sizes)
        self.padded = -(-self.n // world) * world
        self.shard = self.padded // world
        self.lo = rank * self.shard
        dtypes = {p.dtype for p in leaves}
        # the gathered parameters travel in their own dtype where all
        # share one, else in f32 (which holds any of them exactly)
        self.dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32
        self.device = leaves[0].device

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


def collective_plan(params, world: int, model: int = 1
                    ) -> List[Dict[str, Any]]:
    """The collectives one step issues over a data axis of ``world``
    ranks (beside a model axis of ``model``; ``params``: a rank's), in
    order, each as {"op": the ``torch.distributed`` call, "kind",
    "dtype", "result_bytes": the tensor it leaves on a rank, "axis" and
    "group": the mesh axes it runs over and their ranks}: one
    reduce-scatter of the f32 gradient bucket over data (its result one
    rank's shard), one all-reduce of two f32 scalars over every rank (the
    loss and the shard's squared norm), one all-gather of the updated
    shards over data in the parameters' dtype (its result the whole
    bucket). The kv heads' sum before them is ``model_axis_plan``'s."""
    lay = FlatLayout(params, world, 0)
    gathered = lay.dtype.itemsize * lay.padded
    data = {"axis": "data", "group": world}
    every = {"axis": "+".join(a for a, n in (("data", world),
                                             ("model", model)) if n > 1)
             or "data", "group": world * model}
    return [{"op": "reduce_scatter_tensor", "kind": "reduce-scatter",
             "dtype": str(torch.float32), "result_bytes": 4 * lay.shard,
             **data},
            {"op": "all_reduce", "kind": "all-reduce",
             "dtype": str(torch.float32), "result_bytes": 8, **every},
            {"op": "all_gather_into_tensor", "kind": "all-gather",
             "dtype": str(lay.dtype), "result_bytes": gathered, **data}]


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


def _groups(group, ctx: ShardingCtx) -> Tuple[Any, Any, int, int]:
    """(the data group, the group of every rank, the data axis's size,
    this rank's place on it): a mesh's under a sharded ``ctx``, else
    ``group`` for both (the world where None)."""
    if ctx.mesh is not None:
        mesh = ctx.mesh
        return (mesh.group("data"), mesh.world_group(),
                mesh.shape[mesh.axis_names.index("data")],
                mesh.coord("data"))
    return group, group, dist.get_world_size(group), dist.get_rank(group)


def init_shard_state(params, group=None,
                     ctx: ShardingCtx = NULL_CTX) -> AdamWState:
    """Step 0 and zero f32 moments for this rank's shard (of its slices'
    bucket under a model axis)."""
    _, _, world, rank = _groups(group, ctx)
    lay = FlatLayout(params, world, rank)
    z = lambda: torch.zeros(lay.shard, dtype=torch.float32,
                            device=lay.device)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=lay.device),
                      z(), z())


def abstract_zero_opt_state(params, world: int) -> AdamWState:
    """``init_shard_state``'s shapes and dtypes on ``meta`` (the JAX
    package's ``train/manual_dp.py:abstract_zero_opt_state``): the step
    and one rank's f32 moment shards of the flat bucket (``params``: a
    rank's, ``world``: the data axis's size)."""
    lay = FlatLayout(params, world, 0)
    z = lambda: torch.empty(lay.shard, dtype=torch.float32, device="meta")
    return AdamWState(torch.empty((), dtype=torch.int32, device="meta"),
                      z(), z())


def make_manual_dp_train_step(model: Model, opt_cfg: AdamWConfig,
                              group=None, comm=None,
                              ctx: ShardingCtx = NULL_CTX) -> Callable:
    """``step(params, shard_state, batch) -> (params, shard_state,
    metrics)``: ``batch`` is this rank's part of the global batch,
    ``shard_state`` this rank's ZeRO shard (``init_shard_state``). The
    parameters (replicated over data; under a sharded ``ctx`` the rank's
    slices) are updated in place on every rank. Metrics: the loss
    (cross-entropy + aux) and the global grad norm, each the same on
    every rank, and the learning rate. ``comm`` (default
    ``Collectives()``) issues the collectives of ``collective_plan``; it
    has their three methods (a ``group=`` each)."""
    cfg = model.cfg
    loss_fn = make_loss_fn(model, ctx.batch_local())
    comm = Collectives() if comm is None else comm
    data_group, every, world, rank = _groups(group, ctx)
    defs = tree_leaves(model.defs)

    def step(params, opt: AdamWState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        leaves = tree_leaves(params)
        lay = FlatLayout(params, world, rank)
        n_mb = max(cfg.microbatches, 1)
        bucket = torch.zeros(lay.padded, dtype=torch.float32,
                             device=lay.device)
        views = [v.view(x.shape) for v, x in zip(lay.views(bucket), leaves)]
        loss_sum = torch.zeros((), dtype=torch.float32, device=lay.device)
        for mb in _split_microbatches(batch, n_mb):
            grads, (total, _, _) = loss_and_grads(loss_fn, params, mb)
            for view, g in zip(views, grads):
                view.add_(g.to(torch.float32))
            loss_sum += total
            del grads
        # the kv heads several ranks hold: their partials summed, once
        for view, got in zip(views, ctx.sum_shared(views, defs)):
            if got is not view:
                view.copy_(got)
        bucket.div_(n_mb)
        # ---- the one reduction: ZeRO reduce-scatter, then the mean
        g = torch.empty(lay.shard, dtype=torch.float32, device=lay.device)
        comm.reduce_scatter_tensor(g, bucket, group=data_group)
        g.div_(world)
        del bucket, views
        # loss and the global norm: the shards partition the bucket; under
        # a model axis each element weighs 1 / its holders, and the loss
        # (every model rank's alike) 1 / the model axis's size. Leaf by
        # leaf: no temporary of the shard's size
        m = ctx.size("heads")
        segs = lay.segments()
        sq = torch.zeros((), dtype=torch.float32, device=lay.device)
        for i, a, b, o in segs:
            w = held_weight(leaves[i], defs[i], ctx)
            sq = sq + held_square_sum(
                g[o:o + b - a], w[a:b] if isinstance(w, torch.Tensor) else w)
        scalars = torch.stack([loss_sum / (n_mb * m), sq])
        comm.all_reduce(scalars, group=every)
        loss, gnorm = scalars[0] / world, torch.sqrt(scalars[1])
        scale = torch.clamp(opt_cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        new_step = opt.step + 1
        lr, b1c, b2c = step_scalars(opt_cfg, new_step)
        # ---- AdamW on this rank's shard, leaf by leaf, written into the
        # buffer the gather sends; decay on matrices only
        send = torch.zeros(lay.shard, dtype=lay.dtype, device=lay.device)
        for i, a, b, o in segs:
            part = send[o:o + b - a]
            part.copy_(leaves[i].reshape(-1)[a:b])
            update_leaf(opt_cfg, part, g[o:o + b - a], opt.mu[o:o + b - a],
                        opt.nu[o:o + b - a], scale=scale, lr=lr, b1c=b1c,
                        b2c=b2c, decay=leaves[i].dim() >= 2)
        del g
        # ---- the one gather of the updated shard
        full = torch.empty(lay.padded, dtype=lay.dtype, device=lay.device)
        comm.all_gather_into_tensor(full, send, group=data_group)
        del send
        with torch.no_grad():
            for x, view in zip(leaves, lay.views(full)):
                x.copy_(view.reshape(x.shape))
        return params, AdamWState(new_step, opt.mu, opt.nu), \
            {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return step
