"""Manual data-parallel training step with ZeRO-sharded moments, over
``torch.distributed`` — the intent of the JAX package's
``train/manual_dp.py`` (``shard_map`` with a deferred reduce-scatter) on
one process per card.

Each rank runs its microbatch loop on its part of the batch with no
traffic, accumulating f32 gradients into one flat bucket (every parameter
leaf, in ``tree_leaves`` order, padded to a multiple of the world size).
Then, once per step, the gradient crosses the wire exactly once as one
``reduce_scatter_tensor`` (the mean over ranks), each rank applies AdamW
to its own shard of the parameters with its own shard of the f32 moments
(ZeRO), and the updated shard returns exactly once as one
``all_gather_into_tensor``. One ``all_reduce`` of two scalars (the loss
and the shard's sum of squared gradients) gives the loss and the global
norm. Wire bytes per step: the bucket in f32 out, the parameters back —
independent of the number of microbatches.

NCCL on cards, gloo on the CPU (the tests). ``collective_plan`` states
the step's collectives and their sizes; the step issues them through a
``Collectives`` (``torch.distributed``), and the dry run
(``launch/dryrun.py``) traces it with a recorder in its place and holds
what it issued against the plan.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves
from repro_torch.optim import AdamWConfig, AdamWState
from repro_torch.optim.adamw import step_scalars, update_leaf
from repro_torch.train.train_step import (_split_microbatches, grads_of,
                                          make_loss_fn)


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


def collective_plan(params, world: int) -> List[Dict[str, Any]]:
    """The collectives one step issues at ``world`` ranks, in order, each
    as {"op": the ``torch.distributed`` call, "kind", "dtype", and
    "result_bytes": the tensor it leaves on a rank}: one reduce-scatter of
    the f32 gradient bucket (its result one rank's shard), one all-reduce
    of two f32 scalars (the loss and the shard's squared norm), one
    all-gather of the updated shards in the parameters' dtype (its result
    the whole bucket)."""
    lay = FlatLayout(params, world, 0)
    gathered = lay.dtype.itemsize * lay.padded
    return [{"op": "reduce_scatter_tensor", "kind": "reduce-scatter",
             "dtype": str(torch.float32), "result_bytes": 4 * lay.shard},
            {"op": "all_reduce", "kind": "all-reduce",
             "dtype": str(torch.float32), "result_bytes": 8},
            {"op": "all_gather_into_tensor", "kind": "all-gather",
             "dtype": str(lay.dtype), "result_bytes": gathered}]


class Collectives:
    """The step's three collectives over a ``torch.distributed`` group."""

    def __init__(self, group=None):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def reduce_scatter_tensor(self, out: torch.Tensor, inp: torch.Tensor):
        dist.reduce_scatter_tensor(out, inp, op=dist.ReduceOp.SUM,
                                   group=self.group)

    def all_reduce(self, t: torch.Tensor):
        dist.all_reduce(t, group=self.group)

    def all_gather_into_tensor(self, out: torch.Tensor, inp: torch.Tensor):
        dist.all_gather_into_tensor(out, inp, group=self.group)


def init_shard_state(params, group=None) -> AdamWState:
    """Step 0 and zero f32 moments for this rank's shard."""
    lay = FlatLayout(params, dist.get_world_size(group),
                     dist.get_rank(group))
    z = lambda: torch.zeros(lay.shard, dtype=torch.float32,
                            device=lay.device)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=lay.device),
                      z(), z())


def abstract_zero_opt_state(params, world: int) -> AdamWState:
    """``init_shard_state``'s shapes and dtypes on ``meta`` (the JAX
    package's ``train/manual_dp.py:abstract_zero_opt_state``): the step
    and one rank's f32 moment shards of the flat bucket."""
    lay = FlatLayout(params, world, 0)
    z = lambda: torch.empty(lay.shard, dtype=torch.float32, device="meta")
    return AdamWState(torch.empty((), dtype=torch.int32, device="meta"),
                      z(), z())


def make_manual_dp_train_step(model: Model, opt_cfg: AdamWConfig,
                              group=None, comm=None) -> Callable:
    """``step(params, shard_state, batch) -> (params, shard_state,
    metrics)``: ``batch`` is this rank's part of the global batch,
    ``shard_state`` this rank's ZeRO shard (``init_shard_state``). The
    parameters (replicated) are updated in place on every rank. Metrics:
    the mean loss over ranks, the global grad norm, the learning rate.
    ``comm`` (default ``Collectives(group)``) issues the collectives of
    ``collective_plan``; it has their three methods, ``world`` and
    ``rank``."""
    cfg = model.cfg
    loss_fn = make_loss_fn(model)
    comm = Collectives(group) if comm is None else comm
    world, rank = comm.world, comm.rank

    def step(params, opt: AdamWState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        leaves = tree_leaves(params)
        lay = FlatLayout(params, world, rank)
        n_mb = max(cfg.microbatches, 1)
        bucket = torch.zeros(lay.padded, dtype=torch.float32,
                             device=lay.device)
        views = lay.views(bucket)
        loss_sum = torch.zeros((), dtype=torch.float32, device=lay.device)
        for mb in _split_microbatches(batch, n_mb):
            grads, loss = grads_of(loss_fn, params, mb)
            for view, g in zip(views, grads):
                view.add_(g.reshape(-1).to(torch.float32))
            loss_sum += loss
            del grads
        bucket.div_(n_mb)
        # ---- the one reduction: ZeRO reduce-scatter, then the mean
        g = torch.empty(lay.shard, dtype=torch.float32, device=lay.device)
        comm.reduce_scatter_tensor(g, bucket)
        g.div_(world)
        del bucket, views
        # loss and the global norm: the shards partition the bucket
        scalars = torch.stack([loss_sum / n_mb, torch.sum(torch.square(g))])
        comm.all_reduce(scalars)
        loss, gnorm = scalars[0] / world, torch.sqrt(scalars[1])
        scale = torch.clamp(opt_cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        new_step = opt.step + 1
        lr, b1c, b2c = step_scalars(opt_cfg, new_step)
        # ---- AdamW on this rank's shard; decay on matrices only
        p = lay.mine(lay.flat(leaves, torch.float32))
        decay = torch.zeros(lay.padded, dtype=torch.float32,
                            device=lay.device)
        for view, x in zip(lay.views(decay), leaves):
            view.fill_(float(x.dim() >= 2))
        decay = lay.mine(decay)
        update_leaf(opt_cfg, p, g, opt.mu, opt.nu, scale=scale, lr=lr,
                    b1c=b1c, b2c=b2c, decay=decay)
        # ---- the one gather of the updated shard
        full = torch.empty(lay.padded, dtype=lay.dtype, device=lay.device)
        comm.all_gather_into_tensor(full, p.to(lay.dtype).contiguous())
        with torch.no_grad():
            for x, view in zip(leaves, lay.views(full)):
                x.copy_(view.reshape(x.shape))
        return params, AdamWState(new_step, opt.mu, opt.nu), \
            {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return step
