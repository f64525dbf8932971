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

NCCL on cards, gloo on the CPU (the tests).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

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


def init_shard_state(params, group=None) -> AdamWState:
    """Step 0 and zero f32 moments for this rank's shard."""
    lay = FlatLayout(params, dist.get_world_size(group),
                     dist.get_rank(group))
    z = lambda: torch.zeros(lay.shard, dtype=torch.float32,
                            device=lay.device)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=lay.device),
                      z(), z())


def make_manual_dp_train_step(model: Model, opt_cfg: AdamWConfig,
                              group=None) -> Callable:
    """``step(params, shard_state, batch) -> (params, shard_state,
    metrics)``: ``batch`` is this rank's part of the global batch,
    ``shard_state`` this rank's ZeRO shard (``init_shard_state``). The
    parameters (replicated) are updated in place on every rank. Metrics:
    the mean loss over ranks, the global grad norm, the learning rate."""
    cfg = model.cfg
    loss_fn = make_loss_fn(model)
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)

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
        dist.reduce_scatter_tensor(g, bucket, op=dist.ReduceOp.SUM,
                                   group=group)
        g.div_(world)
        del bucket, views
        # loss and the global norm: the shards partition the bucket
        scalars = torch.stack([loss_sum / n_mb, torch.sum(torch.square(g))])
        dist.all_reduce(scalars, group=group)
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
        dist.all_gather_into_tensor(full, p.to(lay.dtype).contiguous(),
                                    group=group)
        with torch.no_grad():
            for x, view in zip(leaves, lay.views(full)):
                x.copy_(view.reshape(x.shape))
        return params, AdamWState(new_step, opt.mu, opt.nu), \
            {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return step
