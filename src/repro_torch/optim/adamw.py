"""AdamW with global-norm clipping and a linear-warmup cosine schedule,
over the port's dict parameter trees (``models/param.py``): the JAX
package's ``optim/adamw.py`` in torch.

Moments are f32. The update of each leaf is computed in f32 and cast back
to the parameter's dtype; decoupled weight decay applies to matrices only
(``ndim >= 2``). Where the reference returns new arrays, ``apply_updates``
writes the new parameters and moments into the tensors it is given (one
copy of each fewer on the card); the step counter is a new tensor.

Under a sharded ``ShardingCtx`` the trees are this rank's slices, and the
global norm counts every element of the global parameter once: each
rank's sum of squares weights an element by 1 / the number of ranks of
the model axis that hold it (``ShardingCtx.held_pieces``: a leaf held
whole by all of them, a kv head by each rank that reads it), and the
sums are all-reduced over the model axis. A leaf fsdp splits over the
data axis is weighed by its model-axis holders only (each element lies
on one data rank); ``train/manual_dp.py`` updates its shard in place
with ``update_leaf`` and moments of the shard's size.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.models.sharding import NULL_CTX, ShardingCtx


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32 []
    mu: Any                # f32 tree like the params
    nu: Any                # f32 tree like the params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), f32."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def init_state(params) -> AdamWState:
    """Step 0 and zero f32 moments on the parameters' device."""
    dev = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def abstract_state(abstract_params) -> AdamWState:
    """``init_state``'s shapes and dtypes as ``meta`` tensors (the JAX
    package's ``optim/adamw.py:abstract_state``): what the dry run traces
    a train step with."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      mu=tree_map(f32, abstract_params),
                      nu=tree_map(f32, abstract_params))


def held_weight(leaf: torch.Tensor, d, ctx: ShardingCtx):
    """1 / the number of ranks of the model axis holding each element of
    ``leaf`` (this rank's slice of ParamDef ``d``; ``held_pieces``): a
    number where one count holds for the whole leaf, else (the f32 weight
    of each index along the dim the pieces cut, the elements after that
    dim per index), which ``held_square_sum`` tiles chunk by chunk (no
    weight of the leaf's size: a shard of the data axis may hold all of a
    leaf, and every rank's peak should be rank 0's)."""
    pieces = ctx.held_pieces(leaf, d.axes, d.shape, d.parts)
    if len(pieces) == 1:
        return 1.0 / pieces[0][1]
    dim = next(k for k, (a, b) in enumerate(zip(pieces[0][0].shape,
                                                 leaf.shape)) if a != b)
    per = torch.cat([torch.full((p.shape[dim],), 1.0 / n,
                                dtype=torch.float32, device=leaf.device)
                     for p, n in pieces])
    return per, math.prod(leaf.shape[dim + 1:])


# elements per chunk of a leaf's flat range that ``held_square_sum`` and
# ``manual_dp``'s update take at a time: bounded f32 temporaries
CHUNK = 1 << 22


def held_square_sum(g: torch.Tensor, w, start: int = 0) -> torch.Tensor:
    """The f32 sum of squares of the flat ``g``, each element weighted by
    its ``held_weight`` ``w`` (``g``: the leaf's flat elements from
    ``start`` on, as ``manual_dp``'s shard holds a range of a leaf)."""
    g = g.reshape(-1).to(torch.float32)
    if not isinstance(w, tuple):
        return torch.dot(g, g) * w
    per, inner = w
    row = per.repeat_interleave(inner)        # one run of the cut dim
    out = torch.zeros((), dtype=torch.float32, device=g.device)
    for c0 in range(0, g.numel(), CHUNK):
        part = g[c0:c0 + CHUNK]
        at = (start + c0) % row.numel()
        reps = -(-(at + part.numel()) // row.numel())
        out = out + torch.dot(part * row.repeat(reps)[at:at + part.numel()],
                              part)
    return out


def global_norm(tree, ctx: ShardingCtx = NULL_CTX, defs=None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, leaves in the
    reference's order. Under a model axis (``ctx``), of the global tree
    of which ``tree`` is this rank's slices (``defs``: the tree's
    ParamDefs): a collective every rank of the model axis calls."""
    if ctx.size("heads") == 1:
        sq = sum(torch.sum(torch.square(g.to(torch.float32)))
                 for g in tree_leaves(tree))
        return torch.sqrt(sq)
    # summed over the ranks, every element of the global tree counts once
    sq = sum(held_square_sum(g, held_weight(g, d, ctx))
             for g, d in zip(tree_leaves(tree), tree_leaves(defs)))
    return torch.sqrt(ctx.reduce(sq.reshape(1), "heads")[0])


def step_scalars(cfg: AdamWConfig, step: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lr, 1 - b1^step, 1 - b2^step) for the step being taken."""
    s = step.to(torch.float32)
    return schedule(cfg, step), 1 - cfg.b1 ** s, 1 - cfg.b2 ** s


@torch.no_grad()
def update_leaf(cfg: AdamWConfig, p: torch.Tensor, g: torch.Tensor,
                m: torch.Tensor, v: torch.Tensor, *, scale, lr, b1c, b2c,
                decay) -> None:
    """One AdamW update of ``p`` (any dtype) and its f32 moments ``m``,
    ``v``, in place. ``decay``: whether weight decay applies (a matrix;
    ``manual_dp`` passes each leaf's part of its flat shard)."""
    g = g.to(torch.float32) * scale
    m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
    v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
    delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    pf = p.to(torch.float32)
    if decay:
        delta = delta + cfg.weight_decay * pf
    p.copy_((pf - lr * delta).to(p.dtype))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState, *,
                  ctx: ShardingCtx = NULL_CTX, defs=None
                  ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """Clip by the global norm, then one AdamW step. Writes the new
    parameters and moments in place; returns (params, the new state,
    metrics {"grad_norm", "lr"}). Under a model axis the trees are this
    rank's slices of ``defs`` (``global_norm``)."""
    gnorm = global_norm(grads, ctx, defs)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr, b1c, b2c = step_scalars(cfg, step)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        update_leaf(cfg, p, g, m, v, scale=scale, lr=lr, b1c=b1c, b2c=b2c,
                    decay=p.dim() >= 2)
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
