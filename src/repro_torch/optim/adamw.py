"""AdamW with global-norm clipping and a linear-warmup cosine schedule,
over the port's dict parameter trees (``models/param.py``): the JAX
package's ``optim/adamw.py`` in torch.

Moments are f32. The update of each leaf is computed in f32 and cast back
to the parameter's dtype; decoupled weight decay applies to matrices only
(``ndim >= 2``). Where the reference returns new arrays, ``apply_updates``
writes the new parameters and moments into the tensors it is given (one
copy of each fewer on the card); the step counter is a new tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.param import tree_leaves, tree_map


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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, leaves in the
    reference's order."""
    sq = sum(torch.sum(torch.square(g.to(torch.float32)))
             for g in tree_leaves(tree))
    return torch.sqrt(sq)


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
    ``v``, in place. ``decay``: True (a matrix), False, or an f32 mask of
    ``p``'s shape (1 where weight decay applies), as ``manual_dp``'s flat
    shards need."""
    g = g.to(torch.float32) * scale
    m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
    v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
    delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    pf = p.to(torch.float32)
    if isinstance(decay, torch.Tensor):
        delta = delta + cfg.weight_decay * pf * decay
    elif decay:
        delta = delta + cfg.weight_decay * pf
    p.copy_((pf - lr * delta).to(p.dtype))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState
                  ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """Clip by the global norm, then one AdamW step. Writes the new
    parameters and moments in place; returns (params, the new state,
    metrics {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr, b1c, b2c = step_scalars(cfg, step)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        update_leaf(cfg, p, g, m, v, scale=scale, lr=lr, b1c=b1c, b2c=b2c,
                    decay=p.dim() >= 2)
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
