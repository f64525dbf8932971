"""Training step: microbatched gradient accumulation, next-token
cross-entropy, the AdamW update, an optional gradient-compression hook —
the JAX package's ``train/train_step.py`` in torch, on one card.

``train_step(params, opt_state, batch)`` takes the loss's gradient with
autograd through ``Model.forward(mode="train")``: on the card the forward
runs the flash_attention and gla_chunk kernels and the backward their
plain versions' gradients (``kernels/*/ops.py``). The reference's
``ShardingCtx`` and ``grad_specs`` place arrays on a mesh; one card has
none, so they are left out. The parameters and moments are updated in
place (``optim.apply_updates``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import AdamWConfig, AdamWState, apply_updates


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """logits: [B, S, V] f32; targets: [B, S] int. Mean CE over tokens."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def _split_microbatches(batch: Dict[str, torch.Tensor], n_mb: int
                        ) -> List[Dict[str, torch.Tensor]]:
    """``n_mb`` microbatches of equal size along the batch axis (views)."""
    out = [dict() for _ in range(n_mb)]
    for key, x in batch.items():
        if x.shape[0] % n_mb:
            raise ValueError(f"batch {x.shape[0]} of {key!r} does not split "
                             f"into {n_mb} microbatches")
        for mb, part in zip(out, x.chunk(n_mb, dim=0)):
            mb[key] = part
    return out


def make_loss_fn(model: Model) -> Callable:
    """``loss_fn(params, mb) -> (loss + aux, (loss, aux))``."""
    def loss_fn(params, mb: Dict[str, torch.Tensor]):
        logits, _, aux = model.forward(params, mb, mode="train")
        loss = cross_entropy(logits, mb["targets"])
        return loss + aux, (loss, aux)
    return loss_fn


def grads_of(loss_fn: Callable, params, mb) -> Tuple[list, torch.Tensor]:
    """The gradient of ``loss_fn``'s total at ``params`` (one leaf per
    parameter, in ``tree_leaves`` order, in the parameters' dtypes) and
    the loss without aux. ``params`` is not modified: the forward runs on
    detached aliases that require grad."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        total, (loss, _) = loss_fn(live, mb)
        grads = torch.autograd.grad(total, tree_leaves(live))
    return list(grads), loss.detach()


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    compress_fn: Optional[Callable] = None) -> Callable:
    """``compress_fn``: optional (grads -> grads) hook applied once per
    step before the optimizer — e.g. ``compression.make_ef_compressor``'s
    int8 error feedback."""
    cfg = model.cfg
    loss_fn = make_loss_fn(model)

    def train_step(params, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        n_mb = max(cfg.microbatches, 1)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tree_leaves(params)]
        loss_sum = 0.0
        for mb in _split_microbatches(batch, n_mb):
            grads, loss = grads_of(loss_fn, params, mb)
            for a, g in zip(acc, grads):
                a.add_(g.to(torch.float32))
            loss_sum = loss_sum + loss
            del grads
        grads = tree_unflatten(params, [a.div_(n_mb) for a in acc])
        if compress_fn is not None:
            grads = compress_fn(grads)
        params, opt_state, metrics = apply_updates(opt_cfg, params, grads,
                                                   opt_state)
        metrics["loss"] = loss_sum / n_mb
        return params, opt_state, metrics

    return train_step

