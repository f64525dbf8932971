"""Training step: microbatched gradient accumulation, next-token
cross-entropy, the AdamW update, an optional gradient-compression hook —
the JAX package's ``train/train_step.py`` in torch.

``train_step(params, opt_state, batch)`` takes the loss's gradient with
autograd through ``Model.forward(mode="train")``: on the card the forward
runs the flash_attention and gla_chunk kernels and the backward their
plain versions' gradients (``kernels/*/ops.py``). The parameters and
moments are updated in place (``optim.apply_updates``).

Under a sharded ``ShardingCtx`` (the reference's ``ctx``, which GSPMD
partitions): each rank holds its slices (``Model.init(gen, ctx)``), the
forward differentiates through the context's collectives, and
``cross_entropy`` is vocab-parallel: the rank's logits columns stay where
they are, and the max, the sum of exponentials and the gold logit are
each all-reduced in f32 (for internlm2 a gathered microbatch of 1 x 2048
tokens would be 758 MB of f32 logits per rank). Once per step
``sync_grads`` makes the rank's gradient the whole gradient of its
slices (the data axis's sum where "batch" is split; each duplicated kv
head's sum over its holders), and the optimizer's global norm counts
every element of the global parameter once. The reference's
``grad_specs`` (GSPMD's ZeRO over data) has no counterpart: the port's
data-parallel step is ``train/manual_dp.py``, which also runs fsdp.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.sharding import NULL_CTX, ParamShard, ShardingCtx
from repro_torch.optim import AdamWConfig, AdamWState, apply_updates


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  ctx: ShardingCtx = NULL_CTX, start: int = 0
                  ) -> torch.Tensor:
    """logits: [B, S, V] f32; targets: [B, S] int. Mean CE over tokens.
    Under a sharded ``ctx``: ``logits`` are this rank's columns, vocab
    ids from ``start`` on (``Model.vocab_range``), and the max, the sum
    of exponentials and the gold logit are reduced over "act_vocab" in
    f32 (the max without a gradient: the result does not depend on it);
    over a split "batch" the mean is the global batch's. Under sequence
    parallelism the logits cover every position, vocab-parallel all the
    same (``ShardingCtx.logits_layout``)."""
    ctx = ctx.logits_layout()
    if ctx.size("act_vocab") == 1 and ctx.size("batch") == 1:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        return torch.mean(lse - gold)
    n = logits.shape[-1]
    top = (logits.detach().amax(dim=-1) if n else
           logits.new_full(logits.shape[:-1], float("-inf")))
    m = ctx.reduce_max(top, "act_vocab")
    se = ctx.reduce(torch.exp(logits - m[..., None]).sum(dim=-1),
                    "act_vocab")
    local = targets.long() - start
    hit = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, max(n - 1, 0))[..., None])
    gold = ctx.reduce(torch.where(hit, gold[..., 0], 0.0), "act_vocab")
    per_token = m + torch.log(se) - gold
    if ctx.size("batch") == 1:
        return torch.mean(per_token)
    return ctx.reduce(per_token.sum(), "batch") / (per_token.numel()
                                                   * ctx.size("batch"))


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


def make_loss_fn(model: Model, ctx: ShardingCtx = NULL_CTX) -> Callable:
    """``loss_fn(params, mb) -> (loss + aux, (loss, aux))`` (this rank's
    params and microbatch under a sharded ``ctx``; the values are every
    rank's alike)."""
    start = model.vocab_range(ctx)[0]

    def loss_fn(params, mb: Dict[str, torch.Tensor]):
        logits, _, aux = model.forward(params, mb, mode="train", ctx=ctx)
        loss = cross_entropy(logits, mb["targets"], ctx, start)
        return loss + aux, (loss, aux)
    return loss_fn


def loss_and_grads(loss_fn: Callable, params, mb, live=None
                   ) -> Tuple[list, Tuple[torch.Tensor, ...]]:
    """The gradient of ``loss_fn``'s total at ``params`` (one leaf per
    parameter, in ``tree_leaves`` order, in the parameters' dtypes) and
    (the total, the loss without aux, aux), detached. ``params`` is not
    modified: the forward runs on detached aliases that require grad, or
    on ``live`` (``params`` as the forward reads them: a ``ParamShard``
    leaf's gradient is its f32 stand-in's)."""
    if live is None:
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        total, (loss, aux) = loss_fn(live, mb)
        grads = torch.autograd.grad(total, [
            x.grad if isinstance(x, ParamShard) else x
            for x in tree_leaves(live)])
    return list(grads), (total.detach(), loss.detach(), aux.detach())


def grads_of(loss_fn: Callable, params, mb) -> Tuple[list, torch.Tensor]:
    """``loss_and_grads``' gradient and the loss without aux."""
    grads, (_, loss, _) = loss_and_grads(loss_fn, params, mb)
    return grads, loss


@torch.no_grad()
def sync_grads(grads: list, model: Model, ctx: ShardingCtx) -> list:
    """Once per step under a sharded ``ctx``: this rank's accumulated
    gradients (``tree_leaves`` order) made the whole gradient of its
    slices — summed over the data axis where "batch" is split (each rank
    holds its share of the global mean; one f32 all-reduce of every
    leaf), then each kv head that several ranks hold summed over them,
    each leaf held whole that the ranks read by their heads' channels
    (RWKV6's vectors) and, under sequence parallelism, each leaf the
    ranks apply to their own positions (the norms, ``bo``, zamba2's
    ``fuse``: ``ParamDef.per_position``) over the model axis, in one
    all-reduce (``ShardingCtx.sum_shared``). Unsharded, ``grads`` as they
    are."""
    if ctx.size("batch") > 1:
        flat = ctx.reduce(torch.cat([g.float().reshape(-1) for g in grads]),
                          "batch")
        grads = [v.view(g.shape).to(g.dtype) for v, g in
                 zip(torch.split(flat, [g.numel() for g in grads]), grads)]
    return ctx.sum_shared(grads, tree_leaves(model.defs))


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    compress_fn: Optional[Callable] = None, *,
                    ctx: ShardingCtx = NULL_CTX) -> Callable:
    """``compress_fn``: optional (grads -> grads) hook applied once per
    step before the optimizer — e.g. ``compression.make_ef_compressor``'s
    int8 error feedback. ``ctx``: the layout (this rank's params, moments
    and batch rows; gradients synced once per step by ``sync_grads``)."""
    cfg = model.cfg
    if ctx.size("embed") > 1:
        raise NotImplementedError(
            "fsdp (\"embed\" over the data axis) trains under "
            "train/manual_dp.py's step")
    loss_fn = make_loss_fn(model, ctx)

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
        grads = tree_unflatten(params, sync_grads(
            [a.div_(n_mb) for a in acc], model, ctx))
        if compress_fn is not None:
            grads = compress_fn(grads)
        params, opt_state, metrics = apply_updates(
            opt_cfg, params, grads, opt_state, ctx=ctx, defs=model.defs)
        metrics["loss"] = loss_sum / n_mb
        return params, opt_state, metrics

    return train_step

