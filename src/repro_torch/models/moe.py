"""Mixture-of-Experts FFN with GShard-style grouped dispatch, the JAX
package's ``models/moe.py`` in torch.

Tokens are reshaped into groups; within each group every token picks its
top-k experts (probabilities renormalised over the k), positions are
assigned by a running count per expert in k-major priority up to a fixed
capacity (over-capacity assignments drop, standard GShard), and the
dispatch and combine are one-hot products: ``disp`` [G, S, E, C] in the
activation dtype, ``comb`` in f32, as the reference computes them outside
any kernel. Padded experts (``n_experts_padded``) exist only for the
reference's expert-parallel divisibility and are masked out of routing.
The Switch load-balancing loss comes back as ``aux``. The dispatch and
the combine run under ``torch.profiler`` ranges "moe.dispatch" and
"moe.combine", so a profiled run reads their share.

Expert-parallel under a sharded ``ctx`` (``models/sharding.py``): a rank
holds its experts (a contiguous range of the padded experts, rank 0 the
largest share) and its columns of the shared experts; the router is
replicated, so every rank routes every token alike (capacity and
positions come from the global routing) and dispatches to its own
experts only; its routed and shared partial outputs are summed in f32
and all-reduced once. Unsplit, the same ending: one f32 sum, rounded
once (the reference rounds the routed output before it adds the shared
experts' product). ``aux`` is equal on every rank: over a split
batch its two means are all-reduced over "batch" first (``manual_dp``'s
forward sees no split batch, so there it is the rank's microbatch's, as
the reference's inside ``shard_map``).

In training the router's computation is replicated: its gradient comes
out whole and equal on every rank because what the rank's experts
consume of it, the gates, and the tokens they and the shared experts
read pass through ``ctx.copy`` (their partial gradients all-reduced),
while the load balance, computed alike on every rank, does not.

DOD-ETL tie-in: a token is a message, the router's expert choice its
business key, experts are partitions and capacity is the consumer's
per-partition buffer (``core/partitioning.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import MoEConfig
from repro_torch.models.param import ParamDef
from repro_torch.models.sharding import NULL_CTX, ShardingCtx

NEG_INF = -1e30


def moe_defs(d_model: int, cfg: MoEConfig, layers: Optional[int] = None):
    lead = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)
    e, fe = cfg.padded_experts, cfg.d_ff_expert
    defs = {
        "router": ParamDef(lead + (d_model, e), lax_ + ("embed", None),
                           dtype=torch.float32),
        "w_gate": ParamDef(lead + (e, d_model, fe),
                           lax_ + ("experts", "embed", "ff_expert")),
        "w_up": ParamDef(lead + (e, d_model, fe),
                         lax_ + ("experts", "embed", "ff_expert")),
        "w_down": ParamDef(lead + (e, fe, d_model),
                           lax_ + ("experts", "ff_expert", "embed")),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * fe
        defs["shared"] = {
            "w_gate": ParamDef(lead + (d_model, fs), lax_ + ("embed", "ff")),
            "w_up": ParamDef(lead + (d_model, fs), lax_ + ("embed", "ff")),
            "w_down": ParamDef(lead + (fs, d_model), lax_ + ("ff", "embed")),
        }
    return defs


def assign_positions(expert_idx: torch.Tensor, n_experts: int, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot assignment per group. expert_idx: [..., S] int (flattened
    (token, k) pairs in priority order, one group per leading index).
    Returns (position [..., S], keep_mask [..., S]): the position is the
    count of earlier assignments to the same expert; assignments at or
    beyond ``capacity`` are dropped."""
    idx = expert_idx.long()
    # F.one_hot's own CUDA path: its CPU path first reads the indices'
    # min and max on the host, so a step would count other ops there
    onehot = torch.zeros((*idx.shape, n_experts), dtype=torch.long,
                         device=idx.device).scatter_(-1, idx[..., None], 1)
    pos = torch.cumsum(onehot, dim=-2) - 1
    position = (pos * onehot).sum(dim=-1)
    return position, position < capacity


def top1_counts(topi: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Tokens whose first choice is each expert, int64 [n_experts]: a
    fixed-size count (``torch.bincount`` sizes its output from the
    indices' max, a host sync per layer on the card, and has no ``meta``
    kernel)."""
    first = topi[..., 0].reshape(-1)
    return torch.zeros(n_experts, dtype=torch.long,
                       device=topi.device).scatter_add_(
        0, first, torch.ones_like(first))


class Routing(NamedTuple):
    """One MoE layer's routing of its tokens, grouped [G, gs, ...]."""
    xt: torch.Tensor           # [G, gs, D] the tokens
    probs: torch.Tensor        # [G, gs, E] f32 router probabilities
    topv: torch.Tensor         # [G, gs, k] renormalised top-k probabilities
    topi: torch.Tensor         # [G, gs, k] their experts
    position: torch.Tensor     # [G, gs, k] slot in the expert's queue
    keep: torch.Tensor         # [G, gs, k] slot < capacity
    capacity: int


def route(params, x: torch.Tensor, cfg: MoEConfig) -> Routing:
    """Group the tokens of x [B, S, D], pick each token's top-k experts
    and assign their slots, as the reference's ``moe_ffn`` does."""
    d = x.shape[-1]
    e, k = cfg.padded_experts, cfg.top_k
    tokens = x.reshape(-1, d)
    n_tok = tokens.shape[0]
    gs = min(cfg.group_size, n_tok)
    while n_tok % gs:            # largest divisor of n_tok <= group_size
        gs -= 1
    g = n_tok // gs
    capacity = max(int(gs * k * cfg.capacity_factor / cfg.n_experts), 1)
    capacity = (capacity + 3) // 4 * 4      # a multiple of 4

    xt = tokens.reshape(g, gs, d)
    logits = xt.float() @ params["router"].float()          # [g, gs, e]
    if e != cfg.n_experts:
        pad = torch.arange(e, device=x.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)                # [g, gs, k]
    topv = topv / torch.clamp(topv.sum(dim=-1, keepdim=True), min=1e-9)

    # positions per group, k-major priority (every token's first choice
    # before any second choice)
    flat_idx = topi.transpose(1, 2).reshape(g, k * gs)
    position, keep = assign_positions(flat_idx, e, capacity)
    return Routing(xt, probs, topv, topi,
                   position.reshape(g, k, gs).transpose(1, 2),
                   keep.reshape(g, k, gs).transpose(1, 2), capacity)


def load_balance(r: Routing, cfg: MoEConfig,
                 ctx: ShardingCtx = NULL_CTX) -> torch.Tensor:
    """The Switch load-balancing loss: mean router probability x mean
    top-1 assignment per expert, over every token of the (global)
    batch."""
    e = cfg.padded_experts
    g, gs = r.xt.shape[:2]
    if ctx.size("batch") == 1:
        me = r.probs.mean(dim=(0, 1))                        # [e]
        ce = top1_counts(r.topi, e).float() / (g * gs)
    else:
        sums = torch.stack([r.probs.sum(dim=(0, 1)),
                            top1_counts(r.topi, e).float()])
        sums = ctx.reduce(sums, "batch") / (g * gs * ctx.size("batch"))
        me, ce = sums.unbind(0)
    return (me * ce).sum() * e * cfg.router_aux_weight


def moe_ffn(params, x: torch.Tensor, cfg: MoEConfig,
            ctx: ShardingCtx = NULL_CTX
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux_loss f32 scalar).

    Grouped dispatch: [G, gs, D] -> one-hot dispatch [G, gs, E, C] ->
    expert compute [E, G, C, D] -> combine (E: this rank's experts).
    Under sequence parallelism ``x`` holds the rank's positions: every
    position is gathered first (``whole``; the router reads them alike on
    every rank), and the output reduce-scattered."""
    x = ctx.whole(x)
    b, s, d = x.shape
    e = cfg.padded_experts
    r = route(params, x, cfg)
    topv, topi, position, keep, capacity = (
        r.topv, r.topi, r.position, r.keep, r.capacity)
    g, gs = r.xt.shape[:2]
    aux = load_balance(r, cfg, ctx)
    # what the rank's experts read of the (replicated) tokens and gates
    x = ctx.copy(x, "experts")
    xt = x.reshape(g, gs, d)
    gate = ctx.copy(topv * keep, "experts")                  # dropped -> 0
    # the one-hot dispatch and combine tensors [g, gs, e, c], written by
    # scatter: a token's k experts differ, so each (e, c) cell holds at
    # most one of the reference's summed one-hot products (a dropped
    # assignment writes a zero at its expert's last slot); the same
    # values without the [g, gs, k, e, c] intermediate. Expert-parallel,
    # the rank's experts [e0, e0 + el) only: the others' assignments
    # write into one column past the end, cut off
    e0, e1 = ctx.range("experts", e)
    el, split = e1 - e0, e1 - e0 != e
    cells = el * capacity
    cell = topi * capacity + position.clamp(max=capacity - 1)
    if split:
        cell = torch.where((topi >= e0) & (topi < e1),
                           cell - e0 * capacity, cells)
    width = cells + split
    with record_function("moe.dispatch"):
        disp = torch.zeros((g, gs, width), dtype=x.dtype,
                           device=x.device).scatter(-1, cell,
                                                    keep.to(x.dtype))
        xe = torch.einsum("gsd,gsec->egcd", xt,
                          disp[..., :cells].view(g, gs, el, capacity))
    h_g = torch.einsum("egcd,edf->egcf", xe, params["w_gate"])
    h_u = torch.einsum("egcd,edf->egcf", xe, params["w_up"])
    h = F.silu(h_g.float()).to(x.dtype) * h_u
    ye = torch.einsum("egcf,efd->egcd", h, params["w_down"])
    with record_function("moe.combine"):
        comb = torch.zeros((g, gs, width), dtype=torch.float32,
                           device=x.device).scatter(-1, cell, gate)
        out = torch.einsum("egcd,gsec->gsd", ye.float(),
                           comb[..., :cells].view(g, gs, el, capacity))
    out = out.reshape(b, s, d)

    if cfg.n_shared_experts:
        sh = params["shared"]
        hsh = F.silu((x @ sh["w_gate"]).float()).to(x.dtype) \
            * (x @ sh["w_up"])
        out = out + (hsh @ sh["w_down"]).float()
    # the routed and shared (partial) sums in f32, all-reduced (or
    # reduce-scattered) once where the experts are split, rounded once
    return ctx.leave(out, "experts").to(x.dtype), aux
