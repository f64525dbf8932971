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
    onehot = F.one_hot(expert_idx.long(), n_experts)          # [..., S, E]
    pos = torch.cumsum(onehot, dim=-2) - 1
    position = (pos * onehot).sum(dim=-1)
    return position, position < capacity


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


def moe_ffn(params, x: torch.Tensor, cfg: MoEConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux_loss f32 scalar).

    Grouped dispatch: [G, gs, D] -> one-hot dispatch [G, gs, E, C] ->
    expert compute [E, G, C, D] -> combine."""
    b, s, d = x.shape
    e = cfg.padded_experts
    xt, probs, topv, topi, position, keep, capacity = route(params, x, cfg)
    g, gs = xt.shape[:2]

    # load-balancing aux loss (Switch): mean prob x mean top-1 assignment
    me = probs.mean(dim=(0, 1))                              # [e]
    ce = torch.bincount(topi[..., 0].reshape(-1), minlength=e).float() \
        / (g * gs)
    aux = (me * ce).sum() * e * cfg.router_aux_weight

    gate = topv * keep                                       # dropped -> 0
    # the one-hot dispatch and combine tensors [g, gs, e, c], written by
    # scatter: a token's k experts differ, so each (e, c) cell holds at
    # most one of the reference's summed one-hot products (a dropped
    # assignment writes a zero at its expert's last slot); the same
    # values without the [g, gs, k, e, c] intermediate
    cell = topi * capacity + position.clamp(max=capacity - 1)
    with record_function("moe.dispatch"):
        disp = torch.zeros((g, gs, e * capacity), dtype=x.dtype,
                           device=x.device).scatter(-1, cell,
                                                    keep.to(x.dtype))
        xe = torch.einsum("gsd,gsec->egcd", xt,
                          disp.view(g, gs, e, capacity))     # [e, g, c, d]
    h_g = torch.einsum("egcd,edf->egcf", xe, params["w_gate"])
    h_u = torch.einsum("egcd,edf->egcf", xe, params["w_up"])
    h = F.silu(h_g.float()).to(x.dtype) * h_u
    ye = torch.einsum("egcf,efd->egcd", h, params["w_down"])
    with record_function("moe.combine"):
        comb = torch.zeros((g, gs, e * capacity), dtype=torch.float32,
                           device=x.device).scatter(-1, cell, gate)
        out = torch.einsum("egcd,gsec->gsd", ye.float(),
                           comb.view(g, gs, e, capacity))
    out = out.reshape(b, s, d).to(x.dtype)

    if cfg.n_shared_experts:
        sh = params["shared"]
        hsh = F.silu((x @ sh["w_gate"]).float()).to(x.dtype) \
            * (x @ sh["w_up"])
        out = out + hsh @ sh["w_down"]
    return out, aux
