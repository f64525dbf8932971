"""Shared neural-net layers: norms (RMSNorm, LayerNorm, per-head
GroupNorm), positions (RoPE, M-RoPE, sinusoidal), the SwiGLU and GELU
MLPs, embedding/unembedding. Pure functions over explicit param trees, as in
the JAX package's ``models/layers.py``: norms, activations and softmaxes
compute in f32, tensors stay in the parameters' dtype (bf16 by default).

Under a sharded ``ctx`` (``models/sharding.py``) the parameters are this
rank's slices: the MLP is column-parallel (its input through
``ctx.enter``: ``copy``, or under sequence parallelism the positions
gathered) then ``row_parallel``: the rules' second matmul of the pair,
row (its partial products summed by ``ctx.leave``: an f32 all-reduce
over "ff", or a reduce-scatter over the positions) or col
(``second_matmul="col"``: the input gathered, the rank's output columns
all-gathered); the embedding and unembedding are vocab-parallel (the
embedding masks the ids outside the rank's rows, then sums over the
ranks with ``leave``, so its gradient reaches the rank's own rows only;
the unembedding returns the rank's logits columns), and ``rmsnorm`` over
a split dim reduces its sum of squares in f32, which the rank's split
part then consumes (so its gradient is all-reduced back).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.param import ParamDef
from repro_torch.models.sharding import NULL_CTX, PAIRED, Part, ShardingCtx


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5, *,
            ctx: ShardingCtx = NULL_CTX, axis: Optional[str] = None,
            width: int = 0) -> torch.Tensor:
    """RMSNorm over the last dim. ``axis`` and ``width``: the dim is split
    over ``axis``'s ranks, ``width`` wide in full; its sum of squares is
    all-reduced in f32."""
    xf = x.float()
    if axis is not None and ctx.size(axis) > 1:
        ss = ctx.reduce(xf.square().sum(dim=-1, keepdim=True), axis)
        var = ctx.copy(ss, axis) / width
    else:
        var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def groupnorm_heads(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, n_heads: int,
                    eps: float = 64e-5) -> torch.Tensor:
    """GroupNorm with one group per head over the last dim (RWKV ln_x)."""
    *lead, d = x.shape
    xg = x.reshape(*lead, n_heads, d // n_heads).float()
    mu = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, unbiased=False, keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (y * weight.float() + bias.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # [hd/2]
    ang = positions[..., :, None].float() * freqs           # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int] = (1, 1, 2)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the rotary dims are split into (t, h, w)
    sections, each rotated by its own position stream. x: [..., seq,
    heads, head_dim]; positions: [..., seq, 3] (t, h, w). For text all
    three streams coincide and M-RoPE is RoPE."""
    half = x.shape[-1] // 2
    total = sum(sections)
    widths = [half * s // total for s in sections]
    widths[-1] = half - sum(widths[:-1])
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # [half]
    parts, start = [], 0
    for i, w in enumerate(widths):
        pos_i = positions[..., i].float()                   # [..., S]
        parts.append(pos_i[..., :, None] * freqs[start:start + w])
        start += w
    ang = torch.cat(parts, dim=-1)                          # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq: int, d_model: int, offset: int = 0,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """[seq, d_model] f32 sinusoidal positions from position ``offset``
    (the decode position)."""
    pos = (torch.arange(seq, dtype=torch.float32, device=device)
           + float(offset))[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d_model)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def norm_def(shape, axes, init: str = "ones") -> ParamDef:
    """A norm's gain (``init="ones"``) or bias (``"zeros"``): applied on
    the residual position by position."""
    return ParamDef(shape, axes, init=init, per_position=True)


def mlp_defs(d_model: int, d_ff: int, layers: Optional[int] = None):
    lead = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)
    return {
        "w_gate": ParamDef(lead + (d_model, d_ff), lax_ + ("embed", "ff")),
        "w_up": ParamDef(lead + (d_model, d_ff), lax_ + ("embed", "ff")),
        "w_down": ParamDef(lead + (d_ff, d_model), lax_ + ("ff2", "embed_out")),
    }


def row_parallel(x: torch.Tensor, w: torch.Tensor, ctx: ShardingCtx,
                 axis: str, *, out: int = 0,
                 parts: Optional[Tuple[Part, ...]] = None) -> torch.Tensor:
    """The second matmul of a pair, ``x @ w``: x's last dim is this
    rank's part of a dim split over ``axis``'s input axis (by ``parts``),
    ``w``'s rows are on ``axis``.

    Row (the rows split): each rank's partial product in x's dtype (in
    bf16 a tensor-core GEMM, rounded once more than the unsplit product),
    summed in f32 and rounded once to x's dtype (``ctx.leave``: an
    all-reduce, or under sequence parallelism a reduce-scatter that
    leaves the rank its positions). Col (``axis`` "heads2" or "ff2" and
    the rules' ``second_matmul="col"``: w's rows whole, its columns of
    the ``out`` wide output on "embed_out"): x all-gathered over the
    input axis (``gather_split``; a rank with no heads sends an empty
    part), multiplied by the rank's columns, and the columns all-gathered
    in x's dtype (``gather``), each output element one whole product.
    ``x @ w`` itself where nothing is split."""
    if axis in PAIRED and ctx.size("embed_out") > 1:
        x = ctx.gather_split(x, PAIRED[axis], w.shape[-2], parts)
        return ctx.own_positions(ctx.gather(x @ w, "embed_out", out))
    return ctx.leave(x @ w, axis)


def swiglu_mlp(params, x: torch.Tensor, ctx: ShardingCtx = NULL_CTX, *,
               down: str = "ff2") -> torch.Tensor:
    """``down``: the rows' axis of ``w_down`` ("ff" for zamba2's shared
    MLP, whose ``w_down`` the reference lays out as ("ff", "embed"))."""
    d = x.shape[-1]
    x = ctx.enter(x, "ff")
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return row_parallel(h, params["w_down"], ctx, down, out=d)


def gelu_mlp(params, x: torch.Tensor,
             ctx: ShardingCtx = NULL_CTX) -> torch.Tensor:
    """2-matrix GELU MLP (whisper); the tanh approximation, as
    ``jax.nn.gelu``'s default. Column-parallel over "ff", then
    ``row_parallel``, as ``swiglu_mlp``."""
    d = x.shape[-1]
    x = ctx.enter(x, "ff")
    h = x @ params["w_up"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return row_parallel(h, params["w_down"], ctx, "ff2", out=d)


def gelu_mlp_defs(d_model: int, d_ff: int, layers: Optional[int] = None):
    lead = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)
    return {
        "w_up": ParamDef(lead + (d_model, d_ff), lax_ + ("embed", "ff")),
        "w_down": ParamDef(lead + (d_ff, d_model),
                           lax_ + ("ff2", "embed_out")),
    }


def embed(table: torch.Tensor, ids: torch.Tensor,
          ctx: ShardingCtx = NULL_CTX, vocab: int = 0) -> torch.Tensor:
    """Rows ``ids`` of the table. Vocab-parallel (``table`` this rank's
    rows of ``vocab``): ids outside them give zeros, and the ranks' rows
    are summed over the ranks (exact: one rank holds each id; under
    sequence parallelism a reduce-scatter, each rank keeping its
    positions: ``ctx`` from ``for_seq``)."""
    if ctx.size("vocab") == 1:
        return ctx.own_positions(table[ids])
    v0, v1 = ctx.range("vocab", vocab)
    local = ids - v0
    hit = (local >= 0) & (local < v1 - v0)
    rows = table[local.clamp(0, v1 - v0 - 1)] * hit[..., None].to(
        table.dtype)
    return ctx.leave(rows, "vocab")


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32 (vocab-parallel: this rank's columns)."""
    return x.float() @ table.float().T
