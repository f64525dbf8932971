"""Transformer / SSM blocks of every family: the dense / MoE / VLM
decoder block (internlm2, qwen2-moe, qwen2-vl), the RWKV6 block (rwkv6),
the Mamba2 block (zamba2's backbone) and whisper's encoder block and
cross-attention decoder block. Every block is a pair (defs fn, apply fn)
over an explicit param tree, as in the JAX package's ``models/blocks.py``;
the stacks in ``model.py`` loop over the leading "layers" axis of the
defs. Each block returns ``(x, new_cache, aux)``: ``aux`` is the f32
scalar auxiliary loss (the MoE load balance; 0 elsewhere).

Cache conventions (decode):
  attention  : {"k": [B, S, Hkv, hd], "v": [B, S, Hkv, hd]}  (bf16)
  rwkv6      : {"state": [B, H, dk, dv] f32, "shift_tm": [B, D],
                "shift_cm": [B, D]}
  mamba2     : {"state": [B, H, dk, dv] f32, "conv": [B, K-1, conv_dim]}
  whisper    : attention's, and the encoder's K/V per decoder layer,
               {"xk", "xv": [B, enc_seq, Hkv, hd]} (bf16), read only
Prefill returns a fresh per-layer cache; decode writes the new token's
entries into the cache it is given, in place (the JAX package donates the
cache and returns an updated copy), and returns that cache.

Under a sharded ``ctx`` (every block) a rank holds its q heads, the kv
heads they read, its MLP columns and experts, its Mamba2 heads and its
RWKV6 heads: ``wq`` / ``wk`` / ``wv`` (and RWKV6's ``wr`` / ``wk`` /
``wv`` / ``wg``) are column-parallel, ``wo``, the MLPs' ``w_down``,
Mamba2's ``out_proj`` and RWKV6's channel-mix ``wv`` row-parallel
(``layers.row_parallel``: one f32 all-reduce of the partial products;
``bo`` added once, after it); the head counts come from the
local weights, so the caches and the kernels' calls are the rank's. A
rank may hold no heads (whisper-small's 12 over 16 ranks): its
attention is skipped (``models/attention.py``; no kernel call) and its
row-parallel partial is zero.
Mamba2's ``in_proj`` is split by meaning: z, x and dt by head, B and C
(one state shared by every head) whole on every rank; its gated norm
all-reduces its variance over the heads. RWKV6's per-channel vectors
(``w_base``, ``w_lora_b``, ``ln_x_w``, ``ln_x_b``) are held whole, as
the reference's specs replicate them, and each rank reads its heads'
channels of them (``ParamDef.read_by_heads``); its channel mix's gate
``r`` is column-split and all-gathered (``ShardingCtx.gather``) before
it multiplies the replicated ``kv``. Whisper's encoder K/V cache is held
by kv head, its 1500 frames whole.

Where the layout splits the K/V cache's sequence ("kv_seq", round-robin:
``models/sharding.py``), a prefill's attention is unchanged (the flash
kernel on the rank's heads over the whole prompt) and only the cache it
returns is the rank's positions (``_split_cache``: one ``all_to_all``
per K and V where the sequence shares the heads' axis, none on "data");
a decode step gathers the token's q, k and v over the heads' axis where
they share it, writes its K/V on the rank that holds ``cache_index`` and
combines the ranks' attention by log-sum-exp
(``attention.attend_decode``). A head-less rank holds positions
and takes part.

Under ``second_matmul="col"`` (the rules' "embed_out" on the model
axis) ``wo`` and the MLPs' ``w_down`` hold every row and the rank's
output columns (``layers.row_parallel``): the rank's heads' output is
all-gathered, multiplied by its columns and the columns all-gathered
(``bo`` once, after). RWKV6's ``wo`` and channel-mix ``wv``, Mamba2's
``out_proj`` and the MoE's experts carry "heads" / "ff" / "experts" and
"embed": they stay row-parallel, as the reference's specs hold them.

Training under the model axis (``sharding.ShardingCtx.copy`` /
``reduce``): the normed input enters ``wq`` / ``wk`` / ``wv`` and the
MLP through ``copy`` (their gradients' partial sums over the ranks'
heads all-reduced), the row-parallel outputs leave through ``reduce``.
Under sequence parallelism (the rules' "seq" on the model axis) the
residual between blocks holds the rank's positions and each block's
norm runs on them; ``ShardingCtx.enter`` gathers every position in
place of the column-parallel ``copy`` (its backward a reduce-scatter),
``ShardingCtx.leave`` reduce-scatters the row-parallel sums in place of
``reduce``; where replicated computation reads the input before a
``copy`` (RWKV6's token shift and mixes, Mamba2's B and C, the MoE's
router) ``ShardingCtx.whole`` gathers it with the rank's slice as its
gradient, and the ``copy`` stays. Recurrences, convolutions and the
token shift see the whole sequence.
Mamba2 computes B and C alike on every rank (replicated computation
from the normed input, its columns of ``in_proj`` and ``conv_w`` whole),
so under a model axis they are projected apart from the rank's z, x and
dt (whose input goes through ``copy``) and pass through ``copy`` after
the conv, where the rank's heads read them: their gradient, and that of
their columns, is then whole on every rank. RWKV6 likewise computes its
token-shift mixes (``mu``) and its LoRA's hidden (``w_lora_a``) alike on
every rank, so ``copy`` goes after them: on the r / k / v / g mixes (one
copy of the four), the LoRA's hidden and the channel mix's k and r
inputs; the RWKV6 vectors held whole get partial gradients, which
``sum_shared`` adds up once per step.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import gla, moe
from repro_torch.models.attention import attend_decode, attend_prefill
from repro_torch.models.layers import (apply_mrope, apply_rope, gelu_mlp,
                                       gelu_mlp_defs, groupnorm_heads,
                                       layernorm, mlp_defs, norm_def,
                                       rmsnorm, row_parallel, swiglu_mlp)
from repro_torch.models.param import ParamDef
from repro_torch.models.sharding import NULL_CTX, Part, ShardingCtx

KV_CACHE_DTYPE = torch.bfloat16      # prefill stores K/V in bf16 always


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Self-attention (GQA) core, shared by the dense / MoE / VLM / whisper
# blocks and zamba2's shared block
# ---------------------------------------------------------------------------

def attn_defs(cfg: ModelConfig, layers: Optional[int] = None,
              bias: bool = False):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    lead = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)
    q_heads = (Part(hq * hd, hq),)
    kv_heads = (Part(hkv * hd, hkv, kv_of=hq),)
    defs = {
        "wq": ParamDef(lead + (d, hq * hd), lax_ + ("embed", "heads"),
                       parts=q_heads),
        "wk": ParamDef(lead + (d, hkv * hd), lax_ + ("embed", "kv_heads"),
                       parts=kv_heads),
        "wv": ParamDef(lead + (d, hkv * hd), lax_ + ("embed", "kv_heads"),
                       parts=kv_heads),
        "wo": ParamDef(lead + (hq * hd, d), lax_ + ("heads2", "embed_out"),
                       parts=q_heads),
    }
    if bias:                         # whisper: q, v and output biases
        defs["bq"] = ParamDef(lead + (hq * hd,), lax_ + ("heads",),
                              init="zeros", parts=q_heads)
        defs["bv"] = ParamDef(lead + (hkv * hd,), lax_ + ("kv_heads",),
                              init="zeros", parts=kv_heads)
        defs["bo"] = ParamDef(lead + (d,), lax_ + ("embed",), init="zeros",
                              per_position=True)
    return defs


def kv_parts(cfg: ModelConfig):
    """The kv-head dim of a K/V cache, as ``attn_defs``' ``wk`` holds it."""
    return (Part(cfg.n_kv_heads, cfg.n_kv_heads, kv_of=cfg.n_heads),)


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig,
                 ctx: ShardingCtx = NULL_CTX):
    """q [B, S, Hq, hd] and k, v [B, S, Hkv, hd] at this rank's head
    counts (those of its weights)."""
    x = ctx.enter(x, "heads")
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        v = v + params["bv"]
    k, v = (ctx.constrain(t.reshape(b, s, t.shape[-1] // hd, hd),
                          ("batch", None, "kv_heads", None),
                          (None, None, cfg.n_kv_heads, None), kv_parts(cfg))
            for t in (k, v))
    return q.reshape(b, s, q.shape[-1] // hd, hd), k, v


def _apply_pos(q, k, cfg: ModelConfig, positions):
    if cfg.pos_scheme == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.pos_scheme == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.rope_theta)
    return q, k


def _out_proj(params, out: torch.Tensor, cfg: ModelConfig,
              ctx: ShardingCtx = NULL_CTX) -> torch.Tensor:
    """``wo`` over the rank's heads (``layers.row_parallel``: row or
    col), then ``bo`` once (on the rank's positions under sequence
    parallelism)."""
    hq = cfg.n_heads
    y = row_parallel(out.flatten(2), params["wo"], ctx, "heads2",
                     out=cfg.d_model,
                     parts=(Part(hq * cfg.resolved_head_dim, hq),))
    if "bo" in params:
        y = y + params["bo"]
    return y


def self_attention(params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                   positions: Optional[torch.Tensor], cache=None,
                   cache_index=None, causal: bool = True,
                   ctx: ShardingCtx = NULL_CTX):
    """mode: train | prefill | decode; positions per ``cfg.pos_scheme``
    (RoPE [.., S], M-RoPE [.., S, 3], none for sinusoidal). Returns (y,
    new_cache)."""
    q, k, v = _project_qkv(params, x, cfg, ctx)
    q, k = _apply_pos(q, k, cfg, positions)

    new_cache = cache
    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        out = _decode(q, k, v, cache, cache_index, cfg, ctx)
    else:
        out = attend_prefill(q, k, v, causal=causal)
        if mode == "prefill":
            split = ctx.size("kv_seq") > 1
            new_cache = {n: (_split_cache(t, cfg, ctx) if split
                             else t.to(KV_CACHE_DTYPE))
                         for n, t in (("k", k), ("v", v))}
    return _out_proj(params, out, cfg, ctx), new_cache


def kv_owners(cfg: ModelConfig, ctx: ShardingCtx) -> list:
    """Per rank of the heads' axis, the (kv head, its slot in the rank's
    K/V) of each kv head whose first holder it is: every kv head once."""
    seen, out = set(), []
    for i in range(ctx.size("heads")):
        held = ctx.indices("kv_heads", cfg.n_kv_heads, kv_parts(cfg), at=i)
        mine = [(h, held.index(h)) for h in dict.fromkeys(held)
                if h not in seen]
        seen.update(h for h, _ in mine)
        out.append(mine)
    return out


def _split_cache(t: torch.Tensor, cfg: ModelConfig,
                 ctx: ShardingCtx) -> torch.Tensor:
    """A prefill's K or V [B, P, h, hd] (this rank's kv heads, every
    position) as this rank's part of a cache whose sequence is split
    round-robin: its positions ``r, r + M, ...`` of every kv head the
    cache leaf holds (``ShardingCtx.leaf_axes``). On "data" (the heads on
    another axis) every rank computed every position of its heads and
    keeps its own. On the heads' axis one ``all_to_all`` moves each kv
    head, from its first holder, to every rank at that rank's positions
    (the pieces padded to the most kv heads a rank sends, and to whole
    rounds of M positions); an all-gather and a slice would move M times
    the bytes."""
    t = t.to(KV_CACHE_DTYPE)
    m, r = ctx.size("kv_seq"), ctx.index("kv_seq")
    b, p, _, hd = t.shape
    mine = len(range(r, p, m))
    if not ctx.shares_axis("kv_seq", "heads"):
        return t[:, r::m].contiguous()
    owners = kv_owners(cfg, ctx)
    width, rounds = max(len(o) for o in owners), -(-p // m)
    send = t.new_zeros((b, rounds * m, width, hd))
    for j, (_, slot) in enumerate(owners[ctx.index("heads")]):
        send[:, :p, j] = t[:, :, slot]
    send = send.view(b, rounds, m, width, hd).permute(2, 0, 1, 3, 4)
    got = ctx.all_to_all(send, "kv_seq")            # [M, B, rounds, w, hd]
    heads = {h: got[i, :, :mine, j] for i, own in enumerate(owners)
             for j, (h, _) in enumerate(own)}
    return torch.stack([heads[h] for h in range(cfg.n_kv_heads)], 2)


def _decode(q, k, v, cache, cache_index: int, cfg: ModelConfig,
            ctx: ShardingCtx) -> torch.Tensor:
    """One decode step's attention, its K/V written into ``cache`` in
    place. Where the cache's sequence is split round-robin over M ranks
    ("kv_seq"; else M = 1 and the rank holds every position) and that
    axis is the heads' too, the token's q, k and v of every rank are
    all-gathered first (one all-gather of the three packed; the cache
    holds every kv head and each rank attends for every q head); the rank
    holding ``cache_index`` (``% M``) writes its K/V at local index
    ``cache_index // M``; every rank then attends over its positions
    (``attend_decode``), and keeps its own q heads of the output. Returns
    [B, 1, h, hd] at this rank's q heads (none on a head-less rank, which
    still takes part where the sequence is split)."""
    m = ctx.size("kv_seq")
    gathered = ctx.shares_axis("kv_seq", "heads")
    if gathered:
        b, hd = q.shape[0], cfg.resolved_head_dim
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        parts = (Part(hq * hd, hq),) + (Part(hkv * hd, hkv, kv_of=hq),) * 2
        # reshapes take the head count: a head-less rank's are empty
        pieces = ctx.all_gather(torch.cat([t.reshape(b, t.shape[2] * hd)
                                           for t in (q, k, v)], -1),
                                "heads", full=(hq + 2 * hkv) * hd,
                                parts=parts)
        qs, ks, vs = [], {}, {}
        for i, piece in enumerate(pieces):
            nq = len(ctx.indices("heads", hq, at=i))
            held = ctx.indices("kv_heads", hkv, kv_parts(cfg), at=i)
            qi, ki, vi = torch.split(piece, [nq * hd, len(held) * hd,
                                             len(held) * hd], -1)
            qs.append(qi)
            for slot, h in enumerate(held):
                ks.setdefault(h, ki[:, slot * hd:(slot + 1) * hd])
                vs.setdefault(h, vi[:, slot * hd:(slot + 1) * hd])
        q = torch.cat(qs, -1).reshape(b, 1, hq, hd)
        k, v = (torch.stack([d[h] for h in range(hkv)], 1)[:, None]
                for d in (ks, vs))
    if ctx.index("kv_seq") == cache_index % m:
        at = slice(cache_index // m, cache_index // m + 1)
        cache["k"][:, at] = k.to(cache["k"].dtype)
        cache["v"][:, at] = v.to(cache["v"].dtype)
    out = attend_decode(q, cache["k"], cache["v"],
                        cache_len=cache_index + 1, ctx=ctx)
    if gathered:
        q0, q1 = ctx.range("heads", cfg.n_heads)
        out = out[:, :, q0:q1]
    return out


def cross_attention(params, x: torch.Tensor, enc_kv, cfg: ModelConfig,
                    ctx: ShardingCtx = NULL_CTX):
    """Whisper's decoder cross-attention against precomputed encoder K/V
    (``enc_kv``: {"k", "v": [B, enc_seq, Hkv, hd]}, the rank's kv heads),
    full (not causal), through the flash_attention kernel in every mode:
    in decode one query against the encoder's keys. K/V held in another
    dtype than x (the bf16 cache of an f32 model) are promoted to x's, as
    JAX's einsum promotes."""
    x = ctx.enter(x, "heads")
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    if "bq" in params:
        q = q + params["bq"]
    q = q.reshape(b, s, q.shape[-1] // hd, hd)
    dt = torch.promote_types(q.dtype, enc_kv["k"].dtype)
    out = attend_prefill(q.to(dt), enc_kv["k"].to(dt), enc_kv["v"].to(dt),
                         causal=False).to(x.dtype)
    return _out_proj(params, out, cfg, ctx)


# ---------------------------------------------------------------------------
# Dense / MoE / VLM decoder block (pre-RMSNorm, SwiGLU or MoE FFN)
# ---------------------------------------------------------------------------

def decoder_block_defs(cfg: ModelConfig, layers: int):
    defs = {
        "ln1": norm_def((layers, cfg.d_model), ("layers", "embed")),
        "attn": attn_defs(cfg, layers),
        "ln2": norm_def((layers, cfg.d_model), ("layers", "embed")),
    }
    if cfg.moe is not None and cfg.moe.n_experts:
        defs["moe"] = moe.moe_defs(cfg.d_model, cfg.moe, layers)
    else:
        defs["mlp"] = mlp_defs(cfg.d_model, cfg.d_ff, layers)
    return defs


def decoder_block(params, x, cfg: ModelConfig, *, mode, positions,
                  cache=None, cache_index=None, ctx: ShardingCtx = NULL_CTX):
    h = rmsnorm(x, params["ln1"], cfg.norm_eps)
    a, new_cache = self_attention(params["attn"], h, cfg, mode=mode,
                                  positions=positions, cache=cache,
                                  cache_index=cache_index, ctx=ctx)
    x = x + a
    h = rmsnorm(x, params["ln2"], cfg.norm_eps)
    if "moe" in params:
        f, aux = moe.moe_ffn(params["moe"], h, cfg.moe, ctx)
    else:
        f, aux = swiglu_mlp(params["mlp"], h, ctx), _no_aux(x)
    x = ctx.constrain(x + f, ("batch", "seq", "act_embed"),
                      (None, None, cfg.d_model))
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# RWKV6 (Finch) block: data-dependent-decay time mix + channel mix
# ---------------------------------------------------------------------------

RWKV_LORA = 32


def rwkv6_heads(cfg: ModelConfig):
    """The packing of a d_model-wide dim of RWKV6's by head (its
    ``n_ssm_heads`` heads of ``d_model / n_ssm_heads`` channels)."""
    return (Part(cfg.d_model, cfg.ssm.n_ssm_heads),)


def rwkv6_channels(cfg: ModelConfig, ctx: ShardingCtx = NULL_CTX) -> slice:
    """This rank's channels of d_model: those of its heads."""
    dk = cfg.d_model // cfg.ssm.n_ssm_heads
    h0, h1 = ctx.range("heads", cfg.ssm.n_ssm_heads)
    return slice(h0 * dk, h1 * dk)


def rwkv6_block_defs(cfg: ModelConfig, layers: int):
    d = cfg.d_model
    h = cfg.ssm.n_ssm_heads
    dk = d // h
    f = cfg.d_ff
    L = layers
    la = ("layers",)
    heads = rwkv6_heads(cfg)
    return {
        "ln1": norm_def((L, d), la + ("embed",)),
        "ln2": norm_def((L, d), la + ("embed",)),
        "tm": {
            # token-shift interpolation coefficients for r, k, v, w, g
            "mu": ParamDef((L, 5, d), la + (None, "embed")),
            "w_base": ParamDef((L, d), la + ("embed",),    # decay base
                               read_by_heads=True),
            "w_lora_a": ParamDef((L, d, RWKV_LORA), la + ("embed", None)),
            "w_lora_b": ParamDef((L, RWKV_LORA, d), la + (None, "embed"),
                                 init="zeros", read_by_heads=True),
            "u": ParamDef((L, h, dk), la + ("heads", None)),   # bonus
            "wr": ParamDef((L, d, d), la + ("embed", "heads"), parts=heads),
            "wk": ParamDef((L, d, d), la + ("embed", "heads"), parts=heads),
            "wv": ParamDef((L, d, d), la + ("embed", "heads"), parts=heads),
            "wg": ParamDef((L, d, d), la + ("embed", "heads"), parts=heads),
            "wo": ParamDef((L, d, d), la + ("heads", "embed"), parts=heads),
            "ln_x_w": ParamDef((L, d), la + ("embed",), init="ones",
                               read_by_heads=True),
            "ln_x_b": ParamDef((L, d), la + ("embed",), init="zeros",
                               read_by_heads=True),
        },
        "cm": {
            "mu_k": ParamDef((L, d), la + ("embed",)),
            "mu_r": ParamDef((L, d), la + ("embed",)),
            "wk": ParamDef((L, d, f), la + ("embed", "ff")),
            "wv": ParamDef((L, f, d), la + ("ff", "embed")),
            "wr": ParamDef((L, d, d), la + ("embed", "heads"), parts=heads),
        },
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """x: [B, S, D] -> x shifted right by one token; position 0 sees
    ``prev`` (the decode carry) or zeros."""
    first = (x.new_zeros((x.shape[0], 1, x.shape[2])) if prev is None
             else prev.to(x.dtype)[:, None])
    return torch.cat([first, x[:, :-1]], dim=1)


def rwkv6_time_mix(p, x, cfg: ModelConfig, *, mode, cache,
                   ctx: ShardingCtx = NULL_CTX):
    """Returns (y, new_cache): decode updates ``cache``'s state and
    ``shift_tm`` in place; prefill returns fresh ones; train None. Under
    a sharded ``ctx``: the rank's heads (``u``'s), their channels of the
    vectors held whole, ``wo`` row-parallel; under sequence parallelism
    every position gathered first (``whole``: the token shift and the
    mixes read them), the output reduce-scattered."""
    x = ctx.whole(x)
    b, s, d = x.shape
    dk = d // cfg.ssm.n_ssm_heads
    h = p["u"].shape[0]                         # this rank's heads
    cols = rwkv6_channels(cfg, ctx)
    prev = cache["shift_tm"] if cache is not None else None
    xs = _token_shift(x, prev)
    mu = p["mu"]
    # the r, k, v and g mixes (mu rows 0, 1, 2, 4), which the rank's
    # columns read, then the decay's (row 3), which the LoRA reads whole
    mix = x[:, :, None, :] + (xs - x)[:, :, None, :] * \
        torch.cat([mu[:3], mu[4:]])[None, None]
    xr, xk, xv, xg = ctx.copy(mix, "heads").unbind(2)
    xw = x + (xs - x) * mu[3]
    r = (xr @ p["wr"]).reshape(b, s, h, dk)
    k = (xk @ p["wk"]).reshape(b, s, h, dk)
    v = (xv @ p["wv"]).reshape(b, s, h, dk)
    g = xg @ p["wg"]
    # data-dependent decay: w = exp(-exp(base + lora(xw))), as a log
    # decay of down to -e^4 per token (the kernel masks before its exps)
    hidden = torch.tanh((xw @ p["w_lora_a"]).float()).to(x.dtype)
    lora = ctx.copy(hidden, "heads") @ p["w_lora_b"][:, cols]
    log_w = -torch.exp(torch.clamp(p["w_base"][cols].float() + lora.float(),
                                   -8.0, 4.0)).reshape(b, s, h, dk)

    if mode == "decode":
        o, new_state = gla.gla_step(r[:, 0], k[:, 0], v[:, 0], log_w[:, 0],
                                    cache["state"], u=p["u"],
                                    inclusive=False)
        out = o[:, None]                                    # [B,1,H,dk]
        cache["state"].copy_(new_state)
        cache["shift_tm"].copy_(x[:, -1])
        new_cache = cache
    else:
        init = cache["state"] if cache is not None else None
        # the RWKV6 regime of the gla_chunk kernel (per-head r/k,
        # per-channel decay, the bonus u; in bf16 its chunk-parallel RWKV6
        # design, in f32 the serial one), f32-accurate as the reference's
        # ratio_dtype=f32 here
        out, final = gla.gla_chunk(r, k, v, log_w, u=p["u"],
                                   inclusive=False, initial_state=init)
        new_cache = (None if mode == "train"
                     else {"state": final, "shift_tm": x[:, -1].clone()})
    y = groupnorm_heads(out.reshape(b, s, h * dk), p["ln_x_w"][cols],
                        p["ln_x_b"][cols], h)
    y = y * F.silu(g.float()).to(x.dtype)
    return row_parallel(y, p["wo"], ctx, "heads"), new_cache


def rwkv6_channel_mix(p, x, cfg: ModelConfig, *, cache,
                      ctx: ShardingCtx = NULL_CTX):
    """Returns (y, x's last token: the next call's shift). Under a
    sharded ``ctx``: ``wk`` column- and ``wv``
    row-parallel over "ff" (one all-reduce of ``kv``), the gate ``r``
    over the rank's channels, all-gathered before it multiplies ``kv``.
    Under sequence parallelism every position is gathered first
    (``whole``), ``kv`` is reduce-scattered and the gathered gate cut to
    the rank's positions (``own_positions``: the all-gather of its
    gradient)."""
    x = ctx.whole(x)
    prev = cache["shift_cm"] if cache is not None else None
    xs = _token_shift(x, prev)
    xk = x + (xs - x) * p["mu_k"]
    xr = x + (xs - x) * p["mu_r"]
    k = torch.square(F.relu((ctx.copy(xk, "ff") @ p["wk"]).float())).to(
        x.dtype)
    kv = row_parallel(k, p["wv"], ctx, "ff")
    r = torch.sigmoid((ctx.copy(xr, "heads") @ p["wr"]).float()).to(x.dtype)
    r = ctx.gather(r, "heads", cfg.d_model, rwkv6_heads(cfg))
    return ctx.own_positions(r) * kv, x[:, -1]


def rwkv6_block(params, x, cfg: ModelConfig, *, mode, cache=None,
                ctx: ShardingCtx = NULL_CTX):
    h = rmsnorm(x, params["ln1"], cfg.norm_eps)
    a, tm_cache = rwkv6_time_mix(params["tm"], h, cfg, mode=mode,
                                 cache=cache, ctx=ctx)
    x = x + a
    h = rmsnorm(x, params["ln2"], cfg.norm_eps)
    f, shift_cm = rwkv6_channel_mix(params["cm"], h, cfg, cache=cache,
                                    ctx=ctx)
    if mode == "decode":
        cache["shift_cm"].copy_(shift_cm)
        new_cache = cache
    else:
        new_cache = (None if mode == "train"
                     else dict(tm_cache, shift_cm=shift_cm.clone()))
    x = ctx.constrain(x + f, ("batch", "seq", "act_embed"),
                      (None, None, cfg.d_model))
    return x, new_cache, _no_aux(x)


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block — the zamba2 hybrid backbone
# ---------------------------------------------------------------------------

def mamba_dims(cfg: ModelConfig):
    """(d_in, heads, head width dv, state width dk) of a Mamba2 layer."""
    ssm = cfg.ssm
    d_in = ssm.expand * cfg.d_model
    nh = ssm.n_ssm_heads or (d_in // ssm.state_size)
    return d_in, nh, d_in // nh, ssm.state_size


def mamba2_block_defs(cfg: ModelConfig, layers: int):
    d = cfg.d_model
    d_in, nh, _, st = mamba_dims(cfg)
    L = layers
    la = ("layers",)
    # in_proj emits [z (d_in), x (d_in), B (st), C (st), dt (nh)]
    proj_out = 2 * d_in + 2 * st + nh
    heads = Part(d_in, nh)
    return {
        "ln": norm_def((L, d), la + ("embed",)),
        "in_proj": ParamDef((L, d, proj_out), la + ("embed", "heads"),
                            parts=(heads, heads, Part(st), Part(st),
                                   Part(nh, nh))),
        "conv_w": ParamDef((L, cfg.ssm.conv_kernel, d_in + 2 * st),
                           la + (None, "heads"), scale=0.5,
                           parts=conv_parts(cfg)),
        "a_log": ParamDef((L, nh), la + ("heads",), init="zeros"),
        "dt_bias": ParamDef((L, nh), la + ("heads",), init="zeros"),
        "d_skip": ParamDef((L, nh), la + ("heads",), init="ones"),
        "norm": ParamDef((L, d_in), la + ("heads",), init="ones",
                         parts=(heads,)),
        "out_proj": ParamDef((L, d_in, d), la + ("heads", "embed"),
                             parts=(heads,)),
    }


def conv_parts(cfg: ModelConfig):
    """The conv's channels [x (d_in) | B (st) | C (st)]: x by head, B
    and C whole."""
    d_in, nh, _, st = mamba_dims(cfg)
    return (Part(d_in, nh), Part(st), Part(st))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 conv_state: Optional[torch.Tensor]):
    """Depthwise causal conv. x: [B, S, C]; w: [K, C]. conv_state: [B, K-1,
    C] carried for decode. Returns (y, new_conv_state)."""
    k = w.shape[0]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # [B, S+K-1, C]
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    # a copy, so the cache does not hold the whole padded input alive
    new_state = xp[:, xp.shape[1] - (k - 1):].clone()
    return F.silu(y.float()).to(x.dtype), new_state


def mamba2_block(params, x, cfg: ModelConfig, *, mode, cache=None,
                 ctx: ShardingCtx = NULL_CTX):
    d_in_full, _, hd, st = mamba_dims(cfg)
    nh = params["a_log"].shape[-1]              # this rank's heads
    d_in = nh * hd

    # under sequence parallelism every position (the conv and the scan
    # read them; B and C are computed alike on every rank)
    h = ctx.whole(rmsnorm(x, params["ln"], cfg.norm_eps))
    b, s, _ = h.shape
    if ctx.size("heads") > 1:
        # B and C from h as it is (every rank computes them alike), the
        # rank's z, x and dt through copy (their gradient is partial)
        w_zx, w_bc, w_dt = torch.split(params["in_proj"],
                                       [2 * d_in, 2 * st, nh], dim=-1)
        hc = ctx.copy(h, "heads")
        z, xin = torch.split(hc @ w_zx, [d_in, d_in], dim=-1)
        Bc, Cc = torch.split(h @ w_bc, [st, st], dim=-1)
        dt = hc @ w_dt
    else:
        zxbcdt = h @ params["in_proj"]
        z, xin, Bc, Cc, dt = torch.split(zxbcdt, [d_in, d_in, st, st, nh],
                                         dim=-1)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = _causal_conv(conv_in, params["conv_w"], conv_state)
    xin = conv_out[..., :d_in]
    Bc, Cc = torch.split(ctx.copy(conv_out[..., d_in:], "heads"), [st, st],
                         dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"].float())   # [B,S,nh]
    a = -torch.exp(params["a_log"].float())                   # [nh]
    log_w = (dt * a[None, None]).reshape(b, s, nh, 1)          # scalar/head
    # k = B (shared across heads), v = dt * x, q = C: broadcast views with
    # zero strides, which the gla_chunk kernel reads as they are
    k = Bc[:, :, None, :].expand(b, s, nh, st)
    q = Cc[:, :, None, :].expand(b, s, nh, st)
    v = (xin.reshape(b, s, nh, hd).float() * dt[..., None]).to(x.dtype)
    # decay is per-head scalar -> broadcast over the dk axis of k
    log_w_full = log_w.expand(b, s, nh, st)

    if mode == "decode":
        o, new_state = gla.gla_step(q[:, 0], k[:, 0], v[:, 0],
                                    log_w_full[:, 0], cache["state"],
                                    inclusive=True)
        out = o[:, None]
        cache["state"].copy_(new_state)
        cache["conv"].copy_(new_conv)
        new_cache = cache
    else:
        init = cache["state"] if cache is not None else None
        out, final = gla.gla_chunk(q, k, v, log_w_full, inclusive=True,
                                   initial_state=init)
        new_cache = (None if mode == "train"
                     else {"state": final, "conv": new_conv})

    y = out.reshape(b, s, d_in) + xin * torch.repeat_interleave(
        params["d_skip"], hd, dim=-1).to(x.dtype)[None, None]
    y = rmsnorm(y, params["norm"], cfg.norm_eps, ctx=ctx, axis="heads",
                width=d_in_full)
    y = y * F.silu(z.float()).to(x.dtype)
    y = row_parallel(y, params["out_proj"], ctx, "heads")
    x = ctx.constrain(x + y, ("batch", "seq", "act_embed"),
                      (None, None, cfg.d_model))
    return x, new_cache, _no_aux(x)


# ---------------------------------------------------------------------------
# Whisper encoder block (bidirectional, LayerNorm + bias, GELU MLP) and
# decoder block with cross-attention
# ---------------------------------------------------------------------------

def encoder_block_defs(cfg: ModelConfig, layers: int):
    d = cfg.d_model
    la = ("layers",)
    return {
        "ln1_w": norm_def((layers, d), la + ("embed",), "ones"),
        "ln1_b": norm_def((layers, d), la + ("embed",), "zeros"),
        "attn": attn_defs(cfg, layers, bias=True),
        "ln2_w": norm_def((layers, d), la + ("embed",), "ones"),
        "ln2_b": norm_def((layers, d), la + ("embed",), "zeros"),
        "mlp": gelu_mlp_defs(d, cfg.d_ff, layers),
    }


def encoder_block(params, x, cfg: ModelConfig, ctx: ShardingCtx = NULL_CTX):
    """Self-attention over the frames, not causal (the flash kernel's full
    regime)."""
    h = layernorm(x, params["ln1_w"], params["ln1_b"], cfg.norm_eps)
    a, _ = self_attention(params["attn"], h, cfg, mode="train",
                          positions=None, causal=False, ctx=ctx)
    x = x + a
    h = layernorm(x, params["ln2_w"], params["ln2_b"], cfg.norm_eps)
    return ctx.constrain(x + gelu_mlp(params["mlp"], h, ctx),
                         ("batch", "seq", "act_embed"),
                         (None, None, cfg.d_model))


def decoder_xattn_block_defs(cfg: ModelConfig, layers: int):
    d = cfg.d_model
    la = ("layers",)
    return {
        "ln1_w": norm_def((layers, d), la + ("embed",), "ones"),
        "ln1_b": norm_def((layers, d), la + ("embed",), "zeros"),
        "attn": attn_defs(cfg, layers, bias=True),
        "lnx_w": norm_def((layers, d), la + ("embed",), "ones"),
        "lnx_b": norm_def((layers, d), la + ("embed",), "zeros"),
        "xattn": attn_defs(cfg, layers, bias=True),
        "ln2_w": norm_def((layers, d), la + ("embed",), "ones"),
        "ln2_b": norm_def((layers, d), la + ("embed",), "zeros"),
        "mlp": gelu_mlp_defs(d, cfg.d_ff, layers),
    }


def decoder_xattn_block(params, x, enc_kv, cfg: ModelConfig, *, mode,
                        cache=None, cache_index=None,
                        ctx: ShardingCtx = NULL_CTX):
    h = layernorm(x, params["ln1_w"], params["ln1_b"], cfg.norm_eps)
    a, new_cache = self_attention(params["attn"], h, cfg, mode=mode,
                                  positions=None, cache=cache,
                                  cache_index=cache_index, ctx=ctx)
    x = x + a
    h = layernorm(x, params["lnx_w"], params["lnx_b"], cfg.norm_eps)
    x = x + cross_attention(params["xattn"], h, enc_kv, cfg, ctx)
    h = layernorm(x, params["ln2_w"], params["ln2_b"], cfg.norm_eps)
    x = ctx.constrain(x + gelu_mlp(params["mlp"], h, ctx),
                      ("batch", "seq", "act_embed"),
                      (None, None, cfg.d_model))
    return x, new_cache, _no_aux(x)
