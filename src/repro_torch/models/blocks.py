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
                                       layernorm, mlp_defs, rmsnorm,
                                       swiglu_mlp)
from repro_torch.models.param import ParamDef

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
    defs = {
        "wq": ParamDef(lead + (d, hq * hd), lax_ + ("embed", "heads")),
        "wk": ParamDef(lead + (d, hkv * hd), lax_ + ("embed", "kv_heads")),
        "wv": ParamDef(lead + (d, hkv * hd), lax_ + ("embed", "kv_heads")),
        "wo": ParamDef(lead + (hq * hd, d), lax_ + ("heads2", "embed_out")),
    }
    if bias:                         # whisper: q, v and output biases
        defs["bq"] = ParamDef(lead + (hq * hd,), lax_ + ("heads",),
                              init="zeros")
        defs["bv"] = ParamDef(lead + (hkv * hd,), lax_ + ("kv_heads",),
                              init="zeros")
        defs["bo"] = ParamDef(lead + (d,), lax_ + ("embed",), init="zeros")
    return defs


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        v = v + params["bv"]
    return (q.reshape(b, s, cfg.n_heads, hd),
            k.reshape(b, s, cfg.n_kv_heads, hd),
            v.reshape(b, s, cfg.n_kv_heads, hd))


def _apply_pos(q, k, cfg: ModelConfig, positions):
    if cfg.pos_scheme == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.pos_scheme == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.rope_theta)
    return q, k


def _out_proj(params, out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s = out.shape[:2]
    y = out.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim) @ params["wo"]
    if "bo" in params:
        y = y + params["bo"]
    return y


def self_attention(params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                   positions: Optional[torch.Tensor], cache=None,
                   cache_index=None, causal: bool = True):
    """mode: train | prefill | decode; positions per ``cfg.pos_scheme``
    (RoPE [.., S], M-RoPE [.., S, 3], none for sinusoidal). Returns (y,
    new_cache)."""
    q, k, v = _project_qkv(params, x, cfg)
    q, k = _apply_pos(q, k, cfg, positions)

    new_cache = cache
    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        at = slice(cache_index, cache_index + 1)
        cache["k"][:, at] = k.to(cache["k"].dtype)
        cache["v"][:, at] = v.to(cache["v"].dtype)
        out = attend_decode(q, cache["k"], cache["v"],
                            cache_len=cache_index + 1)
    else:
        out = attend_prefill(q, k, v, causal=causal)
        if mode == "prefill":
            new_cache = {"k": k.to(KV_CACHE_DTYPE), "v": v.to(KV_CACHE_DTYPE)}
    return _out_proj(params, out, cfg), new_cache


def cross_attention(params, x: torch.Tensor, enc_kv, cfg: ModelConfig):
    """Whisper's decoder cross-attention against precomputed encoder K/V
    (``enc_kv``: {"k", "v": [B, enc_seq, Hkv, hd]}), full (not causal),
    through the flash_attention kernel in every mode: in decode one query
    against the encoder's keys. K/V held in another dtype than x (the
    bf16 cache of an f32 model) are promoted to x's, as JAX's einsum
    promotes."""
    b, s, _ = x.shape
    q = x @ params["wq"]
    if "bq" in params:
        q = q + params["bq"]
    q = q.reshape(b, s, cfg.n_heads, cfg.resolved_head_dim)
    dt = torch.promote_types(q.dtype, enc_kv["k"].dtype)
    out = attend_prefill(q.to(dt), enc_kv["k"].to(dt), enc_kv["v"].to(dt),
                         causal=False).to(x.dtype)
    return _out_proj(params, out, cfg)


# ---------------------------------------------------------------------------
# Dense / MoE / VLM decoder block (pre-RMSNorm, SwiGLU or MoE FFN)
# ---------------------------------------------------------------------------

def decoder_block_defs(cfg: ModelConfig, layers: int):
    defs = {
        "ln1": ParamDef((layers, cfg.d_model), ("layers", "embed"),
                        init="ones"),
        "attn": attn_defs(cfg, layers),
        "ln2": ParamDef((layers, cfg.d_model), ("layers", "embed"),
                        init="ones"),
    }
    if cfg.moe is not None and cfg.moe.n_experts:
        defs["moe"] = moe.moe_defs(cfg.d_model, cfg.moe, layers)
    else:
        defs["mlp"] = mlp_defs(cfg.d_model, cfg.d_ff, layers)
    return defs


def decoder_block(params, x, cfg: ModelConfig, *, mode, positions,
                  cache=None, cache_index=None):
    h = rmsnorm(x, params["ln1"], cfg.norm_eps)
    a, new_cache = self_attention(params["attn"], h, cfg, mode=mode,
                                  positions=positions, cache=cache,
                                  cache_index=cache_index)
    x = x + a
    h = rmsnorm(x, params["ln2"], cfg.norm_eps)
    if "moe" in params:
        f, aux = moe.moe_ffn(params["moe"], h, cfg.moe)
    else:
        f, aux = swiglu_mlp(params["mlp"], h), _no_aux(x)
    return x + f, new_cache, aux


# ---------------------------------------------------------------------------
# RWKV6 (Finch) block: data-dependent-decay time mix + channel mix
# ---------------------------------------------------------------------------

RWKV_LORA = 32


def rwkv6_block_defs(cfg: ModelConfig, layers: int):
    d = cfg.d_model
    h = cfg.ssm.n_ssm_heads
    dk = d // h
    f = cfg.d_ff
    L = layers
    la = ("layers",)
    return {
        "ln1": ParamDef((L, d), la + ("embed",), init="ones"),
        "ln2": ParamDef((L, d), la + ("embed",), init="ones"),
        "tm": {
            # token-shift interpolation coefficients for r, k, v, w, g
            "mu": ParamDef((L, 5, d), la + (None, "embed")),
            "w_base": ParamDef((L, d), la + ("embed",)),   # decay base
            "w_lora_a": ParamDef((L, d, RWKV_LORA), la + ("embed", None)),
            "w_lora_b": ParamDef((L, RWKV_LORA, d), la + (None, "embed"),
                                 init="zeros"),
            "u": ParamDef((L, h, dk), la + ("heads", None)),   # bonus
            "wr": ParamDef((L, d, d), la + ("embed", "heads")),
            "wk": ParamDef((L, d, d), la + ("embed", "heads")),
            "wv": ParamDef((L, d, d), la + ("embed", "heads")),
            "wg": ParamDef((L, d, d), la + ("embed", "heads")),
            "wo": ParamDef((L, d, d), la + ("heads", "embed")),
            "ln_x_w": ParamDef((L, d), la + ("embed",), init="ones"),
            "ln_x_b": ParamDef((L, d), la + ("embed",), init="zeros"),
        },
        "cm": {
            "mu_k": ParamDef((L, d), la + ("embed",)),
            "mu_r": ParamDef((L, d), la + ("embed",)),
            "wk": ParamDef((L, d, f), la + ("embed", "ff")),
            "wv": ParamDef((L, f, d), la + ("ff", "embed")),
            "wr": ParamDef((L, d, d), la + ("embed", "heads")),
        },
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """x: [B, S, D] -> x shifted right by one token; position 0 sees
    ``prev`` (the decode carry) or zeros."""
    first = (x.new_zeros((x.shape[0], 1, x.shape[2])) if prev is None
             else prev.to(x.dtype)[:, None])
    return torch.cat([first, x[:, :-1]], dim=1)


def rwkv6_time_mix(p, x, cfg: ModelConfig, *, mode, cache):
    """Returns (y, new_cache): decode updates ``cache``'s state and
    ``shift_tm`` in place; prefill returns fresh ones; train None."""
    b, s, d = x.shape
    h = cfg.ssm.n_ssm_heads
    dk = d // h
    prev = cache["shift_tm"] if cache is not None else None
    xs = _token_shift(x, prev)
    mix = x[:, :, None, :] + (xs - x)[:, :, None, :] * p["mu"][None, None]
    xr, xk, xv, xw, xg = mix.unbind(2)
    r = (xr @ p["wr"]).reshape(b, s, h, dk)
    k = (xk @ p["wk"]).reshape(b, s, h, dk)
    v = (xv @ p["wv"]).reshape(b, s, h, dk)
    g = xg @ p["wg"]
    # data-dependent decay: w = exp(-exp(base + lora(xw))), as a log
    # decay of down to -e^4 per token (the kernel masks before its exps)
    lora = torch.tanh((xw @ p["w_lora_a"]).float()).to(x.dtype) \
        @ p["w_lora_b"]
    log_w = -torch.exp(torch.clamp(p["w_base"].float() + lora.float(),
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
    y = groupnorm_heads(out.reshape(b, s, d), p["ln_x_w"], p["ln_x_b"], h)
    y = y * F.silu(g.float()).to(x.dtype)
    return y @ p["wo"], new_cache


def rwkv6_channel_mix(p, x, *, cache):
    """Returns (y, x's last token: the next call's shift)."""
    prev = cache["shift_cm"] if cache is not None else None
    xs = _token_shift(x, prev)
    xk = x + (xs - x) * p["mu_k"]
    xr = x + (xs - x) * p["mu_r"]
    k = torch.square(F.relu((xk @ p["wk"]).float())).to(x.dtype)
    kv = k @ p["wv"]
    r = torch.sigmoid((xr @ p["wr"]).float())
    return r.to(x.dtype) * kv, x[:, -1]


def rwkv6_block(params, x, cfg: ModelConfig, *, mode, cache=None):
    h = rmsnorm(x, params["ln1"], cfg.norm_eps)
    a, tm_cache = rwkv6_time_mix(params["tm"], h, cfg, mode=mode,
                                 cache=cache)
    x = x + a
    h = rmsnorm(x, params["ln2"], cfg.norm_eps)
    f, shift_cm = rwkv6_channel_mix(params["cm"], h, cache=cache)
    if mode == "decode":
        cache["shift_cm"].copy_(shift_cm)
        new_cache = cache
    else:
        new_cache = (None if mode == "train"
                     else dict(tm_cache, shift_cm=shift_cm.clone()))
    return x + f, new_cache, _no_aux(x)


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
    return {
        "ln": ParamDef((L, d), la + ("embed",), init="ones"),
        "in_proj": ParamDef((L, d, proj_out), la + ("embed", "heads")),
        "conv_w": ParamDef((L, cfg.ssm.conv_kernel, d_in + 2 * st),
                           la + (None, "heads"), scale=0.5),
        "a_log": ParamDef((L, nh), la + ("heads",), init="zeros"),
        "dt_bias": ParamDef((L, nh), la + ("heads",), init="zeros"),
        "d_skip": ParamDef((L, nh), la + ("heads",), init="ones"),
        "norm": ParamDef((L, d_in), la + ("heads",), init="ones"),
        "out_proj": ParamDef((L, d_in, d), la + ("heads", "embed")),
    }


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


def mamba2_block(params, x, cfg: ModelConfig, *, mode, cache=None):
    b, s, d = x.shape
    d_in, nh, hd, st = mamba_dims(cfg)

    h = rmsnorm(x, params["ln"], cfg.norm_eps)
    zxbcdt = h @ params["in_proj"]
    z, xin, Bc, Cc, dt = torch.split(zxbcdt, [d_in, d_in, st, st, nh],
                                     dim=-1)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = _causal_conv(conv_in, params["conv_w"], conv_state)
    xin, Bc, Cc = torch.split(conv_out, [d_in, st, st], dim=-1)

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
    y = rmsnorm(y, params["norm"], cfg.norm_eps)
    y = y * F.silu(z.float()).to(x.dtype)
    y = y @ params["out_proj"]
    return x + y, new_cache, _no_aux(x)


# ---------------------------------------------------------------------------
# Whisper encoder block (bidirectional, LayerNorm + bias, GELU MLP) and
# decoder block with cross-attention
# ---------------------------------------------------------------------------

def encoder_block_defs(cfg: ModelConfig, layers: int):
    d = cfg.d_model
    la = ("layers",)
    return {
        "ln1_w": ParamDef((layers, d), la + ("embed",), init="ones"),
        "ln1_b": ParamDef((layers, d), la + ("embed",), init="zeros"),
        "attn": attn_defs(cfg, layers, bias=True),
        "ln2_w": ParamDef((layers, d), la + ("embed",), init="ones"),
        "ln2_b": ParamDef((layers, d), la + ("embed",), init="zeros"),
        "mlp": gelu_mlp_defs(d, cfg.d_ff, layers),
    }


def encoder_block(params, x, cfg: ModelConfig):
    """Self-attention over the frames, not causal (the flash kernel's full
    regime)."""
    h = layernorm(x, params["ln1_w"], params["ln1_b"], cfg.norm_eps)
    a, _ = self_attention(params["attn"], h, cfg, mode="train",
                          positions=None, causal=False)
    x = x + a
    h = layernorm(x, params["ln2_w"], params["ln2_b"], cfg.norm_eps)
    return x + gelu_mlp(params["mlp"], h)


def decoder_xattn_block_defs(cfg: ModelConfig, layers: int):
    d = cfg.d_model
    la = ("layers",)
    return {
        "ln1_w": ParamDef((layers, d), la + ("embed",), init="ones"),
        "ln1_b": ParamDef((layers, d), la + ("embed",), init="zeros"),
        "attn": attn_defs(cfg, layers, bias=True),
        "lnx_w": ParamDef((layers, d), la + ("embed",), init="ones"),
        "lnx_b": ParamDef((layers, d), la + ("embed",), init="zeros"),
        "xattn": attn_defs(cfg, layers, bias=True),
        "ln2_w": ParamDef((layers, d), la + ("embed",), init="ones"),
        "ln2_b": ParamDef((layers, d), la + ("embed",), init="zeros"),
        "mlp": gelu_mlp_defs(d, cfg.d_ff, layers),
    }


def decoder_xattn_block(params, x, enc_kv, cfg: ModelConfig, *, mode,
                        cache=None, cache_index=None):
    h = layernorm(x, params["ln1_w"], params["ln1_b"], cfg.norm_eps)
    a, new_cache = self_attention(params["attn"], h, cfg, mode=mode,
                                  positions=None, cache=cache,
                                  cache_index=cache_index)
    x = x + a
    h = layernorm(x, params["lnx_w"], params["lnx_b"], cfg.norm_eps)
    x = x + cross_attention(params["xattn"], h, enc_kv, cfg)
    h = layernorm(x, params["ln2_w"], params["ln2_b"], cfg.norm_eps)
    return x + gelu_mlp(params["mlp"], h), new_cache, _no_aux(x)
