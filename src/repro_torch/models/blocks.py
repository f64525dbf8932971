"""Transformer / SSM blocks of the dense (internlm2) and hybrid (zamba2)
families. Every block is a pair (defs fn, apply fn) over an explicit param
tree, as in the JAX package's ``models/blocks.py``; the stacks in
``model.py`` loop over the leading "layers" axis of the defs.

Cache conventions (decode):
  attention  : {"k": [B, S, Hkv, hd], "v": [B, S, Hkv, hd]}  (bf16)
  mamba2     : {"state": [B, H, dk, dv] f32, "conv": [B, K-1, conv_dim]}
Prefill returns a fresh per-layer cache; decode writes the new token's
entries into the cache it is given, in place (the JAX package donates the
cache and returns an updated copy), and returns that cache.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import gla
from repro_torch.models.attention import attend_decode, attend_prefill
from repro_torch.models.layers import apply_rope, mlp_defs, rmsnorm, swiglu_mlp
from repro_torch.models.param import ParamDef

KV_CACHE_DTYPE = torch.bfloat16      # prefill stores K/V in bf16 always


# ---------------------------------------------------------------------------
# Self-attention (GQA) core, shared by the dense block and zamba2's shared
# block
# ---------------------------------------------------------------------------

def attn_defs(cfg: ModelConfig, layers: Optional[int] = None):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    lead = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)
    return {
        "wq": ParamDef(lead + (d, hq * hd), lax_ + ("embed", "heads")),
        "wk": ParamDef(lead + (d, hkv * hd), lax_ + ("embed", "kv_heads")),
        "wv": ParamDef(lead + (d, hkv * hd), lax_ + ("embed", "kv_heads")),
        "wo": ParamDef(lead + (hq * hd, d), lax_ + ("heads2", "embed_out")),
    }


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ params["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    return q, k, v


def self_attention(params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                   positions: torch.Tensor, cache=None, cache_index=None):
    """Causal, RoPE. mode: train | prefill | decode. Returns (y,
    new_cache)."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

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
        out = attend_prefill(q, k, v)
        if mode == "prefill":
            new_cache = {"k": k.to(KV_CACHE_DTYPE), "v": v.to(KV_CACHE_DTYPE)}
    y = out.reshape(b, -1, cfg.n_heads * hd) @ params["wo"]
    return y, new_cache


# ---------------------------------------------------------------------------
# Dense decoder block (pre-RMSNorm, SwiGLU FFN)
# ---------------------------------------------------------------------------

def decoder_block_defs(cfg: ModelConfig, layers: int):
    return {
        "ln1": ParamDef((layers, cfg.d_model), ("layers", "embed"),
                        init="ones"),
        "attn": attn_defs(cfg, layers),
        "ln2": ParamDef((layers, cfg.d_model), ("layers", "embed"),
                        init="ones"),
        "mlp": mlp_defs(cfg.d_model, cfg.d_ff, layers),
    }


def decoder_block(params, x, cfg: ModelConfig, *, mode, positions,
                  cache=None, cache_index=None):
    h = rmsnorm(x, params["ln1"], cfg.norm_eps)
    a, new_cache = self_attention(params["attn"], h, cfg, mode=mode,
                                  positions=positions, cache=cache,
                                  cache_index=cache_index)
    x = x + a
    h = rmsnorm(x, params["ln2"], cfg.norm_eps)
    x = x + swiglu_mlp(params["mlp"], h)
    return x, new_cache


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
    return x + y, new_cache
