"""Shared neural-net layers: norms (RMSNorm, LayerNorm, per-head
GroupNorm), positions (RoPE, M-RoPE, sinusoidal), the SwiGLU and GELU
MLPs, embedding/unembedding. Pure functions over explicit param trees, as in
the JAX package's ``models/layers.py``: norms, activations and softmaxes
compute in f32, tensors stay in the parameters' dtype (bf16 by default).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.param import ParamDef


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
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


def mlp_defs(d_model: int, d_ff: int, layers: Optional[int] = None):
    lead = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)
    return {
        "w_gate": ParamDef(lead + (d_model, d_ff), lax_ + ("embed", "ff")),
        "w_up": ParamDef(lead + (d_model, d_ff), lax_ + ("embed", "ff")),
        "w_down": ParamDef(lead + (d_ff, d_model), lax_ + ("ff2", "embed_out")),
    }


def swiglu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ params["w_down"]


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """2-matrix GELU MLP (whisper); the tanh approximation, as
    ``jax.nn.gelu``'s default."""
    h = x @ params["w_up"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ params["w_down"]


def gelu_mlp_defs(d_model: int, d_ff: int, layers: Optional[int] = None):
    lead = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)
    return {
        "w_up": ParamDef(lead + (d_model, d_ff), lax_ + ("embed", "ff")),
        "w_down": ParamDef(lead + (d_ff, d_model),
                           lax_ + ("ff2", "embed_out")),
    }


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32."""
    return x.float() @ table.float().T
