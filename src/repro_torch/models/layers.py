"""Shared neural-net layers: RMSNorm, rotary embeddings, SwiGLU MLP,
embedding/unembedding. Pure functions over explicit param trees, as in
the JAX package's ``models/layers.py``: norms, activations and softmaxes
compute in f32, tensors stay in the parameters' dtype (bf16 by default).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.param import ParamDef


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


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


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32."""
    return x.float() @ table.float().T
