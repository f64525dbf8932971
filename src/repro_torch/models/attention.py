"""Attention: grouped-query (GQA/MQA) softmax attention in the model's
[B, S, H, D] layout, in three regimes.

  * ``attend_prefill`` — train and prefill (and cross-attention in every
                         mode), causal or full: the hand-written
                         ``flash_attention`` kernel on the card
                         (``kernels.flash_attention.ops.mha``, its plain
                         version on the CPU) through its autograd
                         Function (the gradient is the plain version's),
                         fed transposed views of the activations, so
                         nothing is copied. The reference trains through
                         ``attend_full`` up to 8192 tokens, the same
                         function.
  * ``attend_full``    — the reference's einsum path in plain torch (its
                         probabilities rounded to the compute dtype before
                         PV, as ``models/attention.py:attend_full``).
  * ``attend_decode``  — one query step against a KV cache with a length
                         mask, plain torch (the JAX package has no kernel
                         for it).

All paths compute the softmax in f32 and respect GQA head grouping.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops

NEG_INF = -1e30


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B, S, Hq, d] -> [B, S, Hkv, G, d]."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, d)


def attend_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True) -> torch.Tensor:
    """q: [B, Sq, Hq, d]; k, v: [B, Skv, Hkv, d] -> [B, Sq, Hq, d],
    through the flash_attention kernel, causal or full (the whisper
    encoder and cross-attention, where Sq may differ from Skv: 1 query
    against the encoder's keys in decode). In bf16 (its tensor-core
    design) the probabilities are rounded to bf16 before PV, as
    ``attend_full`` rounds them; in f32 they stay f32 (as the TPU kernel
    keeps them)."""
    out = flash_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)


def attend_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, Hq, d]; k, v: [B, Skv, Hkv, d] -> [B, Sq, Hq, d]."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    scale = d ** -0.5
    qg = _group(q, hkv)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(skv, device=q.device)
        logits = logits.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, d)


def attend_decode(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, *, cache_len: int) -> torch.Tensor:
    """One decode step. q: [B, 1, Hq, d]; caches: [B, S, Hkv, d];
    cache_len: the number of valid cache positions (includes the token
    being decoded, whose K/V must already be written). The cache's dtype
    is promoted to q's, as JAX's einsum promotes."""
    b, _, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    scale = d ** -0.5
    dt = torch.promote_types(q.dtype, k_cache.dtype)
    qg = _group(q, hkv)[:, 0].to(dt)                        # [B, Hkv, G, d]
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.to(dt)).float()
    logits = logits * scale
    valid = torch.arange(s, device=q.device) < cache_len
    logits = logits.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(dt)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v_cache.to(dt))
    return out.reshape(b, 1, hq, d).to(q.dtype)
