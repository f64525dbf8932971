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
                         for it); where the cache's sequence is split
                         over ranks (``kv_seq``, round-robin) each rank
                         attends over its positions and the ranks combine
                         by log-sum-exp (three f32 all-reduces: the max,
                         the sum of exponentials, the output).

All paths compute the softmax in f32 and respect GQA head grouping. A
rank of the model axis that holds no heads (``q`` with 0 heads) skips
the attention: its output is empty (``q``'s shape) and no kernel is
called (the kernel takes at least one kv head). A rank that holds no heads
but holds cache positions still takes part in a split ``attend_decode``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.sharding import NULL_CTX, ShardingCtx

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
    if q.shape[2] == 0:
        return _headless(q, k, v)
    out = flash_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)


def _headless(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """The attention of a rank holding no heads: ``q`` (empty), tied to
    the empty ``k`` and ``v`` so that what they are computed from (whisper's
    encoder output) stays in the graph and the backward issues the same
    collectives on every rank."""
    return q + (k.sum() + v.sum()).to(q.dtype) * 0


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
                  v_cache: torch.Tensor, *, cache_len: int,
                  ctx: ShardingCtx = NULL_CTX) -> torch.Tensor:
    """One decode step. q: [B, 1, Hq, d] (every q head the cache's kv
    heads serve); caches: [B, T, Hkv, d]; cache_len: the number of valid
    cache positions (includes the token being decoded, whose K/V must
    already be written). The cache's dtype is promoted to q's, as JAX's
    einsum promotes.

    Where ``ctx`` splits the cache's sequence ("kv_seq", round-robin over
    M ranks), the caches hold this rank's positions ``r, r + M, ...``
    (local ``j`` is position ``j·M + r``): each rank takes the f32 logits
    over its positions, masked by global position; the ranks all-reduce
    their row maxima (max) and their sums of ``exp(logits − max)``; each
    rank's probabilities, rounded to the compute dtype, multiply its V in
    that dtype (the cache is read once, not copied to f32), and the
    ranks' outputs are summed in f32 and rounded once. A rank with no
    valid position contributes zeros. Unsplit (M = 1) none of the three
    collectives is issued and the softmax is one fused call. A rank with no kv heads holds no q heads
    either (the sequence is then not on the heads' axis, so its whole
    kv_seq group holds none) and returns ``q``."""
    b, _, hq, d = q.shape
    _, t, hkv, _ = k_cache.shape
    if hkv == 0:
        return q
    m, r = ctx.size("kv_seq"), ctx.index("kv_seq")
    dt = torch.promote_types(q.dtype, k_cache.dtype)
    qg = _group(q, hkv)[:, 0].to(dt)                        # [B, Hkv, G, d]
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.to(dt)).float()
    logits = logits * d ** -0.5
    valid = torch.arange(r, r + t * m, m, device=q.device) < cache_len
    logits = logits.masked_fill(~valid, NEG_INF)
    if m == 1:
        probs = torch.softmax(logits, dim=-1).to(dt)
    else:
        top = (logits.amax(-1, keepdim=True) if t else
               logits.new_full(logits.shape[:-1] + (1,), NEG_INF))
        e = torch.exp(logits - ctx.reduce_max(top, "kv_seq"))
        probs = (e / ctx.reduce(e.sum(-1, keepdim=True), "kv_seq")).to(dt)
    out = ctx.reduce(torch.einsum("bhgk,bkhd->bhgd", probs, v_cache.to(dt)),
                     "kv_seq")
    return out.reshape(b, 1, hq, d).to(q.dtype)

