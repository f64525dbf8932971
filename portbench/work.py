"""The work of a cell, from the configuration's published sizes and the
mix's shapes alone: model FLOPs, the parameters a token passes through,
and one attention call's operations and bytes. It reads nothing of the
program, so it counts the same work whatever implements it.

  N_active  every parameter a token passes through: per layer the
            attention's four projections, the two norm gains and the
            feed-forward (dense: 3·hidden·intermediate; MoE: the top-k
            routed experts' 3·hidden·moe_intermediate each, the shared
            expert's 3·hidden·shared_intermediate and the router
            hidden·experts), then the embedding, the head and the final
            norm. The program's padded experts and vocabulary rows are
            not the configuration's and are not counted.
  attention per sequence and layer, forward, causal: the score and value
            products over the S·(S+1)/2 query-key pairs that the mask
            keeps, 2 FLOPs per multiply-add: 4·heads·head_dim·S(S+1)/2.
  forward   2·N_active per token + attention
  train     3 × forward (the backward twice the forward); a remat
            re-forward is not counted.
  flash call (one causal forward of the attention kernel over
            [B, heads, S, head_dim]): the FLOPs above, and q, k, v read
            once and the output written once, in bfloat16.
"""
from __future__ import annotations

from typing import Tuple


def head_dim(c: dict) -> int:
    return c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"]


def active_params(c: dict) -> int:
    d, hd = c["hidden_size"], head_dim(c)
    h, hkv = c["num_attention_heads"], c["num_key_value_heads"]
    attn = d * h * hd + 2 * d * hkv * hd + h * hd * d
    if c.get("num_experts"):
        ffn = (c["num_experts_per_tok"] * 3 * d * c["moe_intermediate_size"]
               + 3 * d * c["shared_expert_intermediate_size"]
               + d * c["num_experts"])
    else:
        ffn = 3 * d * c["intermediate_size"]
    heads_out = 1 if c.get("tie_word_embeddings") else 2
    return (c["num_hidden_layers"] * (attn + ffn + 2 * d)
            + heads_out * c["vocab_size"] * d + d)


def attention_flops(c: dict, batch: int, seq: int) -> int:
    """Forward causal attention FLOPs of ``batch`` sequences, all layers."""
    pairs = seq * (seq + 1) // 2
    return (c["num_hidden_layers"] * batch * 4 * c["num_attention_heads"]
            * head_dim(c) * pairs)


def forward_flops(c: dict, batch: int, seq: int) -> int:
    return 2 * active_params(c) * batch * seq + attention_flops(c, batch, seq)


def train_flops(c: dict, batch: int, seq: int) -> int:
    return 3 * forward_flops(c, batch, seq)


def flash_call(c: dict, batch: int, seq: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one causal attention forward call of one layer."""
    pairs = seq * (seq + 1) // 2
    h, hkv, hd = c["num_attention_heads"], c["num_key_value_heads"], \
        head_dim(c)
    flops = batch * 4 * h * hd * pairs
    nbytes = 2 * batch * seq * hd * (2 * h + 2 * hkv)
    return flops, nbytes


def bound_s(flops: float, nbytes: float, peak: dict) -> float:
    """The least time the chip could take: the larger of the FLOPs over
    the bfloat16 peak and the bytes over the memory bandwidth."""
    return max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes_per_s"])
