"""Serving steps: batched prefill and greedy single-token decode against
a KV/state cache, with the JAX package's signatures. Decode updates the
cache in place (where the reference donates it) and returns it. Neither
records an autograd graph.

Under a sharded ``ctx`` (``models/sharding.py``) the parameters, batch
and cache are this rank's and the logits are its vocab columns: the
greedy token is the argmax across the ranks' columns (one all-gather of
each rank's maximum and its id), with ``jnp.argmax``'s tie rule — the
first id of the maximum — and the padded vocab never chosen (the model
drops it); a decode step returns the rank's logits."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.model import Model
from repro_torch.models.sharding import NULL_CTX, ShardingCtx


def greedy(model: Model, logits: torch.Tensor,
           ctx: ShardingCtx = NULL_CTX) -> torch.Tensor:
    """The argmax id int32 [B] of logits [B, V] (this rank's columns under
    a sharded ``ctx``)."""
    if ctx.size("act_vocab") == 1:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    v0, _ = model.vocab_range(ctx)
    idx = torch.argmax(logits, dim=-1)
    best = logits.gather(-1, idx[:, None])[:, 0]
    cand = torch.stack([best, (idx + v0).float()], dim=-1)       # [B, 2]
    # ids < 2^24 are exact in f32; ranks hold increasing ids, so the
    # first rank with the maximum holds its first id
    every = torch.stack(ctx.all_gather(cand, "act_vocab"))       # [M, B, 2]
    rank = torch.argmax(every[..., 0], dim=0)                    # [B]
    return every[..., 1].gather(0, rank[None])[0].to(torch.int32)


def make_prefill_step(model: Model, ctx: ShardingCtx = NULL_CTX):
    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Any]:
        """batch: the whole dict reaches ``Model.forward`` — ``tokens``
        [B, P], and an encdec model's ``frames``. Returns (next_token [B],
        the filled cache)."""
        logits, cache, _ = model.forward(params, batch, mode="prefill",
                                         ctx=ctx)
        # greedy next token from the last position
        return greedy(model, logits[:, -1], ctx), cache
    return prefill_step


def make_decode_step(model: Model, ctx: ShardingCtx = NULL_CTX):
    @torch.no_grad()
    def decode_step(params, cache, token: torch.Tensor, index: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        """token: [B, 1] int; index: the position being decoded. Returns
        (next_token [B], logits [B, V], cache)."""
        logits, cache, _ = model.forward(params, {"tokens": token},
                                         mode="decode", cache=cache,
                                         cache_index=index, ctx=ctx)
        return greedy(model, logits[:, 0], ctx), logits[:, 0], cache
    return decode_step
