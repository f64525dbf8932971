"""Serving steps: batched prefill and greedy single-token decode against
a KV/state cache, with the JAX package's signatures. Decode updates the
cache in place (where the reference donates it) and returns it. Neither
records an autograd graph."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.model import Model


def make_prefill_step(model: Model):
    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Any]:
        """batch: the whole dict reaches ``Model.forward`` — ``tokens``
        [B, P], and an encdec model's ``frames``. Returns (next_token [B],
        the filled cache)."""
        logits, cache, _ = model.forward(params, batch, mode="prefill")
        # greedy next token from the last position
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, cache
    return prefill_step


def make_decode_step(model: Model):
    @torch.no_grad()
    def decode_step(params, cache, token: torch.Tensor, index: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        """token: [B, 1] int; index: the position being decoded. Returns
        (next_token [B], logits [B, V], cache)."""
        logits, cache, _ = model.forward(params, {"tokens": token},
                                      mode="decode", cache=cache,
                                      cache_index=index)
        next_tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        return next_tok, logits[:, 0], cache
    return decode_step
