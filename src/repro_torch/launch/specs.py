"""Abstract input construction for every (architecture x shape) cell: the
JAX package's ``launch/specs.py`` on ``meta`` tensors.

``train_batch_specs`` and ``decode_inputs`` return ``meta`` stand-ins
(shape and dtype, no memory) for the arguments of the step a cell
traces — ``train_step`` for train shapes, ``prefill_step`` for prefill,
``decode_step`` for decode/long shapes — with the same logical-axes
dicts. Token ids are int64 (torch's index dtype, what the port's entry
points draw; the JAX package uses int32). ``batch_pspecs`` has no
counterpart: the batch's layout is the caller's (``train/manual_dp.py``
splits it over the cards; under a model axis ``ShardingCtx.shard`` cuts
the rank's sequences), which ``launch/dryrun.py`` builds.

Modality frontends are stubs, as in the JAX package: whisper cells carry
precomputed conv-stem frame embeddings [B, 1500, d_model]; qwen2-vl text
cells carry token ids plus the 3-stream M-RoPE position ids.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSuite
from repro_torch.models.model import Model
from repro_torch.models.param import local_defs, tree_abstract
from repro_torch.models.sharding import NULL_CTX, ShardingCtx

TOKEN_DTYPE = torch.int64


def sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype`` (the counterpart of
    ``jax.ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, suite: ShapeSuite,
                      per_card: int = 0
                      ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(batch of ``meta`` tensors, their logical axes) for a train or
    prefill cell; ``per_card`` (default the suite's global batch) is one
    card's part of the batch."""
    b, s = per_card or suite.global_batch, suite.seq_len
    out = {
        "tokens": sds((b, s), TOKEN_DTYPE),
        "targets": sds((b, s), TOKEN_DTYPE),
    }
    axes = {
        "tokens": ("batch", None),
        "targets": ("batch", None),
    }
    if cfg.family == "encdec":
        out["frames"] = sds((b, cfg.enc_seq, cfg.d_model), torch.bfloat16)
        axes["frames"] = ("batch", None, "act_embed")
    if cfg.pos_scheme == "mrope":
        out["positions"] = sds((b, s, 3), torch.int32)
        axes["positions"] = ("batch", None, None)
    return out, axes


def decode_inputs(model: Model, suite: ShapeSuite, per_card: int = 0,
                  ctx: ShardingCtx = NULL_CTX):
    """(cache_defs, cache, token, index, token_axes) for a decode cell:
    the cache as ``meta`` tensors of ``model.cache_defs`` (seq_len deep,
    ``per_card`` sequences; under a sharded ``ctx`` the rank's part of
    it), one token per sequence, and the index decoded at — the cache's
    last position (the port's decode takes it as a Python int; the JAX
    package traces an abstract scalar), so that the step attends over the
    whole cache."""
    b = per_card or suite.global_batch
    cache_defs = model.cache_defs(b * ctx.size("batch"), suite.seq_len)
    cache = tree_abstract(local_defs(cache_defs, ctx))
    token = sds((b, 1), TOKEN_DTYPE)
    index = suite.seq_len - 1
    token_axes = ("batch", None)
    return cache_defs, cache, token, index, token_axes
