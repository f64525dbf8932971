"""The model API of the dense (internlm2) and hybrid (zamba2) families.

``Model(cfg)`` builds a ParamDef tree once (the JAX package's tree, leaf
for leaf); ``init`` materializes it from a ``torch.Generator`` on that
generator's device, ``init_cache`` allocates the decode cache. ``forward``
covers three modes:

  train   — full-sequence causal LM forward, returns logits; records
            autograd's graph where grad mode is on and the parameters
            require grad (``train/train_step.py``), each layer body under
            ``torch.utils.checkpoint`` when ``cfg.remat`` (the reference's
            ``jax.checkpoint``)
  prefill — like train but also returns a populated KV/state cache
  decode  — one token against a cache, which it updates in place
Prefill and decode run without a graph.

The stacks loop over the stacked ``[L, ...]`` layer params (the JAX
package scans them), unbound once per forward so that the backward stacks
the layers' gradients in one step.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_device
from repro_torch.models import blocks
from repro_torch.models.layers import embed, rmsnorm, swiglu_mlp, unembed
from repro_torch.models.param import ParamDef, tree_init, tree_map


def _layer(tree, i: int):
    """Layer ``i`` of a stacked [L, ...] tree (views)."""
    return tree_map(lambda a: a[i], tree)


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked [L, ...] tree, as views from one
    ``unbind`` per leaf (whose backward stacks the layer gradients at
    once, where per-layer indexing would add L full-size zero-padded
    gradients)."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda p: p[i], parts) for i in range(n)]


def _body(remat: bool, fn, *args):
    """``fn(*args)``, under a non-reentrant activation checkpoint when
    ``remat``: its activations are recomputed in the backward."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _stack(caches):
    """A list of per-layer cache trees -> one stacked [L, ...] tree."""
    return tree_map(lambda *xs: torch.stack(xs), caches[0], *caches[1:])


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in ("dense", "hybrid") or cfg.pos_scheme != "rope":
            raise ValueError(f"the port serves the dense and hybrid "
                             f"families with RoPE, not {cfg.family!r} / "
                             f"{cfg.pos_scheme!r}")
        self.cfg = cfg
        self.defs = self._build_defs()

    # ------------------------------------------------------------------ defs
    def _build_defs(self):
        cfg = self.cfg
        d = {
            "embed": ParamDef((cfg.padded_vocab, cfg.d_model),
                              ("vocab", "embed"), scale=1.0),
            "final_norm": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        }
        if not cfg.tie_embeddings:
            d["unembed"] = ParamDef((cfg.padded_vocab, cfg.d_model),
                                    ("vocab", "embed"))
        if cfg.family == "dense":
            d["layers"] = blocks.decoder_block_defs(cfg, cfg.n_layers)
        else:
            d["layers"] = blocks.mamba2_block_defs(cfg, cfg.n_layers)
            d["shared"] = {
                "fuse": ParamDef((2 * cfg.d_model, cfg.d_model),
                                 (None, "embed")),
                "ln1": ParamDef((cfg.d_model,), ("embed",), init="ones"),
                "attn": blocks.attn_defs(cfg, None),
                "ln2": ParamDef((cfg.d_model,), ("embed",), init="ones"),
                "mlp": {
                    "w_gate": ParamDef((cfg.d_model, cfg.d_ff),
                                       ("embed", "ff")),
                    "w_up": ParamDef((cfg.d_model, cfg.d_ff),
                                     ("embed", "ff")),
                    "w_down": ParamDef((cfg.d_ff, cfg.d_model),
                                       ("ff", "embed")),
                },
            }
        return d

    # -------------------------------------------------------------- params
    def init(self, generator: torch.Generator) -> Any:
        """Random weights on ``generator.device``."""
        return tree_init(self.defs, generator)

    # --------------------------------------------------------------- caches
    def n_shared_apps(self) -> int:
        cfg = self.cfg
        if cfg.family != "hybrid" or not cfg.shared_attn_every:
            return 0
        return cfg.n_layers // cfg.shared_attn_every

    def cache_defs(self, batch: int, seq: int) -> Any:
        """ParamDef-shaped description of the decode cache; seq = max cache
        length."""
        cfg = self.cfg
        L = cfg.n_layers
        hd = cfg.resolved_head_dim

        def kv(layers, s, h):
            axes = ("layers", "batch", "kv_seq", "kv_heads", None)
            return {"k": ParamDef((layers, batch, s, h, hd), axes,
                                  init="zeros"),
                    "v": ParamDef((layers, batch, s, h, hd), axes,
                                  init="zeros")}

        if cfg.family == "dense":
            return kv(L, seq, cfg.n_kv_heads)
        d_in, nh, dv, st = blocks.mamba_dims(cfg)
        cache = {
            "mamba": {
                "state": ParamDef((L, batch, nh, st, dv),
                                  ("layers", "batch", "heads", None, None),
                                  init="zeros", dtype=torch.float32),
                "conv": ParamDef((L, batch, cfg.ssm.conv_kernel - 1,
                                  d_in + 2 * st),
                                 ("layers", "batch", None, "heads"),
                                 init="zeros"),
            },
        }
        napp = self.n_shared_apps()
        if napp:
            cache["shared"] = kv(napp, seq, cfg.n_kv_heads)
        return cache

    def init_cache(self, batch: int, seq: int, device=None) -> Any:
        """The zeroed decode cache on ``device``: the card unless the
        caller asks for the CPU (``core.backend.resolve_device``; raises
        when CUDA is absent)."""
        dev = resolve_device(device)
        return tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                              device=dev),
                        self.cache_defs(batch, seq))

    # -------------------------------------------------------------- forward
    def forward(self, params, batch: Dict[str, torch.Tensor], *, mode: str,
                cache=None, cache_index: Optional[int] = None
                ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
        """Returns (logits f32 [B, S, vocab], new_cache, aux), as the JAX
        package's ``Model.forward`` does. ``aux`` is the f32 scalar sum of
        the blocks' auxiliary losses on the tokens' device: 0 for the
        dense and hybrid families, whose blocks have none. In decode mode
        the logits cover the single new token, ``cache_index`` is the
        position it is decoded at and ``cache`` is updated in place.
        Only train mode records a graph."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode != "train":
            with torch.no_grad():
                return self._forward(params, batch, mode=mode, cache=cache,
                                     cache_index=cache_index)
        return self._forward(params, batch, mode=mode, cache=cache,
                             cache_index=cache_index)

    def _forward(self, params, batch, *, mode, cache, cache_index):
        cfg = self.cfg
        tokens = batch["tokens"]
        s = tokens.shape[1]
        x = embed(params["embed"], tokens)
        offset = cache_index if mode == "decode" else 0
        positions = (offset + torch.arange(s, dtype=torch.int32,
                                           device=tokens.device))[None]

        stack = self._hybrid_stack if cfg.family == "hybrid" \
            else self._scan_stack
        x, new_cache = stack(params, x, mode=mode, positions=positions,
                             cache=cache, cache_index=cache_index)

        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        logits = unembed(table, x)
        if cfg.padded_vocab != cfg.vocab:
            logits = logits[..., :cfg.vocab]   # drop the padding columns
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return logits, new_cache, aux

    # ------------------------------------------------------------ stacks
    def _remat(self, mode: str) -> bool:
        """Whether train mode checkpoints each layer body: ``cfg.remat``,
        where a graph is being recorded."""
        return mode == "train" and self.cfg.remat and torch.is_grad_enabled()

    def _scan_stack(self, params, x, *, mode, positions, cache,
                    cache_index):
        """Blocks return no cache in train mode, a fresh per-layer cache in
        prefill mode (stacked here) and the updated cache in decode
        mode."""
        cfg = self.cfg
        remat = self._remat(mode)
        fresh = []
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            if mode == "train":
                x = _body(remat, lambda p, h: blocks.decoder_block(
                    p, h, cfg, mode=mode, positions=positions)[0], lp, x)
                continue
            x, lc = blocks.decoder_block(
                lp, x, cfg, mode=mode, positions=positions,
                cache=None if cache is None else _layer(cache, i),
                cache_index=cache_index)
            fresh.append(lc)
        if mode == "prefill":
            return x, _stack(fresh)
        return x, cache if mode == "decode" else None

    def _hybrid_stack(self, params, x, *, mode, positions, cache,
                      cache_index):
        """Zamba2: Mamba2 backbone with a single *shared* attention block
        applied after every ``shared_attn_every`` layers. The shared block
        consumes concat(hidden, initial_embedding); the trailing
        ``n_layers % shared_attn_every`` layers have no shared block after
        them."""
        cfg = self.cfg
        k = cfg.shared_attn_every
        napp = self.n_shared_apps()
        x0 = x
        shared_p = params["shared"]
        m_cache = cache["mamba"] if cache is not None else None
        s_cache = cache.get("shared") if cache is not None else None

        def apply_shared(h, sc):
            z = torch.cat([h, x0], dim=-1) @ shared_p["fuse"]
            hh = rmsnorm(z, shared_p["ln1"], cfg.norm_eps)
            a, new_sc = blocks.self_attention(
                shared_p["attn"], hh, cfg, mode=mode, positions=positions,
                cache=sc, cache_index=cache_index)
            z = z + a
            hh = rmsnorm(z, shared_p["ln2"], cfg.norm_eps)
            z = z + swiglu_mlp(shared_p["mlp"], hh)
            return h + z, new_sc

        remat = self._remat(mode)
        m_fresh, s_fresh = [], []
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            g = i // k
            shared_after = (i + 1) % k == 0 and g < napp
            if mode == "train":
                # the shared block's parameters enter every application,
                # so their gradient sums over the applications
                x = _body(remat, lambda p, h: blocks.mamba2_block(
                    p, h, cfg, mode=mode)[0], lp, x)
                if shared_after:
                    x = _body(remat, lambda h: apply_shared(h, None)[0], x)
                continue
            x, lc = blocks.mamba2_block(
                lp, x, cfg, mode=mode,
                cache=None if m_cache is None else _layer(m_cache, i))
            m_fresh.append(lc)
            if shared_after:
                x, sc = apply_shared(
                    x, None if s_cache is None else _layer(s_cache, g))
                s_fresh.append(sc)

        if mode == "train":
            return x, None
        if mode == "decode":
            return x, cache
        new_cache = {"mamba": _stack(m_fresh)}
        if s_fresh:
            new_cache["shared"] = _stack(s_fresh)
        return x, new_cache


@functools.lru_cache(maxsize=32)
def build_model(arch: str, smoke: bool = False) -> Model:
    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    return Model(cfg)
