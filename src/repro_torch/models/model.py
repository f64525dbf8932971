"""The model API of every LM family the JAX package supports: dense
(internlm2), moe (qwen2-moe), vlm (qwen2-vl, M-RoPE), ssm (rwkv6), hybrid
(zamba2) and encdec (whisper).

``Model(cfg)`` builds a ParamDef tree once (the JAX package's tree, leaf
for leaf); ``init`` materializes it from a ``torch.Generator`` on that
generator's device, ``abstract`` gives it as ``meta`` tensors,
``init_cache`` allocates the decode cache (on the CPU or the card; the
dry run takes ``tree_abstract(cache_defs(...))``). ``forward``
covers three modes:

  train   — full-sequence causal LM (or enc-dec) forward, returns logits;
            records autograd's graph where grad mode is on and the
            parameters require grad (``train/train_step.py``), each layer
            body under ``torch.utils.checkpoint`` when ``cfg.remat`` (the
            reference's ``jax.checkpoint``)
  prefill — like train but also returns a populated KV/state cache
  decode  — one token against a cache, which it updates in place
Prefill and decode run without a graph.

The stacks loop over the stacked ``[L, ...]`` layer params (the JAX
package scans them), unbound once per forward so that the backward stacks
the layers' gradients in one step.

The model axis: ``specs`` gives the reference's PartitionSpecs; under a
``ShardingCtx`` with a mesh (``models/sharding.py``),
``init(generator, ctx)`` draws this rank's slices, ``local_defs``
describes them, ``init_cache(..., ctx=ctx)`` allocates the rank's cache
and ``forward(..., ctx=ctx)`` runs the rank's part of train, prefill and
decode for every family (tensor- and expert-parallel, vocab-parallel
embedding and logits: the logits it returns are the rank's vocab
columns, padding dropped; in train mode its gradients flow through the
context's ``reduce`` / ``copy`` / ``gather`` Functions, and
``train/train_step.py``'s vocab-parallel cross-entropy reads those
columns as they are). Whisper's encoder runs under the model axis too,
and its output enters the decoder layers' K/V projections through one
``copy``.

Under fsdp (training: "embed" over the data axis) the parameters are
the rank's parts of their input dims, and each piece of the forward
(``pieces``: a block, an application of zamba2's shared block, the
embedding, the final norm with the unembedding, whisper's encoder blocks,
its final norm and its cross-attention K/V weights) gathers its own
inside the function a block's checkpoint runs (``gathered``), so a remat
re-forward gathers again and the gathered copy lives for the block only.
Prefill and decode under fsdp raise, as the reference's rules apply it
to train cells only.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_device
from repro_torch.models import blocks
from repro_torch.models.layers import (embed, layernorm, norm_def, rmsnorm,
                                       sinusoidal_pos, swiglu_mlp, unembed)
from repro_torch.models.param import (ParamDef, local_defs, tree_abstract,
                                      tree_init, tree_map, tree_specs)
from repro_torch.models.sharding import NULL_CTX, ShardingCtx


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


def _positions_for(cfg: ModelConfig, s: int, offset: int,
                   device) -> Optional[torch.Tensor]:
    """Positions of ``s`` tokens from ``offset``, broadcast over the batch:
    [1, S] for RoPE, [1, S, 3] (t, h, w all equal: text) for M-RoPE, None
    for the sinusoidal and position-free schemes."""
    pos = offset + torch.arange(s, dtype=torch.int32, device=device)
    if cfg.pos_scheme == "mrope":
        return pos[None, :, None].expand(1, s, 3)
    if cfg.pos_scheme == "rope":
        return pos[None]
    return None


def _unlayered(defs):
    """The per-layer ParamDefs of a stacked [L, ...] tree of them."""
    return tree_map(lambda d: dataclasses.replace(
        d, shape=d.shape[1:], axes=d.axes[1:]), defs)


def _stack(caches):
    """A list of per-layer cache trees -> one stacked [L, ...] tree."""
    return tree_map(lambda *xs: torch.stack(xs), caches[0], *caches[1:])


FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}; the port "
                             f"serves {FAMILIES}")
        self.cfg = cfg
        self.defs = self._build_defs()

    # ------------------------------------------------------------------ defs
    def _build_defs(self):
        cfg = self.cfg
        d = {
            "embed": ParamDef((cfg.padded_vocab, cfg.d_model),
                              ("vocab", "embed"), scale=1.0),
            "final_norm": norm_def((cfg.d_model,), ("embed",)),
        }
        if not cfg.tie_embeddings:
            d["unembed"] = ParamDef((cfg.padded_vocab, cfg.d_model),
                                    ("vocab", "embed"))
        fam = cfg.family
        if fam in ("dense", "moe", "vlm"):
            d["layers"] = blocks.decoder_block_defs(cfg, cfg.n_layers)
        elif fam == "ssm":
            d["layers"] = blocks.rwkv6_block_defs(cfg, cfg.n_layers)
        elif fam == "hybrid":
            d["layers"] = blocks.mamba2_block_defs(cfg, cfg.n_layers)
            d["shared"] = {
                "fuse": ParamDef((2 * cfg.d_model, cfg.d_model),
                                 (None, "embed"), per_position=True),
                "ln1": norm_def((cfg.d_model,), ("embed",)),
                "attn": blocks.attn_defs(cfg, None),
                "ln2": norm_def((cfg.d_model,), ("embed",)),
                "mlp": {
                    "w_gate": ParamDef((cfg.d_model, cfg.d_ff),
                                       ("embed", "ff")),
                    "w_up": ParamDef((cfg.d_model, cfg.d_ff),
                                     ("embed", "ff")),
                    "w_down": ParamDef((cfg.d_ff, cfg.d_model),
                                       ("ff", "embed")),
                },
            }
        else:                                                   # encdec
            d["enc_layers"] = blocks.encoder_block_defs(cfg, cfg.n_enc_layers)
            d["enc_final_w"] = norm_def((cfg.d_model,), ("embed",))
            d["enc_final_b"] = norm_def((cfg.d_model,), ("embed",), "zeros")
            d["layers"] = blocks.decoder_xattn_block_defs(cfg, cfg.n_layers)
        return d

    # ------------------------------------------------------------ pieces
    @functools.cached_property
    def pieces(self) -> Dict[str, Any]:
        """The ParamDefs (full, per layer for a stack) of each piece of
        the forward that reads its parameters together, the unit of
        ``ShardingCtx.gather_params`` (fsdp): "embed" (the lookup's
        table), "head" (the final norm and the unembedding's table, tied
        or not), "layers" (one block; whisper's without its cross
        attention's ``wk`` / ``wv``, read for every layer before the
        decoder, "xattn_kv"), "shared" (zamba2's shared block, per
        application), "enc_layers" and "enc_final" (whisper's encoder)."""
        cfg, d = self.cfg, self.defs
        table = "embed" if cfg.tie_embeddings else "unembed"
        out = {"embed": {"embed": d["embed"]},
               "head": {"final_norm": d["final_norm"], table: d[table]},
               "layers": _unlayered(d["layers"])}
        if "shared" in d:
            out["shared"] = d["shared"]
        if cfg.family == "encdec":
            out["enc_layers"] = _unlayered(d["enc_layers"])
            out["enc_final"] = {k: d[k] for k in ("enc_final_w",
                                                  "enc_final_b")}
            xattn = out["layers"]["xattn"]
            out["xattn_kv"] = {"xattn": {k: xattn[k] for k in ("wk",
                                                              "wv")}}
            out["layers"] = {**out["layers"], "xattn": {
                k: v for k, v in xattn.items() if k not in ("wk", "wv")}}
        return out

    def gathered(self, params, piece: str, ctx: ShardingCtx):
        """``params`` (a piece's tree, or the model's for "embed", "head"
        and "enc_final") with the piece's leaves that the layout splits
        over "embed" gathered (``ShardingCtx.gather_params``)."""
        return ctx.gather_params(params, self.pieces[piece])

    # -------------------------------------------------------------- params
    def init(self, generator: torch.Generator,
             ctx: ShardingCtx = NULL_CTX) -> Any:
        """Random weights on ``generator.device`` (this rank's slices of
        them under a sharded ``ctx``)."""
        return tree_init(self.defs, generator, ctx)

    def abstract(self, ctx: ShardingCtx = NULL_CTX) -> Any:
        """The parameters (this rank's) as ``meta`` tensors (no memory):
        what the dry run (``launch/dryrun.py``) traces a step with."""
        return tree_abstract(local_defs(self.defs, ctx))

    def specs(self, rules, mesh=None) -> Any:
        """The parameters' PartitionSpecs (the reference's
        ``Model.specs``)."""
        return tree_specs(self.defs, rules, mesh)

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
        fam = cfg.family

        def kv(layers, s, h, names=("k", "v"), seq_axis="kv_seq"):
            axes = ("layers", "batch", seq_axis, "kv_heads", None)
            return {n: ParamDef((layers, batch, s, h, hd), axes,
                                init="zeros", parts=blocks.kv_parts(cfg))
                    for n in names}

        if fam in ("dense", "moe", "vlm"):
            return kv(L, seq, cfg.n_kv_heads)
        if fam == "ssm":
            h = cfg.ssm.n_ssm_heads
            dk = cfg.d_model // h
            shift = ParamDef((L, batch, cfg.d_model),
                             ("layers", "batch", "embed"), init="zeros")
            return {"state": ParamDef((L, batch, h, dk, dk),
                                      ("layers", "batch", "heads", None,
                                       None),
                                      init="zeros", dtype=torch.float32),
                    "shift_tm": shift, "shift_cm": shift}
        if fam == "encdec":
            # the self-attention K/V, and the encoder's K/V per layer: its
            # frames never split (``src/repro/models/model.py:152-160``)
            return {**kv(L, seq, cfg.n_kv_heads),
                    **kv(L, cfg.enc_seq, cfg.n_kv_heads, ("xk", "xv"), None)}
        d_in, nh, dv, st = blocks.mamba_dims(cfg)
        cache = {
            "mamba": {
                "state": ParamDef((L, batch, nh, st, dv),
                                  ("layers", "batch", "heads", None, None),
                                  init="zeros", dtype=torch.float32),
                "conv": ParamDef((L, batch, cfg.ssm.conv_kernel - 1,
                                  d_in + 2 * st),
                                 ("layers", "batch", None, "heads"),
                                 init="zeros", parts=blocks.conv_parts(cfg)),
            },
        }
        napp = self.n_shared_apps()
        if napp:
            cache["shared"] = kv(napp, seq, cfg.n_kv_heads)
        return cache

    def init_cache(self, batch: int, seq: int, device=None,
                   ctx: ShardingCtx = NULL_CTX) -> Any:
        """The zeroed decode cache on ``device``: the card unless the
        caller asks for the CPU (``core.backend.resolve_device``; raises
        when CUDA is absent). ``batch``: the global batch; under a
        sharded ``ctx``, this rank's part of the cache."""
        dev = resolve_device(device)
        return tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                              device=dev),
                        local_defs(self.cache_defs(batch, seq), ctx))

    # -------------------------------------------------------------- forward
    def forward(self, params, batch: Dict[str, torch.Tensor], *, mode: str,
                cache=None, cache_index: Optional[int] = None,
                ctx: ShardingCtx = NULL_CTX
                ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
        """Returns (logits f32 [B, S, vocab], new_cache, aux), as the JAX
        package's ``Model.forward`` does. ``batch`` holds ``tokens`` [B,
        S]; the encdec family's train and prefill also ``frames`` [B,
        enc_seq, d_model] (the stubbed conv front end's output), and a
        caller may give M-RoPE ``positions`` [B, S, 3]. ``aux`` is the f32
        scalar sum of the blocks' auxiliary losses on the tokens' device
        (the MoE load balance; 0 for the other families). In decode mode
        the logits cover the single new token, ``cache_index`` is the
        position it is decoded at and ``cache`` is updated in place.
        Only train mode records a graph. Under a sharded ``ctx``:
        ``params``, ``batch`` and ``cache`` are this rank's, and so are the
        logits (its vocab columns; ``vocab_range`` gives which)."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode != "train" and (ctx.size("seq") > 1
                                or ctx.size("embed") > 1):
            raise ValueError(
                f"sequence parallelism or fsdp in {mode}: training layouts "
                f"(the reference's rules apply them to train cells only)")
        if mode != "train":
            with torch.no_grad():
                return self._forward(params, batch, mode=mode, cache=cache,
                                     cache_index=cache_index, ctx=ctx)
        return self._forward(params, batch, mode=mode, cache=cache,
                             cache_index=cache_index, ctx=ctx)

    def vocab_range(self, ctx: ShardingCtx = NULL_CTX) -> Tuple[int, int]:
        """The vocab ids [start, stop) of this rank's logits columns."""
        v0, v1 = ctx.logits_layout().range("act_vocab",
                                           self.cfg.padded_vocab)
        return v0, max(v0, min(v1, self.cfg.vocab))

    def gather_logits(self, logits: torch.Tensor,
                      ctx: ShardingCtx = NULL_CTX) -> torch.Tensor:
        """Every rank's logits columns [..., V] all-gathered into the full
        [..., vocab] (a collective: every rank of the model axis calls
        it)."""
        ctx = ctx.logits_layout()
        if ctx.size("act_vocab") == 1:
            return logits
        v0, v1 = ctx.range("act_vocab", self.cfg.padded_vocab)
        pad = list(logits.shape)
        pad[-1] = v1 - v0 - logits.shape[-1]          # the padding dropped
        if pad[-1]:
            logits = torch.cat([logits, logits.new_zeros(pad)], -1)
        parts = ctx.all_gather(logits, "act_vocab",
                               full=self.cfg.padded_vocab)
        return torch.cat(parts, -1)[..., :self.cfg.vocab]

    def _forward(self, params, batch, *, mode, cache, cache_index, ctx):
        cfg = self.cfg
        tokens = batch["tokens"]
        s = tokens.shape[1]
        ctx = ctx.for_seq(s)
        offset = cache_index if mode == "decode" else 0
        if cfg.family == "encdec":
            x, new_cache, aux = self._encdec_stack(
                params, batch, mode=mode, cache=cache,
                cache_index=cache_index, ctx=ctx)
        else:
            x = embed(self.gathered(params, "embed", ctx)["embed"], tokens,
                      ctx, cfg.padded_vocab)
            positions = batch.get("positions")
            if positions is None:
                positions = _positions_for(cfg, s, offset, tokens.device)
            stack = self._hybrid_stack if cfg.family == "hybrid" \
                else self._scan_stack
            x, new_cache, aux = stack(params, x, mode=mode,
                                      positions=positions, cache=cache,
                                      cache_index=cache_index, ctx=ctx)

        head = self.gathered(params, "head", ctx)
        x = rmsnorm(x, head["final_norm"], cfg.norm_eps)
        # every position (the rank's under sequence parallelism) into the
        # rank's vocab columns
        x = ctx.gather_split(x, "seq", s, dim=1) if ctx.size("seq") > 1 \
            else ctx.copy(x, "act_vocab")
        ctx = ctx.logits_layout()
        table = head["embed"] if cfg.tie_embeddings else head["unembed"]
        logits = ctx.constrain(unembed(table, x),
                               ("batch", "seq", "act_vocab"),
                               (None, None, cfg.padded_vocab))
        v0, v1 = self.vocab_range(ctx)
        if v1 - v0 != logits.shape[-1]:
            logits = logits[..., :v1 - v0]     # drop the padding columns
        return logits, new_cache, aux

    # ------------------------------------------------------------ stacks
    def _remat(self, mode: str) -> bool:
        """Whether train mode checkpoints each layer body: ``cfg.remat``,
        where a graph is being recorded."""
        return mode == "train" and self.cfg.remat and torch.is_grad_enabled()

    def _scan_stack(self, params, x, *, mode, positions, cache,
                    cache_index, ctx=NULL_CTX):
        """The dense / MoE / VLM decoder blocks or the RWKV6 blocks, their
        aux losses summed. Blocks return no cache in train mode, a fresh
        per-layer cache in prefill mode (stacked here) and the updated
        cache in decode mode."""
        cfg = self.cfg
        # each block gathers its fsdp leaves itself: under remat its
        # re-forward gathers them again and the gathered copy is freed
        # after the block
        if cfg.family == "ssm":
            def block(p, h, c=None):
                return blocks.rwkv6_block(self.gathered(p, "layers", ctx), h,
                                          cfg, mode=mode, cache=c, ctx=ctx)
        else:
            def block(p, h, c=None):
                return blocks.decoder_block(self.gathered(p, "layers", ctx),
                                            h, cfg, mode=mode,
                                            positions=positions, cache=c,
                                            cache_index=cache_index, ctx=ctx)
        remat = self._remat(mode)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        fresh = []
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            if mode == "train":
                x, a = _body(remat, lambda p, h: block(p, h)[::2], lp, x)
            else:
                x, lc, a = block(lp, x, None if cache is None
                                 else _layer(cache, i))
                fresh.append(lc)
            aux = aux + a
        if mode == "prefill":
            return x, _stack(fresh), aux
        return x, cache if mode == "decode" else None, aux

    def _hybrid_stack(self, params, x, *, mode, positions, cache,
                      cache_index, ctx=NULL_CTX):
        """Zamba2: Mamba2 backbone with a single *shared* attention block
        applied after every ``shared_attn_every`` layers. The shared block
        consumes concat(hidden, initial_embedding); the trailing
        ``n_layers % shared_attn_every`` layers have no shared block after
        them. No aux loss. Under a sharded ``ctx`` the shared block is
        split as a decoder block; ``fuse`` stays whole on every rank."""
        cfg = self.cfg
        k = cfg.shared_attn_every
        napp = self.n_shared_apps()
        x0 = x
        shared_p = params["shared"]
        m_cache = cache["mamba"] if cache is not None else None
        s_cache = cache.get("shared") if cache is not None else None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def apply_shared(h, sc):
            # gathered in each application (fsdp), whose gradients sum
            sp = self.gathered(shared_p, "shared", ctx)
            z = torch.cat([h, x0], dim=-1) @ sp["fuse"]
            hh = rmsnorm(z, sp["ln1"], cfg.norm_eps)
            a, new_sc = blocks.self_attention(
                sp["attn"], hh, cfg, mode=mode, positions=positions,
                cache=sc, cache_index=cache_index, ctx=ctx)
            z = z + a
            hh = rmsnorm(z, sp["ln2"], cfg.norm_eps)
            z = z + swiglu_mlp(sp["mlp"], hh, ctx, down="ff")
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
                    self.gathered(p, "layers", ctx), h, cfg, mode=mode,
                    ctx=ctx)[0], lp, x)
                if shared_after:
                    x = _body(remat, lambda h: apply_shared(h, None)[0], x)
                continue
            x, lc, _ = blocks.mamba2_block(
                self.gathered(lp, "layers", ctx), x, cfg, mode=mode,
                cache=None if m_cache is None else _layer(m_cache, i),
                ctx=ctx)
            m_fresh.append(lc)
            if shared_after:
                x, sc = apply_shared(
                    x, None if s_cache is None else _layer(s_cache, g))
                s_fresh.append(sc)

        if mode == "train":
            return x, None, aux
        if mode == "decode":
            return x, cache, aux
        new_cache = {"mamba": _stack(m_fresh)}
        if s_fresh:
            new_cache["shared"] = _stack(s_fresh)
        return x, new_cache, aux

    def _encdec_stack(self, params, batch, *, mode, cache, cache_index,
                      ctx=NULL_CTX):
        """Whisper: in train and prefill the frames (plus sinusoidal
        positions) through the encoder stack and its final LayerNorm, then
        each decoder layer's encoder K/V (``wk``; ``wv`` plus ``bv``; the
        rank's kv heads, from the encoder's output through one ``copy``);
        in decode the K/V the prefill cached in bf16. The decoder's tokens
        (a vocab-parallel embedding) get sinusoidal positions from the
        decode offset. Returns the decoder's last hidden state, the cache
        (prefill: the layers' self-attention K/V and the encoder K/V
        ``xk`` / ``xv`` in bf16) and aux."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        hd = cfg.resolved_head_dim
        remat = self._remat(mode)
        layers = _unstack(params["layers"], cfg.n_layers)
        if mode in ("train", "prefill"):
            frames = batch["frames"]                 # [B, enc_seq, D] stub
            # under sequence parallelism the rank's frames
            ectx = ctx.for_seq(frames.shape[1])
            f0, f1 = ectx.range("seq", frames.shape[1])
            h = frames[:, f0:f1] + sinusoidal_pos(
                f1 - f0, cfg.d_model, f0, device=frames.device
            ).to(frames.dtype)[None]
            for lp in _unstack(params["enc_layers"], cfg.n_enc_layers):
                h = _body(remat, lambda p, hh: blocks.encoder_block(
                    self.gathered(p, "enc_layers", ctx), hh, cfg, ectx),
                    lp, h)
            # one copy (or gather) for every layer's K/V projection: one
            # collective of its gradient, not one per layer
            fin = self.gathered(params, "enc_final", ctx)
            enc_out = ectx.enter(layernorm(h, fin["enc_final_w"],
                                           fin["enc_final_b"],
                                           cfg.norm_eps), "kv_heads")
            enc_kv = []
            for lp in layers:
                xa = {**lp["xattn"],
                      **self.gathered(lp, "xattn_kv", ctx)["xattn"]}
                ek = enc_out @ xa["wk"]
                ev = enc_out @ xa["wv"] + xa["bv"]
                enc_kv.append(tuple(
                    ctx.constrain(t.reshape(b, t.shape[1], t.shape[2] // hd,
                                            hd),
                                  ("batch", None, "kv_heads", None),
                                  (None, None, cfg.n_kv_heads, None),
                                  blocks.kv_parts(cfg)) for t in (ek, ev)))
        else:
            enc_kv = list(zip(cache["xk"].unbind(0), cache["xv"].unbind(0)))

        offset = cache_index if mode == "decode" else 0
        x = embed(self.gathered(params, "embed", ctx)["embed"], tokens, ctx,
                  cfg.padded_vocab)
        s0, s1 = ctx.range("seq", s)       # the rank's positions
        x = x + sinusoidal_pos(s1 - s0, cfg.d_model, offset + s0,
                               device=x.device).to(x.dtype)[None]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        fresh = []
        for i, (lp, (ek, ev)) in enumerate(zip(layers, enc_kv)):
            if mode == "train":
                x, a = _body(remat, lambda p, hh, k_, v_: (
                    blocks.decoder_xattn_block(
                        self.gathered(p, "layers", ctx), hh,
                        {"k": k_, "v": v_}, cfg, mode=mode, ctx=ctx)[::2]),
                    lp, x, ek, ev)
            else:
                lc = None if cache is None else {
                    "k": cache["k"][i], "v": cache["v"][i]}
                x, lc, a = blocks.decoder_xattn_block(
                    self.gathered(lp, "layers", ctx), x, {"k": ek, "v": ev},
                    cfg, mode=mode, cache=lc,
                    cache_index=cache_index, ctx=ctx)
                fresh.append(lc)
            aux = aux + a
        if mode == "train":
            return x, None, aux
        if mode == "decode":
            return x, cache, aux
        new_cache = _stack(fresh)
        new_cache["xk"] = torch.stack([ek for ek, _ in enc_kv]).to(
            blocks.KV_CACHE_DTYPE)
        new_cache["xv"] = torch.stack([ev for _, ev in enc_kv]).to(
            blocks.KV_CACHE_DTYPE)
        return x, new_cache, aux


@functools.lru_cache(maxsize=32)
def build_model(arch: str, smoke: bool = False) -> Model:
    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    return Model(cfg)
