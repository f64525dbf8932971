"""Dry run: trace every (architecture x input-shape) cell on ``meta``
tensors and reckon, per card, its memory, operations, bytes,
collectives, the three roofline terms and model flops over counted
flops — the JAX package's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
        --shape prefill_32k [--cards N] [--model M] [--out build/dryrun] \\
        [--tag T] [--override key=value ...]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--cards N] \\
        [--model M] [--override key=value ...]

The JAX package lowers and compiles each cell against a 512-chip mesh on
forced host devices; here the step runs once on ``meta`` tensors (no
memory, no card, no CUDA module) under ``launch.step_analysis``, the LM
kernels counted by their own formulas, as rank 0 of the layout.

``--model M`` (default 1) is the model axis beside ``--cards N``: a
(data = N / M, model = M) mesh in its process-free form
(``launch.mesh.make_mesh(..., rank=0)``), with the reference's rules per
cell (``src/repro/launch/dryrun.py:84-94``: the K/V cache's sequence,
``kv_seq``, on "model" for prefill and decode when the kv heads are fewer
than the model axis, and on "data" at long_500k with the batch of 1
whole on each data rank; the port deals it round-robin,
``models/sharding.py``). At M > 1 a cell of any family
traces rank 0's step with its parameters
(``Model.abstract(ctx)``, ``local_defs``) and a ``RecordedCollectives``
in place of ``torch.distributed``: ``make_prefill_step`` /
``make_decode_step`` with its cache, or, for a train cell,
``make_manual_dp_train_step`` over the data axis beside the model axis
(its ZeRO shard over data of its slices' moments, its part of the
batch); what it issued is held against ``model_axis_plan``, and the
cell's JSON gives each collective's bytes (a split cache's: per
attention layer a prefill's two all-to-alls, a decode's all-gather of
the token's q, k and v and the log-sum-exp's three all-reduces).

The layout overrides are the reference CLI's (``LAYOUT_DEFAULTS``),
applied per cell kind as its rules apply them (``cell_rules``):
``second_matmul="col"`` on every cell (``wo`` and ``w_down`` split by
output column, their input and output all-gathered), ``seq_parallel``
on train cells (the residual's positions over the model axis; a
prefill or decode cell's rules ignore it, as the reference's do), and
``dp_mode`` ("auto", the reference's default, or "manual") on train
cells, which run as ``manual_dp`` either way: at cards > 1 an "auto"
cell's ``layout_differences["dp_mode"]`` names how GSPMD's step differs.
``fsdp`` on a train cell (a prefill or decode cell's rules ignore it)
splits each parameter's "embed" dim over "data" (ZeRO-3: gathered per
block and use, again in a remat re-forward, the f32 gradient
reduce-scattered in the backward). ``--multi-pod`` makes the mesh (pod
2, data N / 2M, model M) with the batch over ("pod", "data") for every
cell (``manual_dp`` reduce-scatters over "pod", then "data", and gathers
back over "data", then "pod"); at 512 / 16 the cell's mesh reads
"pod2x16x16", the reference's.

At M = 1 the layout over ``--cards N`` is ``train/manual_dp.py``'s:
parameters replicated, AdamW moments ZeRO-sharded N ways, the batch split
N ways; a train cell at N > 1 traces ``make_manual_dp_train_step`` with a
recorder in place of its collectives and holds what it issued against
``collective_plan``; at N = 1 it traces ``make_train_step`` (one card
issues no collective). Prefill and decode cells at M = 1 are replicas:
each card serves its part of the batch, with no collective.

Exit code 0 and a JSON artifact per cell for "ok", "skipped" (decode for
archs without a decoder, long_500k for quadratic attention, as the JAX
package's rules skip them) cells. Overrides as in the
JAX CLI: ``microbatches``, ``moe_group``, ``moe_capacity`` and any config
field; 20B+ models get 16 microbatches at train_4k. The numbers are
reckonings from counted work, not measurements.
"""
import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import SHAPE_SUITES, ShapeSuite, get_config
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.step_analysis import (CARD_BYTES, analyze_step,
                                              roofline_terms)
from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves, tree_paths
from repro_torch.models.sharding import (Part, ShardingCtx, default_rules,
                                         held_differently)
from repro_torch.optim import AdamWConfig, abstract_state
from repro_torch.train.manual_dp import (abstract_zero_opt_state,
                                         collective_plan,
                                         make_manual_dp_train_step,
                                         split_leaves)
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_train_step

# the reference CLI's layout overrides and their defaults
# (``src/repro/launch/dryrun.py:47-50``)
LAYOUT_DEFAULTS = {"fsdp": False, "seq_parallel": False,
                   "second_matmul": "row", "dp_mode": "auto"}
DP_MODES = ("auto", "manual")


def layout_options(overrides: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The layout overrides of a cell (``LAYOUT_DEFAULTS`` where not
    given); raises for a value the reference does not take."""
    got = {k: (overrides or {}).get(k, v) for k, v in LAYOUT_DEFAULTS.items()}
    if got["second_matmul"] not in ("row", "col"):
        raise ValueError(f"second_matmul {got['second_matmul']!r}: "
                         f"\"row\" or \"col\"")
    if got["dp_mode"] not in DP_MODES:
        raise ValueError(f"dp_mode {got['dp_mode']!r}: one of {DP_MODES}")
    got["fsdp"], got["seq_parallel"] = (bool(got["fsdp"]),
                                        bool(got["seq_parallel"]))
    return got


class RecordedCollectives:
    """The collectives of a traced step, as rank 0: ``manual_dp``'s
    (``torch.distributed``'s signatures, recorded in ``collective_plan``'s
    form) and the model axis's (``all_reduce`` / ``all_gather`` /
    ``all_to_all_single`` with a ``group``: a process-free mesh's
    ``AxisGroup``, recorded with its axis and size). Nothing moves (the
    tensors are ``meta``)."""

    def __init__(self, plan: Optional[List[Dict]] = None):
        self.plan = plan or []      # what the step should issue
        self.issued: List[Dict[str, Any]] = []

    def _record(self, op: str, kind: str, out, group=None) -> None:
        outs = out if isinstance(out, (list, tuple)) else [out]
        rec = {"op": op, "kind": kind, "dtype": str(outs[0].dtype),
               "result_bytes": sum(t.numel() * t.element_size()
                                   for t in outs)}
        if group is not None:
            rec.update(axis=group.axis, group=group.size)
        self.issued.append(rec)

    def reduce_scatter_tensor(self, out, inp, group=None):
        self._record("reduce_scatter_tensor", "reduce-scatter", out, group)

    def all_reduce(self, t, group=None, op=None):
        self._record("all_reduce", "all-reduce", t, group)

    def all_gather_into_tensor(self, out, inp, group=None):
        self._record("all_gather_into_tensor", "all-gather", out, group)

    def all_gather(self, out_list, t, group=None):
        self._record("all_gather", "all-gather", out_list, group)

    def all_to_all_single(self, out, inp, group=None):
        self._record("all_to_all_single", "all-to-all", out, group)


def cell_rules(cfg, suite: ShapeSuite, model_axis: int, *,
               multi_pod: bool = False, fsdp: bool = False,
               seq_parallel: bool = False, second_matmul: str = "row",
               **_) -> Dict[str, Any]:
    """The reference's rules for a cell (``src/repro/launch/dryrun.py:
    77-94``): the multi-pod batch ("pod", "data") and ``second_matmul``
    for every cell, ``fsdp`` and ``seq_parallel`` for train cells only (a
    prefill or decode cell's rules ignore them), then the K/V cache's
    sequence for serving. Takes ``layout_options``' keys (``dp_mode``
    changes no rule)."""
    if suite.kind == "train":
        rules = default_rules(multi_pod, fsdp=fsdp,
                              seq_parallel=seq_parallel,
                              second_matmul=second_matmul)
    else:
        rules = default_rules(multi_pod, second_matmul=second_matmul)
    if suite.name == "long_500k":
        # B=1 cannot shard over data; shard the KV sequence there instead
        rules["batch"] = None
        rules["kv_seq"] = "data"
    elif suite.kind in ("decode", "prefill") and cfg.n_kv_heads < model_axis:
        # kv_heads cannot absorb the model axis -> shard cache seq over it
        rules["kv_seq"] = "model"
    return rules


def _ar(n_bytes: int, axis: str, size: int) -> Dict[str, Any]:
    """One f32 all-reduce of ``n_bytes`` in the plan's form."""
    return {"op": "all_reduce", "kind": "all-reduce",
            "dtype": "torch.float32", "result_bytes": n_bytes, "axis": axis,
            "group": size}


def _ag(n_bytes: int, dtype: str, size: int) -> Dict[str, Any]:
    """One all-gather over "model" with ``n_bytes`` of results."""
    return {"op": "all_gather", "kind": "all-gather", "dtype": dtype,
            "result_bytes": n_bytes, "axis": "model", "group": size}


def kv_seq_collectives(model: Model, b: int, s: int, ctx: ShardingCtx,
                       mode: str) -> List[Dict[str, Any]]:
    """Rank 0's collectives of one self-attention layer's cache where
    ``ctx`` splits its sequence ("kv_seq"), on ``b`` x ``s`` tokens in
    ``mode`` (none in training, or where the sequence is whole): a
    prefill's all-to-all of K, then of V, over the heads' axis (none on
    "data", where every rank keeps its own positions); a decode's
    all-gather of the token's q, k and v packed (where the sequence
    shares the heads' axis, in the activations' dtype), then the
    log-sum-exp's three f32 all-reduces over the kv_seq axis (the row
    maxima, the sums of exponentials, the output)."""
    from repro_torch.models import blocks
    m = ctx.size("kv_seq")
    if mode == "train" or m == 1:
        return []
    cfg = model.cfg
    axis = ctx.mesh_axes("kv_seq")[0]
    shared = ctx.shares_axis("kv_seq", "heads")
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if mode == "prefill":
        if not shared:
            return []
        width = max(len(o) for o in blocks.kv_owners(cfg, ctx))
        a2a = {"op": "all_to_all_single", "kind": "all-to-all",
               "dtype": str(blocks.KV_CACHE_DTYPE),
               "result_bytes": m * b * -(-s // m) * width * hd
               * blocks.KV_CACHE_DTYPE.itemsize, "axis": axis, "group": m}
        return [a2a, a2a]
    out = []
    if shared:
        dtype = model.defs["embed"].dtype
        parts = (Part(hq * hd, hq),) + (Part(hkv * hd, hkv, kv_of=hq),) * 2
        width = max(len(ctx.indices("heads", (hq + 2 * hkv) * hd, parts,
                                    at=i)) for i in range(m))
        out.append(_ag(m * b * width * dtype.itemsize, str(dtype), m))
    else:
        hq = len(ctx.indices("heads", hq))
    return out + [_ar(4 * b * hq, axis, m)] * 2 + [_ar(4 * b * hq * hd,
                                                        axis, m)]


def _rs(n_bytes: int, size: int) -> Dict[str, Any]:
    """One f32 reduce-scatter over "model" with ``n_bytes`` of results."""
    return {"op": "reduce_scatter_tensor", "kind": "reduce-scatter",
            "dtype": "torch.float32", "result_bytes": n_bytes,
            "axis": "model", "group": size}


def param_gathers(ctx: ShardingCtx, defs) -> Tuple[list, list]:
    """(the forward's, the backward's) collectives of
    ``ShardingCtx.gather_params`` over a piece's ParamDefs under fsdp:
    per ``param_packs`` one all-gather in the leaves' dtype, and in the
    backward one f32 reduce-scatter, the last pack's first (none where
    the layout splits no "embed")."""
    packs = ctx.param_packs(defs)
    axis = "+".join(ctx.mesh_axes("embed"))
    ag = [{"op": "all_gather_into_tensor", "kind": "all-gather",
           "dtype": str(p.dtype), "result_bytes": p.n * max(p.sizes)
           * p.dtype.itemsize, "axis": axis, "group": p.n} for p in packs]
    rs = [{"op": "reduce_scatter_tensor", "kind": "reduce-scatter",
           "dtype": "torch.float32", "result_bytes": 4 * max(p.sizes),
           "axis": axis, "group": p.n} for p in reversed(packs)]
    return ag, rs


def layer_bodies(model: Model, b: int, s: int, ctx: ShardingCtx,
                 mode: str = "train") -> List[Tuple[list, int, list, int]]:
    """Rank 0's collectives of each piece of a step on ``b`` x ``s``
    tokens under ``ctx`` in ``mode``, in forward order: the embedding's,
    and each layer body (one decoder block, one Mamba2 layer, one
    application of zamba2's shared block, one RWKV6 block, one whisper
    encoder or decoder layer), each as (the forward's, how many of them
    a remat re-forward issues again, the backward's, how many of those
    come before the re-forward).

    A body is a chain of units (an attention, an MLP or MoE, a Mamba2
    mixer), each: its input entering split computation (``enter``: a
    ``copy``, whose all-reduce is the backward's, or under sequence
    parallelism the positions' all-gather, whose reduce-scatter is; or
    ``whole``: the all-gather alone), what it issues inside (a split
    cache's collectives, ``kv_seq_collectives``; Mamba2's gated norm; the
    MoE's load balance over a split batch), then its output: a
    row-parallel sum (an f32 all-reduce, identity backward; or a
    reduce-scatter, whose all-gather is the backward's) or, for a pair
    under ``second_matmul="col"``, the input's all-gather (its
    reduce-scatter the backward's) and the output columns' (slice
    backward). The backward runs the units from the last, each its
    output's then its input's. A re-forward (``torch.utils.checkpoint``,
    non-reentrant) starts at the first saved tensor the backward unpacks
    (after the closing reduce-scatter's all-gather, which saves none) and
    stops once it has recomputed the last one, so it skips each body's
    closing sum or output gather (RWKV6's body ends on the product of its
    gathered gate and its channel mix's sum, both saved: it reissues
    every one). Whisper's encoder layers (at ``enc_seq`` frames) come
    first outside decode, then its output entering the decoder's K/V
    projections.

    Under fsdp each piece gathers its parameters first (``param_gathers``
    of its ``Model.pieces``: re-issued by a remat re-forward) and its
    backward ends on their reduce-scatters; whisper's cross-attention
    ``wk`` / ``wv`` are gathered layer by layer before the decoder, in a
    piece of their own."""
    cfg, m = model.cfg, ctx.size("heads")
    d, dtype = cfg.d_model, model.defs["embed"].dtype
    item = dtype.itemsize
    sp, col = ctx.size("seq") > 1, ctx.size("embed_out") > 1
    kv = kv_seq_collectives(model, b, s, ctx, mode)

    def ar(n, axis="model", size=m):
        return _ar(n, axis, size)

    def piece(axis, n, parts=None):
        """The largest part a rank holds of ``n`` units over ``axis``."""
        return max(len(ctx.indices(axis, n, parts, at=i))
                   for i in range(ctx.size(axis)))

    def seq_ag(n, dt=dtype):
        return _ag(m * piece("seq", n) * b * d * dt.itemsize, str(dt), m)

    def seq_rs(n):
        return _rs(4 * b * piece("seq", n) * d, m)

    def enter(n):
        """(forward, backward) of a block's input entering split
        computation over ``n`` positions."""
        return ([seq_ag(n)], [seq_rs(n)]) if sp else ([], [ar(4 * b * n
                                                                * d)])

    def whole(n):
        return [seq_ag(n)] if sp else []

    def out(n, dt=dtype):
        """(forward, backward before the re-forward) of a row-parallel
        output over ``n`` positions (``dt``: the dtype it is summed
        from)."""
        return ([seq_rs(n)], [seq_ag(n, dt=dt)]) if sp else (
            [ar(4 * b * n * d)], [])

    def pair(n, axis, units, parts=None):
        """(forward, backward before the re-forward, after it) of a pair's
        second matmul over ``n`` positions, its input split over ``axis``
        (``units`` wide, by ``parts``)."""
        if not col:
            return (*out(n), [])
        wi = piece(axis, units, parts)
        return ([_ag(m * wi * b * n * item, str(dtype), m),
                 _ag(m * piece("embed_out", d) * b * n * item, str(dtype),
                     m)], [seq_ag(n)] if sp else [], [_rs(4 * b * n * wi, m)])

    hd = cfg.resolved_head_dim
    heads = (Part(cfg.n_heads * hd, cfg.n_heads),)

    def attn_unit(n, cache=()):
        e_f, e_b = enter(n)
        p_f, p_pre, p_post = pair(n, "heads", cfg.n_heads * hd, heads)
        return e_f + list(cache) + p_f, p_pre, p_post + e_b

    def mlp_unit(n, second=True):
        e_f, e_b = enter(n)
        if second:
            p_f, p_pre, p_post = pair(n, "ff", cfg.d_ff)
        else:                          # zamba2's shared MLP: ("ff", "embed")
            (p_f, p_pre), p_post = out(n), []
        return e_f + p_f, p_pre, p_post + e_b

    def chain(*units):
        fwd = [c for f, _, _ in units for c in f]
        bwd = [c for _, pre, post in reversed(units) for c in pre + post]
        return fwd, len(fwd) - 1, bwd, len(units[-1][1])

    def gathering(body, piece, remat=True):
        """``body`` with its piece's fsdp gathers first (re-issued by a
        remat re-forward where ``remat``) and their reduce-scatters
        last."""
        ag, rs = param_gathers(ctx, model.pieces[piece])
        fwd, rerun, bwd, pre = body
        return ag + fwd, rerun + (len(ag) if remat else 0), bwd + rs, pre

    emb_f, emb_b = out(s)
    bodies = [gathering((emb_f, 0, emb_b, len(emb_b)), "embed",
                        remat=False)]                   # the embedding's
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        st = cfg.ssm.state_size
        o_f, o_pre = out(s)
        mamba = gathering(chain((whole(s) + [ar(4 * b * s)] + o_f, o_pre,
                                 [ar(4 * b * s), ar(4 * b * s * 2 * st),
                                  ar(4 * b * s * d)])), "layers")
        shared = gathering(chain(attn_unit(s, kv),
                                 mlp_unit(s, second=False)), "shared")
        for i in range(cfg.n_layers):
            bodies.append(mamba)
            if (i + 1) % k == 0 and (i + 1) // k <= model.n_shared_apps():
                bodies.append(shared)
        return bodies
    if cfg.family == "ssm":
        from repro_torch.models.blocks import RWKV_LORA, rwkv6_heads
        cols = piece("heads", cfg.d_model, rwkv6_heads(cfg))
        gate = _ag(m * cols * b * s * item, str(dtype), m)
        (tm_f, tm_pre), (cm_f, cm_pre) = out(s), out(s)
        fwd = whole(s) + tm_f + whole(s) + cm_f + [gate]
        bwd = (whole(s) + [ar(4 * b * s * d)] + cm_pre + [ar(4 * b * s * d)]
               + tm_pre + [ar(4 * b * s * RWKV_LORA), ar(4 * 4 * b * s * d)])
        return bodies + [gathering((fwd, len(fwd), bwd, 0),
                                   "layers")] * cfg.n_layers
    if cfg.family == "encdec":
        layer = gathering(chain(attn_unit(s, kv), attn_unit(s),
                                mlp_unit(s)), "layers")
        if mode == "decode":
            return bodies + [layer] * cfg.n_layers
        n = cfg.enc_seq
        enc = gathering(chain(attn_unit(n), mlp_unit(n)), "enc_layers")
        o_f, o_b = enter(n)
        xg, xr = param_gathers(ctx, model.pieces["xattn_kv"])
        xkv = (xg * cfg.n_layers, 0, xr * cfg.n_layers, 0)
        return ([enc] * cfg.n_enc_layers
                + [gathering((o_f, 0, o_b, 0), "enc_final", remat=False),
                   xkv] + bodies + [layer] * cfg.n_layers)
    data = ctx.size("batch")
    for _ in range(cfg.n_layers):
        if cfg.moe is not None:
            o_f, o_pre = out(s, torch.float32)
            lb = [ar(2 * 4 * cfg.moe.padded_experts,
                     "+".join(ctx.mesh_axes("batch")), data)] \
                if data > 1 else []
            ffn = (whole(s) + lb + o_f, o_pre,
                   [ar(4 * b * s * cfg.moe.top_k), ar(4 * b * s * d)])
        else:
            ffn = mlp_unit(s)
        bodies.append(gathering(chain(attn_unit(s, kv), ffn), "layers"))
    return bodies


def model_axis_plan(model: Model, suite: ShapeSuite, batch: int,
                    ctx: ShardingCtx) -> List[Dict[str, Any]]:
    """The collectives rank 0 issues in one step of ``batch`` sequences
    (its part of the batch) under ``ctx``, in order, reckoned from the
    config (``layer_bodies``); none over a mesh axis of one rank
    (``issued``). Sums and reduce-scatters in f32, gathers in the
    activations' dtype.

    Serving: the embedding's all-reduce; per decoder block the
    attention's (after its split cache's, ``kv_seq_collectives``) and
    the MLP's (MoE: the load balance's over a split batch, then the
    experts'); per Mamba2 layer its gated norm's and its ``out_proj``'s,
    and the shared block's two after each group; per RWKV6 block the time
    mix's, the channel mix's and its gate's all-gather; whisper's two per
    encoder layer (prefill), then per decoder layer three
    (self-attention, cross-attention, MLP); then the greedy token's
    all-gather. Under ``second_matmul="col"`` each pair's all-reduce is
    two all-gathers (its input's and its output columns').

    Training (``manual_dp`` over the data axis, ``batch`` split into the
    config's microbatches): per microbatch the forward's (as serving's,
    the load balance the microbatch's own; under sequence parallelism
    each block's gathers and reduce-scatters, and the final norm's output
    gathered), the cross-entropy's three (max, sum of exponentials, gold
    logit), then the backward's: the logits' input's, and per piece from
    the last, its remat re-forward's and its Functions' (``layer_bodies``);
    then once per step the sum of the leaves several ranks hold a part of
    (each such kv head's, full along its kv dim, RWKV6's vectors held
    whole, and under sequence parallelism the leaves applied position by
    position) and ``manual_dp``'s reduce-scatter, all-reduce and
    all-gather (``collective_plan``)."""
    cfg = model.cfg
    m = ctx.size("heads")
    if suite.kind != "train":
        s = 1 if suite.kind == "decode" else suite.seq_len
        plan = []
        for fwd, _, _, _ in layer_bodies(model, batch, s, ctx, suite.kind):
            plan += fwd
        plan.append({"op": "all_gather", "kind": "all-gather",
                     "dtype": "torch.float32",
                     "result_bytes": m * batch * 2 * 4, "axis": "model",
                     "group": m})
        return issued(plan)
    n_mb = max(cfg.microbatches, 1)
    b, s = batch // n_mb, suite.seq_len
    local = ctx.batch_local()
    bodies = layer_bodies(model, b, s, local)
    tok = _ar(4 * b * s, "model", m)
    head_ag, head_rs = param_gathers(local, model.pieces["head"])
    step = []
    for fwd, _, _, _ in bodies:
        step += fwd
    if ctx.size("seq") > 1:      # the final norm's positions gathered
        piece = -(-s // m)
        item = model.defs["embed"].dtype.itemsize
        step += head_ag + [_ag(m * piece * b * cfg.d_model * item,
                               str(model.defs["embed"].dtype), m), tok, tok,
                           tok, _rs(4 * b * piece * cfg.d_model, m)]
    else:
        step += head_ag + [tok, tok, tok, _ar(4 * b * s * cfg.d_model,
                                              "model", m)]
    step += head_rs
    for fwd, rerun, bwd, pre in reversed(bodies):
        step += bwd[:pre] + (fwd[:rerun] if cfg.remat else []) + bwd[pre:]
    plan = step * n_mb
    defs = tree_leaves(model.defs)
    shared = local.shared_leaves(defs)
    if shared:
        plan.append(_ar(4 * sum(math.prod(local.shared_shape(defs[i], dim,
                                                             mine))
                                for i, dim, mine in shared), "model", m))
    sizes = dict(zip(ctx.mesh.axis_names, ctx.mesh.shape))
    return issued(plan) + collective_plan(
        model.abstract(ctx), sizes["data"], m, sizes.get("pod", 1),
        split_leaves(model, ctx))


def issued(plan: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """``plan`` without its collectives over a mesh axis of one rank,
    which ``ShardingCtx`` does not issue (``manual_dp``'s, which it issues
    over any data axis, are ``collective_plan``'s)."""
    return [c for c in plan if c["group"] > 1]


def model_param_count(abstract_params) -> int:
    return int(sum(x.numel() for x in tree_leaves(abstract_params)))


def dp_mode_difference(cfg, data: int, fsdp: bool = False
                       ) -> Dict[str, Any]:
    """How the port's step for the reference's default ``dp_mode="auto"``
    (GSPMD's ZeRO step, ``src/repro/launch/dryrun.py:121-139``) differs
    from it over the data axes' ``data`` ranks: it is ``manual_dp`` (under
    ``fsdp`` with its ZeRO-3 leaves)."""
    n_mb = max(cfg.microbatches, 1)
    out = {"reason": (
        f"dp_mode \"auto\" runs as manual_dp: the gradient crosses the "
        f"data axis once per step (one reduce-scatter of the f32 bucket), "
        f"not once per microbatch ({n_mb} per step, as GSPMD reduces each "
        f"microbatch's gradient to the moments' specs); the AdamW moments "
        f"are ZeRO-sharded over the {data} data ranks as ranges of the "
        f"flat gradient bucket, not by \"embed\" -> \"data\" specs"),
        "gradient_crossings_per_step": 1,
        "reference_gradient_crossings_per_step": n_mb}
    if fsdp:
        out["reason"] += (
            "; fsdp (ZeRO-3): each piece (a block, an application of "
            "zamba2's shared block, the embedding, the final norm and "
            "unembedding) all-gathers its \"embed\"-split leaves once per "
            "use, in one collective per dtype, again in its remat "
            "re-forward, and reduce-scatters their f32 gradient in its "
            "backward into the step's f32 shard accumulator (GSPMD gathers "
            "each parameter where its partitioner places the gather and "
            "reduces its gradient to the shard per microbatch); the shard "
            "leaves' moments are the rank's \"data\" shard (on a multi-pod "
            "mesh its piece over \"pod\", as the reference's moments on "
            "(\"pod\", \"data\")) as a flat range, the other leaves' the "
            "bucket's ranges")
        out["gradient_crossings_per_step"] = n_mb
    return out


def _config(arch: str, shape: str, overrides: Optional[Dict[str, Any]]):
    overrides = dict(overrides) if overrides else {}
    for key in LAYOUT_DEFAULTS:
        overrides.pop(key, None)
    moe_group = overrides.pop("moe_group", None)
    moe_cap = overrides.pop("moe_capacity", None)
    cfg = get_config(arch)
    if cfg.moe is not None and (moe_group or moe_cap):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe,
            group_size=moe_group or cfg.moe.group_size,
            capacity_factor=moe_cap or cfg.moe.capacity_factor))
    if cfg.param_count() > 2e10 and shape == "train_4k" \
            and "microbatches" not in overrides:
        # 20B+ models: halve per-microbatch activation footprint
        overrides["microbatches"] = 16
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def build_cell(arch: str, shape: str, *, cards: int = 1, model: int = 1,
               overrides: Optional[Dict[str, Any]] = None,
               suite: Optional[ShapeSuite] = None, multi_pod: bool = False):
    """Returns (step_fn, abstract_args, meta, comm) for one dry-run cell;
    ``suite`` replaces ``SHAPE_SUITES[shape]`` (a cell at another batch or
    length). ``comm`` records a train step's collectives at cards > 1 and
    a serving step's at model > 1 (None otherwise), and holds the step's
    ``plan``; step_fn is None for a skipped or not-ported cell. The
    layout overrides (``LAYOUT_DEFAULTS``) apply per cell kind, as the
    reference's (``cell_rules``); a train cell's ``dp_mode`` ("auto", the
    reference's default, or "manual") runs as ``manual_dp`` either way,
    and at cards > 1 its result names how "auto" differs
    (``dp_mode_difference``)."""
    layout = layout_options(overrides)
    cfg = _config(arch, shape, overrides)
    suite = suite or SHAPE_SUITES[shape]

    # ---- applicability (the JAX package's rules, then the port's)
    head = {"arch": arch, "shape": suite.name, "cards": cards,
            "model_axis": model}
    if suite.kind == "decode" and not cfg.supports_decode:
        return None, None, {**head, "status": "skipped",
                            "reason": "no decode path"}, None
    if suite.name == "long_500k" and not cfg.subquadratic:
        return None, None, {**head, "status": "skipped",
                            "reason": "quadratic attention at 500k"}, None
    if model < 1 or cards % (model * (2 if multi_pod else 1)):
        raise ValueError(f"a model axis of {model}"
                         + (" and a pod axis of 2" if multi_pod else "")
                         + f" do not divide {cards} cards")
    if suite.kind == "train":
        head["dp_mode"] = layout["dp_mode"]
    fsdp = layout["fsdp"] and suite.kind == "train" and cards > model
    if model > 1 or multi_pod or fsdp:
        return model_axis_cell(cfg, suite, cards, model, head, layout,
                               multi_pod)
    if cards < 1 or suite.global_batch % cards:
        raise ValueError(f"batch {suite.global_batch} does not split over "
                         f"{cards} cards")
    per_card = suite.global_batch // cards

    model = Model(cfg)
    params = model.abstract()
    meta = {
        **head, "status": "ok", "batch_per_card": per_card,
        "params": model_param_count(params),
        "active_params": cfg.active_param_count(),
        "kind": suite.kind,
    }
    comm = None
    if suite.kind == "train":
        batch, _ = S.train_batch_specs(cfg, suite, per_card)
        meta["tokens_per_step"] = suite.global_batch * suite.seq_len
        meta["microbatches"] = cfg.microbatches
        if cards == 1:
            meta["layout"] = "one card: make_train_step"
            fn = make_train_step(model, AdamWConfig())
            return fn, (params, abstract_state(params), batch), meta, None
        comm = RecordedCollectives(collective_plan(params, cards))
        meta["layout"] = (f"manual_dp: parameters replicated, moments "
                          f"ZeRO-sharded over {cards} cards")
        if layout["dp_mode"] == "auto":
            meta["layout_differences"] = {
                "dp_mode": dp_mode_difference(cfg, cards)}
        ctx = ShardingCtx(make_mesh((cards, 1), ("data", "model"), rank=0),
                          default_rules(), comm=comm)
        fn = make_manual_dp_train_step(model, AdamWConfig(), comm=comm,
                                       ctx=ctx)
        opt = abstract_zero_opt_state(params, cards)
        return fn, (params, opt, batch), meta, comm

    meta["layout"] = f"{cards} replica(s), the batch split over them"
    if suite.kind == "prefill":
        batch, _ = S.train_batch_specs(cfg, suite, per_card)
        batch.pop("targets")
        meta["tokens_per_step"] = suite.global_batch * suite.seq_len
        return make_prefill_step(model), (params, batch), meta, None

    _, cache, token, index, _ = S.decode_inputs(model, suite, per_card)
    meta["tokens_per_step"] = suite.global_batch
    return make_decode_step(model), (params, cache, token, index), meta, None


def model_axis_cell(cfg, suite: ShapeSuite, cards: int, m: int,
                    head: Dict[str, Any],
                    layout: Optional[Dict[str, Any]] = None,
                    multi_pod: bool = False):
    """``build_cell``'s result for a cell of ``cfg`` on a (cards / m, m)
    mesh (``multi_pod``: a (2, cards / 2m, m) mesh over ("pod", "data",
    "model")), as rank 0, under the ``layout`` overrides
    (``layout_options``; default: the reference's defaults); ``head``
    starts its meta. A train cell traces rank 0's
    ``make_manual_dp_train_step`` (its slices, its ZeRO shard over the
    data axes of their moments, its part of the batch)."""
    layout = layout or layout_options(None)
    pod = 2 if multi_pod else 1
    data = cards // (m * pod)
    comm = RecordedCollectives()
    shape, axes = ((pod, data, m), ("pod", "data", "model")) if multi_pod \
        else ((data, m), ("data", "model"))
    ctx = ShardingCtx(make_mesh(shape, axes, rank=0),
                      cell_rules(cfg, suite, m, multi_pod=multi_pod,
                                 **layout), comm=comm)
    split = ctx.size("batch")        # 1 where the rules hold the batch whole
    if suite.global_batch % split:
        raise ValueError(f"batch {suite.global_batch} does not split over "
                         f"data axes of {split}")
    model = Model(cfg)
    params = model.abstract(ctx)
    per_card = suite.global_batch // split
    kv_seq = ctx.mesh_axes("kv_seq")
    meta = {
        **head, "status": "ok", "batch_per_card": per_card,
        "mesh": ("pod2x" if multi_pod else "") + f"{data}x{m}",
        "params": model_param_count(model.abstract()),
        "params_per_card": model_param_count(params),
        "active_params": cfg.active_param_count(),
        "kind": suite.kind,
        "layout": ((f"pod {pod} x " if multi_pod else "")
                   + f"data {data} x model {m}: heads, kv heads (as the q "
                   f"heads read them), MLP columns, experts and vocab "
                   f"over the model axis; the batch "
                   + (("over (pod, data)" if multi_pod else "over data")
                      if split > 1 else "whole on each data rank")
                   + ("; fsdp (ZeRO-3): each leaf's \"embed\" dim over "
                      "data, gathered per block and use"
                      if ctx.size("embed") > 1 else "")
                   + (f"; the K/V cache's sequence round-robin over "
                      f"{kv_seq[0]} (its kv heads whole where that is the "
                      f"model axis)" if kv_seq else "")
                   + ("; second_matmul col: wo's and w_down's output "
                      "columns over the model axis, their input and "
                      "output all-gathered" if ctx.size("embed_out") > 1
                      else "")
                   + ("; seq_parallel: between blocks the residual's "
                      "positions over the model axis (a gather into each "
                      "block's column-parallel matmuls, a reduce-scatter "
                      "out of its row-parallel ones), the logits "
                      "vocab-parallel after a gather of the positions (the "
                      "reference holds their vocab whole)"
                      if ctx.size("seq") > 1 else "")),
        "layout_differences": layout_differences(model, suite, ctx),
    }
    if suite.kind == "train" and layout["dp_mode"] == "auto" and \
            data * pod > 1:
        meta["layout_differences"]["dp_mode"] = dp_mode_difference(
            cfg, data * pod, ctx.size("embed") > 1)
    if ctx.size("seq") > 1:
        meta["layout_differences"]["logits"] = logits_difference(
            model, per_card // max(cfg.microbatches, 1), suite.seq_len)
    comm.plan = model_axis_plan(model, suite, per_card, ctx)
    if suite.kind == "train":
        batch, _ = S.train_batch_specs(cfg, suite, per_card)
        meta["tokens_per_step"] = suite.global_batch * suite.seq_len
        meta["microbatches"] = cfg.microbatches
        meta["layout"] = ((f"manual_dp over (pod {pod}, data {data})"
                           if multi_pod else f"manual_dp over data {data}")
                          + f", moments ZeRO-sharded over it, beside model "
                          f"{m}: " + meta["layout"].split(": ", 1)[1])
        fn = make_manual_dp_train_step(model, AdamWConfig(), comm=comm,
                                       ctx=ctx)
        opt = abstract_zero_opt_state(params, data, pod,
                                      split_leaves(model, ctx))
        return fn, (params, opt, batch), meta, comm
    if suite.kind == "prefill":
        batch, _ = S.train_batch_specs(cfg, suite, per_card)
        batch.pop("targets")
        meta["tokens_per_step"] = suite.global_batch * suite.seq_len
        return make_prefill_step(model, ctx), (params, batch), meta, comm
    _, cache, token, index, _ = S.decode_inputs(model, suite, per_card,
                                                ctx=ctx)
    meta["tokens_per_step"] = suite.global_batch
    return (make_decode_step(model, ctx), (params, cache, token, index),
            meta, comm)


def logits_difference(model: Model, b: int, s: int) -> Dict[str, Any]:
    """How the port's logits under sequence parallelism differ from the
    reference's rules (``act_vocab`` -> None: the logits' vocab whole), on
    a microbatch of ``b`` x ``s`` tokens: the port gathers the normed
    positions (``bytes``) and keeps the vocab-parallel unembedding and
    cross-entropy; the reference's layout gathers the vocab-split table
    (``reference_bytes``) each step."""
    cfg = model.cfg
    item = model.defs["embed"].dtype.itemsize
    return {"reason": (
        "the logits stay vocab-parallel: the final norm's output is "
        "gathered over the sequence and multiplied by the rank's vocab "
        "rows (the reference's seq_parallel rules hold the logits' vocab "
        "whole, which gathers the vocab-split table)"),
        "bytes": b * s * cfg.d_model * item,
        "reference_bytes": cfg.padded_vocab * cfg.d_model * item}


def layout_differences(model: Model, suite: ShapeSuite,
                       ctx: ShardingCtx) -> Dict[str, Any]:
    """Every parameter and cache leaf whose bytes on a card differ from
    the reference's layout (``sharding.held_differently``): its reason
    and both byte counts."""
    b = suite.global_batch
    trees = {"params": model.defs}
    if suite.kind == "decode":
        trees["cache"] = model.cache_defs(b, suite.seq_len)
    out = {}
    for name, defs in trees.items():
        for path, d in tree_paths(defs):
            got = held_differently(d, ctx)
            if got is not None:
                out[f"{name}/{path}"] = got
    return out


def model_flops(meta: Dict[str, Any]) -> int:
    """6·N_active·D for a train cell, 2·N_active·D for inference."""
    mult = 6 if meta["kind"] == "train" else 2
    return mult * meta["active_params"] * meta["tokens_per_step"]


def analyze_cell(fn, args, meta: Dict[str, Any], comm=None
                 ) -> Dict[str, Any]:
    """Trace one built cell under ``analyze_step`` and reckon its
    memory, cost, collectives and roofline (the keys of the JAX
    package's result)."""
    n = meta["cards"]
    plan = [] if comm is None else comm.plan
    t0 = time.time()
    _, a = analyze_step(fn, *args, collectives=plan, world=n)
    result = {"trace_s": round(time.time() - t0, 2)}
    if comm is not None and comm.issued != plan:
        raise RuntimeError(f"the step issued {comm.issued}, its plan is "
                           f"{plan}")
    colls = a["collectives"]
    result["memory"] = a["memory"]
    result["fits"] = a["memory"]["peak_estimate_bytes"] <= CARD_BYTES
    result["cost"] = {
        "flops_per_device": a["flops"], "bytes_per_device": a["bytes"],
        "ops": a["ops"],
        "flops_outside_kernels": a["flops_outside_kernels"],
        "bytes_outside_kernels": a["bytes_outside_kernels"]}
    result["kernels"] = a["kernels"]
    result["collectives"] = colls
    wire = sum(c["wire_bytes"] for c in colls.values())
    result["collective_wire_bytes_per_device"] = wire
    result["collective_result_bytes_per_device"] = sum(
        c["result_bytes"] for c in colls.values())
    result["roofline"] = roofline_terms(
        global_flops=a["flops"] * n, device_bytes=a["bytes"],
        collective_wire_bytes=wire, n_chips=n)
    result["model_flops"] = model_flops(meta)
    total = a["flops"] * n
    result["model_flops_ratio"] = (result["model_flops"] / total
                                   if total else None)
    return result


def run_cell(arch: str, shape: str, *, cards: int = 1, model: int = 1,
             out_dir: str = "build/dryrun", tag: str = "",
             overrides: Optional[Dict[str, Any]] = None,
             suite: Optional[ShapeSuite] = None,
             multi_pod: bool = False) -> Dict[str, Any]:
    t0 = time.time()
    fn, args, meta, comm = build_cell(arch, shape, cards=cards, model=model,
                                      overrides=overrides, suite=suite,
                                      multi_pod=multi_pod)
    result = dict(meta)
    if meta["status"] == "ok":
        try:
            result.update(analyze_cell(fn, args, meta, comm))
        except Exception as e:
            result["status"] = "error"
            result["error"] = f"{type(e).__name__}: {e}"
            result["traceback"] = traceback.format_exc()[-4000:]
        result["total_s"] = round(time.time() - t0, 2)
    if out_dir:
        _write(out_dir, arch, shape, cards, result, tag, model, multi_pod)
    return result


def _write(out_dir, arch, shape, cards, result, tag="", model=1,
           multi_pod=False):
    os.makedirs(out_dir, exist_ok=True)
    safe_arch = arch.replace(".", "p").replace("/", "_")
    suffix = ((f"_model{model}" if model > 1 else "")
              + ("_multipod" if multi_pod else "")
              + (f"_{tag}" if tag else ""))
    path = os.path.join(out_dir,
                        f"{safe_arch}__{shape}__{cards}card{suffix}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)


def brief(res: Dict[str, Any]) -> Dict[str, Any]:
    """The one-line summary of a cell the CLI prints last."""
    out = {k: res.get(k) for k in ("arch", "shape", "cards", "model_axis",
                                   "status", "trace_s", "fits",
                                   "model_flops_ratio", "reason", "error")}
    if "roofline" in res:
        out.update(res["roofline"])
    if "memory" in res:
        out["peak_bytes_per_card"] = res["memory"]["peak_estimate_bytes"]
    return out


def matrix_line(res: Dict[str, Any]) -> str:
    """One cell of the matrix: status, peak GiB, fits, dominant term,
    bound seconds, collective bytes."""
    head = f"{res['arch']:>16} {res['shape']:>12}: {res['status']}"
    if "roofline" not in res:
        return head + (f" ({res.get('reason') or res.get('error')})")
    roof = res["roofline"]
    return (f"{head}, peak {res['memory']['peak_estimate_bytes'] / 2**30:.2f}"
            f" GiB, fits {res['fits']}, {roof['dominant']}-bound, bound "
            f"{roof['bound_s']:.6g} s, collectives "
            f"{res['collective_result_bytes_per_device'] / 2**20:.2f} MiB "
            f"(wire {res['collective_wire_bytes_per_device'] / 2**20:.2f} "
            f"MiB), model/counted flops {res['model_flops_ratio']:.4f}, "
            f"traced in {res['trace_s']} s")


STATUSES_OK = ("ok", "skipped")


def run_matrix(cards: int = 1, out_dir: str = "build/dryrun",
               model: int = 1, overrides: Optional[Dict[str, Any]] = None,
               tag: str = "", multi_pod: bool = False) -> bool:
    """Every arch x ``shape_cells()`` cell under ``overrides`` (each
    cell's kind takes those of the reference's rules), one line each,
    then the statuses counted and the host seconds the matrix took. True
    when every cell is ok or skipped."""
    from repro_torch.configs import list_archs
    t0 = time.time()
    ok, statuses = True, {}
    for arch in list_archs():
        for shape in SHAPE_SUITES:
            res = run_cell(arch, shape, cards=cards, model=model,
                           out_dir=out_dir, tag=tag, overrides=overrides,
                           multi_pod=multi_pod)
            ok &= res["status"] in STATUSES_OK
            statuses[res["status"]] = statuses.get(res["status"], 0) + 1
            print(matrix_line(res), flush=True)
    print(f"matrix at {cards} card(s), model axis {model}"
          + (", multi-pod" if multi_pod else "")
          + (f", overrides {json.dumps(overrides)}" if overrides else "")
          + f": {json.dumps(statuses)}, {time.time() - t0:.1f} s of host "
          f"time")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape cell (the matrix)")
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPE_SUITES))
    ap.add_argument("--cards", type=int, default=1)
    ap.add_argument("--model", type=int, default=1,
                    help="the model axis (data = cards / model)")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", action="append", default=[],
                    help="override key=JSON value: a cfg field, or a layout "
                         "(fsdp=true, seq_parallel=true, "
                         "second_matmul='\"col\"', dp_mode='\"manual\"')")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's (pod, data, model) mesh")
    args = ap.parse_args(argv)
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        overrides[k] = json.loads(v)
    if args.all:
        raise SystemExit(0 if run_matrix(args.cards, args.out, args.model,
                                         overrides or None, args.tag,
                                         args.multi_pod) else 1)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    res = run_cell(args.arch, args.shape, cards=args.cards, model=args.model,
                   out_dir=args.out, tag=args.tag,
                   overrides=overrides or None, multi_pod=args.multi_pod)
    print(json.dumps(brief(res)))
    raise SystemExit(0 if res["status"] in STATUSES_OK else 1)


if __name__ == "__main__":
    main()
