"""Prefill mixes: a closed loop of one client, each request a batch of
prompts of one length drawn from the seed, sent to the program's
``make_prefill_step`` when the last has returned. A request's latency
runs from its send to the device synchronisation that ends it.

Set-up warms up the cell's one shape on ``warmup_requests`` requests of
their own. The window keeps what each request returns: the served token
of every prompt (the greedy next token), and the K/V cache of the
``kv_checked_requests`` requests drawn from the seed among the first
eight; the window runs on past its seconds until those have returned.

Compared (``check``), once the window has closed, against the plain
reference on the same weights and prompts:
  token_gap  over ``checked_requests`` completed requests drawn from the
             seed: the widest gap by which a served token's reference
             logit lies below the reference's best logit at that position
  token_p90  the 90th percentile of those gaps, linear between ranks
             (the bulk of the served tokens, where the widest gap is a
             few tokens whose MoE routing a rounding has tipped)
  kv_err     over the kept requests, every layer, K and V: the worst
             ||program - reference|| / ||reference||
  kv_med     the same per token, its median over the request's tokens:
             the worst over the kept requests, layers, K and V (a few
             tokens whose MoE routing a rounding has tipped to another
             expert move ``kv_err`` and leave the median)
  kv_err_l1  ``kv_err`` at the second layer alone, whose K and V read
             the whole first block's output (attention and feed-forward
             or MoE)
A cell compares the numbers its limits file names; the others are
printed on standard error with the per-layer errors (``kv_err by
layer``, ``kv_med by layer``) and the served tokens' gaps.
"""
from __future__ import annotations

import random
import sys
import time
from typing import Dict

import torch

from portbench import port, weights

TOKENS = 1          # the prompts' generator stream (weights: 0)
FIRST = 8           # the kept caches are drawn among the first requests


class State:
    pass


def setup(ctx) -> State:
    t = ctx.traffic
    s = State()
    s.step = port.prefill_step(ctx.model)
    s.params = ctx.params
    gen = weights.generator(ctx.seed, ctx.device, TOKENS)
    s.pool = torch.randint(0, ctx.conf["vocab_size"],
                           (t["pool"] + t["warmup_requests"], t["batch"],
                            t["prompt_len"]), generator=gen,
                           device=ctx.device)
    rng = random.Random(ctx.seed)
    s.keep = sorted(rng.sample(range(FIRST), t["kv_checked_requests"]))
    for i in range(t["warmup_requests"]):
        s.step(s.params, {"tokens": s.pool[t["pool"] + i]})
    ctx.sync()
    s.served, s.kept = [], {}
    return s


def window(s: State, ctx, seconds: float, max_units: int = 0) -> dict:
    t = ctx.traffic
    lat = []
    t0 = time.perf_counter()
    while True:
        i = len(s.served)
        sent = time.perf_counter()
        tok, cache = s.step(s.params, {"tokens": s.pool[i % t["pool"]]})
        ctx.sync()
        end = time.perf_counter()
        lat.append(end - sent)
        s.served.append(tok)
        if i in s.keep:
            s.kept[i] = cache
        del cache
        if max_units and len(lat) >= max_units:
            break
        if end - t0 >= seconds and i >= max(s.keep, default=0):
            break
    return {"units": len(lat), "tokens": len(lat) * t["batch"]
            * t["prompt_len"], "window_s": end - t0, "latencies_s": lat}


def outputs(s: State, ctx) -> dict:
    return {"served": [x.cpu() for x in s.served], "kept": s.kept,
            "pool": s.pool}


def sample(ctx, done: int, keep) -> list:
    """The checked requests: ``checked_requests`` of the ``done`` drawn
    from the seed, and the kept ones."""
    rng = random.Random(ctx.seed + 1)
    n = min(ctx.traffic["checked_requests"], done)
    return sorted(set(rng.sample(range(done), n)) | set(keep))


def reference_run(ctx, pool, idx, kv_idx, precision=None):
    ref = ctx.reference
    w = ref.weights_from(ctx.draw(), ctx.dims)
    reqs = [pool[i % ctx.traffic["pool"]] for i in idx]
    logits, kv = ref.prefill(w, ctx.dims, reqs, precision or ref.F32,
                             tuple(idx.index(i) for i in kv_idx))
    return logits, {idx[j]: v for j, v in kv.items()}


def _token_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per token of [B, S, heads, head_dim]: ||got - want|| / ||want||."""
    d = (got.float() - want).flatten(2).norm(dim=-1)
    return (d / want.flatten(2).norm(dim=-1)).flatten()


def numbers(served: Dict[int, torch.Tensor], kv: dict, logits, idx,
            ref_kv: dict) -> Dict[str, float]:
    gaps = []
    for j, i in enumerate(idx):
        lg = logits[j]
        tok = served[i].to(lg.device).long()[:, None]
        gaps += (lg.max(-1).values - lg.gather(-1, tok)[:, 0]).tolist()
    err, first, per_layer, per_med = 0.0, 0.0, [], []
    for i, layers in ref_kv.items():
        for l, (k, v) in enumerate(layers):
            pairs = ((kv[i]["k"][l], k), (kv[i]["v"][l], v))
            e = max(float((got.float() - want).norm() / want.norm())
                    for got, want in pairs)
            per_layer.append(e)
            per_med.append(max(float(_token_err(got, want).median())
                               for got, want in pairs))
            err = max(err, e)
            if l == 1:
                first = max(first, e)
    gaps.sort()
    print("kv_err by layer:", " ".join(f"{e:.4g}" for e in per_layer),
          file=sys.stderr)
    print("kv_med by layer:", " ".join(f"{e:.4g}" for e in per_med),
          file=sys.stderr)
    print(f"served-token gaps: {len(gaps)}, nonzero "
          f"{sum(g > 0 for g in gaps)}, median {gaps[len(gaps) // 2]:.4g}, "
          f"top {' '.join(f'{g:.4g}' for g in gaps[-8:])}", file=sys.stderr)
    at = 0.9 * (len(gaps) - 1)
    lo = int(at)
    p90 = gaps[lo] + (gaps[min(lo + 1, len(gaps) - 1)] - gaps[lo]) * (at - lo)
    print(f"served-token gap p90 {p90:.4g}", file=sys.stderr)
    return {"token_gap": gaps[-1], "token_p90": p90, "kv_err": err,
            "kv_med": max(per_med), "kv_err_l1": first}


def check(out: dict, ctx) -> Dict[str, float]:
    kept = out["kept"]
    idx = sample(ctx, len(out["served"]), kept)
    logits, ref_kv = reference_run(ctx, out["pool"], idx, sorted(kept))
    return numbers(dict(enumerate(out["served"])), kept, logits, idx, ref_kv)


def control(ctx) -> Dict[str, Dict[str, float]]:
    """The control's readings: the reference in float8 in the program's
    place, its served tokens the argmax of its logits at the same
    positions, its K/V the program's would be, at the cell's size."""
    t = ctx.traffic
    gen = weights.generator(ctx.seed, ctx.device, TOKENS)
    pool = torch.randint(0, ctx.conf["vocab_size"],
                         (t["checked_requests"], t["batch"], t["prompt_len"]),
                         generator=gen, device=ctx.device)
    idx = list(range(t["checked_requests"]))
    kv_idx = idx[:t["kv_checked_requests"]]
    logits, ref_kv = reference_run(ctx, pool, idx, kv_idx)
    c_logits, c_kv = reference_run(ctx, pool, idx, kv_idx,
                                   ctx.reference.FP8)
    served = {i: c_logits[j].argmax(-1) for j, i in enumerate(idx)}
    kv = {i: {"k": [k for k, _ in c_kv[i]], "v": [v for _, v in c_kv[i]]}
          for i in kv_idx}
    return {"control_fp8": numbers(served, kv, logits, idx, ref_kv)}
