"""Dry run: trace every (architecture x input-shape) cell on ``meta``
tensors and reckon, per card, its memory, operations, bytes,
collectives, the three roofline terms and model flops over counted
flops — the JAX package's ``launch/dryrun.py`` without its mesh.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
        --shape prefill_32k [--cards N] [--out build/dryrun] [--tag T] \\
        [--override key=value ...]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--cards N]

The JAX package lowers and compiles each cell against a 512-chip mesh on
forced host devices; here the step runs once on ``meta`` tensors (no
memory, no card, no CUDA module) under ``launch.step_analysis``, the LM
kernels counted by their own formulas. The layout over ``--cards N`` is
``train/manual_dp.py``'s: parameters replicated, AdamW moments
ZeRO-sharded N ways, the batch split N ways; a train cell at N > 1
traces ``make_manual_dp_train_step`` with a recorder in place of its
collectives and holds what it issued against ``collective_plan``; at
N = 1 it traces ``make_train_step`` (one card issues no collective).
Prefill and decode cells are replicas: each card serves its part of the
batch, with no collective.

Exit code 0 and a JSON artifact per cell for "ok" and "skipped" cells
(decode for archs without a decoder, long_500k for quadratic attention),
as the JAX package's rules skip them. Overrides as in the JAX CLI:
``microbatches``, ``moe_group``, ``moe_capacity`` and any config field;
20B+ models get 16 microbatches at train_4k. ``fsdp``, ``seq_parallel``,
``second_matmul`` and ``dp_mode`` other than "manual" name a mesh layout
the port does not have, and raise. The numbers are reckonings from
counted work, not measurements.
"""
import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import SHAPE_SUITES, ShapeSuite, get_config
from repro_torch.launch import specs as S
from repro_torch.launch.step_analysis import (CARD_BYTES, analyze_step,
                                              roofline_terms)
from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves
from repro_torch.optim import AdamWConfig, abstract_state
from repro_torch.train.manual_dp import (abstract_zero_opt_state,
                                         collective_plan,
                                         make_manual_dp_train_step)
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_train_step

# overrides that need a mesh layout the port lacks
MESH_OVERRIDES = ("fsdp", "seq_parallel", "second_matmul")


class RecordedCollectives:
    """``manual_dp``'s collectives for a traced step, as rank 0 of
    ``world``: each call is recorded in ``collective_plan``'s form and
    moves nothing (its tensors are ``meta``)."""

    def __init__(self, world: int):
        self.world, self.rank = world, 0
        self.issued: List[Dict[str, Any]] = []

    def _record(self, op: str, kind: str, out: torch.Tensor) -> None:
        self.issued.append({"op": op, "kind": kind, "dtype": str(out.dtype),
                            "result_bytes": out.numel() * out.element_size()})

    def reduce_scatter_tensor(self, out, inp):
        self._record("reduce_scatter_tensor", "reduce-scatter", out)

    def all_reduce(self, t):
        self._record("all_reduce", "all-reduce", t)

    def all_gather_into_tensor(self, out, inp):
        self._record("all_gather_into_tensor", "all-gather", out)


def model_param_count(abstract_params) -> int:
    return int(sum(x.numel() for x in tree_leaves(abstract_params)))


def _config(arch: str, shape: str, overrides: Optional[Dict[str, Any]]):
    overrides = dict(overrides) if overrides else {}
    for key in MESH_OVERRIDES:
        if key in overrides:
            raise ValueError(f"override {key!r} needs a device mesh; the "
                             f"port's only layout across cards is "
                             f"manual_dp's (--cards)")
    dp_mode = overrides.pop("dp_mode", "manual")
    if dp_mode != "manual":
        raise ValueError(f"dp_mode {dp_mode!r} needs a device mesh; the "
                         f"port has dp_mode 'manual' only")
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


def build_cell(arch: str, shape: str, *, cards: int = 1,
               overrides: Optional[Dict[str, Any]] = None,
               suite: Optional[ShapeSuite] = None):
    """Returns (step_fn, abstract_args, meta, comm) for one dry-run cell;
    ``suite`` replaces ``SHAPE_SUITES[shape]`` (a cell at another batch or
    length). ``comm`` records a train step's collectives at cards > 1
    (None otherwise); step_fn is None for a skipped cell."""
    cfg = _config(arch, shape, overrides)
    suite = suite or SHAPE_SUITES[shape]

    # ---- applicability (the JAX package's rules)
    skip = {"status": "skipped", "arch": arch, "shape": suite.name,
            "cards": cards}
    if suite.kind == "decode" and not cfg.supports_decode:
        return None, None, {**skip, "reason": "no decode path"}, None
    if suite.name == "long_500k" and not cfg.subquadratic:
        return None, None, {**skip, "reason": "quadratic attention at 500k"
                            }, None
    if cards < 1 or suite.global_batch % cards:
        raise ValueError(f"batch {suite.global_batch} does not split over "
                         f"{cards} cards")
    per_card = suite.global_batch // cards

    model = Model(cfg)
    params = model.abstract()
    meta = {
        "status": "ok", "arch": arch, "shape": suite.name,
        "cards": cards, "batch_per_card": per_card,
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
        comm = RecordedCollectives(cards)
        meta["layout"] = (f"manual_dp: parameters replicated, moments "
                          f"ZeRO-sharded over {cards} cards")
        fn = make_manual_dp_train_step(model, AdamWConfig(), comm=comm)
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
    plan = [] if comm is None else collective_plan(args[0], n)
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


def run_cell(arch: str, shape: str, *, cards: int = 1,
             out_dir: str = "build/dryrun", tag: str = "",
             overrides: Optional[Dict[str, Any]] = None,
             suite: Optional[ShapeSuite] = None) -> Dict[str, Any]:
    t0 = time.time()
    fn, args, meta, comm = build_cell(arch, shape, cards=cards,
                                      overrides=overrides, suite=suite)
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
        _write(out_dir, arch, shape, cards, result, tag)
    return result


def _write(out_dir, arch, shape, cards, result, tag=""):
    os.makedirs(out_dir, exist_ok=True)
    safe_arch = arch.replace(".", "p").replace("/", "_")
    suffix = f"_{tag}" if tag else ""
    path = os.path.join(out_dir,
                        f"{safe_arch}__{shape}__{cards}card{suffix}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)


def brief(res: Dict[str, Any]) -> Dict[str, Any]:
    """The one-line summary of a cell the CLI prints last."""
    out = {k: res.get(k) for k in ("arch", "shape", "cards", "status",
                                   "trace_s", "fits", "model_flops_ratio",
                                   "error")}
    if "roofline" in res:
        out.update(res["roofline"])
    if "memory" in res:
        out["peak_bytes_per_card"] = res["memory"]["peak_estimate_bytes"]
    return out


def matrix_line(res: Dict[str, Any]) -> str:
    """One cell of the matrix: status, peak GiB, fits, dominant term,
    bound seconds."""
    head = f"{res['arch']:>16} {res['shape']:>12}: {res['status']}"
    if "roofline" not in res:
        return head + (f" ({res.get('reason') or res.get('error')})")
    roof = res["roofline"]
    return (f"{head}, peak {res['memory']['peak_estimate_bytes'] / 2**30:.2f}"
            f" GiB, fits {res['fits']}, {roof['dominant']}-bound, bound "
            f"{roof['bound_s']:.6g} s, model/counted flops "
            f"{res['model_flops_ratio']:.4f}, traced in {res['trace_s']} s")


def run_matrix(cards: int = 1, out_dir: str = "build/dryrun") -> bool:
    """Every arch x ``shape_cells()`` cell, one line each, then the host
    seconds the matrix took. True when every cell is ok or skipped."""
    from repro_torch.configs import list_archs
    t0 = time.time()
    ok = True
    for arch in list_archs():
        for shape in SHAPE_SUITES:
            res = run_cell(arch, shape, cards=cards, out_dir=out_dir)
            ok &= res["status"] in ("ok", "skipped")
            print(matrix_line(res), flush=True)
    print(f"matrix at {cards} card(s): {time.time() - t0:.1f} s of host time")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape cell (the matrix)")
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPE_SUITES))
    ap.add_argument("--cards", type=int, default=1)
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (int/float/bool)")
    args = ap.parse_args(argv)
    if args.all:
        raise SystemExit(0 if run_matrix(args.cards, args.out) else 1)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        overrides[k] = json.loads(v)
    res = run_cell(args.arch, args.shape, cards=args.cards,
                   out_dir=args.out, tag=args.tag,
                   overrides=overrides or None)
    print(json.dumps(brief(res)))
    raise SystemExit(0 if res["status"] in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
