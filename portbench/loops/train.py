"""Training mixes: back-to-back optimizer steps of the program's
``make_train_step`` on token rows drawn from the seed.

Set-up builds the one train step with its parameters and AdamW state and
drives it through the mix's ``setup_steps`` first steps, on rows that
all differ; those steps warm up every shape the window runs, and the
reference follows them. The window then continues the same object on
fresh rows, each step ending in a device synchronisation.

Compared (``check``), by the worst leaf where a number is per leaf:
  loss_gap    each checked step's mean loss against the reference's,
              |program - reference| / reference
  grad_gap    the first step's gradient as the optimizer got it (its
              first moment after one step / (1 - b1): clipped), its norm
              per leaf against the reference's: |program - reference| /
              max(the reference's norm of the leaf, of the median leaf)
  change_gap  each leaf's change over the checked steps, likewise;
              leaves whose reference gradient is under a thousandth of
              the median leaf's are left out (their change is round-off)
"""
from __future__ import annotations

import statistics
import sys
import time
from typing import Dict, List

import torch

from portbench import port, weights

TOKENS = 1          # the token rows' generator stream (weights: 0)


def _feed(rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"tokens": rows[:, :-1], "targets": rows[:, 1:]}


def _norms(ctx, tree) -> Dict[str, float]:
    """Per leaf name of the reference, the norm of the program's tree
    (the configuration's part of each leaf)."""
    ref = ctx.reference
    named = ref.leaves(ref.weights_from(tree, ctx.dims))
    return {k: float(torch.sqrt(sum(t.float().square().sum() for t in ts)))
            for k, ts in named.items()}


class State:
    pass


def rows(ctx, n: int) -> List[torch.Tensor]:
    t = ctx.traffic
    gen = weights.generator(ctx.seed, ctx.device, TOKENS)
    return list(torch.randint(0, ctx.conf["vocab_size"],
                              (n, t["batch"], t["seq_len"] + 1),
                              generator=gen, device=ctx.device))


def setup(ctx) -> State:
    t = ctx.traffic
    s = State()
    s.step = port.train_step(ctx.model, t["optimizer"])
    s.params = ctx.params
    s.opt = port.init_opt(s.params)
    s.rows = rows(ctx, t["setup_steps"] + t["pool"])
    losses = []
    b1 = t["optimizer"]["b1"]
    for i in range(t["setup_steps"]):
        s.params, s.opt, met = s.step(s.params, s.opt, _feed(s.rows[i]))
        losses.append(met["loss"])
        if i == 0:
            s.grad = {k: v / (1 - b1) for k, v in _norms(ctx, s.opt.mu).items()}
    s.loss = [float(x) for x in losses[:t["checked_steps"]]]
    start = ctx.draw()
    diff = {}
    ref = ctx.reference
    now = ref.leaves(ref.weights_from(s.params, ctx.dims))
    then = ref.leaves(ref.weights_from(start, ctx.dims))
    for k in now:
        diff[k] = float(torch.sqrt(sum(
            (a.float() - b.float()).square().sum()
            for a, b in zip(now[k], then[k]))))
    s.change = diff
    del start, now, then
    ctx.sync()
    return s


def window(s: State, ctx, seconds: float, max_units: int = 0) -> dict:
    t = ctx.traffic
    tokens = t["batch"] * t["seq_len"]
    n, t0 = 0, time.perf_counter()
    while True:
        r = s.rows[(t["setup_steps"] + n) % len(s.rows)]
        s.params, s.opt, _ = s.step(s.params, s.opt, _feed(r))
        ctx.sync()
        n += 1
        end = time.perf_counter()
        if end - t0 >= seconds or (max_units and n >= max_units):
            break
    return {"units": n, "tokens": n * tokens, "window_s": end - t0,
            "latencies_s": []}


def outputs(s: State, ctx) -> dict:
    """What the check reads; the program's state is dropped."""
    return {"loss": s.loss, "grad": s.grad, "change": s.change,
            "rows": s.rows[:ctx.traffic["checked_steps"]]}


def reference_run(ctx, rows, precision=None, half: bool = False) -> dict:
    """The reference's training over ``rows`` (half: the first half of
    each step's rows in half as many microbatches, a planted fault)."""
    ref, t = ctx.reference, ctx.traffic
    w = ref.weights_from(ctx.draw(), ctx.dims)
    mb = t["microbatches"]
    if half:
        rows, mb = [r[:r.shape[0] // 2] for r in rows], mb // 2
    return ref.train(w, ctx.dims, t["optimizer"], rows, mb,
                     precision or ref.F32)


def _leaf_gap(got: Dict[str, float], want: Dict[str, float],
              keep=None, name: str = "") -> float:
    floor = statistics.median(want.values())
    gaps = {k: abs(got[k] - want[k]) / max(want[k], floor)
            for k in want if keep is None or k in keep}
    print(f"{name} by leaf:", " ".join(f"{k} {v:.3g}"
                                       for k, v in gaps.items()),
          "left out:", sorted(set(want) - set(gaps)), file=sys.stderr)
    return max(gaps.values())


def numbers(got: dict, want: dict) -> Dict[str, float]:
    """The compared numbers of ``got`` (the program's readings, or a
    control's) against the reference's ``want``."""
    floor = statistics.median(want["raw_grad"].values())
    moved = {k for k, v in want["raw_grad"].items() if v >= 1e-3 * floor}
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(got["loss"], want["loss"])),
        "grad_gap": _leaf_gap(got["grad"], want["grad"], None, "grad_gap"),
        "change_gap": _leaf_gap(got["change"], want["change"], moved,
                                "change_gap"),
    }


def check(out: dict, ctx) -> Dict[str, float]:
    return numbers(out, reference_run(ctx, out["rows"]))


def control(ctx) -> Dict[str, Dict[str, float]]:
    """The readings of the control (the reference in float8 in the
    program's place) and of the planted half-batch fault, at the cell's
    size, against the reference."""
    r = rows(ctx, ctx.traffic["checked_steps"])
    want = reference_run(ctx, r)
    return {"control_fp8": numbers(reference_run(ctx, r, ctx.reference.FP8),
                                   want),
            "fault_half_batch": numbers(reference_run(ctx, r, half=True),
                                        want)}
