"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics. ``run.py`` is the command; tests call
``run_cell`` on the CPU at small sizes.

Order of a run: the program's model and the benchmark's weights (drawn
from the seed); the mix's set-up (``loops/<kind>.py``), which warms up
every shape the window uses (``setup_s`` ends here); the window; with
``--trace 1`` then the mix's ``trace_units`` more units under the
profiler (the host-clock metrics read the untraced window, the device
metrics the traced units); the peak device memory; the program's state
dropped; the reference, redrawing the weights from the seed; the
comparison, each number against its limit (``limits/<cell>.json``); the
metrics (``metrics/<name>.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
from typing import List, Optional

import torch

from portbench import port, trace, weights
from portbench.spec import Spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """What a mix's loop reads: the cell's files, the run's seed and
    device, the program's model, its weights and their layout, and the
    configuration's plain reference."""
    conf: dict
    traffic: dict
    seed: int
    device: torch.device
    model: object
    layout: list
    params: Optional[dict]
    reference: object
    dims: object

    def draw(self) -> dict:
        """The benchmark's weights, drawn anew from the seed (nested)."""
        return weights.nest(weights.draw(self.layout, self.seed, self.device,
                                         self.conf.get("weight_scale")))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Run:
    """What a metric's reader reads: the units, tokens, time and
    latencies of the measured (untraced) window, and in a traced run the
    trace of the units after it."""
    conf: dict
    traffic: dict
    peak: Optional[dict]
    setup_s: float
    units: int
    tokens: int
    window_s: float
    latencies_s: List[float]
    trace: Optional[trace.Trace] = None    # a traced run's traced units


def forbidden_modules() -> List[str]:
    """Top-level names (compared whole) of loaded modules the benchmark
    must never load: JAX and the JAX package."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def run_cell(spec: Spec, name: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float) -> dict:
    cell = spec.cell(name)
    conf = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(name)
    loop = spec.loop(traffic["kind"])
    ref = spec.reference(conf)
    model = port.model(conf, traffic)
    layout = port.layout(model)
    ctx = Context(conf, traffic, seed, device, model, layout, None, ref,
                  ref.Dims.of(conf))
    ctx.params = ctx.draw()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = loop.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start

    win = loop.window(state, ctx, seconds)
    box: list = []
    if traced:
        with trace.capture(box):
            loop.window(state, ctx, seconds, traffic["trace_units"])
    peak_bytes = (torch.cuda.max_memory_allocated(device)
                  if device.type == "cuda" else 0)

    out = loop.outputs(state, ctx)
    del state
    ctx.params = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = loop.check(out, ctx)
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    peaks = json.loads((spec.here / "peaks.json").read_text())
    run = Run(conf, traffic, peaks.get(kind), setup_s, win["units"],
              win["tokens"], win["window_s"], win["latencies_s"],
              box[0] if box else None)
    metrics = {}
    for m in spec.metrics(name, traced):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": 1, "memory_peak_bytes": peak_bytes}
    result = {"correct": correct, "attempted": win["units"], "failed": 0,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        busy = trace.length(trace.busy(run.trace)) / 1e6
        dev.update(busy_s=busy, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": trace.top_ops(run.trace),
                               "idle_gaps": trace.idle_gaps(run.trace)}
    result["checks"] = checks
    return result


def check_lines(result: dict) -> List[str]:
    return [f"check {k}: {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}"
            for k, v in result["checks"].items()]
