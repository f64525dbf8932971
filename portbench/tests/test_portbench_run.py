"""Whole runs of tiny cells on the CPU (the harness's look for a card
skipped): the result line, faults planted under the timed path turning
``correct`` false, and the control failing a limit."""
from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import CELLS, ROOT

from portbench import bench
from portbench.spec import Spec

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(root, cell, traced=False, device=torch.device("cpu"), seed=2**31 + 7):
    spec = Spec(root, root / "portbench")
    return bench.run_cell(spec, cell, seed, 0.5, traced, device,
                          time.perf_counter())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_cell_runs_correct(tiny_root, cell):
    out = run(tiny_root, cell)
    assert list(out) == KEYS + ["checks"]
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    spec = Spec(tiny_root, tiny_root / "portbench")
    assert set(out["metrics"]) == {m["name"]
                                   for m in spec.metrics(cell, False)}
    for m in out["metrics"].values():
        assert m["value"] > 0
    lines = bench.check_lines(out)
    assert len(lines) == len(out["checks"]) and all("ok" in x for x in lines)
    json.dumps(out)


def _altered_token(orig):
    def make(model, *a, **k):
        step = orig(model, *a, **k)

        def broken(params, batch):
            tok, cache = step(params, batch)
            return (tok + 1) % model.cfg.vocab, cache
        return broken
    return make


def _unfilled_cache(orig):
    def make(model, *a, **k):
        step = orig(model, *a, **k)

        def broken(params, batch):
            tok, cache = step(params, batch)
            return tok, {n: torch.zeros_like(t) for n, t in cache.items()}
        return broken
    return make


def _unchanged_state(orig):
    def make(model, *a, **k):
        step = orig(model, *a, **k)

        def broken(params, opt, batch):
            copy = lambda t: {k: copy(v) for k, v in t.items()} \
                if isinstance(t, dict) else t.clone()       # noqa: E731
            _, _, met = step(copy(params), type(opt)(
                opt.step.clone(), copy(opt.mu), copy(opt.nu)), batch)
            return params, opt, met
        return broken
    return make


def _half_batch(orig):
    def make(model, *a, **k):
        from repro_torch.models.model import Model
        half = Model(dataclasses.replace(
            model.cfg, microbatches=max(model.cfg.microbatches // 2, 1)))
        step = orig(half, *a, **k)

        def broken(params, opt, batch):
            n = batch["tokens"].shape[0] // 2
            return step(params, opt, {k: v[:n] for k, v in batch.items()})
        return broken
    return make


FAULTS = {
    "token_altered-dense": ("serve_step", "make_prefill_step",
                            _altered_token, "tiny-dense.prefill"),
    "token_altered-moe": ("serve_step", "make_prefill_step", _altered_token,
                          "tiny-moe.prefill"),
    "cache_unfilled-dense": ("serve_step", "make_prefill_step",
                             _unfilled_cache, "tiny-dense.prefill"),
    "cache_unfilled-moe": ("serve_step", "make_prefill_step",
                           _unfilled_cache, "tiny-moe.prefill"),
    "state_unchanged": ("train_step", "make_train_step", _unchanged_state,
                        "tiny-dense.train"),
    "half_batch": ("train_step", "make_train_step", _half_batch,
                   "tiny-dense.train"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, fault):
    import importlib
    module, fn, wrap, cell = FAULTS[fault]
    mod = importlib.import_module(f"repro_torch.train.{module}")
    monkeypatch.setattr(mod, fn, wrap(getattr(mod, fn)))
    out = run(tiny_root, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_a_limit(tiny_root, cell):
    """The reference in float8 in the program's place reads above a limit
    of the cell."""
    spec = Spec(tiny_root, tiny_root / "portbench")
    conf = spec.config(spec.cell(cell)["config"])
    traffic = spec.traffic(spec.cell(cell)["traffic"])
    ref = spec.reference(conf)
    from portbench import port
    model = port.model(conf, traffic)
    ctx = bench.Context(conf, traffic, 11, torch.device("cpu"), model,
                        port.layout(model), None, ref, ref.Dims.of(conf))
    readings = spec.loop(traffic["kind"]).control(ctx)["control_fp8"]
    limits = spec.limits(cell)
    assert any(readings[k] > limits[k] for k in limits), readings


def test_traced_run_on_the_cpu_is_refused(tiny_root):
    with pytest.raises(Exception):
        run(tiny_root, "tiny-dense.prefill", traced=True)


def test_no_card_no_result(tmp_path):
    """Without a CUDA card (here), and in a checkout holding only the
    benchmark's files, the command exits non-zero and prints nothing on
    standard output."""
    for root in (ROOT, tmp_path):
        if root is tmp_path:
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                            ignore=shutil.ignore_patterns("__pycache__"))
        done = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "internlm2-1.8b.prefill", "--seed", "5", "--seconds", "1",
             "--trace", "0"], cwd=root, capture_output=True, text=True,
            timeout=300)
        assert done.returncode != 0 and done.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_cell_on_the_card(tiny_root, cuda_card, cell):
    out = run(tiny_root, cell, traced=True, device=cuda_card)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
