"""The port's manual data-parallel step (``train/manual_dp.py``) over
``torch.distributed`` with the gloo backend on the CPU: two processes,
each given half of the batch, end every step with the parameters of one
single-process ``make_train_step`` on the whole batch (1e-6, f32
``internlm2-smoke``), and each step makes exactly one reduce-scatter and
one all-gather (counted by wrapping the two collectives)."""
import multiprocessing
import socket

import numpy as np
import pytest
import torch

from repro_torch.models import build_model
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.train.train_step import make_train_step

WORLD = 2
STEPS = 2
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)


def _setup():
    """The f32 smoke model, its weights and a seeded batch of 4."""
    torch.set_num_threads(1)
    model = build_model("internlm2-1.8b", smoke=True)
    params = tree_map(lambda p: p.float(),
                      model.init(torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.cfg.vocab, (4, 32)))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    return model, params, batch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, port: int, out) -> None:
    import torch.distributed as dist
    from repro_torch.train import manual_dp
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        counts = {"reduce_scatter_tensor": 0, "all_gather_into_tensor": 0}
        for name in counts:
            def counted(*a, _fn=getattr(dist, name), _name=name, **kw):
                counts[_name] += 1
                return _fn(*a, **kw)
            setattr(dist, name, counted)
        model, params, batch = _setup()
        mine = {k: v.chunk(WORLD)[rank] for k, v in batch.items()}
        step = manual_dp.make_manual_dp_train_step(model, OPT)
        opt = manual_dp.init_shard_state(params)
        per_step, metrics = [], []
        for _ in range(STEPS):
            before = dict(counts)
            params, opt, met = step(params, opt, mine)
            per_step.append({k: counts[k] - before[k] for k in counts})
            metrics.append({k: float(v) for k, v in met.items()})
        out.put((rank, [p.numpy() for p in tree_leaves(params)], per_step,
                 metrics))
    finally:
        dist.destroy_process_group()


def test_two_ranks_match_one_process_on_the_whole_batch():
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        got = dict((r, rest) for r, *rest in
                   (out.get(timeout=240) for _ in range(WORLD)))
    finally:
        for p in procs:
            p.join(60)
    assert all(p.exitcode == 0 for p in procs)

    model, params, batch = _setup()
    step = make_train_step(model, OPT)
    opt = init_state(params)
    want = []
    for _ in range(STEPS):
        params, opt, met = step(params, opt, batch)
        want.append({k: float(v) for k, v in met.items()})
    for r in range(WORLD):
        leaves, per_step, metrics = got[r]
        assert per_step == [{"reduce_scatter_tensor": 1,
                             "all_gather_into_tensor": 1}] * STEPS
        for a, b in zip(leaves, tree_leaves(params)):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-6, atol=1e-6)
        for m, w in zip(metrics, want):
            for key in ("loss", "grad_norm", "lr"):
                assert m[key] == pytest.approx(w[key], rel=1e-6, abs=1e-6)


_KINDS = {"reduce_scatter_tensor": "reduce-scatter",
          "all_reduce": "all-reduce",
          "all_gather_into_tensor": "all-gather"}


def _rank_plan(rank: int, port: int, out) -> None:
    """One step with every collective the step issues recorded, in
    ``collective_plan``'s form (the output tensor each leaves, and the
    size of the group it ran over)."""
    import torch.distributed as dist
    from repro_torch.train import manual_dp
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        issued = []
        for name, kind in _KINDS.items():
            def recorded(result, *a, _fn=getattr(dist, name), _name=name,
                         _kind=kind, **kw):
                issued.append({"op": _name, "kind": _kind,
                               "dtype": str(result.dtype),
                               "result_bytes": result.numel()
                               * result.element_size(),
                               "group": dist.get_world_size(
                                   kw.get("group"))})
                return _fn(result, *a, **kw)
            setattr(dist, name, recorded)
        model, params, batch = _setup()
        params = tree_map(lambda p: p.bfloat16(), params)
        mine = {k: v.chunk(WORLD)[rank] for k, v in batch.items()}
        step = manual_dp.make_manual_dp_train_step(model, OPT)
        step(params, manual_dp.init_shard_state(params), mine)
        out.put((rank, issued))
    finally:
        dist.destroy_process_group()


def test_two_ranks_issue_exactly_the_collective_plan():
    """Each of two gloo ranks issues exactly ``collective_plan``'s
    collectives, in order, of its sizes, dtypes and group sizes (bf16
    parameters: the gathered bucket travels in bf16, the gradient in
    f32; without a mesh every collective runs over the one data axis)."""
    from repro_torch.train.manual_dp import collective_plan
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_plan, args=(r, port, out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        got = dict(out.get(timeout=240) for _ in range(WORLD))
    finally:
        for p in procs:
            p.join(60)
    assert all(p.exitcode == 0 for p in procs)
    model, params, _ = _setup()
    plan = collective_plan(tree_map(lambda p: p.bfloat16(), params), WORLD)
    assert [c["kind"] for c in plan] == ["reduce-scatter", "all-reduce",
                                         "all-gather"]
    assert plan[2]["dtype"] == "torch.bfloat16"
    assert {c["axis"] for c in plan} == {"data"}
    for r in range(WORLD):
        assert got[r] == [{k: v for k, v in c.items() if k != "axis"}
                          for c in plan]
