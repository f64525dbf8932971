"""``second_matmul="col"`` (the reference's ``default_rules(second_matmul=
"col")``: ``wo`` and the MLPs' ``w_down`` split by output column,
"embed_out" on the model axis) in spawned gloo ranks on the CPU, against
the port's unsharded model, the JAX package's sharded forward under the
same rules, and the port's row layout.

One subprocess runs the JAX package with 4 host devices, as
``tests/test_torch_tp.py`` does, its rules ``default_rules(second_matmul=
"col")``: for the f32 smoke configs of all six families and whisper-smoke
cut to 2 heads (``whisper-small:2``), ``Model.forward`` on an Auto
(data 2, model 2) mesh, the prefill logits of a [4, 32] batch and 4
decode steps, each step's input cache saved. The port then runs the same
weights over (data, model) = (1, 2), (1, 4) and (2, 2) ranks, every
layout at once (``whisper-small:2`` at (1, 4), where ranks 2 and 3 hold
no heads and send empty parts of each pair's input gather):

* prefill and decode logits against the port's unsharded forward at
  1e-5 (f32), and against the JAX package's at 1e-4; greedy tokens equal
  every step and over 4 free-running decode steps;
* rwkv6 (whose ``wo`` and channel-mix ``wv`` carry "heads" / "ff" and
  "embed", not "heads2" / "ff2" and "embed_out") holds the same leaves
  and gives bitwise the same logits as under the row layout;
* one training step: every rank's loss and gradient of every leaf
  (``sync_grads``) equal its slice of the port's unsharded gradient
  within 1e-5 x max(1, max |g|);
* the dry run of a col train cell (internlm2-smoke, remat, 2
  microbatches) at ``--cards 4 --model 2``: rank 0 of a gloo run of the
  same step counts exactly the
  dry run's operations, bytes, kernel calls and memory, and both issue
  ``model_axis_plan``'s collectives (per pair the input's and the output
  columns' all-gathers; in the backward the input's reduce-scatter).
"""
import dataclasses
import multiprocessing
import os
import queue
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_tp import (_JAX_SCRIPT, B, HEADLESS, P, T, TOL_JAX,
                           TOL_PORT, _close, _load, _steps, archs_at,
                           model_of)
from test_torch_tp_train import TIMEOUT_S, _leaf_close, free_ports

from repro_torch.launch.mesh import make_mesh
from repro_torch.models.param import shard_tree, tree_leaves
from repro_torch.models.sharding import NULL_CTX, ShardingCtx, default_rules

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["internlm2-1.8b", "zamba2-1.2b", "qwen2-moe-a2.7b", "qwen2-vl-7b",
         "rwkv6-7b", "whisper-small"]
LAYOUTS = [(1, 2), (1, 4), (2, 2)]
CASES = [(arch, shape) for arch in ARCHS for shape in LAYOUTS] + [HEADLESS]
COL = dict(second_matmul="col")
ROW_SCRIPT_LINE = "rules = default_rules()"


def _ids(cases):
    return [f"{a}-{s[0]}x{s[1]}" for a, s in cases]


def spawn_all(target, runs, timeout=TIMEOUT_S, tries=3):
    """``target(rank, port, *args, queue)`` for every (world, args) of
    ``runs``, every group at once on its own port; returns each run's
    items (one per rank, in arrival order). A rank that exits before its
    group reported (a port another process took between its choice and
    the rendezvous: ``EADDRINUSE``) stops the ranks, which start again on
    fresh ports, ``tries`` times in all; each try within ``timeout``
    seconds."""
    mp = multiprocessing.get_context("spawn")
    for attempt in range(tries):
        q = mp.Queue()
        procs = []
        for port, (world, args) in zip(free_ports(len(runs)), runs):
            procs += [mp.Process(target=target, args=(r, port, *args, q))
                      for r in range(world)]
        for p in procs:
            p.start()
        got, t0, broken = [], time.monotonic(), False
        try:
            while len(got) < len(procs):
                try:
                    got.append(q.get(timeout=5))
                except queue.Empty:
                    broken = any(p.exitcode not in (None, 0) for p in procs)
                    assert time.monotonic() - t0 < timeout, "ranks hung"
                    if broken:
                        break
        finally:
            for p in procs:
                p.join(60 if not broken else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
        if not broken:
            assert all(p.exitcode == 0 for p in procs)
            return got
    raise AssertionError(f"a rank failed in each of {tries} tries")


def _ctx(shape, rank=None, **rules):
    mesh = make_mesh(shape, ("data", "model"), rank=rank)
    return ShardingCtx(mesh, default_rules(**rules))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's runs under the col rules, one npz per arch."""
    assert _JAX_SCRIPT.count(ROW_SCRIPT_LINE) == 1
    script = _JAX_SCRIPT.replace(
        ROW_SCRIPT_LINE, 'rules = default_rules(second_matmul="col")')
    out = tmp_path_factory.mktemp("col_ref")
    # XLA at optimization level 0: each step runs once on a few hundred
    # tokens, so compiling is nearly all of its time
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_backend_optimization_level=0")
    got = subprocess.run(
        [sys.executable, "-c", script, str(out), str(B), str(P), str(T),
         *ARCHS, HEADLESS[0]], capture_output=True, text=True, env=env,
        timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    return out


def _train_batch(z, ctx):
    """The rank's rows of the prefill batch, the targets its tokens
    shifted."""
    toks = torch.from_numpy(z["tokens"]).long()
    mb = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    if "frames" in z.files:
        mb["frames"] = torch.from_numpy(z["frames"])
    return {k: ctx.shard(v, ("batch",) + (None,) * (v.dim() - 1))
            for k, v in mb.items()}


def _grads(model, params, z, ctx):
    from repro_torch.train.train_step import (loss_and_grads, make_loss_fn,
                                              sync_grads)
    grads, (_, loss, _) = loss_and_grads(make_loss_fn(model, ctx), params,
                                         _train_batch(z, ctx))
    return float(loss), [g.numpy() for g in sync_grads(grads, model, ctx)]


def _serve(model, params, z, ctx):
    got = _steps(model, shard_tree(params, model.defs, ctx), z, ctx)
    for key in ("logits", "logits32"):
        got[key] = [model.gather_logits(lg, ctx).numpy() for lg in got[key]]
    return {k: [np.asarray(t) for t in v] for k, v in got.items()}


def _rank_main(rank, port, shape, ref_dir, q) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=shape[0] * shape[1], rank=rank)
    try:
        ctx = _ctx(shape, **COL)
        res = {}
        for arch in archs_at(shape):
            model, params, z = _load(ref_dir, arch)
            got = _serve(model, params, z, ctx)
            got["loss"], got["grads"] = _grads(
                model, shard_tree(params, model.defs, ctx), z, ctx)
            if arch == "rwkv6-7b":
                row = _serve(model, params, z, _ctx(shape))
                got["row_logits"] = row["logits"] + row["logits32"]
            res[arch] = got
        q.put((shape, rank, res))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(reference):
    """{(layout, rank): {arch: its outputs}}, every layout at once."""
    got = spawn_all(_rank_main, [(d * m, ((d, m), str(reference)))
                                 for d, m in LAYOUTS])
    return {(shape, rank): res for shape, rank, res in got}


@pytest.fixture(scope="module")
def unsharded(reference):
    out = {}
    for arch in ARCHS + [HEADLESS[0]]:
        model, params, z = _load(reference, arch)
        got = _steps(model, params, z, NULL_CTX)
        got = {k: [np.asarray(t) for t in v] for k, v in got.items()}
        got["loss"], got["grads"] = _grads(model, params, z, NULL_CTX)
        out[arch] = got
    return out


def _rows(runs, shape, arch, key):
    """``key``'s outputs of every data rank's model rank 0, their rows
    concatenated."""
    d_, m_ = shape
    return [np.concatenate([runs[(shape, d * m_)][arch][key][i]
                            for d in range(d_)])
            for i in range(len(runs[(shape, 0)][arch][key]))]


@pytest.mark.parametrize("arch,shape", CASES, ids=_ids(CASES))
def test_col_serving_matches_unsharded_and_reference(arch, shape, runs,
                                                     unsharded, reference):
    want = unsharded[arch]
    z = np.load(Path(reference) / f"{arch}.npz")
    jax_logits = [z["logits"]] + [z[f"logits{i}"] for i in range(T)]
    got = {k: _rows(runs, shape, arch, k)
           for k in ("logits", "logits32", "greedy", "free")}
    for i in range(T + 1):
        what = f"{arch} {shape} {'prefill' if i == 0 else f'step {i}'}"
        _close(got["logits32"][i], want["logits32"][i], TOL_PORT, what)
        _close(got["logits"][i], jax_logits[i], TOL_JAX, what + " vs JAX")
        np.testing.assert_array_equal(got["greedy"][i], want["greedy"][i])
        np.testing.assert_array_equal(got["greedy"][i],
                                      jax_logits[i].argmax(-1))
    for a, b in zip(got["free"], want["free"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_rwkv6_col_is_its_row_layout(shape, runs):
    """No rwkv6 leaf carries "heads2", "ff2" or "embed_out": under col
    every rank holds the row layout's slices, and its logits are
    bitwise the row layout's."""
    model = model_of("rwkv6-7b")
    full = model.init(torch.Generator().manual_seed(0))
    for rank in range(shape[0] * shape[1]):
        col, row = _ctx(shape, rank, **COL), _ctx(shape, rank)
        for d, x in zip(tree_leaves(model.defs), tree_leaves(full)):
            assert torch.equal(col.shard(x, d.axes, d.parts),
                               row.shard(x, d.axes, d.parts)), d.axes
        got = runs[(shape, rank)]["rwkv6-7b"]
        for a, b in zip(got["logits"] + got["logits32"], got["row_logits"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,shape", CASES, ids=_ids(CASES))
def test_col_rank_gradients_are_slices_of_the_unsharded_gradient(
        arch, shape, runs, unsharded):
    model = model_of(arch)
    want = unsharded[arch]
    for rank in range(shape[0] * shape[1]):
        got, ctx = runs[(shape, rank)][arch], _ctx(shape, rank, **COL)
        assert got["loss"] == pytest.approx(want["loss"], rel=TOL_PORT,
                                            abs=TOL_PORT)
        for i, (d, g, w) in enumerate(zip(tree_leaves(model.defs),
                                          got["grads"], want["grads"])):
            _leaf_close(g, ctx.shard(torch.from_numpy(w), d.axes,
                                     d.parts).numpy(), TOL_PORT,
                        f"{arch} {shape} rank {rank} leaf {i} {d.axes}")


def test_col_leaves_hold_the_reference_bytes():
    """``wo`` and ``w_down`` split their "embed_out" columns as the
    reference's spec does: under col no leaf of the smoke configs is
    held otherwise than under row, and the pairs' leaves not at all."""
    from repro_torch.models.sharding import held_differently
    from repro_torch.models.param import tree_paths
    for arch in ARCHS:
        model = model_of(arch)
        for m in (2, 4):
            row, col = _ctx((1, m), 0), _ctx((1, m), 0, **COL)
            for path, d in tree_paths(model.defs):
                got = held_differently(d, col)
                if "embed_out" in d.axes:
                    assert got is None, (arch, path)
                elif got is not None:
                    assert got == held_differently(d, row), (arch, path)


# ------------------------------------------------------------ the dry run
def dry_rank(rank, port, arch, layout, q) -> None:
    """Rank ``rank`` of a (2, 2) gloo run of a smoke train cell's
    ``manual_dp`` step (``dry_cell``) under the ``layout`` overrides and
    ``analyze_step``, its collectives
    recorded as they are issued (what ``torch.distributed`` runs around
    gloo's collective is the collective's, neither an operation nor
    bytes of the step)."""
    import torch.distributed as dist
    from repro_torch.kernels import _build
    from repro_torch.launch.dryrun import cell_rules, layout_options
    from repro_torch.launch.step_analysis import analyze_step
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import manual_dp as mdp
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    try:
        issued = []

        def record(op, out, group):
            outs = out if isinstance(out, list) else [out]
            issued.append((op, str(outs[0].dtype),
                           sum(o.numel() * o.element_size() for o in outs),
                           dist.get_world_size(group)))
            return _build.COUNTER.inside_kernel()

        class Recorded:
            def all_reduce(self, t, group=None, op=None):
                with record("all_reduce", t, group):
                    dist.all_reduce(t, group=group,
                                    **({} if op is None else {"op": op}))

            def reduce_scatter_tensor(self, out, inp, group=None):
                with record("reduce_scatter_tensor", out, group):
                    dist.reduce_scatter_tensor(out, inp, group=group)

            def all_gather_into_tensor(self, out, inp, group=None):
                with record("all_gather_into_tensor", out, group):
                    dist.all_gather_into_tensor(out, inp, group=group)

            def all_gather(self, out, t, group=None):
                with record("all_gather", out, group):
                    dist.all_gather(out, t, group=group)

        cfg, suite = dry_cell(arch)
        model, comm = Model(cfg), Recorded()
        ctx = ShardingCtx(make_mesh((2, 2), ("data", "model")),
                          cell_rules(cfg, suite, 2,
                                     **layout_options(layout)), comm=comm)
        params = model.init(torch.Generator().manual_seed(0), ctx)
        toks = ctx.shard(torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab, (suite.global_batch, 32))), ("batch", None)).clone()
        batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
        if cfg.family == "encdec":
            batch["frames"] = torch.randn(toks.shape[0], cfg.enc_seq,
                                          cfg.d_model).bfloat16()
        step = mdp.make_manual_dp_train_step(model, AdamWConfig(), comm=comm,
                                             ctx=ctx)
        _, got = analyze_step(step, params, mdp.init_shard_state(
            params, ctx=ctx), batch)
        q.put((rank, {k: got[k] for k in ("flops", "bytes", "ops",
                                          "kernels", "memory")}, issued))
    finally:
        dist.destroy_process_group()


def dry_cell(arch):
    """(the smoke config, the suite) of a (2, 2) dry-run train cell, with
    remat and 2 microbatches (its re-forward's and each microbatch's
    collectives show)."""
    from repro_torch.configs import ShapeSuite, get_smoke_config
    cfg = dataclasses.replace(get_smoke_config(arch), remat=True,
                              microbatches=2)
    return cfg, ShapeSuite("tp_train", 32, 8, "train")


def check_dry_cell(arch, layout):
    """The dry run of the train cell against rank 0 of its gloo run;
    returns the plan and the cell's meta."""
    from repro_torch.launch import dryrun
    cfg, suite = dry_cell(arch)
    head = {"arch": arch, "shape": suite.name, "cards": 4, "model_axis": 2}
    fn, args, meta, comm = dryrun.model_axis_cell(
        cfg, suite, 4, 2, head, dryrun.layout_options(layout))
    res = dryrun.analyze_cell(fn, args, meta, comm)   # raises off the plan
    plan = comm.plan
    assert comm.issued == plan and meta["mesh"] == "2x2"
    got = {r: rest for r, *rest in spawn_all(dry_rank,
                                             [(4, (arch, layout))])}
    counts, issued = got[0]
    assert counts["flops"] == res["cost"]["flops_per_device"]
    assert counts["bytes"] == res["cost"]["bytes_per_device"]
    assert counts["ops"] == res["cost"]["ops"]
    assert counts["kernels"] == res["kernels"]
    assert counts["memory"] == res["memory"]
    assert [(c["op"], c["dtype"], c["result_bytes"], c["group"])
            for c in plan] == issued
    return plan, meta


def test_dry_run_of_a_col_cell_counts_the_gloo_run():
    plan, meta = check_dry_cell("internlm2-1.8b", COL)
    assert "second_matmul col" in meta["layout"]
    # the pairs' input gathers' reduce-scatters in the backward, before
    # manual_dp's three
    assert "reduce-scatter" in [c["kind"] for c in plan[:-3]]
