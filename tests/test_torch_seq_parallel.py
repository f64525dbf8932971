"""Sequence parallelism in training (the reference's ``default_rules(
seq_parallel=True)``: the residual's positions on the model axis) in
spawned gloo ranks on the CPU, against the port's unsharded gradient and
the JAX package's ``make_manual_dp_train_step`` under the same rules.

Once per session (``test_torch_tp_train.session_cached``) one subprocess
per arch runs the JAX package with 4 host devices: the f32 smoke configs
of all six families (RWKV6's zero-init ``w_lora_b`` drawn, Mamba2 and
RWKV6 with f32 decay ratios, as ``tests/test_torch_tp_train.py``;
whisper-smoke with 18 encoder frames, ``ENC_SEQ``, so that 4 ranks hold
5, 5, 4 and 4 of them), one ``make_manual_dp_train_step`` step on an Auto
(data 2, model 2) mesh from a warm optimizer state, on a seeded [4, 32]
batch. The port then runs the same weights over (data, model) = (1, 2),
(1, 4) and (2, 2) ranks, every layout at once:

* every rank's loss, aux and gradient of every leaf after ``sync_grads``
  equal its slice of the port's unsharded gradient, within 1e-5 x
  max(1, max |g|);
* every element several ranks of the model axis hold gets bitwise the
  same gradient on each of them; the leaves applied position by
  position (``ParamDef.per_position``: the norms' gains and biases,
  whisper's ``bo``, zamba2's ``fuse``) come out of the backward partial
  (they differ between the ranks) and ``sync_grads`` makes each their sum
  over the model axis (and the data axis's), so the test fails without
  the step's sum;
* one ``manual_dp`` step at (2, 2): the metrics, the updated parameters
  and the rank's moments against the reference's within 1e-5;
* the dry run of a sequence-parallel train cell (rwkv6-smoke, whose
  body's backward interleaves its gathers' and reduce-scatters'
  transposes with its copies, remat, 2 microbatches) at ``--cards 4
  --model 2``: rank 0 of a gloo run counts exactly the dry run's
  operations, bytes, kernel calls and memory, and both issue
  ``model_axis_plan``'s collectives.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_second_matmul import check_dry_cell, spawn_all
from test_torch_tp_train import (JAX_SCRIPT, OPT, TIMEOUT_S, TOL_DP,
                                 TOL_PORT, _leaf_close, rank_batch, ref_tree,
                                 session_cached, warm_state)

from repro_torch.launch.mesh import make_mesh
from repro_torch.models.param import shard_tree, tree_leaves, tree_unflatten
from repro_torch.models.sharding import NULL_CTX, ShardingCtx, default_rules

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["internlm2-1.8b", "zamba2-1.2b", "qwen2-moe-a2.7b", "qwen2-vl-7b",
         "rwkv6-7b", "whisper-small"]
LAYOUTS = [(1, 2), (1, 4), (2, 2)]
DP_LAYOUT = (2, 2)
ENC_SEQ = 18
SP = dict(seq_parallel=True)
MODEL_LINE = "jm = build_model(name, smoke=True)\n"


def _ids(cases):
    return [f"{a}-{s[0]}x{s[1]}" for a, s in cases]


def model_of(arch):
    """The smoke model of ``arch`` (whisper's with ``ENC_SEQ`` frames)."""
    from repro_torch.models import Model, build_model
    model = build_model(arch, smoke=True)
    if model.cfg.family == "encdec":
        model = Model(dataclasses.replace(model.cfg, enc_seq=ENC_SEQ))
    return model


def _ctx(shape, rank=None):
    return ShardingCtx(make_mesh(shape, ("data", "model"), rank=rank),
                       default_rules(**SP))


def _build_reference(out: Path) -> None:
    """``JAX_SCRIPT``'s manual_dp step at ``DP_LAYOUT`` under the
    sequence-parallel rules, one process per arch, all at once."""
    assert JAX_SCRIPT.count("rules = default_rules()") == 1
    assert JAX_SCRIPT.count(MODEL_LINE) == 1
    script = JAX_SCRIPT.replace(
        "rules = default_rules()", "rules = default_rules(seq_parallel=True)"
    ).replace(MODEL_LINE, MODEL_LINE + (
        "if jm.cfg.family == 'encdec':\n"
        f"    jm = Model(dataclasses.replace(jm.cfg, enc_seq={ENC_SEQ}))\n"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_backend_optimization_level=0")
    job = f"dp:{DP_LAYOUT[0]}x{DP_LAYOUT[1]}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(out / f"{arch}.npz"), arch, "1",
         job], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for arch in ARCHS]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return session_cached(tmp_path_factory, "seq_parallel_ref",
                          _build_reference)


def _rank_main(rank, port, shape, ref_dir, q) -> None:
    import torch.distributed as dist
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import manual_dp as mdp
    from repro_torch.train.train_step import (loss_and_grads, make_loss_fn,
                                              sync_grads)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=shape[0] * shape[1], rank=rank)
    try:
        ctx = _ctx(shape)
        res = {}
        for arch in ARCHS:
            model = model_of(arch)
            z = np.load(Path(ref_dir) / f"{arch}.npz")
            local = shard_tree(ref_tree(model, z, "param"), model.defs, ctx)
            mb = rank_batch(z, ctx)
            raw, (_, loss, aux) = loss_and_grads(make_loss_fn(model, ctx),
                                                 local, mb)
            out = {"loss": float(loss), "aux": float(aux),
                   "raw": [g.numpy() for g in raw],
                   "grads": [g.numpy() for g in sync_grads(raw, model, ctx)]}
            if shape == DP_LAYOUT:
                params = tree_unflatten(model.defs, [
                    t.clone() for t in tree_leaves(local)])
                opt = warm_state(model, params, z, ctx, mdp)
                step = mdp.make_manual_dp_train_step(
                    model, AdamWConfig(**OPT), ctx=ctx)
                params, opt, met = step(params, opt, mb)
                out["dp"] = {"metrics": {k: float(v) for k, v in
                                         met.items()},
                             "params": [p.numpy() for p in
                                        tree_leaves(params)],
                             "mu": opt.mu.numpy(), "nu": opt.nu.numpy()}
            res[arch] = out
        q.put((shape, rank, res))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(reference):
    got = spawn_all(_rank_main, [(d * m, ((d, m), str(reference)))
                                 for d, m in LAYOUTS])
    return {(shape, rank): res for shape, rank, res in got}


@pytest.fixture(scope="module")
def unsharded(reference):
    from repro_torch.train.train_step import loss_and_grads, make_loss_fn
    out = {}
    for arch in ARCHS:
        model = model_of(arch)
        z = np.load(Path(reference) / f"{arch}.npz")
        grads, (_, loss, aux) = loss_and_grads(
            make_loss_fn(model), ref_tree(model, z, "param"),
            rank_batch(z, NULL_CTX))
        out[arch] = (float(loss), float(aux), grads)
    return out


GRAD_CASES = [(a, s) for a in ARCHS for s in LAYOUTS]


@pytest.mark.parametrize("arch,shape", GRAD_CASES, ids=_ids(GRAD_CASES))
def test_sp_rank_gradients_are_slices_of_the_unsharded_gradient(
        arch, shape, runs, unsharded):
    model = model_of(arch)
    loss, aux, want = unsharded[arch]
    for rank in range(shape[0] * shape[1]):
        got, ctx = runs[(shape, rank)][arch], _ctx(shape, rank)
        assert got["loss"] == pytest.approx(loss, rel=TOL_PORT, abs=TOL_PORT)
        assert got["aux"] == pytest.approx(aux, rel=TOL_PORT, abs=TOL_PORT)
        for i, (d, g, w) in enumerate(zip(tree_leaves(model.defs),
                                          got["grads"], want)):
            _leaf_close(g, ctx.shard(w, d.axes, d.parts).numpy(), TOL_PORT,
                        f"{arch} {shape} rank {rank} leaf {i} {d.axes}")
    if arch == "qwen2-moe-a2.7b":
        assert aux > 0


@pytest.mark.parametrize("shape", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sp_replicated_leaves_get_equal_gradients(shape, runs):
    """Per leaf, each element several ranks of one data group hold has
    bitwise the same gradient on each of them; each ``per_position``
    leaf's gradient is partial out of the backward (its ranks' differ)
    and after ``sync_grads`` their sum over the model axis."""
    d_, m_ = shape
    held = partial = 0
    for arch in ARCHS:
        model = model_of(arch)
        for data in range(d_):
            ranks = [data * m_ + j for j in range(m_)]
            for i, d in enumerate(tree_leaves(model.defs)):
                seen = {}
                for rank in ranks:
                    ctx = _ctx(shape, rank)
                    g = runs[(shape, rank)][arch]["grads"][i]
                    dim, mine, _ = ctx._holding(d.axes, d.shape, d.parts)
                    cols = ([(0, g)] if dim is None else
                            [(mine[k], np.take(g, k, axis=dim))
                             for k in range(len(mine))])
                    for key, col in cols:
                        if key in seen:
                            held += 1
                            assert np.array_equal(seen[key], col), (
                                arch, shape, i, d.axes, key)
                        else:
                            seen[key] = col
                if not d.per_position:
                    continue
                raw = [runs[(shape, r)][arch]["raw"][i] for r in ranks]
                partial += not all(np.array_equal(raw[0], r) for r in raw)
                # summed over the model axis (and over data, the batch's)
                every = [runs[(shape, r)][arch]["raw"][i]
                         for r in range(d_ * m_)]
                np.testing.assert_allclose(
                    runs[(shape, ranks[0])][arch]["grads"][i],
                    np.sum(every, axis=0, dtype=np.float64), rtol=1e-6,
                    atol=1e-7, err_msg=f"{arch} {shape} leaf {i}")
    assert held > 0 and partial > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_sp_manual_dp_step_matches_reference(arch, runs, reference):
    from repro_torch.train.manual_dp import FlatLayout
    model = model_of(arch)
    defs = tree_leaves(model.defs)
    z = np.load(Path(reference) / f"{arch}.npz")
    job = f"dp:{DP_LAYOUT[0]}x{DP_LAYOUT[1]}/0"
    d_, m_ = DP_LAYOUT
    for rank in range(d_ * m_):
        got, ctx = runs[(DP_LAYOUT, rank)][arch]["dp"], _ctx(DP_LAYOUT, rank)
        for key in ("loss", "grad_norm", "lr"):
            assert got["metrics"][key] == pytest.approx(
                float(z[f"{job}/{key}"]), rel=TOL_DP, abs=TOL_DP), key
        for i, (d, p) in enumerate(zip(defs, got["params"])):
            ref = torch.from_numpy(np.array(z[f"{job}/param/{i}"]))
            _leaf_close(p, ctx.shard(ref, d.axes, d.parts).numpy(), TOL_DP,
                        f"{arch} rank {rank} param {i}")
        mates = [dd * m_ + ctx.index("heads") for dd in range(d_)]
        local = tree_unflatten(model.defs, [
            torch.empty(ctx.local_shape(d.axes, d.shape, d.parts))
            for d in defs])
        lay = FlatLayout(local, d_, 0)
        for name in ("mu", "nu"):
            bucket = np.concatenate([runs[(DP_LAYOUT, r)][arch]["dp"][name]
                                     for r in mates])
            for i, (d, v) in enumerate(zip(defs, lay.views(
                    torch.from_numpy(bucket)))):
                ref = torch.from_numpy(np.array(z[f"{job}/{name}/{i}"]))
                want = ctx.shard(ref, d.axes, d.parts).numpy()
                _leaf_close(v.numpy().reshape(want.shape), want, TOL_DP,
                            f"{arch} rank {rank} {name} {i}")


def test_sp_is_a_training_layout():
    """A prefill under the sequence-parallel rules raises (the reference's
    dry run applies them to train cells only); the uneven split gives
    rank 0 the largest share (whisper-small's 1,500 frames over 16 ranks:
    94 on ranks 0-11, 93 on ranks 12-15)."""
    model = model_of("internlm2-1.8b")
    ctx = _ctx((1, 2), 0)
    with pytest.raises(ValueError, match="training layout"):
        model.forward(model.abstract(ctx),
                      {"tokens": torch.zeros(1, 4, dtype=torch.long,
                                             device="meta")},
                      mode="prefill", ctx=ctx)
    sizes = [len(range(*_ctx((1, 16), r).range("seq", 1500)))
             for r in range(16)]
    assert sizes == [94] * 12 + [93] * 4


def test_dry_run_of_a_seq_parallel_cell_counts_the_gloo_run():
    plan, meta = check_dry_cell("rwkv6-7b", SP)
    assert "seq_parallel" in meta["layout"]
    assert "logits" in meta["layout_differences"]
    kinds = [c["kind"] for c in plan[:-3]]
    assert kinds.count("reduce-scatter") and kinds.count("all-gather")
