"""fsdp (ZeRO-3: each parameter's "embed" dim over the data axis) in the
port's training, on the CPU: the layout against the JAX package's specs,
``manual_dp``'s fsdp step against its unsplit step and against the JAX
package's step under the fsdp rules, the dry run against a gloo run.

* Under ``default_rules(fsdp=True)`` at (2, 2) and (16, 16) every
  parameter's bytes on rank 0 are the reference spec's shard, or the
  leaf is one ``held_differently`` names with its reason; the set of
  such leaves is the one the model axis alone gives (fsdp adds none).
* ``sum_shared`` on the data shards of the rank's gradients is the data
  shard of ``sum_shared`` on its whole slices (the kv heads several
  ranks hold, RWKV6's vectors read by heads), bitwise: the sum is
  elementwise and commutes with the data split.
* In spawned gloo ranks at (data, model) = (2, 1) and (2, 2), all six
  families' f32 smoke configs (``tests/test_torch_tp_train.py``'s
  session reference: its weights, batch and warm moments at step 3), two
  ``manual_dp`` steps with fsdp and without it from the same state: the
  first step's loss bitwise (the gathered weights are the whole weights;
  the second's within 1e-6 relative: it reads weights the first step
  updated from gradients summed in another order), the grad norm within
  1e-6 relative (the f32 sums run in another order: per microbatch over
  data, then over microbatches), every updated leaf
  within 1e-6 x max |p| of the unsplit step's slice, and each rank's
  moments the matching ranges of the unsplit step's within 1e-6.
* internlm2 and zamba2 (no aux loss) at the same two meshes against the
  JAX package's train step under the fsdp rules (its dry run's
  ``dp_mode="auto"`` cell: moments and gradients on "embed" -> "data",
  on an Auto mesh of 4 host devices): the loss and grad norm within
  1e-5 relative, the parameters within 1e-5.
* The dry run's fsdp train cell at ``--cards 4 --model 2`` (remat, 2
  microbatches) counts a gloo rank 0's operations, bytes, kernels and
  memory exactly, and its plan is the collectives that rank issued.
* ``build_cell`` at ``--cards 256 --model 16`` with fsdp: internlm2's
  train_4k and prefill_32k are "ok", their issued collectives the plan.
"""
import dataclasses
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_tp_train import (ARCHS, OPT, REF_STEPS, WARM_STEP,
                                 _dry_rank, _train_cfg, model_of, rank_batch,
                                 ref_tree, run_reference, session_cached,
                                 shared_reference, spawn_all)

from repro_torch.launch.mesh import make_mesh
from repro_torch.models.param import (shard_tree, tree_leaves, tree_map,
                                      tree_paths)
from repro_torch.models.sharding import (ShardingCtx, default_rules,
                                         held_differently)

LAYOUTS = [(2, 1), (2, 2)]
JAX_ARCHS = ("internlm2-1.8b", "zamba2-1.2b")
TOL_SELF, TOL_JAX = 1e-6, 1e-5
AXES = ("data", "model")


def _ctx(shape, rank, fsdp):
    return ShardingCtx(make_mesh(shape, AXES, rank=rank),
                       default_rules(fsdp=fsdp))


# ---------------------------------------------------------------- layout
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_bytes_are_the_reference_spec_shard(arch):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    model = Model(get_config(arch))
    for shape in ((2, 2), (16, 16)):
        named = {}
        for fsdp in (False, True):
            ctx = _ctx(shape, 0, fsdp)
            named[fsdp] = {p for p, d in tree_paths(model.defs)
                           if held_differently(d, ctx) is not None}
            if fsdp:
                split = [d for _, d in tree_paths(model.defs)
                         if ctx.embed_dim(d.axes, d.shape) is not None]
                assert len(split) > 0
                for d in split:
                    # rank 0's part of the "embed" dim: the spec's shard
                    dim = ctx.embed_dim(d.axes, d.shape)
                    assert ctx.local_shape(d.axes, d.shape, d.parts)[dim] \
                        == -(-d.shape[dim] // shape[0])
        assert named[True] == named[False], (arch, shape)


def _sum_shared_all(ctxs, grads):
    """``sum_shared`` on each model rank's ``grads`` (its contexts
    ``ctxs``), its all-reduce carried out across them: each rank's
    buffer captured, then their sum delivered."""
    class Capture:
        def all_reduce(self, t, group=None, op=None):
            self.buf = t.clone()

    class Deliver:
        def __init__(self, total):
            self.total = total

        def all_reduce(self, t, group=None, op=None):
            t.copy_(self.total)

    bufs = []
    for ctx, g in zip(ctxs, grads):
        cap = Capture()
        dataclasses.replace(ctx, comm=cap).sum_shared(g, ctx._defs)
        bufs.append(cap.buf)
    total = sum(bufs[1:], bufs[0].clone())
    return [dataclasses.replace(ctx, comm=Deliver(total)).sum_shared(
        g, ctx._defs) for ctx, g in zip(ctxs, grads)]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "rwkv6-7b"])
def test_sum_shared_commutes_with_the_data_split(arch):
    """At (2, 4) (internlm2-smoke's 2 kv heads each held by two ranks,
    RWKV6's vectors read by heads): the fsdp ranks' summed data shards
    are the data shards of the summed whole slices, bitwise."""
    model = model_of(arch)
    defs = tree_leaves(model.defs)
    gen = torch.Generator().manual_seed(7)
    for data in range(2):
        plain, split = [], []
        for j in range(4):
            rank = data * 4 + j
            c0, c1 = _ctx((2, 4), rank, False), _ctx((2, 4), rank, True)
            c0._defs = c1._defs = defs
            plain.append(c0)
            split.append(c1)
        grads = [[torch.randn(c.local_shape(d.axes, d.shape, d.parts),
                              generator=gen) for d in defs] for c in plain]
        assert plain[0].shared_leaves(defs) and \
            len(split[0].shared_leaves(defs)) == len(
                plain[0].shared_leaves(defs))
        parts = []
        for c, g in zip(split, grads):
            mine = []
            for d, x in zip(defs, g):
                dim = c.embed_dim(d.axes, d.shape)
                if dim is not None:
                    lo, hi = c.range("embed", d.shape[dim])
                    x = x.narrow(dim, lo, hi - lo).clone()
                mine.append(x)
            parts.append(mine)
        whole = _sum_shared_all(plain, grads)
        shards = _sum_shared_all(split, parts)
        for c, w, s in zip(split, whole, shards):
            for d, a, b in zip(defs, w, s):
                dim = c.embed_dim(d.axes, d.shape)
                if dim is not None:
                    lo, hi = c.range("embed", d.shape[dim])
                    a = a.narrow(dim, lo, hi - lo)
                assert torch.equal(a, b), (arch, d.axes)


# ------------------------------------------------------------ gloo steps
def _moment_leaves(lay, flat):
    """A rank's flat moment as per-leaf tensors of its parameter shapes,
    for the fsdp leaves (whole: the accumulator at pod 1) and None for
    the bucket's (spread over the data ranks)."""
    out = [None] * len(lay.split)
    if lay.zero3 is not None:
        _, acc = lay.moments(flat)
        for i, v in zip(lay.zero3_idx, lay.zero3.views(acc)):
            out[i] = v
    return out


def _rank_main(rank, port, shape, ref_dir, archs, q) -> None:
    import torch.distributed as dist
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import manual_dp as mdp
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=shape[0] * shape[1], rank=rank)
    try:
        mesh = make_mesh(shape, AXES)
        res = {}
        for arch in archs:
            model = model_of(arch)
            z = np.load(Path(ref_dir) / f"{arch}.npz")
            full = ref_tree(model, z, "param")
            out = {}
            for fsdp in (False, True):
                ctx = ShardingCtx(mesh, default_rules(fsdp=fsdp))
                params = tree_map(lambda t: t.clone(),
                                  shard_tree(full, model.defs, ctx))
                mb = rank_batch(z, ctx)
                lay = mdp.StepLayout(tree_leaves(params),
                                     mdp.split_leaves(model, ctx),
                                     shape[0], rank // shape[1])
                opt = mdp.init_shard_state(params, ctx=ctx, model=model)
                for name, flat in (("mu", opt.mu), ("nu", opt.nu)):
                    local = shard_tree(ref_tree(model, z, name), model.defs,
                                       ctx)
                    flat.copy_(lay.shard_of(tree_leaves(local)))
                opt = opt._replace(step=torch.tensor(WARM_STEP,
                                                     dtype=torch.int32))
                step = mdp.make_manual_dp_train_step(
                    model, AdamWConfig(**OPT), ctx=ctx)
                steps = []
                for _ in range(REF_STEPS):
                    params, opt, met = step(params, opt, mb)
                    steps.append({
                        "metrics": {k: float(v) for k, v in met.items()},
                        "params": [p.numpy().copy()
                                   for p in tree_leaves(params)],
                        "mu": opt.mu.numpy().copy(),
                        "nu": opt.nu.numpy().copy()})
                out[fsdp] = steps
            res[arch] = out
        q.put((shape, rank, res))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(layout, rank): {arch: {fsdp: the rank's steps}}}, once per
    session."""
    ref = shared_reference(tmp_path_factory)

    def build(out):
        got = spawn_all(_rank_main, [(d * m, ((d, m), str(ref), ARCHS))
                                     for d, m in LAYOUTS])
        with open(out / "runs.pkl", "wb") as f:
            pickle.dump({(shape, rank): res for shape, rank, res in got}, f)

    with open(session_cached(tmp_path_factory, "fsdp_runs", build)
              / "runs.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's train step under the fsdp rules at ``LAYOUTS``
    for ``JAX_ARCHS``, once per session (the shared reference's weights,
    batch and warm moments: the same seeds)."""
    jobs = {arch: [f"fsdp:{d}x{m}" for d, m in LAYOUTS]
            for arch in JAX_ARCHS}
    return session_cached(tmp_path_factory, "fsdp_ref",
                          lambda out: run_reference(out, jobs, REF_STEPS))


def _leaf_close(got, want, tol, what):
    want = np.asarray(want, np.float64)
    bound = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(np.asarray(got, np.float64) - want).max(initial=0.0))
    assert err <= bound, f"{what}: {err} > {bound}"


def _data_part(x, d, ctx):
    """The rank's part along "embed" of ``x`` (its slice of ParamDef
    ``d`` held whole over data)."""
    dim = ctx.embed_dim(d.axes, d.shape)
    if dim is None:
        return x
    lo, hi = ctx.range("embed", d.shape[dim])
    return np.take(x, range(lo, hi), axis=dim)


CASES = [(a, s) for a in ARCHS for s in LAYOUTS]
IDS = [f"{a}-{s[0]}x{s[1]}" for a, s in CASES]


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_fsdp_step_is_the_unsplit_step(arch, shape, runs):
    defs = tree_leaves(model_of(arch).defs)
    for rank in range(shape[0] * shape[1]):
        ctx = _ctx(shape, rank, True)
        got = runs[(shape, rank)][arch]
        for t, (a, b) in enumerate(zip(got[True], got[False])):
            what = f"{arch} {shape} rank {rank} step {t}"
            if t == 0:
                assert a["metrics"]["loss"] == b["metrics"]["loss"], what
            else:     # the weights of the steps' updates, ~1 ulp apart
                assert a["metrics"]["loss"] == pytest.approx(
                    b["metrics"]["loss"], rel=TOL_SELF, abs=0), what
            assert a["metrics"]["grad_norm"] == pytest.approx(
                b["metrics"]["grad_norm"], rel=TOL_SELF, abs=0), what
            for i, (d, p, q) in enumerate(zip(defs, a["params"],
                                              b["params"])):
                _leaf_close(p, _data_part(q, d, ctx), TOL_SELF,
                            f"{what} leaf {i} {d.axes}")


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_fsdp_moments_are_the_unsplit_ranges(arch, shape, runs):
    """Each rank's moments after each step: its bucket shard (the leaves
    held whole over data) and its fsdp shards, against the same elements
    of the unsplit step's moments (its data group's shards put
    together)."""
    from repro_torch.train.manual_dp import FlatLayout, StepLayout
    model = model_of(arch)
    defs = tree_leaves(model.defs)
    d_, m_ = shape
    for rank in range(d_ * m_):
        cf, cu = _ctx(shape, rank, True), _ctx(shape, rank, False)
        local_u = [torch.empty(cu.local_shape(d.axes, d.shape, d.parts))
                   for d in defs]
        local_f = [torch.empty(cf.local_shape(d.axes, d.shape, d.parts))
                   for d in defs]
        split = [cf.embed_dim(d.axes, d.shape) is not None for d in defs]
        mates = [dd * m_ + rank % m_ for dd in range(d_)]
        for t in range(REF_STEPS):
            for name in ("mu", "nu"):
                whole = np.concatenate([runs[(shape, r)][arch][False][t][
                    name] for r in mates])
                ulay = FlatLayout(local_u, d_, 0)
                want = [v.numpy().reshape(x.shape) for v, x in zip(
                    ulay.views(torch.from_numpy(whole)), local_u)]
                lay = StepLayout(local_f, split, d_, rank // m_)
                mine = torch.from_numpy(runs[(shape, rank)][arch][True][t][
                    name])
                fs = _moment_leaves(lay, mine)
                # the bucket's leaves: the data group's shards together
                bucket = torch.from_numpy(np.concatenate([
                    lay.moments(torch.from_numpy(runs[(shape, r)][arch][
                        True][t][name]))[0].numpy() for r in mates]))
                for i, v in zip(lay.main_idx, FlatLayout(
                        [local_f[i] for i in lay.main_idx], d_, 0).views(
                            bucket)):
                    fs[i] = v
                for i, (d, g, w) in enumerate(zip(defs, fs, want)):
                    _leaf_close(g.numpy().reshape(local_f[i].shape),
                                _data_part(w, d, cf), TOL_SELF,
                                f"{arch} {shape} rank {rank} step {t} "
                                f"{name} leaf {i}")


JAX_CASES = [(a, s) for a in JAX_ARCHS for s in LAYOUTS]


@pytest.mark.parametrize("arch,shape", JAX_CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in JAX_CASES])
def test_fsdp_step_matches_reference(arch, shape, runs, reference):
    """Against the JAX package's fsdp step; its reported loss is the
    cross-entropy without aux (these two families have none) over the
    global batch, the mean of the ranks' equal-sized microbatches."""
    defs = tree_leaves(model_of(arch).defs)
    z = np.load(Path(reference) / f"{arch}.npz")
    job = f"fsdp:{shape[0]}x{shape[1]}"
    for rank in range(shape[0] * shape[1]):
        ctx = _ctx(shape, rank, True)
        for t, step in enumerate(runs[(shape, rank)][arch][True]):
            for key in ("loss", "grad_norm", "lr"):
                assert step["metrics"][key] == pytest.approx(
                    float(z[f"{job}/{t}/{key}"]), rel=TOL_JAX,
                    abs=TOL_JAX), (arch, shape, rank, t, key)
            for i, (d, p) in enumerate(zip(defs, step["params"])):
                ref = torch.from_numpy(np.array(z[f"{job}/{t}/param/{i}"]))
                _leaf_close(p, ctx.shard(ref, d.axes, d.parts).numpy(),
                            TOL_JAX, f"{arch} {shape} rank {rank} step {t} "
                            f"param {i}")


# -------------------------------------------------------------- dry run
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-1.2b",
                                  "rwkv6-7b", "whisper-small"])
def test_dry_run_of_an_fsdp_train_cell_counts_the_gloo_run(arch):
    from repro_torch.configs import ShapeSuite
    from repro_torch.launch import dryrun
    suite = ShapeSuite("tp_train", 32, 8, "train")
    head = {"arch": arch, "shape": suite.name, "cards": 4, "model_axis": 2}
    fn, args, meta, comm = dryrun.model_axis_cell(
        _train_cfg(arch), suite, 4, 2, head,
        dryrun.layout_options({"fsdp": True}))
    res = dryrun.analyze_cell(fn, args, meta, comm)   # raises off the plan
    plan = comm.plan
    assert "fsdp" in meta["layout"]
    gathers = [c for c in plan if c["axis"] == "data"
               and c["op"] == "all_gather_into_tensor"]
    assert len(gathers) > 1           # the pieces' gathers and the step's
    got = {r: rest for r, *rest in spawn_all(
        _dry_rank, [(4, (arch, ((2, 2), {"fsdp": True})))])}
    counts, issued = got[0]
    assert counts["flops"] == res["cost"]["flops_per_device"]
    assert counts["bytes"] == res["cost"]["bytes_per_device"]
    assert counts["ops"] == res["cost"]["ops"]
    assert counts["kernels"] == res["kernels"]
    assert counts["memory"] == res["memory"]
    assert [(c["op"], c["dtype"], c["result_bytes"], c["group"])
            for c in plan] == issued


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_fsdp_cells_at_16x16_are_ok(shape):
    from repro_torch.launch import dryrun
    fn, args, meta, comm = dryrun.build_cell(
        "internlm2-1.8b", shape, cards=256, model=16,
        overrides={"fsdp": True})
    assert meta["status"] == "ok" and meta["mesh"] == "16x16"
    dryrun.analyze_cell(fn, args, meta, comm)          # raises off the plan
    assert comm.issued == comm.plan
    if shape == "train_4k":
        assert "fsdp" in meta["layout"]
        assert "ZeRO-3" in meta["layout_differences"]["dp_mode"]["reason"]
        _, _, plain, _ = dryrun.build_cell("internlm2-1.8b", shape,
                                           cards=256, model=16)
        # wo and w_down ("embed_out") stay whole over data
        assert meta["params_per_card"] < plain["params_per_card"] / 3
    else:
        assert "fsdp" not in meta["layout"]
