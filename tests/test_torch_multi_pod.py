"""The multi-pod mesh ("pod", "data", "model") in the port, on the CPU:
the batch over ("pod", "data") for every cell and ``manual_dp``'s
reduce-scatter over "pod" then "data" (and gather back over "data" then
"pod"), with and without fsdp.

* ``make_mesh`` gives each rank a "pod+data" group (the batch's), pod
  major; a rank's batch rows are ``pod x data + data_index``'s, as the
  reference's ``axis_index`` order gives them.
* In four spawned gloo ranks, internlm2 and qwen2-moe's f32 smoke
  configs (``tests/test_torch_tp_train.py``'s session reference: its
  weights, batch and warm moments at step 3), two ``manual_dp`` steps at
  (pod, data, model) = (2, 2, 1) and (2, 1, 2), with and without fsdp,
  against the JAX package's ``make_manual_dp_train_step(multi_pod=True)``
  on the same Auto meshes of 4 host devices: the loss and grad norm
  within 1e-5 relative, the parameters within 1e-5 (and, without fsdp,
  the moments: the ranks' ZeRO shards, pod-major, put together).
* On the same four ranks, (2, 2, 1) against (data 4, model 1): the
  first step's loss bitwise (the same rows on each rank, the same sum of
  the four ranks' losses), the grad norm within 1e-6 relative (the
  bucket is reduce-scattered over "pod", then "data": another order of
  f32 sums).
* The dry run's multi-pod train cells at ``--cards 4`` (remat, 2
  microbatches) count a gloo rank 0's operations, bytes, kernels and
  memory exactly, its plan the collectives that rank issued.
* ``build_cell`` at ``--cards 512 --model 16 --multi-pod``, with and
  without fsdp: internlm2's train_4k and prefill_32k are "ok" on the
  mesh "pod2x16x16", their issued collectives the plan.
"""
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_tp_train import (OPT, REF_STEPS, WARM_STEP, _dry_rank,
                                 _leaf_close, _train_cfg, model_of,
                                 rank_batch, ref_tree, run_reference,
                                 session_cached, shared_reference, spawn_all)

from repro_torch.configs import SHAPE_SUITES
from repro_torch.launch.mesh import _axis_ranks, make_mesh
from repro_torch.models.param import shard_tree, tree_leaves, tree_map
from repro_torch.models.sharding import ShardingCtx, default_rules

ARCHS = ("internlm2-1.8b", "qwen2-moe-a2.7b")
POD_LAYOUTS = [(2, 2, 1), (2, 1, 2)]
FLAT = (4, 1)                      # the same ranks as one data axis
TOL_JAX, TOL_SELF = 1e-5, 1e-6
POD_AXES = ("pod", "data", "model")


def _axes(shape):
    return POD_AXES[-len(shape):]


def _ctx(shape, rank, fsdp=False):
    return ShardingCtx(make_mesh(shape, _axes(shape), rank=rank),
                       default_rules(len(shape) == 3, fsdp=fsdp))


# ---------------------------------------------------------------- layout
def test_pod_data_groups_and_batch_rows_are_pod_major():
    groups = _axis_ranks((2, 16, 16), 0, 2)
    assert len(groups) == 16 and all(len(g) == 32 for g in groups)
    assert groups[0] == [p * 256 + d * 16 for p in range(2)
                         for d in range(16)]
    for rank in (0, 17, 300, 511):
        ctx = _ctx((2, 16, 16), rank)
        pod, data = rank // 256, rank // 16 % 16
        assert ctx.size("batch") == 32
        assert ctx.index("batch") == pod * 16 + data
        group = ctx._group("batch")
        assert (group.axis, group.size) == ("pod+data", 32)
        rows = ctx.shard(torch.arange(64), ("batch",))
        assert rows.tolist() == [2 * (pod * 16 + data),
                                 2 * (pod * 16 + data) + 1]
    # a data axis of 1: the batch's group is the pod's
    assert _ctx((2, 1, 2), 3)._group("batch").axis == "pod"


# ------------------------------------------------------------ gloo steps
def _rank_main(rank, port, ref_dir, q) -> None:
    import torch.distributed as dist
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import manual_dp as mdp
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    try:
        meshes = {shape: make_mesh(shape, _axes(shape))
                  for shape in POD_LAYOUTS + [FLAT]}
        res = {}
        for arch in ARCHS:
            model = model_of(arch)
            z = np.load(Path(ref_dir) / f"{arch}.npz")
            full = ref_tree(model, z, "param")
            for shape, mesh in meshes.items():
                for fsdp in (False, True):
                    ctx = ShardingCtx(mesh, default_rules(len(shape) == 3,
                                                          fsdp=fsdp))
                    params = tree_map(lambda t: t.clone(),
                                      shard_tree(full, model.defs, ctx))
                    pod = shape[0] if len(shape) == 3 else 1
                    lay = mdp.StepLayout(
                        tree_leaves(params), mdp.split_leaves(model, ctx),
                        ctx.size("batch"), ctx.index("batch"), pod)
                    opt = mdp.init_shard_state(params, ctx=ctx, model=model)
                    for name, flat in (("mu", opt.mu), ("nu", opt.nu)):
                        local = shard_tree(ref_tree(model, z, name),
                                           model.defs, ctx)
                        flat.copy_(lay.shard_of(tree_leaves(local)))
                    opt = opt._replace(step=torch.tensor(
                        WARM_STEP, dtype=torch.int32))
                    step = mdp.make_manual_dp_train_step(
                        model, AdamWConfig(**OPT), ctx=ctx)
                    mb = rank_batch(z, ctx)
                    steps = []
                    for _ in range(REF_STEPS):
                        params, opt, met = step(params, opt, mb)
                        steps.append({
                            "metrics": {k: float(v) for k, v in met.items()},
                            "params": [p.numpy().copy()
                                       for p in tree_leaves(params)],
                            "mu": opt.mu.numpy().copy(),
                            "nu": opt.nu.numpy().copy()})
                    res[(arch, shape, fsdp)] = steps
        q.put((rank, res))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{rank: {(arch, mesh shape, fsdp): its steps}}, once per session."""
    ref = shared_reference(tmp_path_factory)

    def build(out):
        got = spawn_all(_rank_main, [(4, (str(ref),))])
        with open(out / "runs.pkl", "wb") as f:
            pickle.dump(dict(got), f)

    with open(session_cached(tmp_path_factory, "multi_pod_runs", build)
              / "runs.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's ``make_manual_dp_train_step(multi_pod=True)`` at
    ``POD_LAYOUTS``, once per session (the shared reference's seeds)."""
    jobs = {arch: ["mp:" + "x".join(map(str, s)) for s in POD_LAYOUTS]
            for arch in ARCHS}
    return session_cached(tmp_path_factory, "multi_pod_ref",
                          lambda out: run_reference(out, jobs, REF_STEPS))


CASES = [(a, s, f) for a in ARCHS for s in POD_LAYOUTS for f in (False,
                                                                  True)]


@pytest.mark.parametrize(
    "arch,shape,fsdp", CASES,
    ids=[f"{a}-{'x'.join(map(str, s))}-{'fsdp' if f else 'plain'}"
         for a, s, f in CASES])
def test_multi_pod_step_matches_reference(arch, shape, fsdp, runs,
                                          reference):
    from repro_torch.train.manual_dp import FlatLayout
    model = model_of(arch)
    defs = tree_leaves(model.defs)
    z = np.load(Path(reference) / f"{arch}.npz")
    job = "mp:" + "x".join(map(str, shape))
    data_ranks = shape[0] * shape[1]
    for rank in range(4):
        ctx = _ctx(shape, rank, fsdp)
        for t, step in enumerate(runs[rank][(arch, shape, fsdp)]):
            what = f"{arch} {shape} fsdp={fsdp} rank {rank} step {t}"
            for key in ("loss", "grad_norm", "lr"):
                assert step["metrics"][key] == pytest.approx(
                    float(z[f"{job}/{t}/{key}"]), rel=TOL_JAX,
                    abs=TOL_JAX), (what, key)
            for i, (d, p) in enumerate(zip(defs, step["params"])):
                ref = torch.from_numpy(np.array(z[f"{job}/{t}/param/{i}"]))
                _leaf_close(p, ctx.shard(ref, d.axes, d.parts).numpy(),
                            TOL_JAX, f"{what} param {i}")
            if fsdp:
                continue
            # the moments: the data ranks' shards, pod-major, together
            mates = [k * shape[2] + ctx.index("heads")
                     for k in range(data_ranks)]
            local = [torch.empty(ctx.local_shape(d.axes, d.shape, d.parts))
                     for d in defs]
            lay = FlatLayout(local, data_ranks, 0)
            for name in ("mu", "nu"):
                bucket = np.concatenate([runs[r][(arch, shape, fsdp)][t][
                    name] for r in mates])
                for i, (d, v) in enumerate(zip(defs, lay.views(
                        torch.from_numpy(bucket)))):
                    ref = torch.from_numpy(np.array(
                        z[f"{job}/{t}/{name}/{i}"]))
                    want = ctx.shard(ref, d.axes, d.parts).numpy()
                    _leaf_close(v.numpy().reshape(want.shape), want,
                                TOL_JAX, f"{what} {name} {i}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "fsdp"])
def test_pod_data_step_is_the_data_step(arch, fsdp, runs):
    """(pod 2, data 2) against (data 4) on the same ranks, each rank the
    same rows."""
    for rank in range(4):
        pods = runs[rank][(arch, POD_LAYOUTS[0], fsdp)]
        flat = runs[rank][(arch, FLAT, fsdp)]
        assert pods[0]["metrics"]["loss"] == flat[0]["metrics"]["loss"]
        for a, b in zip(pods, flat):
            for key in ("loss", "grad_norm"):
                assert a["metrics"][key] == pytest.approx(
                    b["metrics"][key], rel=TOL_SELF, abs=0), (arch, rank,
                                                              key)


# -------------------------------------------------------------- dry run
DRY = [("internlm2-1.8b", (2, 2, 1), False), ("internlm2-1.8b", (2, 2, 1),
                                              True),
       ("zamba2-1.2b", (2, 1, 2), True)]


@pytest.mark.parametrize(
    "arch,shape,fsdp", DRY,
    ids=[f"{a}-{'x'.join(map(str, s))}-{'fsdp' if f else 'plain'}"
         for a, s, f in DRY])
def test_dry_run_of_a_multi_pod_train_cell_counts_the_gloo_run(arch, shape,
                                                               fsdp):
    from repro_torch.configs import ShapeSuite
    from repro_torch.launch import dryrun
    suite = ShapeSuite("tp_train", 32, 8, "train")
    head = {"arch": arch, "shape": suite.name, "cards": 4,
            "model_axis": shape[2]}
    fn, args, meta, comm = dryrun.model_axis_cell(
        _train_cfg(arch), suite, 4, shape[2], head,
        dryrun.layout_options({"fsdp": fsdp}), multi_pod=True)
    res = dryrun.analyze_cell(fn, args, meta, comm)   # raises off the plan
    plan = comm.plan
    assert meta["mesh"] == "pod2x{}x{}".format(*shape[1:])
    steps = [c for c in plan if c["axis"] in ("pod", "data")
             and c["op"] in ("reduce_scatter_tensor",
                             "all_gather_into_tensor")]
    # the bucket over "pod" then "data" and back; the fsdp accumulators'
    # pieces over "pod" (none at a data axis of 1: nothing split)
    want = ["pod", "data", "pod", "data", "pod", "pod"] \
        if fsdp and shape[1] > 1 else ["pod", "data", "data", "pod"]
    assert [c["axis"] for c in steps[-len(want):]] == want
    got = {r: rest for r, *rest in spawn_all(
        _dry_rank, [(4, (arch, (shape, {"fsdp": fsdp})))])}
    counts, issued = got[0]
    assert counts["flops"] == res["cost"]["flops_per_device"]
    assert counts["bytes"] == res["cost"]["bytes_per_device"]
    assert counts["ops"] == res["cost"]["ops"]
    assert counts["kernels"] == res["kernels"]
    assert counts["memory"] == res["memory"]
    assert [(c["op"], c["dtype"], c["result_bytes"], c["group"])
            for c in plan] == issued


@pytest.mark.parametrize("shape,fsdp", [("train_4k", False),
                                        ("train_4k", True),
                                        ("prefill_32k", False)])
def test_multi_pod_cells_at_512_are_ok(shape, fsdp):
    from repro_torch.launch import dryrun
    fn, args, meta, comm = dryrun.build_cell(
        "internlm2-1.8b", shape, cards=512, model=16, multi_pod=True,
        overrides={"fsdp": fsdp})
    assert meta["status"] == "ok" and meta["mesh"] == "pod2x16x16"
    assert meta["batch_per_card"] * 32 == SHAPE_SUITES[shape].global_batch
    dryrun.analyze_cell(fn, args, meta, comm)          # raises off the plan
    assert comm.issued == comm.plan
    if shape == "train_4k":
        assert meta["layout"].startswith("manual_dp over (pod 2, data 16)")
        assert [c["axis"] for c in comm.plan if c["axis"] == "pod"] == \
            ["pod"] * (4 if fsdp else 2)
