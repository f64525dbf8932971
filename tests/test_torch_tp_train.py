"""Training under the model axis in spawned gloo ranks on the CPU, against
the port's unsharded gradient and the JAX package's sharded training.

Once per session (``shared_reference``, which
``tests/test_torch_manual_dp_reference.py`` shares), two subprocesses per
arch (its gradient jobs, its manual_dp jobs) run the JAX package with 4
host devices, for
the f32 smoke configs of all six families (internlm2, zamba2, qwen2-moe,
qwen2-vl, rwkv6, whisper; its weights from ``Model.init``, cast to f32,
with RWKV6's zero-init ``w_lora_b`` drawn from a seed so that the
decay's LoRA has a gradient; Mamba2 and RWKV6 with f32 decay ratios, the
port's precision), and whisper-smoke cut to 2 heads (``HEADLESS``) at
(1, 4), on Auto
("data", "model") meshes with the parameters placed by ``model.specs``:
``jax.value_and_grad`` of ``make_loss_fn(jm, ShardingCtx(mesh, rules))``
on a seeded [4, 32] batch (whisper's with seeded frames) at (1, 2) and
(2, 2), and one ``make_manual_dp_train_step`` step at the
same two meshes from a warm optimizer state (seeded moments at step 3: a
step from zero moments turns the rounding of near-zero gradients into
whole learning-rate steps, g / (|g| + eps)). The port then runs the same
weights over (data, model) = (1, 2), (1, 4) and (2, 2) ranks, every
layout at once (the M = 4 layouts give internlm2-smoke's and
qwen2-vl-smoke's 2 kv heads to two ranks each, and qwen2-moe-smoke's 6
experts unevenly), then ``HEADLESS``' four ranks, two of them with no
heads, apart and with their own time limit:

* (a) every rank's loss, aux and gradient of every leaf (``sync_grads``:
  the data axis's sum, each duplicated kv head's sum over its holders)
  equal its slice of the port's unsharded gradient, within 1e-5 x
  max(1, max |g|) per leaf;
* (b) at (1, 2) and (2, 2) (``HEADLESS`` at (1, 4)), the JAX package's
  sharded gradient, within 1e-4 (the tolerance of the port's other
  model tests);
* (c) every element several ranks of the model axis hold (the norm
  weights, the router, ``fuse``, Mamba2's B and C columns of ``in_proj``
  and ``conv_w``, a kv head two ranks read, RWKV6's token-shift mixes,
  LoRA and per-channel vectors) has a bitwise equal gradient on each of
  them (a ``copy`` placed before RWKV6's ``mu`` / ``w_lora_a`` /
  ``mu_k`` / ``mu_r`` would leave their gradients a rank's partial sum,
  which (a) and (b) catch);
* (d) one ``manual_dp`` step at (2, 2) and (1, 2) (``HEADLESS`` at
  (1, 4)): the metrics (loss =
  cross-entropy + aux, grad norm), the updated parameters and the rank's
  moments (its slice over the model axis, the data ranks' ZeRO shards
  put together) against the reference's, within 1e-5.

Then (e) the dry run of the internlm2, zamba2, rwkv6 and whisper smoke
train cells at ``--cards 4 --model 2`` (remat on, 2 microbatches, so that the plan's
re-forward and per-microbatch collectives show): rank 0 of a gloo CPU
run of the same ``manual_dp`` step counts exactly the dry run's
operations, bytes, kernel calls and memory, and both issue
``model_axis_plan``'s collectives.
"""
import dataclasses
import multiprocessing
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from filelock import FileLock

from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models.param import shard_tree, tree_leaves, tree_unflatten
from repro_torch.models.sharding import NULL_CTX, ShardingCtx, default_rules

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["internlm2-1.8b", "zamba2-1.2b", "qwen2-moe-a2.7b", "qwen2-vl-7b",
         "rwkv6-7b", "whisper-small"]
LAYOUTS = [(1, 2), (1, 4), (2, 2)]
JAX_LAYOUTS = [(1, 2), (2, 2)]
# whisper-smoke cut to 2 heads (``arch:heads``, in both packages): at
# (1, 4) ranks 2 and 3 hold none; its ranks run apart, in their own time
HEADLESS = ("whisper-small:2", (1, 4))
B, S, WARM_STEP = 4, 32, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TOL_PORT, TOL_JAX, TOL_DP = 1e-5, 1e-4, 1e-5
TIMEOUT_S, HEADLESS_TIMEOUT_S = 300, 180
# the reference's manual_dp steps; its (data 2, model 1) job is
# tests/test_torch_manual_dp_reference.py's, for these archs
REF_STEPS = 2
DP_ONLY_ARCHS = ("internlm2-1.8b", "qwen2-moe-a2.7b")

# argv: out file, arch, manual_dp steps, then jobs "grad:DxM" / "dp:DxM"
# / "fsdp:DxM" (the reference's default dp_mode="auto" step under the
# fsdp rules) / "mp:PxDxM" (manual_dp with multi_pod=True)
JAX_SCRIPT = r"""
import dataclasses, functools, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.models import build_model, gla
from repro.models.model import Model
from repro.models.sharding import ShardingCtx, default_rules
from repro.optim import AdamWConfig, AdamWState
from repro.train.manual_dp import make_manual_dp_train_step
from repro.train.train_step import make_loss_fn, make_train_step
gla.gla_chunk = functools.partial(gla.gla_chunk, ratio_dtype=jnp.float32)
out, arch, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
B, S, WARM = 4, 32, 3
rules = default_rules()
name, _, heads = arch.partition(":")
jm = build_model(name, smoke=True)
if heads:
    jm = Model(dataclasses.replace(jm.cfg, n_heads=int(heads),
                                   n_kv_heads=int(heads)))
params = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                      jax.jit(jm.init)(jax.random.PRNGKey(0)))

def draw_lora_b(tree, rng):
    # RWKV6's w_lora_b is zero at init: drawn, the decay's LoRA (w_lora_a,
    # mu's decay row) gets a gradient. At std 0.1 the port's unsharded
    # f32 gradient itself drifts from its f64 one by more than the tests'
    # 1e-5, whatever the sharding; at 0.05 it stays well inside
    for k, v in tree.items():
        if isinstance(v, dict):
            draw_lora_b(v, rng)
        elif k == "w_lora_b":
            tree[k] = (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
draw_lora_b(params, np.random.default_rng(2))
leaves, tdef = jax.tree.flatten(params)
rng = np.random.default_rng(1)
toks = rng.integers(0, jm.cfg.vocab, (B, S), dtype=np.int32)
batch = {"tokens": toks, "targets": np.roll(toks, -1, 1)}
axes = {"tokens": ("batch", None), "targets": ("batch", None)}
mu = [(rng.standard_normal(x.shape) * 1e-3).astype(np.float32)
      for x in leaves]
nu = [((rng.random(x.shape) + 0.5) * 1e-4).astype(np.float32)
      for x in leaves]
if jm.cfg.family == "encdec":
    batch["frames"] = rng.standard_normal(
        (B, jm.cfg.enc_seq, jm.cfg.d_model)).astype(np.float32)
    axes["frames"] = ("batch", None, None)
res = dict(batch)
for name, tree in (("param", leaves), ("mu", mu), ("nu", nu)):
    for i, x in enumerate(tree):
        res[f"{name}/{i}"] = x
opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
for job in sys.argv[4:]:
    kind, shape = job.split(":")
    dims = [int(n) for n in shape.split("x")]
    names = ("pod", "data", "model")[-len(dims):]
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(dims))]).reshape(dims),
                names)
    rules = default_rules(kind == "mp", fsdp=kind == "fsdp")
    if kind == "grad":
        ctx = ShardingCtx(mesh, rules)
        placed = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params,
            jm.specs(rules, mesh), is_leaf=lambda x: isinstance(x, P))
        bp = {k: jax.device_put(v, NamedSharding(mesh, P("data", None)))
              for k, v in batch.items()}
        (tot, (loss, aux)), g = jax.jit(jax.value_and_grad(
            make_loss_fn(jm, ctx), has_aux=True))(placed, bp)
        res[f"{job}/loss"], res[f"{job}/aux"] = np.asarray(loss), np.asarray(aux)
        for i, x in enumerate(jax.tree.leaves(g)):
            res[f"{job}/grad/{i}"] = np.asarray(x)
        continue
    if kind == "fsdp":
        # the reference's dry run's train cell (src/repro/launch/
        # dryrun.py:121-139): moments and gradients on embed -> data
        named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                       is_leaf=lambda x: isinstance(x, P))
        zero = dict(rules, embed="data")
        mspecs, pspecs = jm.specs(zero, mesh), jm.specs(rules, mesh)
        opt_sh = AdamWState(NamedSharding(mesh, P()), named(mspecs),
                            named(mspecs))
        bsh = {k: NamedSharding(mesh, P("data", *([None] * (v.ndim - 1))))
               for k, v in batch.items()}
        step = jax.jit(make_train_step(jm, opt_cfg, ShardingCtx(mesh, rules),
                                       grad_specs=mspecs),
                       in_shardings=(named(pspecs), opt_sh, bsh),
                       out_shardings=(named(pspecs), opt_sh, None))
    else:
        step, _, _ = make_manual_dp_train_step(
            jm, opt_cfg, mesh, rules, axes, multi_pod=kind == "mp")
    p = jax.tree.map(np.copy, params)
    opt = AdamWState(np.int32(WARM), tdef.unflatten([x.copy() for x in mu]),
                     tdef.unflatten([x.copy() for x in nu]))
    for t in range(steps):
        p, opt, met = step(p, opt, batch)
        for key in ("loss", "grad_norm", "lr"):
            res[f"{job}/{t}/{key}"] = np.asarray(met[key])
        for name, tree in (("param", p), ("mu", opt.mu), ("nu", opt.nu)):
            for i, x in enumerate(jax.tree.leaves(tree)):
                res[f"{job}/{t}/{name}/{i}"] = np.asarray(x)
np.savez(out, **res)
"""


def run_reference(out: Path, jobs, steps: int) -> None:
    """``JAX_SCRIPT`` for each arch of ``jobs`` ({arch: its jobs}): one
    process per arch and kind of job, all at once, their results merged
    into ``out / f"{arch}.npz"``. XLA compiles at optimization level 0:
    each job runs once, on a few hundred tokens, so compiling is nearly
    all of its time."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_backend_optimization_level=0")
    kinds = sorted({j.split(":")[0] for arch_jobs in jobs.values()
                    for j in arch_jobs})
    parts = {(arch, kind): [j for j in arch_jobs
                            if j.split(":")[0] == kind]
             for arch, arch_jobs in jobs.items() for kind in kinds}
    parts = {key: part for key, part in parts.items() if part}
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(out / f"{arch}.{kind}.npz"),
         arch, str(steps), *part], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for (arch, kind), part in parts.items()]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for arch in jobs:
        merged = {}
        for kind in kinds:
            if (arch, kind) in parts:
                with np.load(out / f"{arch}.{kind}.npz") as z:
                    merged.update({k: z[k] for k in z.files})
        np.savez(out / f"{arch}.npz", **merged)


def session_cached(tmp_path_factory, name: str, build) -> Path:
    """A directory that ``build(dir)`` fills once per test session: in the
    session's temporary root, which xdist's workers share (the first to
    take the lock builds it, the others read it)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER") is not None:
        root = root.parent
    out = root / name
    with FileLock(f"{out}.lock"):
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            build(out)
            (out / "done").touch()
    return out


def shared_reference(tmp_path_factory) -> Path:
    """The JAX package's run for this file and for
    ``tests/test_torch_manual_dp_reference.py``, once per session: every
    arch's gradient and manual_dp jobs at ``jax_layouts``, and the
    ``DP_ONLY_ARCHS``' manual_dp at (data 2, model 1); ``REF_STEPS``
    steps each."""
    jobs = {arch: [f"{kind}:{d}x{m}" for kind in ("grad", "dp")
                   for d, m in jax_layouts(arch)]
            + (["dp:2x1"] if arch in DP_ONLY_ARCHS else [])
            for arch in ARCHS + [HEADLESS[0]]}
    return session_cached(tmp_path_factory, "tp_train_ref",
                          lambda out: run_reference(out, jobs, REF_STEPS))


def jax_layouts(arch):
    """The layouts the reference runs ``arch`` at (and the port's
    manual_dp step)."""
    return [HEADLESS[1]] if arch == HEADLESS[0] else JAX_LAYOUTS


def model_of(arch):
    """The smoke model of ``arch`` ("name" or "name:heads": its q and kv
    heads cut to ``heads``)."""
    from repro_torch.models import Model
    name, _, heads = arch.partition(":")
    model = build_model(name, smoke=True)
    if heads:
        model = Model(dataclasses.replace(model.cfg, n_heads=int(heads),
                                          n_kv_heads=int(heads)))
    return model


def ref_tree(model, z, prefix):
    """The npz's leaves ``prefix/i`` as a tree of ``model.defs``' shape."""
    leaves = [torch.from_numpy(np.array(z[f"{prefix}/{i}"]))
              for i in range(len(tree_leaves(model.defs)))]
    for x, d in zip(leaves, tree_leaves(model.defs)):
        assert tuple(x.shape) == d.shape
    return tree_unflatten(model.defs, leaves)


def free_ports(n: int) -> list:
    """``n`` distinct free ports, reserved together."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def spawn_all(target, runs, timeout=TIMEOUT_S):
    """``target(rank, port, *args, queue)`` for every (world, args) of
    ``runs``, every group at once on its own port; returns each run's
    items (one per rank, in arrival order), each within ``timeout``
    seconds."""
    mp = multiprocessing.get_context("spawn")
    q = mp.Queue()
    procs = []
    for port, (world, args) in zip(free_ports(len(runs)), runs):
        procs += [mp.Process(target=target, args=(r, port, *args, q))
                  for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = [q.get(timeout=timeout) for _ in procs]
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    return got


def rank_batch(z, ctx):
    """The rank's rows of the reference's batch (tokens, targets and
    whisper's frames)."""
    out = {k: ctx.shard(torch.from_numpy(z[k]).long(), ("batch", None))
           for k in ("tokens", "targets")}
    if "frames" in z.files:
        out["frames"] = ctx.shard(torch.from_numpy(z["frames"]),
                                  ("batch", None, None))
    return out


def warm_state(model, params, z, ctx, mdp):
    """The reference's warm moments at step 3 as this rank's ZeRO shard
    of its slices (``params``: the rank's)."""
    state = mdp.init_shard_state(params, ctx=ctx)
    lay = mdp.FlatLayout(params, ctx.size("batch"), ctx.index("batch"))
    for name, out in (("mu", state.mu), ("nu", state.nu)):
        local = shard_tree(ref_tree(model, z, name), model.defs, ctx)
        out.copy_(lay.mine(lay.flat(tree_leaves(local), torch.float32)))
    return state._replace(step=torch.tensor(WARM_STEP, dtype=torch.int32))


def _rank_main(rank, port, shape, ref_dir, archs, q) -> None:
    import torch.distributed as dist
    from repro_torch.train import manual_dp as mdp
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import (loss_and_grads, make_loss_fn,
                                              sync_grads)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=shape[0] * shape[1], rank=rank)
    try:
        ctx = ShardingCtx(make_mesh(shape, ("data", "model")),
                          default_rules())
        res = {}
        for arch in archs:
            model = model_of(arch)
            z = np.load(Path(ref_dir) / f"{arch}.npz")
            full = ref_tree(model, z, "param")
            mb = rank_batch(z, ctx)
            local = shard_tree(full, model.defs, ctx)
            grads, (_, loss, aux) = loss_and_grads(
                make_loss_fn(model, ctx), local, mb)
            grads = sync_grads(grads, model, ctx)
            out = {"loss": float(loss), "aux": float(aux),
                   "grads": [g.numpy() for g in grads]}
            if shape in jax_layouts(arch):
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
def reference(tmp_path_factory):
    return shared_reference(tmp_path_factory)


def _runs(tmp_path_factory, name, layouts, archs, timeout):
    """{(layout, rank): {arch: the rank's results}} of ``archs`` at each
    of ``layouts``, once per session."""
    def build(out):
        got = spawn_all(_rank_main, [(d * m, ((d, m), str(reference), archs))
                                     for d, m in layouts], timeout)
        with open(out / "runs.pkl", "wb") as f:
            pickle.dump({(shape, rank): res for shape, rank, res in got}, f)

    reference = shared_reference(tmp_path_factory)
    with open(session_cached(tmp_path_factory, name, build) / "runs.pkl",
              "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    return _runs(tmp_path_factory, "tp_train_runs", LAYOUTS, ARCHS,
                 TIMEOUT_S)


@pytest.fixture(scope="module")
def headless_runs(reference, tmp_path_factory):
    """``HEADLESS``' ranks, spawned apart with their own time limit (a
    rank with no heads that missed a collective would hang its group)."""
    return _runs(tmp_path_factory, "tp_train_headless", [HEADLESS[1]],
                 [HEADLESS[0]], HEADLESS_TIMEOUT_S)


def runs_of(request, arch):
    """The rank runs that hold ``arch``."""
    return request.getfixturevalue(
        "headless_runs" if arch == HEADLESS[0] else "runs")


@pytest.fixture(scope="module")
def unsharded(reference):
    from repro_torch.train.train_step import loss_and_grads, make_loss_fn
    out = {}
    for arch in ARCHS + [HEADLESS[0]]:
        model = model_of(arch)
        z = np.load(Path(reference) / f"{arch}.npz")
        batch = rank_batch(z, NULL_CTX)
        grads, (_, loss, aux) = loss_and_grads(
            make_loss_fn(model), ref_tree(model, z, "param"), batch)
        out[arch] = (float(loss), float(aux), grads)
    return out


def _ctx(shape, rank):
    return ShardingCtx(make_mesh(shape, ("data", "model"), rank=rank),
                       default_rules())


def _leaf_close(got, want, tol, what):
    want = np.asarray(want, np.float64)
    bound = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(np.asarray(got, np.float64) - want).max(initial=0.0))
    assert err <= bound, f"{what}: {err} > {bound}"


def _ids(cases):
    return [f"{a}-{s[0]}x{s[1]}" for a, s in cases]


GRAD_CASES = [(a, s) for a in ARCHS for s in LAYOUTS] + [HEADLESS]
DP_CASES = [(a, s) for a in ARCHS for s in JAX_LAYOUTS] + [HEADLESS]


@pytest.mark.parametrize("arch,shape", GRAD_CASES, ids=_ids(GRAD_CASES))
def test_rank_gradients_are_slices_of_the_unsharded_gradient(
        arch, shape, request, unsharded, reference):
    """(a), and (b) at the reference's meshes."""
    model = model_of(arch)
    runs = runs_of(request, arch)
    loss, aux, want = unsharded[arch]
    z = np.load(Path(reference) / f"{arch}.npz")
    job = f"grad:{shape[0]}x{shape[1]}"
    for rank in range(shape[0] * shape[1]):
        got, ctx = runs[(shape, rank)][arch], _ctx(shape, rank)
        assert got["loss"] == pytest.approx(loss, rel=TOL_PORT, abs=TOL_PORT)
        assert got["aux"] == pytest.approx(aux, rel=TOL_PORT, abs=TOL_PORT)
        if shape in jax_layouts(arch):
            assert got["loss"] == pytest.approx(float(z[f"{job}/loss"]),
                                                rel=TOL_JAX, abs=TOL_JAX)
            assert got["aux"] == pytest.approx(float(z[f"{job}/aux"]),
                                               rel=TOL_JAX, abs=TOL_JAX)
        for i, (d, g, w) in enumerate(zip(tree_leaves(model.defs),
                                          got["grads"], want)):
            what = f"{arch} {shape} rank {rank} leaf {i} {d.axes}"
            _leaf_close(g, ctx.shard(w, d.axes, d.parts).numpy(), TOL_PORT,
                        what)
            if shape in jax_layouts(arch):
                ref = torch.from_numpy(np.array(z[f"{job}/grad/{i}"]))
                _leaf_close(g, ctx.shard(ref, d.axes, d.parts).numpy(),
                            TOL_JAX, what + " vs JAX")
    if arch == "qwen2-moe-a2.7b":
        assert aux > 0


@pytest.mark.parametrize("shape", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_elements_held_by_several_ranks_get_equal_gradients(shape, request):
    """(c): per leaf, each global element that several ranks of one data
    group hold has bitwise the same gradient on every one of them (and
    on every copy one rank holds); at ``HEADLESS``' layout its ranks
    too."""
    d_, m_ = shape
    held = 0
    archs = ARCHS + ([HEADLESS[0]] if shape == HEADLESS[1] else [])
    for arch in archs:
        model = model_of(arch)
        runs = runs_of(request, arch)
        for data in range(d_):
            ranks = [data * m_ + j for j in range(m_)]
            for i, d in enumerate(tree_leaves(model.defs)):
                seen = {}
                for rank in ranks:
                    ctx = _ctx(shape, rank)
                    g = runs[(shape, rank)][arch]["grads"][i]
                    dim, mine, _ = ctx._holding(d.axes, d.shape, d.parts)
                    if dim is None:
                        cols = [(0, g)]
                    else:
                        cols = [(mine[k], np.take(g, k, axis=dim))
                                for k in range(len(mine))]
                    for key, col in cols:
                        if key in seen:
                            held += 1
                            assert np.array_equal(seen[key], col), (
                                arch, shape, i, d.axes, key)
                        else:
                            seen[key] = col
    assert held > 0


@pytest.mark.parametrize("arch,shape", DP_CASES, ids=_ids(DP_CASES))
def test_manual_dp_step_matches_reference(arch, shape, request, reference):
    """(d)."""
    from repro_torch.train.manual_dp import FlatLayout
    model = model_of(arch)
    runs = runs_of(request, arch)
    defs = tree_leaves(model.defs)
    z = np.load(Path(reference) / f"{arch}.npz")
    job = f"dp:{shape[0]}x{shape[1]}/0"
    d_, m_ = shape
    for rank in range(d_ * m_):
        got, ctx = runs[(shape, rank)][arch]["dp"], _ctx(shape, rank)
        for key in ("loss", "grad_norm", "lr"):
            assert got["metrics"][key] == pytest.approx(
                float(z[f"{job}/{key}"]), rel=TOL_DP, abs=TOL_DP), key
        for i, (d, p) in enumerate(zip(defs, got["params"])):
            ref = torch.from_numpy(np.array(z[f"{job}/param/{i}"]))
            _leaf_close(p, ctx.shard(ref, d.axes, d.parts).numpy(), TOL_DP,
                        f"{arch} {shape} rank {rank} param {i}")
        # the rank's moments: its data group's ZeRO shards put together
        mates = [dd * m_ + ctx.index("heads") for dd in range(d_)]
        local = tree_unflatten(model.defs, [
            torch.empty(ctx.local_shape(d.axes, d.shape, d.parts))
            for d in defs])
        lay = FlatLayout(local, d_, 0)
        for name in ("mu", "nu"):
            bucket = np.concatenate([runs[(shape, r)][arch]["dp"][name]
                                     for r in mates])
            views = lay.views(torch.from_numpy(bucket))
            for i, (d, v) in enumerate(zip(defs, views)):
                ref = torch.from_numpy(np.array(z[f"{job}/{name}/{i}"]))
                want = ctx.shard(ref, d.axes, d.parts).numpy()
                _leaf_close(v.numpy().reshape(want.shape), want, TOL_DP,
                            f"{arch} {shape} rank {rank} {name} {i}")


# ------------------------------------------------------------ the dry run
def _train_cfg(arch):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), remat=True,
                               microbatches=2)


def _dry_rank(rank, port, arch, *rest) -> None:
    """Rank ``rank`` of a (2, 2) gloo run of the smoke train cell's
    ``manual_dp`` step under ``analyze_step``, its collectives recorded
    as they are issued. ``rest``: the queue, after it optionally the
    layout (the mesh's shape, the reference's layout overrides; a shape
    of three: the multi-pod mesh)."""
    *layout, q = rest
    shape, overrides = layout[0] if layout else ((2, 2), {})
    import torch.distributed as dist
    from repro_torch.configs import ShapeSuite
    from repro_torch.kernels import _build
    from repro_torch.launch.dryrun import cell_rules
    from repro_torch.launch.step_analysis import analyze_step
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import manual_dp as mdp
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    try:
        axes = ("pod", "data", "model")[-len(shape):]
        issued = []

        def size(group):
            return dist.get_world_size(group)

        def quiet():
            # what torch.distributed runs around gloo's collective (its
            # reduce-scatter copies the result out) is the collective's,
            # neither an operation nor bytes of the step
            return _build.COUNTER.inside_kernel()

        class Recorded:
            def all_reduce(self, t, group=None, op=None):
                issued.append(("all_reduce", str(t.dtype), t.numel()
                               * t.element_size(), size(group)))
                kw = {} if op is None else {"op": op}
                with quiet():
                    dist.all_reduce(t, group=group, **kw)

            def reduce_scatter_tensor(self, out, inp, group=None):
                issued.append(("reduce_scatter_tensor", str(out.dtype),
                               out.numel() * out.element_size(), size(group)))
                with quiet():
                    dist.reduce_scatter_tensor(out, inp, group=group)

            def all_gather_into_tensor(self, out, inp, group=None):
                issued.append(("all_gather_into_tensor", str(out.dtype),
                               out.numel() * out.element_size(), size(group)))
                with quiet():
                    dist.all_gather_into_tensor(out, inp, group=group)

            def all_gather(self, out, t, group=None):
                issued.append(("all_gather", str(t.dtype), sum(
                    o.numel() * o.element_size() for o in out), size(group)))
                with quiet():
                    dist.all_gather(out, t, group=group)

        cfg = _train_cfg(arch)
        model = Model(cfg)
        suite = ShapeSuite("tp_train", 32, 8, "train")
        comm = Recorded()
        ctx = ShardingCtx(make_mesh(shape, axes),
                          cell_rules(cfg, suite, shape[-1],
                                     multi_pod=len(shape) == 3,
                                     **overrides), comm=comm)
        params = model.init(torch.Generator().manual_seed(0), ctx)
        toks = ctx.shard(torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab, (8, 32))), ("batch", None)).clone()
        batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
        if cfg.family == "encdec":
            batch["frames"] = torch.randn(toks.shape[0], cfg.enc_seq,
                                          cfg.d_model).bfloat16()
        step = mdp.make_manual_dp_train_step(model, AdamWConfig(),
                                             comm=comm, ctx=ctx)
        _, got = analyze_step(step, params, mdp.init_shard_state(
            params, ctx=ctx, model=model), batch)
        q.put((rank, {k: got[k] for k in ("flops", "bytes", "ops",
                                          "kernels", "memory")}, issued))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-1.2b", "rwkv6-7b",
                                  "whisper-small"])
def test_dry_run_of_a_model_axis_train_cell_counts_the_gloo_run(arch):
    from repro_torch.configs import ShapeSuite
    from repro_torch.launch import dryrun
    suite = ShapeSuite("tp_train", 32, 8, "train")
    head = {"arch": arch, "shape": suite.name, "cards": 4, "model_axis": 2}
    fn, args, meta, comm = dryrun.model_axis_cell(_train_cfg(arch), suite,
                                                  4, 2, head)
    res = dryrun.analyze_cell(fn, args, meta, comm)   # raises off the plan
    plan = comm.plan
    assert comm.issued == plan
    assert meta["mesh"] == "2x2" and meta["batch_per_card"] == 4
    kinds = [c["kind"] for c in plan[-3:]]
    assert kinds == ["reduce-scatter", "all-reduce", "all-gather"]
    assert [c["axis"] for c in plan[-3:]] == ["data", "data+model", "data"]
    got = {r: rest for r, *rest in spawn_all(_dry_rank, [(4, (arch,))])}
    counts, issued = got[0]
    assert counts["flops"] == res["cost"]["flops_per_device"]
    assert counts["bytes"] == res["cost"]["bytes_per_device"]
    assert counts["ops"] == res["cost"]["ops"]
    assert counts["kernels"] == res["kernels"]
    assert counts["memory"] == res["memory"]
    assert [(c["op"], c["dtype"], c["result_bytes"], c["group"])
            for c in plan] == issued
