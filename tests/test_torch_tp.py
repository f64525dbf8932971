"""Tensor- and expert-parallel serving in spawned gloo ranks on the CPU,
against the port's unsharded model and the JAX package's sharded forward.

One subprocess runs the JAX package with 4 host devices: for the f32
smoke configs of all six families (internlm2, zamba2, qwen2-moe,
qwen2-vl, rwkv6, whisper), its weights (``Model.init``, cast to f32),
then ``Model.forward`` under ``ShardingCtx`` on an Auto (data 2, model
2) mesh with the parameters placed by ``model.specs`` (Mamba2 and RWKV6
with f32 decay ratios, the port's precision): the prefill logits and
``aux`` of a [4, 32] batch (whisper's with seeded frames), and 4 decode
steps of seeded tokens, each step's input cache saved. The port then
runs the same weights over (data, model) = (1, 2), (1, 4) and (2, 2)
ranks (``models/sharding.py``; the M = 4 layouts give internlm2-smoke's
2 kv heads and qwen2-moe-smoke's 6 experts unevenly), and whisper-smoke
cut to 2 heads (``whisper-small:2``, in both packages) over (1, 4),
where ranks 2 and 3 hold no heads and call no attention kernel, each
decode step from the reference's saved cache cut to the rank's part, so
that every step is checked on the same inputs:

* against the port's unsharded forward on the whole inputs at 1e-5
  (f32; only the ranks' partial sums are added in another order), each
  decode step from that cache in f32;
* against the JAX package's sharded forward at 1e-4 (the tolerance of
  the port's other model tests, ``tests/test_torch_lm.py``), each decode
  step from the bf16 cache the reference keeps.

The greedy tokens (the all-gathered argmax of ``serve_step.greedy``)
equal the unsharded ones and the reference's, every step and over 4
free-running decode steps from each run's own caches. Why the steps
start from one saved cache, and the 1e-5 check from it in f32: a partial
sum added in another order can round a new K/V entry to the
neighbouring bf16 value, which moves the logits by up to ~1e-4 in both
packages alike (the decode writes its token's K/V in the cache's
dtype).

Then the dry run of the internlm2, zamba2, rwkv6 and whisper smoke
prefill at ``--cards 4 --model 2``, and of internlm2-smoke's decode at
``--cards 4 --model 4`` (its 2 kv heads fewer than the model axis: the
cache's sequence split round-robin over it, 33 positions, rank 0 writing
the token at position 32): rank 0 of a gloo CPU run of the same step
(bf16, its collectives real) counts exactly the dry run's operations,
bytes, aten ops, kernel calls and memory, and both issue
``model_axis_plan``'s collectives.
"""
import dataclasses
import json
import multiprocessing
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.models import build_model
from repro_torch.models.convert import from_reference
from repro_torch.models.param import shard_tree, tree_map
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.sharding import NULL_CTX, ShardingCtx, default_rules

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["internlm2-1.8b", "zamba2-1.2b", "qwen2-moe-a2.7b", "qwen2-vl-7b",
         "rwkv6-7b", "whisper-small"]
LAYOUTS = [(1, 2), (1, 4), (2, 2)]
# whisper-smoke cut to 2 heads (``arch:heads``): at (1, 4) ranks 2 and 3
# hold none
HEADLESS = ("whisper-small:2", (1, 4))
CASES = [(arch, shape) for arch in ARCHS for shape in LAYOUTS] + [HEADLESS]
B, P, T = 4, 32, 4
TOL_PORT, TOL_JAX = 1e-5, 1e-4

_JAX_SCRIPT = r"""
import dataclasses, functools, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.models import build_model, gla
from repro.models.model import Model
from repro.models.sharding import ShardingCtx, default_rules
gla.gla_chunk = functools.partial(gla.gla_chunk, ratio_dtype=jnp.float32)

def model_of(arch):
    name, _, heads = arch.partition(":")
    jm = build_model(name, smoke=True)
    if heads:
        jm = Model(dataclasses.replace(jm.cfg, n_heads=int(heads),
                                       n_kv_heads=int(heads)))
    return jm
out = sys.argv[1]
B, P_, T = (int(a) for a in sys.argv[2:5])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
rules = default_rules()
ctx = ShardingCtx(mesh, rules)

def flat(tree, prefix, into):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, f"{prefix}/{k}", into)
    elif tree.dtype == jnp.bfloat16:          # kept bit for bit
        into[prefix + "@bf16"] = np.asarray(tree).view(np.int16)
    else:
        into[prefix] = np.asarray(tree)

def pad(c):
    if isinstance(c, dict):
        return {k: (pad(v) if isinstance(v, dict) or k not in ("k", "v")
                    else np.pad(np.asarray(v), [(0, 0), (0, 0), (0, T),
                                                (0, 0), (0, 0)]))
                for k, v in c.items()}
    return np.asarray(c)

for arch in sys.argv[5:]:
    jm = model_of(arch)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jax.jit(jm.init)(jax.random.PRNGKey(0)))
    placed = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params,
        jm.specs(rules, mesh), is_leaf=lambda x: isinstance(x, P))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jm.cfg.vocab, (B, P_), dtype=np.int32)
    feed = rng.integers(0, jm.cfg.vocab, (B, T), dtype=np.int32)
    res = {"tokens": toks, "feed": feed}
    pre = {"tokens": toks}
    if jm.cfg.family == "encdec":
        res["frames"] = pre["frames"] = rng.standard_normal(
            (B, jm.cfg.enc_seq, jm.cfg.d_model)).astype(np.float32)
    flat(params, "params", res)
    prefill = jax.jit(lambda p, b: jm.forward(p, b, mode="prefill",
                                              ctx=ctx))
    decode = jax.jit(lambda p, c, t, i: jm.forward(
        p, {"tokens": t}, mode="decode", cache=c, cache_index=i, ctx=ctx))
    logits, cache, aux = prefill(placed, pre)
    res["logits"], res["aux"] = np.asarray(logits[:, -1]), np.asarray(aux)
    cache = pad(cache)
    for i in range(T):
        flat(cache, f"cache{i}", res)
        lg, cache, a = decode(placed, cache, feed[:, i:i + 1],
                              jnp.int32(P_ + i))
        cache = jax.tree.map(np.asarray, cache)
        res[f"logits{i}"], res[f"aux{i}"] = np.asarray(lg[:, 0]), np.asarray(a)
    np.savez(f"{out}/{arch}.npz", **res)
"""


def _nest(npz, prefix):
    """The arrays under ``prefix/`` as nested dicts (bf16 ones, saved as
    their bits, as ml_dtypes' bf16: ``from_reference`` takes those)."""
    import ml_dtypes
    out = {}
    for key in npz.files:
        if not key.startswith(prefix + "/"):
            continue
        node, parts = out, key.split("/")[1:]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        name, bf16 = parts[-1].removesuffix("@bf16"), key.endswith("@bf16")
        node[name] = npz[key].view(ml_dtypes.bfloat16) if bf16 else npz[key]
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's sharded runs, one npz per arch."""
    out = tmp_path_factory.mktemp("tp_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    got = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(out), str(B), str(P),
         str(T), *ARCHS, HEADLESS[0]], capture_output=True, text=True,
        env=env,
        timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    return out


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


def archs_at(shape):
    """The archs a layout runs."""
    return ARCHS + ([HEADLESS[0]] if shape == HEADLESS[1] else [])


def _load(ref_dir, arch):
    """(model, full f32 params, the reference's arrays)."""
    z = np.load(Path(ref_dir) / f"{arch}.npz")
    model = model_of(arch)
    return model, from_reference(model.defs, _nest(z, "params")), z


def _steps(model, params, z, ctx):
    """This rank's part of: the prefill's last-position logits, aux and
    greedy token, and per decode step (from the reference's cache of that
    step) the logits, aux and greedy token; then the greedy tokens of 4
    free-running decode steps from its own caches."""
    from repro_torch.examples.serve_lm import fill_cache
    from repro_torch.train.serve_step import (greedy, make_decode_step,
                                              make_prefill_step)
    rows = ("batch", None)
    toks = ctx.shard(torch.from_numpy(z["tokens"]).long(), rows)
    feed = ctx.shard(torch.from_numpy(z["feed"]).long(), rows)
    pre = {"tokens": toks}
    if "frames" in z.files:
        pre["frames"] = ctx.shard(torch.from_numpy(z["frames"]),
                                  rows + (None,))
    logits, cache, aux = model.forward(params, pre, mode="prefill", ctx=ctx)
    out = {"logits": [logits[:, -1]], "aux": [aux],
           "greedy": [greedy(model, logits[:, -1], ctx)]}
    out["logits32"] = [logits[:, -1]]
    cdefs = model.cache_defs(B, P + T)
    for i in range(T):
        # fresh copies: a decode updates its cache in place
        full = _nest(z, f"cache{i}")
        for key, cache in (("logits", from_reference(cdefs, full)),
                           ("logits32", tree_map(lambda t: t.float(),
                                                 from_reference(cdefs,
                                                                full)))):
            lg, _, a = model.forward(params, {"tokens": feed[:, i:i + 1]},
                                     mode="decode",
                                     cache=shard_tree(cache, cdefs, ctx),
                                     cache_index=P + i, ctx=ctx)
            out[key].append(lg[:, 0])
            if key == "logits":
                out["aux"].append(a)
                out["greedy"].append(greedy(model, lg[:, 0], ctx))
    tok, filled = make_prefill_step(model, ctx)(params, pre)
    cache = fill_cache(model.init_cache(B, P + T, "cpu", ctx), filled)
    decode, free = make_decode_step(model, ctx), [tok]
    for i in range(T):
        tok, _, cache = decode(params, cache, free[-1][:, None], P + i)
        free.append(tok)
    out["free"] = free
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, port, shape, ref_dir, q) -> None:
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import ShardingCtx, default_rules
    torch.set_num_threads(1)
    world = shape[0] * shape[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    calls, attention = [], flash_ops.attention

    def counted(*a, **kw):
        calls.append(1)
        return attention(*a, **kw)
    flash_ops.attention = counted
    try:
        mesh = make_mesh(shape, ("data", "model"))
        ctx = ShardingCtx(mesh, default_rules())
        res = {}
        for arch in archs_at(shape):
            model, params, z = _load(ref_dir, arch)
            calls.clear()
            got = _steps(model, shard_tree(params, model.defs, ctx), z, ctx)
            got["flash_calls"] = [len(calls)]
            # every rank takes part in the gathers; model rank 0 reports
            for key in ("logits", "logits32"):
                got[key] = [model.gather_logits(lg, ctx).numpy()
                            for lg in got[key]]
            res[arch] = {k: [np.asarray(t) for t in v]
                         for k, v in got.items()}
        q.put((mesh.coord("data"), mesh.coord("model"), res))
    finally:
        flash_ops.attention = attention
        dist.destroy_process_group()


def _spawn(target, world, *args):
    """``target(rank, port, *args, queue)`` in ``world`` spawned ranks;
    returns what each put on the queue (one item per rank)."""
    ctx = multiprocessing.get_context("spawn")
    q, port = ctx.Queue(), _free_port()
    procs = [ctx.Process(target=target, args=(r, port, *args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = [q.get(timeout=300) for _ in range(world)]
    finally:
        for p in procs:
            p.join(60)
    assert all(p.exitcode == 0 for p in procs)
    return got


@pytest.fixture(scope="module")
def tp_runs(reference):
    """{layout: {arch: each output, the data ranks' rows concatenated;
    "flash_calls": each model rank's attention calls}}, one layout at a
    time."""
    runs = {}
    for shape in LAYOUTS:
        got = _spawn(_rank_main, shape[0] * shape[1], shape, str(reference))
        rows = sorted(((d, res) for d, m, res in got if m == 0),
                      key=lambda x: x[0])
        archs = archs_at(shape)
        runs[shape] = {arch: {k: [np.concatenate([r[arch][k][i]
                                                  for _, r in rows])
                                  for i in range(len(rows[0][1][arch][k]))]
                              for k in ("logits", "logits32", "greedy",
                                        "free")}
                       for arch in archs}
        for arch in archs:              # aux: equal on every rank
            auxes = {tuple(float(a) for a in res[arch]["aux"])
                     for _, _, res in got}
            assert len(auxes) == 1, (shape, arch, auxes)
            runs[shape][arch]["aux"] = list(auxes.pop())
            runs[shape][arch]["flash_calls"] = {
                m: int(res[arch]["flash_calls"][0]) for d, m, res in got
                if d == 0}
    return runs


@pytest.fixture(scope="module")
def unsharded(reference):
    """The port's unsharded run of the same steps."""
    out = {}
    for arch in ARCHS + [HEADLESS[0]]:
        model, params, z = _load(reference, arch)
        got = _steps(model, params, z, NULL_CTX)
        out[arch] = {k: [np.asarray(t, dtype=np.float64 if k == "aux"
                                    else None) for t in v]
                     for k, v in got.items()}
    return out


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}" if isinstance(c, tuple)
                         else c)
def test_tp_serving_matches_unsharded_and_reference(arch, shape, tp_runs,
                                                    unsharded, reference):
    got, want = tp_runs[shape][arch], unsharded[arch]
    z = np.load(Path(reference) / f"{arch}.npz")
    jax_logits = [z["logits"]] + [z[f"logits{i}"] for i in range(T)]
    jax_aux = [z["aux"]] + [z[f"aux{i}"] for i in range(T)]
    for i in range(T + 1):
        what = f"{arch} {shape} {'prefill' if i == 0 else f'step {i}'}"
        _close(got["logits32"][i], want["logits32"][i], TOL_PORT, what)
        _close(got["aux"][i], want["aux"][i], TOL_PORT, what + " aux")
        _close(got["logits"][i], jax_logits[i], TOL_JAX, what + " vs JAX")
        _close(got["aux"][i], jax_aux[i], TOL_JAX, what + " aux vs JAX")
        np.testing.assert_array_equal(got["greedy"][i], want["greedy"][i])
        np.testing.assert_array_equal(got["greedy"][i],
                                      jax_logits[i].argmax(-1))
    for a, b in zip(got["free"], want["free"]):
        np.testing.assert_array_equal(a, b)
    if arch == "qwen2-moe-a2.7b":
        assert got["aux"][0] > 0
    calls = got["flash_calls"]
    if model_of(arch).cfg.family == "encdec":
        # a rank holding no heads calls no attention kernel
        heads = [len(ShardingCtx(make_mesh(shape, ("data", "model"),
                                           rank=m), default_rules())
                     .indices("heads", model_of(arch).cfg.n_heads))
                 for m in range(shape[1])]
        assert [calls[m] > 0 for m in range(shape[1])] == [
            h > 0 for h in heads], (calls, heads)
        assert (0 in heads) == (arch == HEADLESS[0])


# ------------------------------------------------------------ the dry run
# (arch, kind): the smoke prefill at (2, 2), and a decode whose cache's
# sequence the rules split at (1, 4)
DRY_CELLS = [(arch, "prefill") for arch in ("internlm2-1.8b", "zamba2-1.2b",
                                            "rwkv6-7b", "whisper-small")]
DRY_CELLS.append(("internlm2-1.8b", "decode"))


def _dry_suite(kind):
    """(the cell's suite, its mesh)."""
    from repro_torch.configs import ShapeSuite
    if kind == "decode":
        return ShapeSuite("tp_decode", 33, 4, "decode"), (1, 4)
    return ShapeSuite("tp_prefill", 32, 4, "prefill"), (2, 2)


def _dry_rank(rank, port, arch, kind, q) -> None:
    """Rank ``rank`` of a gloo run of the smoke cell (``_dry_suite``)
    under ``analyze_step``, its collectives recorded as they are
    issued."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.step_analysis import analyze_step
    from repro_torch.models.sharding import ShardingCtx
    from repro_torch.launch.dryrun import cell_rules
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    try:
        issued = []

        class Recorded:
            def all_reduce(self, t, group=None, op=None):
                issued.append(("all_reduce", t.dtype, t.numel()
                               * t.element_size(), dist.get_world_size(group)))
                dist.all_reduce(t, group=group,
                                **({} if op is None else {"op": op}))

            def all_gather(self, out, t, group=None):
                issued.append(("all_gather", t.dtype, sum(
                    o.numel() * o.element_size() for o in out),
                    dist.get_world_size(group)))
                dist.all_gather(out, t, group=group)

        model = build_model(arch, smoke=True)
        suite, shape = _dry_suite(kind)
        ctx = ShardingCtx(make_mesh(shape, ("data", "model")),
                          cell_rules(model.cfg, suite, shape[1]),
                          comm=Recorded())
        params = model.init(torch.Generator().manual_seed(0), ctx)
        rows = ("batch", None)
        if kind == "decode":
            cache = model.init_cache(4, suite.seq_len, "cpu", ctx)
            token = ctx.shard(torch.from_numpy(np.random.default_rng(
                5).integers(0, model.cfg.vocab, (4, 1))), rows).clone()
            _, got = analyze_step(make_decode_step(model, ctx), params,
                                  cache, token, suite.seq_len - 1)
            q.put((rank, {k: got[k] for k in ("flops", "bytes", "ops",
                                              "kernels", "memory")},
                   [(op, str(dt), n, g) for op, dt, n, g in issued]))
            return
        toks = ctx.shard(torch.from_numpy(np.random.default_rng(5).integers(
            0, model.cfg.vocab, (4, 32))), rows).clone()
        batch = {"tokens": toks}
        if model.cfg.family == "encdec":
            batch["frames"] = torch.randn(2, model.cfg.enc_seq,
                                          model.cfg.d_model).bfloat16()
        _, got = analyze_step(make_prefill_step(model, ctx), params, batch)
        q.put((rank, {k: got[k] for k in ("flops", "bytes", "ops",
                                          "kernels", "memory")},
               [(op, str(dt), n, g) for op, dt, n, g in issued]))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,kind", DRY_CELLS,
                         ids=[a if k == "prefill" else f"{a}-decode-kv_seq"
                              for a, k in DRY_CELLS])
def test_dry_run_of_a_model_axis_cell_counts_the_gloo_run(arch, kind):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    suite, shape = _dry_suite(kind)
    head = {"arch": arch, "shape": suite.name, "cards": 4,
            "model_axis": shape[1]}
    fn, args, meta, comm = dryrun.model_axis_cell(get_smoke_config(arch),
                                                  suite, 4, shape[1], head)
    res = dryrun.analyze_cell(fn, args, meta, comm)   # raises off the plan
    plan = comm.plan
    assert comm.issued == plan and len(plan) > 2
    assert meta["mesh"] == f"{shape[0]}x{shape[1]}"
    assert meta["batch_per_card"] == 4 // shape[0]
    if kind == "decode":
        # per layer the token's gather and the log-sum-exp's three
        # all-reduces before the attention's and the MLP's
        assert [c["kind"] for c in plan[1:7]] == [
            "all-gather"] + ["all-reduce"] * 5
        assert "round-robin over model" in meta["layout"]
    got = {r: rest for r, *rest in _spawn(_dry_rank, 4, arch, kind)}
    counts, issued = got[0]
    assert counts["flops"] == res["cost"]["flops_per_device"]
    assert counts["bytes"] == res["cost"]["bytes_per_device"]
    assert counts["ops"] == res["cost"]["ops"]
    assert counts["kernels"] == res["kernels"]
    assert counts["memory"] == res["memory"]
    assert [(c["op"], c["dtype"], c["result_bytes"], c["group"])
            for c in plan] == issued
    assert json.dumps(res["collectives"])         # the cell's JSON
    wire = res["collective_wire_bytes_per_device"]
    group = shape[1]
    assert wire == sum(c["result_bytes"] * (
        2 * (group - 1) / group if c["op"] == "all_reduce"
        else (group - 1) / group) for c in plan)
