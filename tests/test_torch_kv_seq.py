"""The K/V cache's sequence split over ranks ("kv_seq", round-robin) in
spawned gloo ranks on the CPU, against the port's unsharded model and the
JAX package's forward under the same rules.

One subprocess runs the JAX package with 4 host devices, as
``tests/test_torch_tp.py`` does: for each smoke config its weights
(``Model.init``, cast to f32), then ``Model.forward`` under
``ShardingCtx`` with the reference's cell rules
(``src/repro/launch/dryrun.py:86-93``) — "kv_seq" on "model" on a (1, 4)
mesh for internlm2-smoke and qwen2-vl-smoke (2 kv heads < 4) and
whisper-smoke cut to 2 heads (``whisper-small:2``), the batch whole and
"kv_seq" on "data" on a (2, 2) mesh for zamba2-smoke (long_500k) — each
decode step's cache placed by its specs, so that the reference writes
its sharded cache with its one-hot masked update
(``src/repro/models/blocks.py:99-110``). The port then runs the same
weights over (1, 4) (ranks 2 and 3 of whisper-small:2 hold no heads but
hold cache positions), and zamba2 over (2, 1) and (2, 2), each decode
step from the reference's saved cache cut to the rank's round-robin
positions:

* against the port's unsharded forward at 1e-5 (f32 caches);
* against the JAX package's at 1e-4 (the bf16 caches it keeps);
* the greedy tokens equal the unsharded run's every step and over 4
  free-running decode steps from ``fill_cache``.

Unit cases without processes: round-robin ``indices`` with uneven
counts, a cache leaf holding its kv heads whole where "kv_seq" shares
their mesh axis, the raise where the kv heads are as many as the ranks
on one axis, and the prefill cache's ``all_to_all`` bitwise the unsplit
cache cut to each rank's positions.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models.param import local_defs, tree_leaves
from repro_torch.models.sharding import NULL_CTX, ShardingCtx, default_rules
from test_torch_tp import B, P, T, _close, _load, _spawn, _steps, model_of

ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
# (arch, the rule: "model" for prefill / decode with kv heads < the model
# axis, "data" for long_500k) and the layouts each runs
ON_MODEL = ["internlm2-1.8b", "qwen2-vl-7b", "whisper-small:2"]
CASES = ([(arch, (1, 4)) for arch in ON_MODEL]
         + [("zamba2-1.2b", (2, 1)), ("zamba2-1.2b", (2, 2))])
TOL_PORT, TOL_JAX = 1e-5, 1e-4


def rules_for(rule: str):
    """The reference's cell rules (``launch.dryrun.cell_rules``)."""
    rules = default_rules()
    if rule == "data":
        rules["batch"] = None
    rules["kv_seq"] = rule
    return rules


def rule_of(arch: str) -> str:
    return "model" if arch in ON_MODEL else "data"


_JAX_SCRIPT = r"""
import dataclasses, functools, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.models import build_model, gla
from repro.models.model import Model
from repro.models.param import tree_specs
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

def place(tree, specs, mesh):
    return jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                        tree, specs, is_leaf=lambda x: isinstance(x, P))

for item in sys.argv[5:]:
    arch, rule = item.split("@")
    shape = (1, 4) if rule == "model" else (2, 2)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))
    rules = default_rules()
    if rule == "data":
        rules["batch"] = None
    rules["kv_seq"] = rule
    ctx = ShardingCtx(mesh, rules)
    jm = model_of(arch)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jax.jit(jm.init)(jax.random.PRNGKey(0)))
    placed = place(params, jm.specs(rules, mesh), mesh)
    cache_specs = tree_specs(jm.cache_defs(B, P_ + T), rules, mesh)
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
    res["logits"] = np.asarray(logits[:, -1])
    cache = pad(cache)
    for i in range(T):
        flat(cache, f"cache{i}", res)
        lg, cache, _ = decode(placed, place(cache, cache_specs, mesh),
                              feed[:, i:i + 1], jnp.int32(P_ + i))
        cache = jax.tree.map(np.asarray, cache)
        res[f"logits{i}"] = np.asarray(lg[:, 0])
    np.savez(f"{out}/{arch}.npz", **res)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's runs under the kv_seq rules, one npz per arch."""
    out = tmp_path_factory.mktemp("kv_seq_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    archs = dict.fromkeys(arch for arch, _ in CASES)
    got = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(out), str(B), str(P),
         str(T), *(f"{a}@{rule_of(a)}" for a in archs)],
        capture_output=True, text=True, env=env, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    return out


def _rank_main(rank, port, shape, archs, ref_dir, q) -> None:
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.param import shard_tree
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=shape[0] * shape[1], rank=rank)
    calls, attention = [], flash_ops.attention

    def counted(*a, **kw):
        calls.append(1)
        return attention(*a, **kw)
    flash_ops.attention = counted
    try:
        mesh = make_mesh(shape, AXES)
        res = {}
        for arch in archs:
            ctx = ShardingCtx(mesh, rules_for(rule_of(arch)))
            model, params, z = _load(ref_dir, arch)
            calls.clear()
            got = _steps(model, shard_tree(params, model.defs, ctx), z, ctx)
            for key in ("logits", "logits32"):
                got[key] = [model.gather_logits(lg, ctx).numpy()
                            for lg in got[key]]
            out = {k: [np.asarray(t) for t in v] for k, v in got.items()}
            out["flash_calls"] = len(calls)
            out["cache"] = [tuple(t.shape) for t in tree_leaves(
                model.init_cache(B, P + T, "cpu", ctx))]
            res[arch] = out
        q.put((mesh.coord("data"), mesh.coord("model"), res))
    finally:
        flash_ops.attention = attention
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(reference):
    """{(arch, layout): rank (0, 0)'s outputs, and every rank's cache
    shapes and attention calls}, one layout at a time."""
    out = {}
    for shape in dict.fromkeys(s for _, s in CASES):
        archs = [a for a, s in CASES if s == shape]
        got = _spawn(_rank_main, shape[0] * shape[1], shape, archs,
                     str(reference))
        for arch in archs:
            first = next(res[arch] for d, m, res in got if d == m == 0)
            out[(arch, shape)] = dict(
                first, ranks={(d, m): (res[arch]["cache"],
                                       res[arch]["flash_calls"])
                              for d, m, res in got})
    return out


@pytest.fixture(scope="module")
def unsharded(reference):
    out = {}
    for arch in dict.fromkeys(a for a, _ in CASES):
        model, params, z = _load(reference, arch)
        out[arch] = {k: [np.asarray(t) for t in v]
                     for k, v in _steps(model, params, z, NULL_CTX).items()}
    return out


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}" if isinstance(c, tuple)
                         else c)
def test_split_cache_serving_matches_unsharded_and_reference(
        arch, shape, runs, unsharded, reference):
    got, want = runs[(arch, shape)], unsharded[arch]
    z = np.load(Path(reference) / f"{arch}.npz")
    jax_logits = [z["logits"]] + [z[f"logits{i}"] for i in range(T)]
    for i in range(T + 1):
        what = f"{arch} {shape} {'prefill' if i == 0 else f'step {i}'}"
        _close(got["logits32"][i], want["logits32"][i], TOL_PORT, what)
        _close(got["logits"][i], jax_logits[i], TOL_JAX, what + " vs JAX")
        np.testing.assert_array_equal(got["greedy"][i], want["greedy"][i])
        np.testing.assert_array_equal(got["greedy"][i],
                                      jax_logits[i].argmax(-1))
    for a, b in zip(got["free"], want["free"]):
        np.testing.assert_array_equal(a, b)
    # every rank holds its round-robin positions of the cache, with its kv
    # heads whole where the sequence shares their axis; a rank holding no
    # heads holds positions and calls no attention kernel
    model = model_of(arch)
    for (d, m), (caches, calls) in got["ranks"].items():
        ctx = ShardingCtx(make_mesh(shape, AXES, rank=d * shape[1] + m),
                          rules_for(rule_of(arch)))
        defs = local_defs(model.cache_defs(B, P + T), ctx)
        assert caches == [d_.shape for d_ in tree_leaves(defs)]
        heads = len(ctx.indices("heads", model.cfg.n_heads))
        assert (calls > 0) == (heads > 0), ((d, m), calls, heads)
        if arch == "whisper-small:2":
            k = caches[1]                            # "k": [L, B, S, H, hd]
            assert k[2] == len(range(m, P + T, 4)) and k[3] == 2
    if arch == "whisper-small:2":
        assert [got["ranks"][(0, m)][1] > 0 for m in range(4)] == [
            True, True, False, False]


# ------------------------------------------------------------- unit cases
def _ctxs(shape, rules, comm=None):
    return [ShardingCtx(make_mesh(shape, AXES, rank=r), rules, comm=comm)
            for r in range(shape[0] * shape[1])]


def test_round_robin_positions_with_uneven_counts():
    ctxs = _ctxs((1, 4), rules_for("model"))
    assert [c.indices("kv_seq", 10) for c in ctxs] == [
        [0, 4, 8], [1, 5, 9], [2, 6], [3, 7]]
    # the counts of an even split: the first n % M ranks one more
    assert [len(c.indices("kv_seq", 10)) for c in ctxs] == [3, 3, 2, 2]
    assert [c.indices("kv_seq", 2) for c in ctxs] == [[0], [1], [], []]
    with pytest.raises(ValueError):
        ctxs[0].range("kv_seq", 10)
    # over "data" at long_500k: by the data coordinate, the model's alike
    data = _ctxs((2, 2), rules_for("data"))
    assert [c.indices("kv_seq", 5) for c in data] == [
        [0, 2, 4], [0, 2, 4], [1, 3], [1, 3]]
    full = torch.arange(2 * 10 * 3).reshape(2, 10, 3)
    for c in ctxs:
        part = c.shard(full, ("batch", "kv_seq", None))
        assert torch.equal(part, full[:, c.index("kv_seq")::4])


def test_kv_heads_whole_where_the_sequence_shares_their_axis():
    model = build_model("internlm2-1.8b", smoke=True)     # 4 q, 2 kv heads
    cdefs = model.cache_defs(4, 9)
    on_model = _ctxs((1, 4), rules_for("model"))
    for c in on_model:
        k = local_defs(cdefs, c)["k"]
        assert k.shape == (2, 4, len(range(c.index("kv_seq"), 9, 4)), 2,
                           model.cfg.resolved_head_dim)
        # the projection's K/V stay split by the q heads
        assert len(c.indices("kv_heads", 2, cdefs["k"].parts)) == 1
    # on "data" the kv heads follow the q heads on "model"
    for c in _ctxs((2, 2), rules_for("data")):
        k = local_defs(cdefs, c)["k"]
        assert k.shape[2:4] == (len(range(c.index("kv_seq"), 9, 2)), 1)
    # whisper's encoder K/V: its frames never split
    w = model_of("whisper-small:2")
    wdefs = w.cache_defs(4, 9)
    assert wdefs["xk"].axes == ("layers", "batch", None, "kv_heads", None)
    assert local_defs(wdefs, on_model[0])["xk"].shape[2] == w.cfg.enc_seq


def test_as_many_kv_heads_as_ranks_on_one_axis_raise():
    model = build_model("internlm2-1.8b", smoke=True)      # 2 kv heads
    ctx = ShardingCtx(make_mesh((1, 2), AXES, rank=0),
                      default_rules(kv_seq_shard=True))
    with pytest.raises(ValueError, match="name the axis twice"):
        local_defs(model.cache_defs(4, 8), ctx)


def test_sequence_and_batch_on_one_axis_raise():
    """The cache's sequence on "data" with its batch still there: each
    data rank would hold other rows, and the decode's sums over "data"
    would mix them."""
    model = build_model("internlm2-1.8b", smoke=True)
    ctx = ShardingCtx(make_mesh((2, 1), AXES, rank=0),
                      {**default_rules(), "kv_seq": "data"})
    with pytest.raises(ValueError, match="sequence and its batch"):
        local_defs(model.cache_defs(4, 8), ctx)
    # held whole at long_500k's rule, the batch on no axis: no raise
    assert local_defs(model.cache_defs(4, 8), _ctxs(
        (2, 1), rules_for("data"))[0])["k"].shape[1:3] == (4, 4)


class _A2A:
    """Simulated ``all_to_all_single`` over ranks called in turn: a first
    pass keeps what each rank sends, a second delivers piece ``j`` of
    every rank's buffer to rank ``j``."""

    def __init__(self, n: int):
        self.n, self.sent, self.received = n, [], 0

    def all_to_all_single(self, out, inp, group=None):
        if len(self.sent) < self.n:
            self.sent.append(inp.clone())
            return
        for i, buf in enumerate(self.sent):
            out[i].copy_(buf[self.received])
        self.received += 1


@pytest.mark.parametrize("heads", [(4, 2), (28, 4), (2, 2)],
                         ids=lambda h: f"{h[0]}q{h[1]}kv")
@pytest.mark.parametrize("p", [12, 13, 3])
def test_prefill_cache_all_to_all_is_the_unsplit_cache_cut(heads, p):
    """Each rank's part of a prefill's K (its kv heads, every position)
    redistributed by ``_split_cache``: bitwise the unsplit cache at the
    rank's positions, every kv head whole. 28 q heads over 4 ranks read
    4 kv heads one each; 2 heads over 4 ranks leave two ranks with none
    (whisper-small:2)."""
    from repro_torch.models import blocks
    hq, hkv = heads
    cfg = dataclasses.replace(build_model("internlm2-1.8b", smoke=True).cfg,
                              n_heads=hq, n_kv_heads=hkv, head_dim=8)
    full = torch.randn(2, p, hkv, 8).to(torch.bfloat16)
    ctxs = _ctxs((1, 4), rules_for("model"), _A2A(4))
    local = [c.shard(full, ("batch", None, "kv_heads", None),
                     blocks.kv_parts(cfg)) for c in ctxs]
    for c, t in zip(ctxs, local):                   # each rank sends
        blocks._split_cache(t, cfg, c)
    for j, (c, t) in enumerate(zip(ctxs, local)):   # each rank receives
        got = blocks._split_cache(t, cfg, c)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, full[:, j::4]), j
