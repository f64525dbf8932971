"""The port's model axis on the CPU, without processes: its rule table,
PartitionSpecs and explicit layout (``models/sharding.py``,
``models/param.py``, ``launch/mesh.py``) against the JAX package's.

* ``default_rules`` equals the reference's under every option.
* ``Model.specs`` (``tree_specs``) equals the JAX package's leaf by leaf
  for all six archs, full and smoke, parameters and decode caches, at
  2 x 2 and 16 x 16: the JAX side reads only ``mesh.axis_names`` and
  ``mesh.devices.shape``, so a stand-in with those serves.
* Where a rank holds other bytes than the reference's spec gives a card,
  the leaf is named with its reason (``held_differently``) and the set
  of such leaves is the one the layout's rules predict.
* The ranks' slices from ``shard_tree`` put back at their indices give
  the full tree, every element covered; ``init(gen, ctx)`` draws exactly
  those slices; ``local_defs`` gives their shapes.
"""
import itertools
import types

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.model import Model as JaxModel
from repro.models.param import tree_specs as jax_tree_specs
from repro.models.sharding import default_rules as jax_default_rules
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import (_axis_ranks, make_mesh,
                                     make_production_mesh)
from repro_torch.models.model import Model
from repro_torch.models.param import (local_defs, shard_tree, tree_leaves,
                                      tree_map, tree_paths, tree_specs)
from repro_torch.models.sharding import (NULL_CTX, ShardingCtx,
                                         default_rules, head_dim,
                                         kv_heads_read, split_range)

ARCHS = ["internlm2-1.8b", "qwen2-moe-a2.7b", "qwen2-vl-7b", "rwkv6-7b",
         "whisper-small", "zamba2-1.2b"]
TP_ARCHS = ["internlm2-1.8b", "qwen2-moe-a2.7b", "qwen2-vl-7b", "rwkv6-7b",
            "whisper-small", "zamba2-1.2b"]
MESHES = [(2, 2), (16, 16), (2, 16, 16)]
AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def _stand_in(shape):
    return types.SimpleNamespace(axis_names=POD_AXES[-len(shape):],
                                 devices=np.empty(shape))


OPTIONS = list(itertools.product((False, True), (False, True), (False, True),
                                 ("row", "col"), (False, True)))


@pytest.mark.parametrize("opts", OPTIONS, ids=str)
def test_default_rules_match_reference(opts):
    multi_pod, fsdp, sp, second, kv = opts
    kw = dict(fsdp=fsdp, seq_parallel=sp, second_matmul=second,
              kv_seq_shard=kv)
    assert default_rules(multi_pod, **kw) == jax_default_rules(multi_pod,
                                                               **kw)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, shape):
    """Every parameter and cache leaf, full and smoke configs, under the
    default, ``second_matmul="col"``, ``seq_parallel`` and ``fsdp`` rules
    (on the (pod, data, model) mesh the multi-pod rules: the batch on
    ("pod", "data")); the cache also under the reference's rules of the
    prefill_32k, decode_32k and long_500k cells (``cell_rules``: its
    sequence on "model" or "data", with each layout override), where
    whisper's encoder K/V keep their frames whole."""
    from repro_torch.configs import SHAPE_SUITES
    from repro_torch.launch.dryrun import cell_rules
    pods = len(shape) == 3
    mesh = make_mesh(shape, POD_AXES[-len(shape):], rank=0)
    layouts = ({}, {"second_matmul": "col"}, {"seq_parallel": True},
               {"fsdp": True})
    for port_cfg, jax_cfg in ((get_config(arch), jax_get_config(arch)),
                              (get_smoke_config(arch),
                               jax_smoke_config(arch))):
        pm, jm = Model(port_cfg), JaxModel(jax_cfg)
        pairs = [(pm.specs(default_rules(pods, **kw), mesh),
                  jm.specs(jax_default_rules(pods, **kw), _stand_in(shape)))
                 for kw in layouts]
        if port_cfg.supports_decode:
            cells = [default_rules(pods)] + [
                cell_rules(port_cfg, SHAPE_SUITES[c], shape[-1],
                           multi_pod=pods, **kw)
                for c in ("prefill_32k", "decode_32k", "long_500k")
                for kw in layouts]
            pairs += [(tree_specs(pm.cache_defs(32, 64), r, mesh),
                       jax_tree_specs(jm.cache_defs(32, 64), r,
                                      _stand_in(shape))) for r in cells]
        for got, want in pairs:
            flat = [(p, s) for p, s in tree_paths(got)]
            assert len(flat) > 1
            for path, spec in flat:
                node = want
                for k in path.split("/"):
                    node = node[k]
                assert spec == tuple(node), (port_cfg.arch, path)


# the leaves rank 0 holds otherwise than the reference's spec gives a card
# at 16 x 16 (the reference's rules per prefill / decode cell), and why
# (the decode cache's k / v equal the reference's bytes: its sequence is
# split round-robin over the model axis, its kv heads whole)
DIFFERENT_16x16 = {
    "internlm2-1.8b": {"params/layers/attn/wk", "params/layers/attn/wv"},
    "qwen2-moe-a2.7b": set(),
    "qwen2-vl-7b": {"params/layers/attn/wq", "params/layers/attn/wk",
                    "params/layers/attn/wv", "params/layers/attn/wo"},
    "zamba2-1.2b": {"params/layers/in_proj", "params/layers/conv_w",
                    "cache/mamba/conv"},
    # RWKV6's vectors are held whole, as the reference's specs replicate
    # them; its 64 heads split evenly
    "rwkv6-7b": set(),
    # 12 heads over 16 ranks: rank 0 holds one whole head (64 columns),
    # the reference's even pieces are 48 columns; the encoder's K/V by the
    # kv head rank 0's q head reads, where the reference holds all 12
    "whisper-small": {f"params/{stack}/{attn}/{w}"
                      for stack, attns in (("enc_layers", ("attn",)),
                                           ("layers", ("attn", "xattn")))
                      for attn in attns
                      for w in ("wq", "wk", "wv", "wo", "bq", "bv")}
    | {"cache/xk", "cache/xv"},
}
# the one leaf pair a rank holds in fewer bytes than the reference's spec
# gives a card: whisper's encoder K/V, held as the rank's q heads read
# them (one kv head on rank 0), where the reference's spec drops the 12
# kv heads from the 16-rank axis and holds them all
FEWER_16x16 = {("whisper-small", "cache/xk"), ("whisper-small", "cache/xv")}
REASONS = {"kv": "kv heads are held whole, as the rank's q heads read them",
           "packed": "B and C (one state shared by every head) are whole",
           "uneven": "whole heads are split unevenly",
           "fewer": "fewer heads than ranks"}


def _differences(arch, shape, kind):
    from repro_torch.configs import SHAPE_SUITES
    from repro_torch.launch.dryrun import cell_rules, layout_differences
    cfg = get_config(arch)
    suite = SHAPE_SUITES[kind]
    ctx = ShardingCtx(make_mesh(shape, AXES, rank=0),
                      cell_rules(cfg, suite, shape[1]))
    return layout_differences(Model(cfg), suite, ctx)


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_layout_differences_are_named_with_reasons(arch):
    """At 16 x 16 (decode_32k: parameters and cache) exactly the leaves
    the rules predict differ, each with its reason and more bytes on rank
    0 than the reference's even split (never fewer: nothing is dropped),
    but whisper's encoder K/V (``FEWER_16x16``); at 2 x 2 only Mamba2's
    packed B and C differ."""
    got = _differences(arch, (16, 16), "decode_32k")
    assert set(got) == DIFFERENT_16x16[arch]
    for path, d in got.items():
        if (arch, path) in FEWER_16x16:
            assert d["bytes"] < d["reference_bytes"], path
        else:
            assert d["bytes"] > d["reference_bytes"], path
        want = []
        if (path.startswith("cache/") and arch != "zamba2-1.2b") or \
                path.endswith(("wk", "wv")):
            want.append(REASONS["kv"])
        if path.endswith(("wq", "wo")):
            want.append(REASONS["uneven"])
        if "mamba" in path or path.endswith(("in_proj", "conv_w")):
            want.append(REASONS["packed"])
        if arch == "whisper-small":
            want.append(REASONS["fewer"])
        for w in want:
            assert w in d["reason"], (path, d["reason"])
    small = _differences(arch, (2, 2), "decode_32k")
    assert set(small) == ({"params/layers/in_proj", "params/layers/conv_w",
                           "cache/mamba/conv"}
                          if arch == "zamba2-1.2b" else set())


def _rebuild(arch, shape):
    """(model, its weights, every rank's ctx) for a smoke model over a
    (data, model) mesh."""
    model = Model(get_smoke_config(arch))
    params = model.init(torch.Generator().manual_seed(0))
    ctxs = [ShardingCtx(make_mesh(shape, AXES, rank=r), default_rules())
            for r in range(shape[0] * shape[1])]
    return model, params, ctxs


def _put_back(full_like, slices, defs, ctxs):
    """Each rank's slice written at its indices; returns the rebuilt tree
    and the count of writes per element."""
    out = [torch.zeros_like(leaf) for leaf in tree_leaves(full_like)]
    seen = [torch.zeros(t.shape, dtype=torch.int32) for t in out]
    for ctx, tree in zip(ctxs, slices):
        for i, (part, d) in enumerate(zip(tree_leaves(tree),
                                          tree_leaves(defs))):
            hd = head_dim(d.axes)
            idx = [torch.tensor(ctx.indices(a, n, d.parts if j == hd
                                            else None), dtype=torch.long)
                   for j, (a, n) in enumerate(zip(d.axes, d.shape))]
            grid = torch.meshgrid(*idx, indexing="ij")
            out[i][grid] = part
            seen[i][grid] += 1
    return out, seen


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)], ids=str)
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_shard_tree_slices_give_the_full_tree_back(arch, shape):
    model, params, ctxs = _rebuild(arch, shape)
    slices = [shard_tree(params, model.defs, c) for c in ctxs]
    out, seen = _put_back(params, slices, model.defs, ctxs)
    for a, b, n in zip(tree_leaves(params), out, seen):
        assert torch.equal(a, b)
        assert bool((n >= 1).all())
    # the cache (whose batch is split over data)
    cdefs = model.cache_defs(4, 16)
    full = tree_map(lambda d: torch.randn(d.shape).to(d.dtype), cdefs)
    slices = [shard_tree(full, cdefs, c) for c in ctxs]
    out, seen = _put_back(full, slices, cdefs, ctxs)
    for a, b, n in zip(tree_leaves(full), out, seen):
        assert torch.equal(a, b) and bool((n >= 1).all())
    for c, sl in zip(ctxs, slices):
        assert [t.shape for t in tree_leaves(sl)] == [
            torch.Size(d.shape) for d in tree_leaves(local_defs(cdefs, c))]


@pytest.mark.parametrize("arch", ["rwkv6-7b", "whisper-small"])
def test_shard_tree_round_trip_other_families(arch):
    """rwkv6's and whisper's trees split by head too, and ``init`` under
    a split ctx draws each rank's slices (RWKV6's vectors whole on every
    rank); with whisper-smoke's 4 heads cut to 2, ranks 2 and 3 of
    (1, 4) hold none of them."""
    import dataclasses
    model, params, ctxs = _rebuild(arch, (1, 2))
    slices = [shard_tree(params, model.defs, c) for c in ctxs]
    out, seen = _put_back(params, slices, model.defs, ctxs)
    for a, b, n in zip(tree_leaves(params), out, seen):
        assert torch.equal(a, b) and bool((n >= 1).all())
    for c, want in zip(ctxs, slices):
        got = model.init(torch.Generator().manual_seed(0), c)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                     tree_leaves(want)))
    whole = [p for p, d in tree_paths(model.defs) if d.read_by_heads]
    assert whole == ([f"layers/tm/{k}" for k in ("ln_x_b", "ln_x_w",
                                                  "w_base", "w_lora_b")]
                     if arch == "rwkv6-7b" else [])
    if arch == "whisper-small":
        model = Model(dataclasses.replace(model.cfg, n_heads=2,
                                          n_kv_heads=2))
        params = model.init(torch.Generator().manual_seed(0))
        ctxs = [ShardingCtx(make_mesh((1, 4), AXES, rank=r),
                            default_rules()) for r in range(4)]
        slices = [shard_tree(params, model.defs, c) for c in ctxs]
        out, seen = _put_back(params, slices, model.defs, ctxs)
        for a, b in zip(tree_leaves(params), out):
            assert torch.equal(a, b)
        wq = [t["layers"]["xattn"]["wq"].shape[-1] for t in slices]
        assert wq == [32, 32, 0, 0]


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_sharded_init_draws_the_slices_of_the_full_tree(arch):
    model, params, ctxs = _rebuild(arch, (1, 4))
    for ctx in ctxs:
        got = model.init(torch.Generator().manual_seed(0), ctx)
        want = shard_tree(params, model.defs, ctx)
        for a, b, d in zip(tree_leaves(got), tree_leaves(want),
                           tree_leaves(local_defs(model.defs, ctx))):
            assert torch.equal(a, b) and a.shape == torch.Size(d.shape)
        assert [t.shape for t in tree_leaves(model.abstract(ctx))] == [
            t.shape for t in tree_leaves(got)]


def test_splits_kv_heads_and_mesh_coordinates():
    # 28 q heads over 16 ranks: 2 on ranks 0-11, 1 on ranks 12-15
    sizes = [b - a for a, b in (split_range(28, 16, i) for i in range(16))]
    assert sizes == [2] * 12 + [1] * 4 and sum(sizes) == 28
    # qwen2-vl (28 q, 4 kv: group 7): at 16 ranks rank 3 holds q 6 and 7,
    # which read kv 0 and 1; at 4 ranks one kv head each
    assert kv_heads_read(28, 4, 6, 8) == [0, 1]
    assert kv_heads_read(28, 4, 0, 2) == [0]
    assert [kv_heads_read(28, 4, *split_range(28, 4, i))
            for i in range(4)] == [[0], [1], [2], [3]]
    # uneven reads: one kv copy per q head (group 1)
    assert kv_heads_read(6, 3, 1, 4) == [0, 1, 1]
    mesh = make_mesh((2, 4), AXES, rank=6)
    assert (mesh.coord("data"), mesh.coord("model")) == (1, 2)
    assert _axis_ranks((2, 4), 1) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert _axis_ranks((2, 4), 0) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert mesh.group("model") == ("model", 4)
    prod = make_production_mesh(rank=17)
    assert prod.shape == (16, 16) and prod.axis_names == AXES
    assert (prod.coord("data"), prod.coord("model")) == (1, 1)
    assert make_production_mesh(multi_pod=True, rank=0).shape == (2, 16, 16)


def test_shard_takes_kv_heads_repeated_as_many_as_the_leaf():
    """28 q heads and 4 kv heads over 8 ranks (qwen2-vl-7b): rank 1's q
    heads 4-7 read kv heads [0, 0, 0, 1], one per q head, as many columns
    as the leaf holds; ``shard`` gathers them (it took the leaf whole
    where the indices were as many as the dim), and every rank's slice is
    the leaf at its indices."""
    from repro_torch.models.sharding import Part
    parts, hd = (Part(4 * 2, 4, kv_of=28),), 2
    full = torch.randn(3, 4 * hd)
    axes = ("embed", "kv_heads")
    for r in range(8):
        ctx = ShardingCtx(make_mesh((1, 8), AXES, rank=r), default_rules())
        idx = ctx.indices("kv_heads", 4 * hd, parts)
        assert torch.equal(ctx.shard(full, axes, parts), full[:, idx])
        if r == 1:
            assert [i // hd for i in idx[::hd]] == [0, 0, 0, 1]


def test_constrain_checks_the_local_layout():
    x = torch.zeros(2, 3, 5)
    assert NULL_CTX.constrain(x, ("batch", "seq", "act_vocab"),
                              (None, None, 99)) is x
    ctx = ShardingCtx(make_mesh((1, 2), AXES, rank=1), default_rules())
    # rank 1 of a 2-way vocab split of 9 holds 4
    with pytest.raises(ValueError):
        ctx.constrain(x, ("batch", "seq", "act_vocab"), (None, None, 9))
    assert ctx.constrain(x[..., :4], ("batch", "seq", "act_vocab"),
                         (None, None, 9)) is not None
    # fsdp: rank 0 holds the first half of the "embed" rows, the
    # reference spec's shard (("data", None) at data 2)
    fsdp = ShardingCtx(make_mesh((2, 2), AXES, rank=0),
                       default_rules(fsdp=True))
    full = torch.arange(16.0).view(4, 4)
    assert fsdp.spec_for_shape(("embed", None), (4, 4)) == ("data", None)
    assert torch.equal(fsdp.shard(full, ("embed", None)), full[:2])
    # an axis the port still does not split ("ff_expert", which no rule
    # of the reference puts on a mesh axis) raises
    other = ShardingCtx(make_mesh((2, 2), AXES, rank=0),
                        {**default_rules(), "ff_expert": "data"})
    with pytest.raises(NotImplementedError):
        other.shard(torch.zeros(4, 4), ("ff_expert", None))


class _Capture:
    """A rank's side of an all-gather: keeps what it sends."""
    def all_gather(self, out, t, group=None):
        self.sent = t.clone()


class _Deliver:
    """Every rank's sent tensor, as an all-gather delivers them."""
    def __init__(self, sent):
        self.sent = sent

    def all_gather(self, out, t, group=None):
        for o, x in zip(out, self.sent):
            o.copy_(x)


def test_vocab_parallel_logits_and_greedy_across_padded_vocab():
    """vocab 250 (padded to 256) over 2 ranks: rank 0 holds ids 0-127,
    rank 1 ids 128-249 (the padding dropped); the gathered logits are the
    full ones and the greedy token is the first id of the maximum across
    ranks (a tie between the ranks goes to rank 0's id)."""
    import dataclasses
    from repro_torch.train.serve_step import greedy
    model = Model(dataclasses.replace(get_smoke_config("internlm2-1.8b"),
                                      vocab=250))
    full = torch.randn(3, 250)
    full[1, 200] = full[1, 5] = full[1].abs().max() + 1     # a tie
    ctxs = [ShardingCtx(make_mesh((1, 2), AXES, rank=r), default_rules(),
                        comm=_Capture()) for r in range(2)]
    local = []
    for c in ctxs:
        v0, v1 = model.vocab_range(c)
        local.append(full[:, v0:v1])
    assert [t.shape[-1] for t in local] == [128, 122]
    for op in (model.gather_logits, lambda lg, c: greedy(model, lg, c)):
        for c, lg in zip(ctxs, local):
            c.comm = _Capture()
            op(lg, c)
        sent = [c.comm.sent for c in ctxs]
        for c, lg in zip(ctxs, local):
            c.comm = _Deliver(sent)
            got = op(lg, c)
            want = full if got.dim() == 2 else torch.argmax(full, -1)
            assert torch.equal(got.to(want.dtype), want)
    assert int(greedy(model, local[0], ctxs[0])[1]) == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_statuses_at_the_reference_mesh(arch):
    """``--cards 256 --model 16`` (the reference's 16 x 16): the
    train_4k, prefill_32k and decode_32k cells of every family are built
    (rank 0's parameters, and its cache or its ZeRO shard of the moments,
    on ``meta``), and the long_500k cells of rwkv6 and zamba2 (the batch
    of 1 whole on each data rank, as the reference's rule holds it;
    zamba2's K/V cache's sequence round-robin over data, its step's
    collectives its plan: the log-sum-exp's three all-reduces over the 16
    data ranks per shared-attention application), and the reference's own
    rules still skip what they skip: 20 ok, 0 not_ported, 4 skipped."""
    from repro_torch.configs import SHAPE_SUITES
    from repro_torch.launch import dryrun
    cfg = get_config(arch)
    for shape, suite in SHAPE_SUITES.items():
        fn, args, meta, comm = dryrun.build_cell(arch, shape, cards=256,
                                                 model=16)
        if (suite.kind == "decode" and not cfg.supports_decode) or (
                shape == "long_500k" and not cfg.subquadratic):
            want = "skipped"
        else:
            want = "ok"
        assert meta["status"] == want, (shape, meta)
        if shape == "long_500k" and arch == "zamba2-1.2b":
            dryrun.analyze_cell(fn, args, meta, comm)   # raises off the plan
            on_data = [c for c in comm.issued if c["axis"] == "data"]
            assert comm.issued == comm.plan
            assert len(on_data) == 3 * Model(cfg).n_shared_apps()
            assert {c["group"] for c in on_data} == {16}
            assert "round-robin over data" in meta["layout"]
        if want == "ok":
            assert meta["mesh"] == "16x16" and comm is not None
            assert meta["batch_per_card"] == (
                suite.global_batch if shape == "long_500k"
                else suite.global_batch // 16)
            assert 0 < meta["params_per_card"] < meta["params"] / 8


def test_cli_model_axis_cell(tmp_path):
    """One 16 x 16 cell from the CLI with jax and the JAX package
    blocked: ok, fits a card, its collectives in the JSON as the plan
    gives them."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; sys.argv = ['dryrun', '--arch', "
            "'qwen2-vl-7b', '--shape', 'decode_32k', '--cards', '256', "
            f"'--model', '16', '--out', {str(tmp_path)!r}]; "
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=tmp_path,
                         env={"PYTHONPATH": str(root / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["status"] == "ok" and last["fits"] is True
    assert last["model_axis"] == 16
    art = json.loads((tmp_path / "qwen2-vl-7b__decode_32k__256card_model16"
                                  ".json").read_text())
    colls = art["collectives"]
    # per layer the split cache's gather of the token's q, k and v and its
    # three log-sum-exp all-reduces, the attention's and the MLP's
    # all-reduce; the embedding's, and the greedy token's all-gather
    assert colls["all-reduce"]["count"] == 5 * 28 + 1
    assert colls["all-gather"]["count"] == 28 + 1
    assert colls["all-reduce"]["max_group"] == 16
    assert art["layout_differences"]["params/layers/attn/wq"]["reason"]
    assert "cache/k" not in art["layout_differences"]
