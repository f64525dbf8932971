"""The port's launch layer (``repro_torch.launch``: ``specs``,
``step_analysis``, ``dryrun``) on the CPU, against the JAX package's
``launch/`` where the two count the same thing.

* A step traced on ``meta`` tensors counts exactly what the same step
  counts when it runs for real on the CPU (operations, bytes, aten ops,
  memory), for all six families in prefill, decode and train (smoke
  configs, inputs drawn with numpy from a seed).
* internlm2-smoke's prefill [2, 64] and decode: the port's operations
  outside kernel calls equal ``analyze_hlo`` of a one-device CPU compile
  of the JAX step, less the products the port's flash_attention kernel
  takes (4·B·Hq·Sq·Skv·D per layer; none in decode). Exact.
* Every arch at full width: parameters, active parameters, model flops
  and each (arch, shape) status equal those the JAX package's config and
  ``model_param_count(model.abstract())`` give.
* ``roofline_terms`` against the JAX function with the constants scaled;
  the live-bytes tracker on a hand-made sequence; the kernels' work
  formulas at ``PERF.md``'s bound rows; the collectives a traced
  ``manual_dp`` step issues against ``collective_plan``; the CLI (one
  full-width cell, a skipped one, ``fsdp`` and ``--multi-pod``: "ok")
  with ``jax`` blocked, and the reference CLI's layout overrides on a
  train cell ("ok"; ``fsdp``'s ZeRO-3 and the multi-pod mesh named in
  the cell's layout; ``dp_mode="auto"``, the
  reference's default, with the default cell's counts and its difference
  from GSPMD's step named) and on a prefill cell (its rules ignore
  ``seq_parallel`` and ``fsdp``); the MoE load-balance term bitwise the
  old ``bincount`` form's.
"""
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPE_SUITES as JAX_SUITES
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.launch import hlo_analysis
from repro.models import moe as jax_moe
from repro.models.model import Model as JaxModel
from repro.models.param import tree_abstract as jax_tree_abstract
from repro.train.serve_step import make_decode_step as jax_decode_step
from repro.train.serve_step import make_prefill_step as jax_prefill_step
from repro_torch.configs import SHAPE_SUITES, MoEConfig, ShapeSuite
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.gla_chunk import ops as gla_ops
from repro_torch.launch import dryrun, step_analysis
from repro_torch.launch.step_analysis import analyze_step, roofline_terms
from repro_torch.models import build_model, moe
from repro_torch.models.param import tree_abstract, tree_map
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.train.manual_dp import collective_plan
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_train_step

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["internlm2-1.8b", "qwen2-moe-a2.7b", "qwen2-vl-7b", "rwkv6-7b",
         "whisper-small", "zamba2-1.2b"]
KINDS = ["prefill", "decode", "train"]
B, S = 4, 64


def _to_meta(tree):
    """The same tree with every tensor replaced by a ``meta`` tensor of
    its shape, strides and dtype."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tree.shape, tree.stride(),
                                   dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_meta(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_meta(v) for v in tree)
    return tree


def _step_args(arch: str, kind: str):
    """(step, its CPU arguments) for a smoke model's step, weights from a
    seeded generator, tokens and frames drawn with numpy."""
    model = build_model(arch, smoke=True)
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model), dtype=np.float32)).bfloat16()
    if kind == "prefill":
        return make_prefill_step(model), (params, batch)
    if kind == "decode":
        return make_decode_step(model), (
            params, model.init_cache(B, S, device="cpu"),
            toks[:, :1].clone(), S - 1)
    batch["targets"] = torch.roll(toks, -1, 1)
    return make_train_step(model, AdamWConfig()), (params, init_state(params),
                                                   batch)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_trace_counts_what_the_cpu_run_counts(arch, kind):
    fn, args = _step_args(arch, kind)
    meta_args = _to_meta(args)
    _, cpu = analyze_step(fn, *args)
    _, met = analyze_step(fn, *meta_args)
    for key in ("flops", "bytes", "ops", "flops_outside_kernels",
                "bytes_outside_kernels", "kernels", "op_flops", "memory"):
        assert cpu[key] == met[key], key
    assert cpu["flops"] > 0 and cpu["memory"]["peak_estimate_bytes"] > 0
    # the LM kernels were counted by their formulas, where the arch has one
    fam = build_model(arch, smoke=True).cfg.family
    if kind != "decode" or fam == "encdec":
        assert cpu["kernels"], "no kernel call counted"
    if kind == "train":
        assert any(k.endswith("_backward") for k in cpu["kernels"])


def _jax_flops(step, *abstract_args) -> float:
    hlo = jax.jit(step).lower(*abstract_args).compile().as_text()
    return hlo_analysis.analyze_hlo(hlo)["flops"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_flops_outside_kernels_equal_jax_analyze_hlo(kind):
    arch, b, s = "internlm2-1.8b", 2, 64
    jm = JaxModel(jax_smoke_config(arch))
    tm = build_model(arch, smoke=True)
    cfg = tm.cfg
    tok = torch.empty((b, s if kind == "prefill" else 1), dtype=torch.int64,
                      device="meta")
    if kind == "prefill":
        want = _jax_flops(jax_prefill_step(jm), jm.abstract(), {
            "tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)})
        _, got = analyze_step(make_prefill_step(tm), tm.abstract(),
                              {"tokens": tok})
        # the attention's two full-size products, taken by the kernel
        full = 4 * b * cfg.n_heads * s * s * cfg.resolved_head_dim
        assert got["kernels"]["flash_attention"]["calls"] == cfg.n_layers
        want -= full * cfg.n_layers
    else:
        want = _jax_flops(
            jax_decode_step(jm), jm.abstract(),
            jax_tree_abstract(jm.cache_defs(b, s)),
            jax.ShapeDtypeStruct((b, 1), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.int32))
        _, got = analyze_step(make_decode_step(tm), tm.abstract(),
                              tree_abstract(tm.cache_defs(b, s)), tok, s - 1)
        assert not got["kernels"]
    assert got["flops_outside_kernels"] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_cells_match_the_jax_package(arch):
    jcfg = jax_get_config(arch)
    j_params = int(sum(x.size for x in jax.tree.leaves(
        JaxModel(jcfg).abstract())))
    assert set(SHAPE_SUITES) == set(JAX_SUITES)
    for shape, js in JAX_SUITES.items():
        fn, args, meta, _ = dryrun.build_cell(arch, shape)
        skipped = (js.kind == "decode" and not jcfg.supports_decode) or (
            js.name == "long_500k" and not jcfg.subquadratic)
        assert meta["status"] == ("skipped" if skipped else "ok"), shape
        if skipped:
            assert fn is None
            continue
        assert meta["params"] == j_params
        assert meta["active_params"] == jcfg.active_param_count()
        tokens = js.global_batch * (1 if js.kind == "decode" else js.seq_len)
        assert meta["tokens_per_step"] == tokens
        mult = 6 if js.kind == "train" else 2
        assert dryrun.model_flops(meta) == \
            mult * jcfg.active_param_count() * tokens


ROOF_CASES = [(1e15, 1e11, 0.0, 1), (3e12, 9e11, 0.0, 1),
              (5e16, 2e11, 4e10, 4), (1e12, 1e9, 3e10, 2)]


@pytest.mark.parametrize("case", range(len(ROOF_CASES)))
def test_roofline_terms_match_the_jax_function(case):
    flops, n_bytes, wire, n = ROOF_CASES[case]
    got = roofline_terms(global_flops=flops, device_bytes=n_bytes,
                         collective_wire_bytes=wire, n_chips=n)
    # the JAX function's inputs scaled by the ratio of its constants to
    # the H100's: the same three terms
    want = hlo_analysis.roofline_terms(
        global_flops=flops * hlo_analysis.PEAK_FLOPS_BF16
        / step_analysis.PEAK_FLOPS_BF16,
        device_bytes=n_bytes * hlo_analysis.HBM_BW / step_analysis.HBM_BW,
        collective_wire_bytes=wire * hlo_analysis.ICI_BW
        / step_analysis.LINK_BW, n_chips=n)
    assert set(got) == set(want)
    assert got["dominant"] == want["dominant"]
    for key in ("t_compute_s", "t_memory_s", "t_collective_s", "bound_s"):
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0)


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_live_bytes_tracker_peak(device):
    """a (4 kB) -> b = 2a (4 kB, peak 8 kB) -> free a -> c = [b, b]
    (8 kB, peak 12 kB) -> free b -> d = c[:10] (a view: nothing) -> e =
    d + 1 (40 B); the argument x (400 B) stays live throughout."""
    def step(x):
        a = torch.empty(1000, device=device)
        b = a * 2
        del a
        c = torch.cat([b, b])
        del b
        return (c[:10] + 1).sum() + x.sum()

    x = torch.zeros(100, device=device)
    _, got = analyze_step(step, x)
    mem = got["memory"]
    assert mem["argument_size_in_bytes"] == 400
    assert mem["peak_estimate_bytes"] == 400 + 8000 + 4000
    assert mem["output_size_in_bytes"] == 4
    # bytes: mul 4000 + 4000; cat 8000 + 8000; add 40 + 40; two sums
    # 40 + 4 and 400 + 4; the final add 4 + 4 + 4
    assert got["bytes"] == 8000 + 16000 + 80 + 44 + 404 + 12
    assert got["ops"] == 6


@pytest.mark.parametrize("kernel", ["flash", "gla"])
def test_backward_reckons_the_plain_recompute(kernel):
    """An LM kernel's autograd backward recomputes its plain version and
    that version's gradient: on ``meta`` nothing runs, so the dry run
    reckons the recompute's activations and temporaries as the call's
    scratch (``_build.recompute_scratch``): the traced step's peak holds
    them beside the live tensors, at least the plain backward's own
    peak above its gradients (a step that allocated only the gradients
    there missed the SSD recompute's 772 MB on the card)."""
    from repro_torch.kernels._build import recompute_grads
    from repro_torch.launch.step_analysis import StepCounter

    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kernel == "flash":
        args = [m(1, 4, 256, 64).requires_grad_() for _ in range(3)]

        def step(q, k, v):
            return flash_ops.attention(q, k, v, causal=True).sum()

        def plain(q, k, v):
            return flash_ops.attention_ref(q, k, v, causal=True)
        outs = (m(1, 4, 256, 64),)
    else:
        args = [m(1, 256, 4, 64).requires_grad_() for _ in range(3)] + [
            (-m(1, 256, 4, 64)).requires_grad_()]

        def step(q, k, v, log_w):
            return gla_ops.gla_fn(q, k, v, log_w, inclusive=True)[0].sum()

        plain = gla_ops.plain_for(*args, None, True)
        outs = (m(1, 256, 4, 64), None)

    def fwd_bwd(*xs):
        return torch.autograd.grad(step(*xs), xs)

    _, got = analyze_step(fwd_bwd, *args)
    counter = StepCounter()
    with counter:
        saved = [x.detach() for x in args] + (
            [None, None] if kernel == "gla" else [])
        grads = recompute_grads(plain, saved, [True] * len(args) + (
            [False, False] if kernel == "gla" else []), outs)
    counter.close()
    held = sum(g.numel() * g.element_size() for g in grads if g is not None)
    assert counter.peak - held > 0
    assert got["memory"]["peak_estimate_bytes"] >= got["memory"][
        "argument_size_in_bytes"] + counter.peak - held


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_ops_inside_a_kernel_call_skip_the_counter(device, monkeypatch):
    """A kernel call's own ops (the plain version the CPU runs, a
    backward's recompute: rwkv6's gla loops over its chunks) run with the
    dispatch modes set aside: none reaches the counter's dispatch, which
    costs the card's counted step a Python call per op; the call counts
    as the kernel's formula all the same."""
    from repro_torch.launch.step_analysis import StepCounter
    seen = []
    dispatch = StepCounter.__torch_dispatch__

    def spy(self, func, types, args=(), kwargs=None):
        seen.append(self.depth)
        return dispatch(self, func, types, args, kwargs)

    monkeypatch.setattr(StepCounter, "__torch_dispatch__", spy)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 128, 2, 16), generator=gen).to(device)
               .requires_grad_() for _ in range(3))
    log_w = (-torch.rand((1, 128, 2, 16), generator=gen)).to(
        device).requires_grad_()

    def fwd_bwd(*xs):
        out = gla_ops.gla_fn(*xs, inclusive=False)[0]
        return torch.autograd.grad(out.sum(), xs)

    _, got = analyze_step(fwd_bwd, q, k, v, log_w)
    assert seen and not any(seen)
    assert {name: r["calls"] for name, r in got["kernels"].items()} == {
        "gla_chunk": 1, "gla_chunk_backward": 1}


def _bound_ms(flops, n_bytes) -> float:
    return max(n_bytes / step_analysis.HBM_BW,
               flops / step_analysis.PEAK_FLOPS_BF16) * 1e3


def test_work_formulas_give_perf_bound_rows():
    """``PERF.md`` §6 rows 6′, 7′ and 7‴: flash_attention at internlm2's
    serving shape, gla_chunk at zamba2's Mamba2 and rwkv6's RWKV6 ones."""
    def m(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    q, kv = m(4, 2048, 16, 128), m(4, 2048, 8, 128)
    row6 = flash_ops.work(q.transpose(1, 2), kv.transpose(1, 2),
                          kv.transpose(1, 2), causal=True)
    assert round(_bound_ms(*row6), 7) == 0.0694838
    b, s, h, d = 4, 2048, 64, 64
    shared = m(b, s, 1, d).expand(b, s, h, d)
    lw = m(b, s, h, 1, dtype=torch.float32).expand(b, s, h, d)
    row7 = gla_ops.work(shared, shared, m(b, s, h, d), lw, inclusive=True)
    assert row7[1] == 142_606_336
    assert round(_bound_ms(*row7), 7) == 0.0425691
    r = m(b, s, h, d)
    row7c = gla_ops.work(r, r, r, m(b, s, h, d, dtype=torch.float32),
                         m(h, d, dtype=torch.float32), inclusive=False)
    assert row7c[1] == 406_863_872
    assert round(_bound_ms(*row7c), 7) == 0.1214519
    # the chunk-state scratch of the SSD design at zamba2's shape
    assert gla_ops.scratch_bytes(shared, shared, m(b, s, h, d), lw, None,
                                 True) == 4 * b * h * 32 * (d * d + 1)


def test_manual_dp_cell_issues_its_collective_plan():
    """A two-card train cell (internlm2 at full width, 2 layers) traces
    ``make_manual_dp_train_step`` with the collectives recorded: they are
    ``collective_plan``'s, and the wire bytes the ring multipliers'."""
    suite = ShapeSuite("small_train", 64, 16, "train")
    fn, args, meta, comm = dryrun.build_cell(
        "internlm2-1.8b", "train_4k", cards=2, suite=suite,
        overrides={"n_layers": 2})
    res = dryrun.analyze_cell(fn, args, meta, comm)
    plan = collective_plan(args[0], 2)
    assert comm.issued == plan
    colls = res["collectives"]
    assert {k: c["count"] for k, c in colls.items()} == {
        "reduce-scatter": 1, "all-reduce": 1, "all-gather": 1}
    shard = plan[0]["result_bytes"]
    assert colls["reduce-scatter"]["wire_bytes"] == shard
    assert colls["all-gather"]["wire_bytes"] == plan[2]["result_bytes"] / 2
    assert res["roofline"]["t_collective_s"] > 0
    assert meta["batch_per_card"] == 8


def _cli(*argv, tmp_path):
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; sys.argv = ['dryrun'] + "
            f"{list(argv)!r}; "
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')")
    return subprocess.run(
        [sys.executable, "-c", code, "--"], capture_output=True, text=True,
        timeout=240, cwd=tmp_path,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_cli_full_width_cell(tmp_path):
    """internlm2-1.8b prefill_32k at full width on ``meta``, with jax and
    the JAX package blocked: exit 0, an ok artifact, a peak that does not
    fit one card (the f32 logits of 32 x 32,768 tokens alone are 388 GB)."""
    out = _cli("--arch", "internlm2-1.8b", "--shape", "prefill_32k",
               "--out", str(tmp_path), tmp_path=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["status"] == "ok" and last["fits"] is False
    art = json.loads((tmp_path / "internlm2-1p8b__prefill_32k__1card.json"
                      ).read_text())
    assert art["kernels"]["flash_attention"]["calls"] == 24
    assert art["roofline"]["bound_s"] == last["bound_s"] > 0
    assert 0 < art["model_flops_ratio"] < 1
    for key in ("params", "active_params", "tokens_per_step", "cost",
                "collectives", "model_flops", "total_s"):
        assert key in art


# the CLI's cells under the reference CLI's layout overrides: a skipped
# cell, then internlm2 train_4k at 4 cards under each override and on the
# multi-pod mesh, and a prefill cell, whose rules ignore seq_parallel and
# fsdp
CLI_CASES = ["skipped", "fsdp", "seq_parallel", "second_matmul_col",
             "dp_mode_auto", "dp_mode_manual", "prefill_seq_parallel",
             "multi_pod"]


def _analyzed(overrides, **kw):
    fn, args, meta, comm = dryrun.build_cell("internlm2-1.8b", "train_4k",
                                             overrides=overrides, **kw)
    assert meta["status"] == "ok", meta
    return meta, dryrun.analyze_cell(fn, args, meta, comm)


@pytest.mark.parametrize("case", CLI_CASES)
def test_cli_skips_and_refuses(case, tmp_path):
    if case == "skipped":
        out = _cli("--arch", "whisper-small", "--shape", "long_500k",
                   "--out", str(tmp_path), tmp_path=tmp_path)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])[
            "status"] == "skipped"
    elif case == "fsdp":
        # ZeRO-3 over the 4 data ranks: the layout's record and how it
        # differs from GSPMD's
        fn, _, meta, _ = dryrun.build_cell("internlm2-1.8b", "train_4k",
                                           cards=4, overrides={"fsdp": True})
        assert fn is not None and meta["status"] == "ok"
        assert "fsdp (ZeRO-3)" in meta["layout"] and meta["mesh"] == "4x1"
        assert "ZeRO-3" in meta["layout_differences"]["dp_mode"]["reason"]
        out = _cli("--arch", "internlm2-1.8b", "--shape", "decode_32k",
                   "--cards", "4", "--override", "fsdp=true", "--out",
                   str(tmp_path), tmp_path=tmp_path)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])[
            "status"] == "ok"
    elif case == "multi_pod":
        fn, _, meta, _ = dryrun.build_cell("internlm2-1.8b", "train_4k",
                                           cards=4, multi_pod=True)
        assert fn is not None and meta["status"] == "ok"
        assert meta["mesh"] == "pod2x2x1"
        assert meta["layout"].startswith("manual_dp over (pod 2, data 2)")
        with pytest.raises(ValueError):          # no pod axis of 2 in 2
            dryrun.build_cell("internlm2-1.8b", "train_4k", cards=2,
                              model=2, multi_pod=True)
        out = _cli("--arch", "internlm2-1.8b", "--shape", "decode_32k",
                   "--cards", "4", "--multi-pod", "--out", str(tmp_path),
                   tmp_path=tmp_path)
        assert out.returncode == 0, out.stderr[-2000:]
        last = json.loads(out.stdout.strip().splitlines()[-1])
        assert last["status"] == "ok"
        art = json.loads((tmp_path / "internlm2-1p8b__decode_32k__4card_"
                                      "multipod.json").read_text())
        assert art["mesh"] == "pod2x2x1"
    elif case in ("seq_parallel", "second_matmul_col"):
        key, value = (("seq_parallel", True) if case == "seq_parallel"
                      else ("second_matmul", "col"))
        fn, _, meta, _ = dryrun.build_cell("internlm2-1.8b", "train_4k",
                                           cards=4, overrides={key: value})
        assert fn is not None and meta["status"] == "ok"
        assert meta["dp_mode"] == "auto"
    elif case == "dp_mode_auto":
        # the reference's default: manual_dp's counts, the difference named
        meta, got = _analyzed({"dp_mode": "auto"}, cards=4)
        default_meta, want = _analyzed(None, cards=4)
        got.pop("trace_s"), want.pop("trace_s")
        assert got == want
        assert meta["dp_mode"] == default_meta["dp_mode"] == "auto"
        diff = meta["layout_differences"]["dp_mode"]
        assert diff == default_meta["layout_differences"]["dp_mode"]
        assert "once per step" in diff["reason"]
        assert "flat gradient bucket" in diff["reason"]
        assert diff["reference_gradient_crossings_per_step"] == \
            max(meta["microbatches"], 1)
    elif case == "dp_mode_manual":
        fn, _, meta, _ = dryrun.build_cell("internlm2-1.8b", "train_4k",
                                           cards=4,
                                           overrides={"dp_mode": "manual"})
        assert fn is not None and meta["dp_mode"] == "manual"
        assert "layout_differences" not in meta
    else:
        from repro_torch.launch.dryrun import cell_rules
        from repro_torch.configs import get_config
        cfg, suite = get_config("internlm2-1.8b"), SHAPE_SUITES["prefill_32k"]
        assert cell_rules(cfg, suite, 16, seq_parallel=True, fsdp=True) == \
            cell_rules(cfg, suite, 16)
        for over in ({"seq_parallel": True}, {"fsdp": True}):
            fn, _, meta, _ = dryrun.build_cell(
                "internlm2-1.8b", "prefill_32k", cards=32, model=16,
                overrides=over)
            assert fn is not None and meta["status"] == "ok"
            assert "seq_parallel" not in meta["layout"]


def test_moe_top1_count_is_bincount_and_aux_unchanged():
    """The fixed-size count equals ``torch.bincount``, so the load-balance
    term is bitwise what the ``bincount`` form gave, and within 1e-6
    (relative) of the JAX package's, which sums in another order."""
    kw = dict(n_experts=6, top_k=2, n_shared_experts=1, d_ff_expert=16,
              group_size=32, n_experts_padded=8, capacity_factor=1.0)
    cfg = MoEConfig(**kw)
    rng = np.random.default_rng(11)
    d = 32
    p = {"router": rng.standard_normal((d, 8), dtype=np.float32),
         "w_gate": rng.standard_normal((8, d, 16), dtype=np.float32) * 0.2,
         "w_up": rng.standard_normal((8, d, 16), dtype=np.float32) * 0.2,
         "w_down": rng.standard_normal((8, 16, d), dtype=np.float32) * 0.2,
         "shared": {"w_gate": rng.standard_normal((d, 16), np.float32),
                    "w_up": rng.standard_normal((d, 16), np.float32),
                    "w_down": rng.standard_normal((16, d), np.float32)}}
    x = rng.standard_normal((3, 40, d), dtype=np.float32)
    tp, tx = tree_map(torch.from_numpy, p), torch.from_numpy(x)
    _, aux = moe.moe_ffn(tp, tx, cfg)
    r = moe.route(tp, tx, cfg)
    g, gs = r.xt.shape[:2]
    e = cfg.padded_experts
    counts = torch.bincount(r.topi[..., 0].reshape(-1), minlength=e)
    assert torch.equal(moe.top1_counts(r.topi, e), counts)
    old = (r.probs.mean(dim=(0, 1)) * (counts.float() / (g * gs))).sum() \
        * e * cfg.router_aux_weight
    assert torch.equal(aux, old)
    _, jaux = jax_moe.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              JaxMoEConfig(**kw))
    assert math.isclose(float(aux), float(jaux), rel_tol=1e-6, abs_tol=0)
