"""The port's training path against the JAX package on the CPU: AdamW and
its schedule, the cross-entropy, ``make_train_step`` for
``internlm2-smoke`` and ``zamba2-smoke`` (loss, grad norm, every gradient
leaf, the parameters after two steps), int8 error feedback, the
checkpoint manager (files cross-loaded between the packages), and the
autograd Functions of the two LM kernels.

Both sides run f32 from the reference's ``Model.init`` weights and one
optimizer state, carried across by ``models/convert.py``; inputs are
drawn with numpy from a seed. Tolerances: 1e-6 for the optimizer alone
(the same f32 ops), 1e-4 for the models (summation order; zamba2 with
the reference's Mamba2 at f32 decay ratios, the port's precision), and
the reference's model bound, 0.02 x max(|x|, 1)
(tests/test_models_smoke.py:93), for zamba2 against the unpatched
reference (bf16 ratios). The int8 compressor is bitwise.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro.models import build_model as jax_build_model
from repro.models import gla as jax_gla
from repro.models.model import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import AdamWState as JaxAdamWState
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import schedule as jax_schedule
from repro.train import checkpoint as ref_ckpt
from repro.train import compression as ref_comp
from repro.train.train_step import cross_entropy as jax_cross_entropy
from repro.train.train_step import make_loss_fn as jax_make_loss_fn
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gla_chunk import ops as gla_ops
from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref
from repro_torch.models import Model, build_model
from repro_torch.models.convert import from_reference, opt_from_reference
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.optim import (AdamWConfig, apply_updates, init_state,
                               schedule)
from repro_torch.train import compression as comp
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import (cross_entropy, grads_of,
                                          make_loss_fn, make_train_step)

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture
def f32_ratios(monkeypatch):
    """The reference's Mamba2 layers with f32 decay ratios (the port's and
    the Pallas kernel's precision)."""
    monkeypatch.setattr(jax_gla, "gla_chunk", functools.partial(
        jax_gla.gla_chunk, ratio_dtype=jnp.float32))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _within_bound(got, want, what):
    """The reference's model bound: max |got - want| <= 0.02 x
    max(max |want|, 1)."""
    g, w = _np(got), _np(want)
    bound = 0.02 * max(float(np.abs(w).max(initial=0.0)), 1.0)
    err = float(np.abs(g - w).max(initial=0.0))
    assert err <= bound, f"{what}: {err} > {bound}"


def _leaf_pairs(port_tree, jax_tree):
    """(port leaf, reference leaf) in the one leaf order both use."""
    return list(zip(tree_leaves(port_tree), jax.tree.leaves(jax_tree)))


# ------------------------------------------------------------- optimizer

def test_schedule_matches_reference():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = JaxAdamWConfig(**dataclasses.asdict(cfg))
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got = schedule(cfg, torch.tensor(s, dtype=torch.int32))
        _close(got, jax_schedule(jcfg, jnp.asarray(s, jnp.int32)), 1e-6)
    assert float(schedule(cfg, torch.tensor(5))) < 1e-3
    assert abs(float(schedule(cfg, torch.tensor(10))) - 1e-3) < 1e-9
    assert float(schedule(cfg, torch.tensor(100))) < 2e-4


@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_apply_updates_matches_reference(clip_norm):
    """Three steps on a tree of a matrix (decayed), a vector and a stacked
    [L, ...] tensor, f32: parameters, moments, grad norm and lr at 1e-6;
    with clipping active (clip 1) and not (clip 1000)."""
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "layers": {"k": (2, 3, 4)}}
    p_np = jax.tree.map(lambda s: rng.standard_normal(s, dtype=np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                      clip_norm=clip_norm)
    jcfg = JaxAdamWConfig(**dataclasses.asdict(cfg))
    params = tree_map(lambda a: torch.from_numpy(a.copy()), p_np)
    state = init_state(params)
    jp = jax.tree.map(jnp.asarray, p_np)
    jstate = JaxAdamWState(jnp.zeros((), jnp.int32),
                           jax.tree.map(jnp.zeros_like, jp),
                           jax.tree.map(jnp.zeros_like, jp))
    for _ in range(3):
        g_np = jax.tree.map(lambda a: rng.standard_normal(
            a.shape, dtype=np.float32), p_np)
        params, state, met = apply_updates(cfg, params,
                                           tree_map(torch.from_numpy, g_np),
                                           state)
        jp, jstate, jmet = jax_apply_updates(
            jcfg, jp, jax.tree.map(jnp.asarray, g_np), jstate)
        for key in ("grad_norm", "lr"):
            _close(met[key], jmet[key], 1e-6)
        for a, b in (_leaf_pairs(params, jp) + _leaf_pairs(state.mu,
                                                          jstate.mu)
                     + _leaf_pairs(state.nu, jstate.nu)):
            _close(a, b, 1e-6)
    assert int(state.step) == int(jstate.step) == 3
    assert all(m.dtype == torch.float32 for m in tree_leaves(state.mu))


def test_apply_updates_casts_back_to_bf16():
    p = {"w": torch.ones((3, 3), dtype=torch.bfloat16)}
    g = {"w": torch.full((3, 3), 0.5, dtype=torch.bfloat16)}
    state = init_state(p)
    p, state, _ = apply_updates(AdamWConfig(lr=0.1, warmup_steps=1), p, g,
                                state)
    assert p["w"].dtype == torch.bfloat16
    assert state.mu["w"].dtype == torch.float32
    assert bool((p["w"] < 1).all())


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 7, 50), dtype=np.float32) * 4
    tg = rng.integers(0, 50, (3, 7), dtype=np.int32)
    _close(cross_entropy(torch.from_numpy(logits), torch.from_numpy(tg)),
           jax_cross_entropy(jnp.asarray(logits), jnp.asarray(tg)), 1e-6)


# ------------------------------------------------------------ train step

_cache = {}


def _weights(arch):
    """The reference's f32 ``Model.init`` weights of the smoke config and
    a nonzero AdamW state (step 5, random moments), as numpy."""
    if arch not in _cache:
        jm = jax_build_model(arch, smoke=True)
        p = jax.tree.map(lambda a: np.asarray(a, np.float32),
                         jax.jit(jm.init)(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(7)
        mu = jax.tree.map(lambda a: (rng.standard_normal(
            a.shape, dtype=np.float32) * 1e-3), p)
        nu = jax.tree.map(lambda a: (rng.random(
            a.shape, dtype=np.float32) * 1e-6), p)
        _cache[arch] = (p, (np.int32(5), mu, nu))
    return _cache[arch]


def _pair(arch, remat):
    """(JAX model, JAX params, JAX state, port model, port params, port
    state), fresh copies, both configs with ``remat``."""
    p_np, (step, mu, nu) = _weights(arch)
    jcfg = dataclasses.replace(jax_build_model(arch, smoke=True).cfg,
                               remat=remat)
    pcfg = dataclasses.replace(build_model(arch, smoke=True).cfg,
                               remat=remat)
    jm, pm = JaxModel(jcfg), Model(pcfg)
    jp = jax.tree.map(jnp.asarray, p_np)
    js = JaxAdamWState(jnp.asarray(step), jax.tree.map(jnp.asarray, mu),
                       jax.tree.map(jnp.asarray, nu))
    pp = from_reference(pm.defs, p_np)
    ps = opt_from_reference(pm.defs, (step, mu, nu))
    return jm, jp, js, pm, pp, ps


def _batch(cfg, b=4, s=64, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    tg = np.roll(toks, -1, 1)
    bt = {"tokens": torch.from_numpy(toks).long(),
          "targets": torch.from_numpy(tg).long()}
    bj = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tg)}
    if cfg.family == "encdec":                   # whisper's encoder input
        fr = rng.standard_normal((b, cfg.enc_seq, cfg.d_model),
                                 dtype=np.float32)
        bt["frames"], bj["frames"] = torch.from_numpy(fr), jnp.asarray(fr)
    return bt, bj


def _train_step_vs_reference(arch, remat, check):
    """One ``value_and_grad`` and two optimizer steps on each side."""
    jm, jp, js, pm, pp, ps = _pair(arch, remat)
    bt, bj = _batch(pm.cfg)
    # the gradient of one step, leaf by leaf
    grads, loss = grads_of(make_loss_fn(pm), pp, bt)
    (jtot, (jloss, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jm), has_aux=True))(jp, bj)
    check(loss, jloss, "loss")
    with torch.no_grad():
        _, (_, aux) = make_loss_fn(pm)(pp, bt)
    check(aux, jaux, "aux")
    for i, (g, jg) in enumerate(zip(grads, jax.tree.leaves(jgrads))):
        check(g, jg, f"gradient leaf {i}")
    # two train steps
    step = make_train_step(pm, AdamWConfig(**OPT))
    jstep = jax.jit(jax_make_train_step(jm, JaxAdamWConfig(**OPT)))
    for _ in range(2):
        pp, ps, met = step(pp, ps, bt)
        jp, js, jmet = jstep(jp, js, bj)
        for key in ("loss", "grad_norm", "lr"):
            check(met[key], jmet[key], key)
    for a, b in _leaf_pairs(pp, jp):
        check(a, b, "parameters after 2 steps")
    for a, b in _leaf_pairs(ps.mu, js.mu):
        check(a, b, "first moment after 2 steps")
    assert int(ps.step) == int(js.step) == 7
    return pm, grads


@pytest.mark.parametrize("remat", [False, True])
def test_internlm2_train_step_matches_reference(remat):
    _train_step_vs_reference("internlm2-1.8b", remat,
                             lambda a, b, _: _close(a, b, 1e-4))


@pytest.mark.parametrize("remat", [False, True])
def test_zamba2_train_step_matches_reference_at_f32_ratios(remat,
                                                           f32_ratios):
    """Including the shared attention block, applied twice in the smoke
    config: its gradient (the sum over both applications) against
    ``jax.grad``'s."""
    pm, grads = _train_step_vs_reference(
        "zamba2-1.2b", remat, lambda a, b, _: _close(a, b, 1e-4))
    assert pm.n_shared_apps() == 2
    shared = [g for g, (path, _) in zip(grads, _paths(pm.defs))
              if path[0] == "shared"]
    assert shared and all(bool(g.abs().sum() > 0) for g in shared)


def test_zamba2_train_step_within_reference_model_bound():
    """The unpatched reference (bf16 ratios in its Mamba2 layers)."""
    _train_step_vs_reference("zamba2-1.2b", False, _within_bound)


def _paths(tree, prefix=()):
    """(key path, leaf) in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k],
                                                        prefix + (k,))]
    return [(prefix, tree)]


def test_remat_changes_no_gradient():
    """Activation checkpointing recomputes the same forward: the
    gradients with and without it are bitwise equal."""
    out = []
    for remat in (False, True):
        _, _, _, pm, pp, _ = _pair("zamba2-1.2b", remat)
        bt, _ = _batch(pm.cfg)
        out.append(grads_of(make_loss_fn(pm), pp, bt)[0])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_grad_accumulation_invariance():
    """1 microbatch of 4 == 4 microbatches of 1 (same total batch), bf16
    weights, as tests/test_train_substrate.py:91 holds the reference."""
    m1 = build_model("internlm2-1.8b", smoke=True)
    m4 = Model(dataclasses.replace(m1.cfg, microbatches=4))
    params = m1.init(torch.Generator().manual_seed(0))
    bt, _ = _batch(m1.cfg)
    ocfg = AdamWConfig(warmup_steps=1, total_steps=10)
    p1, _, met1 = make_train_step(m1, ocfg)(
        tree_map(torch.clone, params), init_state(params), bt)
    p4, _, met4 = make_train_step(m4, ocfg)(
        tree_map(torch.clone, params), init_state(params), bt)
    assert abs(float(met1["loss"]) - float(met4["loss"])) < 0.02
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0.08, atol=0.02)


def test_loss_decreases_on_tiny_model():
    """tests/test_train_substrate.py:19 on the port: bf16 weights, 8
    steps on one batch."""
    m = build_model("internlm2-1.8b", smoke=True)
    params = m.init(torch.Generator().manual_seed(0))
    opt = init_state(params)
    step = make_train_step(m, AdamWConfig(lr=3e-3, warmup_steps=2,
                                          total_steps=50))
    bt, _ = _batch(m.cfg, s=64, seed=1)
    losses = []
    for _ in range(8):
        params, opt, metrics = step(params, opt, bt)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses


def test_forward_records_a_graph_in_train_mode_only():
    m = build_model("internlm2-1.8b", smoke=True)
    params = tree_map(lambda p: p.float().requires_grad_(),
                      m.init(torch.Generator().manual_seed(0)))
    toks = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    logits, _, _ = m.forward(params, toks, mode="train")
    assert logits.requires_grad
    logits, cache, _ = m.forward(params, toks, mode="prefill")
    assert not logits.requires_grad
    assert not any(t.requires_grad for t in tree_leaves(cache))


# ------------------------------------------------------------ compression

def test_int8_error_feedback_bitwise_reference():
    rng = np.random.default_rng(4)
    res_t = torch.zeros(300)
    res_j = jnp.zeros(300, jnp.float32)
    for _ in range(6):
        g = rng.standard_normal(300, dtype=np.float32) * 3
        q, s, res_t = comp.compress_int8(torch.from_numpy(g), res_t)
        jq, js, res_j = ref_comp.compress_int8(jnp.asarray(g), res_j)
        assert q.dtype == torch.int8
        assert q.numpy().tobytes() == np.asarray(jq).tobytes()
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        assert res_t.numpy().tobytes() == np.asarray(res_j).tobytes()
        assert comp.decompress_int8(q, s).numpy().tobytes() == \
            np.asarray(ref_comp.decompress_int8(jq, js)).tobytes()


def test_ef_compressor_matches_reference_over_steps():
    rng = np.random.default_rng(5)
    shapes = {"a": (4, 3), "b": (7,)}
    init = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    fn, get_res, _ = comp.make_ef_compressor(tree_map(torch.from_numpy,
                                                      init))
    jfn, jget, _ = ref_comp.make_ef_compressor(jax.tree.map(jnp.asarray,
                                                            init))
    for _ in range(4):
        g = {k: rng.standard_normal(s, dtype=np.float32)
             for k, s in shapes.items()}
        out = fn(tree_map(torch.from_numpy, g))
        jout = jfn(jax.tree.map(jnp.asarray, g))
        for a, b in _leaf_pairs(out, jout) + _leaf_pairs(get_res(), jget()):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()


@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=0, max_value=2**31 - 1))
def test_int8_error_feedback_unbiased_over_time(seed):
    """tests/test_train_substrate.py:75 on the port: the dequantized sends
    plus the residual add up to the true accumulated gradient."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    res = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(20):
        q, s, res = comp.compress_int8(g, res)
        total = total + comp.decompress_int8(q, s)
    np.testing.assert_allclose((total + res).numpy(), (20 * g).numpy(),
                               rtol=1e-4, atol=1e-4)
    assert float(res.abs().max()) <= float(g.abs().max())


# ------------------------------------------------------------ checkpoints

def test_checkpoint_manager_async_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = {"w": torch.zeros(4)}
    for s in (1, 2, 3):
        mgr.save_async(s, tree_map(lambda x: x + s, tree))
    mgr.wait()
    got = mgr.restore_latest(tree)
    assert got is not None and got[0] == 3
    assert torch.equal(got[1]["w"], torch.full((4,), 3.0))
    dirs = sorted(os.listdir(tmp_path))
    assert "step_1" not in dirs and "step_3" in dirs


def test_save_async_snapshots_before_an_in_place_update(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    mgr.save_async(1, tree)
    tree["w"].add_(100)                  # the next step, in place
    got = mgr.restore_latest(tree)
    assert torch.equal(got[1]["w"], torch.arange(6, dtype=torch.float32))


def test_restore_latest_falls_back_past_a_torn_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=3)
    tree = {"w": torch.zeros(8), "b": torch.zeros(2, dtype=torch.bfloat16)}
    for s in (1, 2):
        mgr.save_sync(s, tree_map(lambda x: x + s, tree))
    path = os.path.join(mgr.dir_for(2), "leaves.npz")
    with open(path, "r+b") as f:                # torn: half the zip
        f.truncate(os.path.getsize(path) // 2)
    step, got, _ = mgr.restore_latest(tree)
    assert step == 1 and torch.equal(got["w"], torch.ones(8))
    assert got["b"].dtype == torch.bfloat16


def test_train_checkpoints_cross_load_with_reference(tmp_path):
    """Each package's manager restores the other's train checkpoint, bf16
    parameters and f32 moments, bytes equal, in one leaf order."""
    _, jp, js, _, pp, ps = _pair("zamba2-1.2b", False)
    tree = {"params": tree_map(lambda t: t.to(torch.bfloat16), pp),
            "opt": ps}
    jtree = {"params": jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp),
             "opt": js}
    port_mgr = CheckpointManager(str(tmp_path / "port"))
    port_mgr.save_async(7, tree, extra={"stream": {"production": 3}})
    port_mgr.wait()
    ref_mgr = ref_ckpt.CheckpointManager(str(tmp_path / "port"))
    step, got, extra = ref_mgr.restore_latest(jtree)
    assert step == 7 and extra == {"stream": {"production": 3}}
    ours = _host_bytes(tree)
    theirs = [np.asarray(a).tobytes() for a in jax.tree.leaves(got)]
    assert ours == theirs

    ref_mgr = ref_ckpt.CheckpointManager(str(tmp_path / "ref"))
    ref_mgr.save_async(9, jtree)
    ref_mgr.wait()
    step, got, _ = CheckpointManager(str(tmp_path / "ref")).restore_latest(
        tree)
    assert step == 9
    assert _host_bytes(got) == [np.asarray(a).tobytes()
                                for a in jax.tree.leaves(jtree)]
    assert all(a.dtype == b.dtype for a, b in zip(
        _flat(got), _flat(tree)))


def _flat(tree):
    from repro_torch.train.checkpoint import flatten
    return flatten(tree)[0]


def _host_bytes(tree) -> list:
    out = []
    for x in _flat(tree):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        out.append(x.detach().numpy().tobytes())
    return out


# ------------------------------------------- the LM kernels' Functions

def test_flash_function_gradcheck_f64():
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, h, 5, 4)))
               .requires_grad_() for h in (4, 2, 2))
    for causal in (True, False):
        assert torch.autograd.gradcheck(
            lambda q, k, v: flash_ops.attention(q, k, v, causal=causal),
            (q, k, v))


@pytest.mark.parametrize("inclusive,use_u", [(True, False), (False, True)])
def test_gla_function_gradcheck_f64(inclusive, use_u):
    """Both regimes over three chunks (S 10, chunk 4), an initial state
    too."""
    rng = np.random.default_rng(9)
    b, s, h, dk, dv = 1, 10, 2, 3, 2
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape)).requires_grad_()
    q, k, v = t(b, s, h, dk), t(b, s, h, dk), t(b, s, h, dv)
    lw = (-torch.from_numpy(rng.random((b, s, h, dk)) + 0.1)
          ).requires_grad_()
    u = t(h, dk) if use_u else None
    s0 = t(b, h, dk, dv)
    args = (q, k, v, lw, u, s0)
    fn = lambda q, k, v, lw, u, s0: gla_ops.gla_fn(
        q, k, v, lw, u, inclusive=inclusive, chunk=4, initial_state=s0)
    assert torch.autograd.gradcheck(fn, args)


def test_functions_match_plain_autograd_bitwise():
    """On the CPU the Functions' gradients are bitwise autograd's through
    the plain versions, for the model's inputs: transposed [B, S, H, D]
    views (flash), zero-stride broadcast q, k and decay (Mamba2's gla),
    whose gradient ``expand``'s backward sums."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((2, 12, 4, 8),
                                             dtype=np.float32))
    q = x.clone().requires_grad_()
    k, v = (x[:, :, :2].clone().requires_grad_() for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((2, 4, 12, 8),
                                             dtype=np.float32))
    got = torch.autograd.grad(flash_ops.attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)), (q, k, v),
        g)
    want = torch.autograd.grad(attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)), (q, k, v),
        g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    b, s, h, dk, dv = 2, 70, 3, 8, 4
    qb, kb = (torch.from_numpy(rng.standard_normal((b, s, 1, dk),
                                                   dtype=np.float32))
              .requires_grad_() for _ in range(2))
    lw = torch.from_numpy(-rng.random((b, s, h, 1), dtype=np.float32)
                          ).requires_grad_()
    v = torch.from_numpy(rng.standard_normal((b, s, h, dv),
                                             dtype=np.float32)
                         ).requires_grad_()
    go = torch.from_numpy(rng.standard_normal((b, s, h, dv),
                                              dtype=np.float32))

    def run(fn):
        out, _ = fn(qb.expand(b, s, h, dk), kb.expand(b, s, h, dk), v,
                    lw.expand(b, s, h, dk))
        return torch.autograd.grad(out, (qb, kb, v, lw), go)

    got = run(lambda *a: gla_ops.gla_fn(*a, inclusive=True))
    want = run(lambda *a: gla_chunk_ref(*a, inclusive=True))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ssd_regime_gradient_agrees_with_the_chunked_form():
    """bf16 Mamba2 inputs (the SSD design's regime) take the gradient of
    ``gla_ssd_ref``, the SSD decomposition's plain version; it agrees
    with autograd through ``gla_chunk_ref`` in f32 within bf16
    rounding."""
    rng = np.random.default_rng(11)
    b, s, h, dk, dv = 1, 128, 4, 16, 16
    base = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for shape in ((b, s, 1, dk), (b, s, 1, dk), (b, s, h, dv))]
    lw0 = torch.from_numpy(-rng.random((b, s, h, 1), dtype=np.float32))
    go = torch.from_numpy(rng.standard_normal((b, s, h, dv),
                                              dtype=np.float32))
    grads = {}
    for name, dtype, fn in (
            ("ssd", torch.bfloat16,
             lambda *a: gla_ops.gla_fn(*a, inclusive=True)),
            ("chunk", torch.float32,
             lambda *a: gla_chunk_ref(*a, inclusive=True))):
        qb, kb, v = (x.to(dtype).requires_grad_() for x in base)
        lw = lw0.clone().requires_grad_()
        assert (name == "ssd") == gla_ops.takes_ssd(
            qb.expand(b, s, h, dk), kb.expand(b, s, h, dk), v,
            lw.expand(b, s, h, dk), None, True)
        out, _ = fn(qb.expand(b, s, h, dk), kb.expand(b, s, h, dk), v,
                    lw.expand(b, s, h, dk))
        grads[name] = torch.autograd.grad(out, (qb, kb, v, lw),
                                          go.to(dtype))
    for a, want in zip(grads["ssd"], grads["chunk"]):
        scale = float(want.abs().max())
        assert float((a.float() - want).abs().max()) <= 2e-2 * scale


def test_kernel_wrappers_raise_for_inputs_that_require_grad():
    """The bare wrappers have no graph: with grad mode on and an input
    requiring grad they raise instead of dropping the gradient."""
    q = torch.zeros((1, 2, 4, 16), requires_grad=True)
    k = torch.zeros((1, 1, 4, 16))
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_ops.mha(q, k, k)
    with torch.no_grad():
        flash_ops.mha(q, k, k)
    x = torch.zeros((1, 64, 2, 8))
    lw = torch.zeros((1, 64, 2, 8), requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        gla_ops.gla(x, x, x, lw, inclusive=True)
    with torch.no_grad():
        gla_ops.gla(x, x, x, lw, inclusive=True)
    out = gla_ops.gla_fn(x, x, x, lw, inclusive=True)[0]
    assert out.requires_grad
