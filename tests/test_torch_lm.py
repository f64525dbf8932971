"""The port's LM serving path against the JAX package on the CPU, for
``internlm2-smoke`` and ``zamba2-smoke``: the reference's ``Model.init``
weights carried across by ``models/convert.py``, both sides in f32
(parameters cast to f32), inputs drawn with numpy from a seed.

Tolerances: 1e-4 (absolute and relative) wherever both sides run the
same f32 arithmetic up to summation order — layers, blocks, the dense
model's logits and caches. Zamba2's Mamba2 layers call the reference's
``gla_chunk`` with bf16 decay ratios by default (``models/gla.py:33``)
where the port computes f32, so the zamba2 model is held at the
reference's own model bound, 0.02 x max(|logits|, 1)
(tests/test_models_smoke.py:93), and again at 1e-4 with the reference
switched to f32 ratios for the test (``ratio_dtype`` is a parameter of
its ``gla_chunk``; the JAX package itself is untouched)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro.models import blocks as jax_blocks
from repro.models import build_model as jax_build_model
from repro.models import gla as jax_gla
from repro.models import layers as jax_layers
from repro.train.serve_step import make_decode_step as jax_decode_step
from repro.train.serve_step import make_prefill_step as jax_prefill_step
from repro_torch.examples import serve_lm
from repro_torch.models import blocks, build_model, layers
from repro_torch.models.convert import from_reference
from repro_torch.models.param import (ParamDef, count_params, tree_leaves,
                                      tree_map)
from repro_torch.train.serve_step import make_decode_step, make_prefill_step

ARCHS = ["internlm2-1.8b", "zamba2-1.2b"]
# every arch the port registers: the reference's six, one per family
ALL_ARCHS = ["internlm2-1.8b", "qwen2-moe-a2.7b", "qwen2-vl-7b", "rwkv6-7b",
             "whisper-small", "zamba2-1.2b"]
TOL = 1e-4
_cache = {}


@pytest.fixture
def f32_ratios(monkeypatch):
    """The reference's Mamba2 layers with f32 decay ratios (the port's and
    the Pallas kernel's precision)."""
    monkeypatch.setattr(jax_gla, "gla_chunk", functools.partial(
        jax_gla.gla_chunk, ratio_dtype=jnp.float32))


def _models(arch):
    """(JAX model, JAX f32 params, port model, port f32 params)."""
    if arch not in _cache:
        jm = jax_build_model(arch, smoke=True)
        jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jax.jit(jm.init)(jax.random.PRNGKey(0)))
        pm = build_model(arch, smoke=True)
        pp = from_reference(pm.defs, jax.tree.map(np.asarray, jp))
        _cache[arch] = (jm, jp, pm, pp)
    return _cache[arch]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _tokens(cfg, b=2, s=40, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _tree_close(got, want, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _tree_close(got[k], want[k], tol)
    else:
        _close(got, want, tol)


def _pad_kv(c, p, tail):
    """The reference test's cache growth: K/V padded from p to p + tail."""
    def one(x):
        if isinstance(x, dict):
            return {k: (one(v) if isinstance(v, dict) or k not in ("k", "v")
                        else _pad_seq(v, p, tail)) for k, v in x.items()}
        return x
    return one(c)


def _pad_seq(x, p, tail):
    ax = x.ndim - 3                               # [..., S, Hkv, hd]
    assert x.shape[ax] == p
    if isinstance(x, torch.Tensor):
        pad = torch.zeros(x.shape[:ax] + (tail,) + x.shape[ax + 1:],
                          dtype=x.dtype)
        return torch.cat([x, pad], dim=ax)
    widths = [(0, 0)] * x.ndim
    widths[ax] = (0, tail)
    return jnp.pad(x, widths)


# ----------------------------------------------------------------- layers

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_match_reference(arch):
    import dataclasses
    import repro.configs as jax_configs
    import repro_torch.configs as port_configs
    for get in ("get_config", "get_smoke_config"):
        got = getattr(port_configs, get)(arch)
        want = getattr(jax_configs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.padded_vocab == want.padded_vocab
    assert port_configs.list_archs() == ALL_ARCHS == jax_configs.list_archs()



def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 32), dtype=np.float32)
    w = rng.standard_normal(32, dtype=np.float32)
    _close(layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
           jax_layers.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    pos = np.broadcast_to(np.arange(5, 14, dtype=np.int32), (2, 9))
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                             1e4),
           jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    mlp = {k: rng.standard_normal(shape, dtype=np.float32) * 0.2
           for k, shape in (("w_gate", (32, 48)), ("w_up", (32, 48)),
                            ("w_down", (48, 32)))}
    h = rng.standard_normal((3, 7, 32), dtype=np.float32)
    _close(layers.swiglu_mlp(tree_map(torch.from_numpy, mlp),
                             torch.from_numpy(h)),
           jax_layers.swiglu_mlp(jax.tree.map(jnp.asarray, mlp),
                                 jnp.asarray(h)))
    table = rng.standard_normal((300, 32), dtype=np.float32)
    _close(layers.unembed(torch.from_numpy(table), torch.from_numpy(h)),
           jax_layers.unembed(jnp.asarray(table), jnp.asarray(h)))


def test_attention_regimes_match_reference():
    """``attend_full`` (probabilities rounded to the compute dtype, here
    f32), ``attend_decode`` against a bf16 cache at several lengths, and
    ``attend_prefill`` (the flash kernel's plain version) against the
    reference's ``attend_full``."""
    from repro_torch.models import attention
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 24, h, 16), dtype=np.float32)
               for h in (4, 2, 2))
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))
    _close(attention.attend_full(qt, kt, vt, causal=True, q_offset=0),
           jax_attn.attend_full(qj, kj, vj, causal=True))
    _close(attention.attend_full(qt[:, -5:], kt, vt, causal=True,
                                 q_offset=19),
           jax_attn.attend_full(qj[:, -5:], kj, vj, causal=True,
                                q_offset=19))
    _close(attention.attend_prefill(qt, kt, vt),
           jax_attn.attend_full(qj, kj, vj, causal=True))
    for n in (1, 17, 24):
        got = attention.attend_decode(
            qt[:, :1], kt.to(torch.bfloat16), vt.to(torch.bfloat16),
            cache_len=n)
        want = jax_attn.attend_decode(
            qj[:, :1], kj.astype(jnp.bfloat16), vj.astype(jnp.bfloat16),
            cache_len=jnp.asarray(n))
        assert got.dtype == torch.float32
        _close(got, want)


def test_param_init_and_convert_checks():
    pm = build_model("internlm2-1.8b", smoke=True)
    params = pm.init(torch.Generator().manual_seed(0))
    assert count_params(pm.defs) == sum(t.numel() for t in _leaves(params))
    wq = params["layers"]["attn"]["wq"].float()
    std = 1.0 / np.sqrt(wq.shape[-2])
    assert params["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert float(wq.abs().max()) <= 2 * std * 1.01       # truncated at 2 std
    assert 0.8 * std < float(wq.std()) < 0.95 * std      # 0.88 std when cut
    assert bool((params["layers"]["ln1"] == 1).all())
    again = pm.init(torch.Generator().manual_seed(0))
    assert torch.equal(again["embed"], params["embed"])
    tree = tree_map(lambda t: t.float().numpy(), params)
    del tree["final_norm"]
    with pytest.raises(ValueError):
        from_reference(pm.defs, tree)
    tree = tree_map(lambda t: t.float().numpy(), params)
    tree["embed"] = tree["embed"][:-1]
    with pytest.raises(ValueError):
        from_reference(pm.defs, tree)
    with pytest.raises(ValueError):
        ParamDef((2, 3), ("embed",))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_convert_takes_bf16_arrays():
    jm, _, pm, _ = _models("internlm2-1.8b")
    raw = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(1)))
    got = from_reference(pm.defs, raw)
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got["embed"]),
                                  raw["embed"].astype(np.float32))


# ----------------------------------------------------------------- blocks

def _positions(b, s, offset=0):
    pos = np.broadcast_to(np.arange(offset, offset + s, dtype=np.int32),
                          (b, s)).copy()
    return torch.from_numpy(pos), jnp.asarray(pos)


def _hidden(cfg, b=2, s=40, seed=5):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model), dtype=np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def test_decoder_block_matches_reference():
    jm, jp, pm, pp = _models("internlm2-1.8b")
    cfg = pm.cfg
    lp = tree_map(lambda a: a[1], pp["layers"])
    jlp = jax.tree.map(lambda a: a[1], jp["layers"])
    xt, xj = _hidden(cfg)
    pt, pj = _positions(2, 40)
    for mode in ("train", "prefill"):
        y, c, _ = blocks.decoder_block(lp, xt, cfg, mode=mode, positions=pt)
        jy, jc, _ = jax_blocks.decoder_block(jlp, xj, jm.cfg, mode=mode,
                                             positions=pj)
        _close(y, jy)
        if mode == "prefill":
            assert c["k"].dtype == torch.bfloat16        # as the reference
            _tree_close(c, jc, 1e-2)                     # bf16 rounding
    # one decode step at position 40 against a 48-deep cache
    _, cache, _ = jax_blocks.decoder_block(jlp, xj, jm.cfg, mode="prefill",
                                           positions=pj)
    jcache = _pad_kv(cache, 40, 8)
    tcache = tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32)
                                                 ).to(torch.bfloat16),
                      jax.tree.map(np.asarray, jcache))
    xt1, xj1 = _hidden(cfg, s=1, seed=6)
    pt1, pj1 = _positions(2, 1, 40)
    y, out_cache, _ = blocks.decoder_block(lp, xt1, cfg, mode="decode",
                                        positions=pt1, cache=tcache,
                                        cache_index=40)
    jy, jc, _ = jax_blocks.decoder_block(jlp, xj1, jm.cfg, mode="decode",
                                         positions=pj1, cache=jcache,
                                         cache_index=40)
    assert out_cache is tcache                           # updated in place
    _close(y, jy)
    _tree_close(tcache, jc, 1e-2)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 30, 12), dtype=np.float32)
    w = rng.standard_normal((4, 12), dtype=np.float32)
    st = rng.standard_normal((2, 3, 12), dtype=np.float32)
    for state in (None, st):
        y, ns = blocks._causal_conv(
            torch.from_numpy(x), torch.from_numpy(w),
            None if state is None else torch.from_numpy(state))
        jy, jns = jax_blocks._causal_conv(
            jnp.asarray(x), jnp.asarray(w),
            None if state is None else jnp.asarray(state))
        _close(y, jy)
        _close(ns, jns)


@pytest.mark.usefixtures("f32_ratios")
def test_mamba2_block_matches_reference():
    jm, jp, pm, pp = _models("zamba2-1.2b")
    cfg = pm.cfg
    lp = tree_map(lambda a: a[2], pp["layers"])
    jlp = jax.tree.map(lambda a: a[2], jp["layers"])
    jblock = jax.jit(jax_blocks.mamba2_block, static_argnames=("cfg", "mode"))
    xt, xj = _hidden(cfg, s=70)                   # one full chunk + a tail
    y, c, _ = blocks.mamba2_block(lp, xt, cfg, mode="train")
    jy, jc, _ = jblock(jlp, xj, jm.cfg, mode="train")
    assert c is None and jc is None
    _close(y, jy)
    y, c, _ = blocks.mamba2_block(lp, xt, cfg, mode="prefill")
    jy, jc, _ = jblock(jlp, xj, jm.cfg, mode="prefill")
    _close(y, jy)
    _tree_close(c, jc)
    xt1, xj1 = _hidden(cfg, s=1, seed=9)
    y, c2, _ = blocks.mamba2_block(lp, xt1, cfg, mode="decode", cache=c)
    jy, jc2, _ = jblock(jlp, xj1, jm.cfg, mode="decode", cache=jc)
    assert c2 is c
    _close(y, jy)
    _tree_close(c2, jc2)


def test_shared_attention_matches_reference():
    jm, jp, pm, pp = _models("zamba2-1.2b")
    cfg = pm.cfg
    xt, xj = _hidden(cfg, s=33)
    pt, pj = _positions(2, 33)
    y, c = blocks.self_attention(pp["shared"]["attn"], xt, cfg,
                                 mode="prefill", positions=pt)
    jy, jc = jax_blocks.self_attention(jp["shared"]["attn"], xj, jm.cfg,
                                       mode="prefill", positions=pj)
    _close(y, jy)
    _tree_close(c, jc, 1e-2)


# ------------------------------------------------------------ whole model

def _forward_all_modes(arch, tol):
    jm, jp, pm, pp = _models(arch)
    # a fresh jit per call: the f32-ratio patch must be traced in
    jforward = jax.jit(jm.forward, static_argnames=("mode",))
    toks = _tokens(pm.cfg)
    tt, tj = torch.from_numpy(toks).long(), jnp.asarray(toks)
    logits, cache, _ = pm.forward(pp, {"tokens": tt}, mode="train")
    jl, jc, _ = jforward(jp, {"tokens": tj}, mode="train")
    assert cache is None and logits.shape == (2, 40, pm.cfg.vocab)
    scale = max(float(np.abs(_np(jl)).max()), 1.0)
    _close(logits, jl, tol * scale)
    p = 36
    logits, cache, _ = pm.forward(pp, {"tokens": tt[:, :p]}, mode="prefill")
    jl, jc, _ = jforward(jp, {"tokens": tj[:, :p]}, mode="prefill")
    _close(logits, jl, tol * scale)
    _tree_close(cache, jc, max(tol * scale, 1e-2))       # bf16 K/V
    cache, jc = _pad_kv(cache, p, 4), _pad_kv(jc, p, 4)
    for t in range(p, 40):
        logits, cache, _ = pm.forward(pp, {"tokens": tt[:, t:t + 1]},
                                   mode="decode", cache=cache, cache_index=t)
        jl, jc, _ = jforward(jp, {"tokens": tj[:, t:t + 1]},
                             mode="decode", cache=jc, cache_index=t)
        _close(logits, jl, tol * scale)


def test_internlm2_forward_matches_reference():
    _forward_all_modes("internlm2-1.8b", TOL)


@pytest.mark.usefixtures("f32_ratios")
def test_zamba2_forward_matches_reference_at_f32_ratios():
    _forward_all_modes("zamba2-1.2b", TOL)


def test_zamba2_forward_within_reference_model_bound():
    """The unpatched reference (bf16 ratios in its Mamba2 layers) against
    the port, at the reference's own model bound."""
    _forward_all_modes("zamba2-1.2b", 0.02)


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_aux_matches_reference(arch, mode):
    """``Model.forward`` returns the reference's third value: the f32
    scalar aux loss on the model's device, bitwise the reference's (0.0
    for the dense and hybrid families)."""
    jm, jp, pm, pp = _models(arch)
    toks = _tokens(pm.cfg, s=16)
    logits, _, aux = pm.forward(pp, {"tokens": torch.from_numpy(
        toks).long()}, mode=mode)
    _, _, jaux = jax.jit(jm.forward, static_argnames=("mode",))(
        jp, {"tokens": jnp.asarray(toks)}, mode=mode)
    assert aux.shape == () and aux.dtype == torch.float32
    assert aux.device == logits.device
    assert aux.numpy().tobytes() == np.asarray(jaux, np.float32).tobytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_greedy_tokens_match_reference(arch, f32_ratios):
    jm, jp, pm, pp = _models(arch)
    toks = _tokens(pm.cfg, s=24, seed=4)
    tok, cache = make_prefill_step(pm)(pp, {"tokens": torch.from_numpy(
        toks).long()})
    jtok, jc = jax.jit(jax_prefill_step(jm))(jp, {"tokens":
                                                  jnp.asarray(toks)})
    cache, jc = _pad_kv(cache, 24, 6), _pad_kv(jc, 24, 6)
    decode, jdecode = make_decode_step(pm), jax.jit(jax_decode_step(jm))
    got, want = [tok], [jtok]
    for i in range(6):
        tok, logits, cache = decode(pp, cache, got[-1][:, None].long(),
                                    24 + i)
        jtok, jlogits, jc = jdecode(jp, jc, want[-1][:, None],
                                    jnp.asarray(24 + i, jnp.int32))
        assert logits.shape == (2, pm.cfg.vocab)
        got.append(tok)
        want.append(jtok)
    np.testing.assert_array_equal(np.stack([t.numpy() for t in got], 1),
                                  np.stack([np.asarray(t) for t in want], 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    """The reference's tests/test_models_smoke.py test on the port, in the
    configs' own bf16: decode logits of the last 4 positions against one
    full forward, within 0.02 x max(|logits|, 1)."""
    m = build_model(arch, smoke=True)
    cfg = m.cfg
    params = m.init(torch.Generator().manual_seed(2))
    b, s, tail = 2, 64, 4
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, s)))
    full, _, _ = m.forward(params, {"tokens": toks}, mode="train")
    p = s - tail
    _, pre, _ = m.forward(params, {"tokens": toks[:, :p]}, mode="prefill")
    cache = serve_lm.fill_cache(m.init_cache(b, s, device="cpu"), pre)
    errs = []
    for t in range(p, s):
        dl, cache, _ = m.forward(params, {"tokens": toks[:, t:t + 1]},
                              mode="decode", cache=cache, cache_index=t)
        errs.append(float((dl[:, 0] - full[:, t]).abs().max()))
    scale = float(full.abs().max())
    assert max(errs) < 0.02 * max(scale, 1.0), (max(errs), scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_example_runs_on_cpu(arch, capsys):
    out = serve_lm.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert out["tokens"].shape == (4, 16)
    assert out["logits"].shape[:2] == (4, 15)
    assert bool(torch.isfinite(out["logits"]).all())
    text = capsys.readouterr().out
    assert "prefill 4 x 48 tokens" in text and "decode: 15 steps" in text


def test_serve_lm_example_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError):
        serve_lm.main(["--smoke"])


def test_init_cache_needs_a_card_unless_told_cpu():
    """Like every entry point, ``init_cache`` puts its cache on the card
    unless the caller asks for the CPU, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError):
        build_model(ARCHS[0], smoke=True).init_cache(1, 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_honours_device_cpu(arch):
    m = build_model(arch, smoke=True)
    cache = m.init_cache(2, 16, device="cpu")
    got, defs = tree_leaves(cache), tree_leaves(m.cache_defs(2, 16))
    assert len(got) == len(defs) > 0
    for t, d in zip(got, defs):
        assert t.device.type == "cpu" and t.dtype == d.dtype
        assert tuple(t.shape) == tuple(d.shape) and not bool(t.any())
