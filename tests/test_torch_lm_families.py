"""The port's four other LM families against the JAX package on the CPU:
rwkv6 (ssm), qwen2-moe (moe), qwen2-vl (vlm, M-RoPE) and whisper
(encdec) — their layers, the MoE FFN, every new block in each mode, the
whole smoke models (train, prefill and decode: logits, caches and aux),
the serve steps' greedy tokens and ``serve_lm``.

Weights come from the reference's ``Model.init``, carried across by
``models/convert.py``; both sides run in f32 (parameters cast to f32);
inputs are drawn with numpy from a seed. Tolerance: 1e-4, absolute and
relative, as in ``tests/test_torch_lm.py`` (1e-4 x max(|logits|, 1) for
whole models); the bf16 caches at 1e-2 (one bf16 rounding of values equal
to 1e-4), and positions and keep masks as integers, exactly. RWKV6's
reference computes its decay ratios in f32 (``ratio_dtype=jnp.float32``
in its time mix), the port's precision, so no patch is needed. The
prefill/decode consistency checks run the port alone, in the configs'
bf16, at the reference's own bound 0.02 x max(|logits|, 1)
(tests/test_models_smoke.py:54); MoE is left out there, as the reference
leaves it out (a dispatch group's capacity depends on its token count).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import attention as jax_attn
from repro.models import blocks as jax_blocks
from repro.models import build_model as jax_build_model
from repro.models import gla as jax_gla
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.train.serve_step import make_decode_step as jax_decode_step
from repro.train.serve_step import make_prefill_step as jax_prefill_step
from repro_torch.configs import MoEConfig, list_archs
from repro_torch.examples import serve_lm
from repro_torch.kernels.gla_chunk import ops as gla_ops
from repro_torch.models import blocks, build_model, gla, layers, moe
from repro_torch.models.convert import from_reference
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.train.serve_step import make_decode_step, make_prefill_step

ARCHS = ["rwkv6-7b", "qwen2-moe-a2.7b", "qwen2-vl-7b", "whisper-small"]
CONSISTENT = ["rwkv6-7b", "qwen2-vl-7b", "whisper-small"]
TOL = 1e-4
_cache = {}


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


def _cache_close(got, want, tol=TOL):
    """Cache trees leaf by leaf: bf16 leaves (K/V) at 1e-2, the rest
    (recurrent states, token shifts) at ``tol``."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _cache_close(got[k], want[k], tol)
        return
    assert tuple(got.shape) == tuple(want.shape)
    bf16 = got.dtype == torch.bfloat16
    assert bf16 == (want.dtype == jnp.bfloat16)
    _close(got, want, 1e-2 if bf16 else tol)


def _pad_kv(c, p, tail):
    """The reference test's cache growth: self-attention K/V padded from p
    to p + tail positions (whisper's encoder K/V and the recurrent states
    stay)."""
    out = {}
    for k, x in c.items():
        if k not in ("k", "v"):
            out[k] = x
            continue
        ax = x.ndim - 3                               # [..., S, Hkv, hd]
        assert x.shape[ax] == p
        if isinstance(x, torch.Tensor):
            pad = torch.zeros(x.shape[:ax] + (tail,) + x.shape[ax + 1:],
                              dtype=x.dtype)
            out[k] = torch.cat([x, pad], dim=ax)
        else:
            widths = [(0, 0)] * x.ndim
            widths[ax] = (0, tail)
            out[k] = jnp.pad(x, widths)
    return out


def _batches(cfg, b=2, s=40, seed=3):
    """(port batch, reference batch): tokens, and whisper's frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    bt, bj = ({"tokens": torch.from_numpy(toks).long()},
              {"tokens": jnp.asarray(toks)})
    if cfg.family == "encdec":
        fr = rng.standard_normal((b, cfg.enc_seq, cfg.d_model),
                                 dtype=np.float32)
        bt["frames"], bj["frames"] = torch.from_numpy(fr), jnp.asarray(fr)
    return bt, bj


def _cut(batch, lo, hi):
    """The tokens [lo, hi) of a batch (frames kept)."""
    return dict(batch, tokens=batch["tokens"][:, lo:hi])


def _hidden(d, b=2, s=40, seed=5):
    x = np.random.default_rng(seed).standard_normal((b, s, d),
                                                    dtype=np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def _layer_params(arch, i=1, key="layers"):
    _, jp, _, pp = _models(arch)
    return (tree_map(lambda a: a[i], pp[key]),
            jax.tree.map(lambda a: a[i], jp[key]))


# ---------------------------------------------------------------- configs

def test_all_six_archs_build_and_count():
    """``build_model`` builds every registered arch at full size (the
    ParamDef tree only) with the reference's parameter count and leaf
    shapes."""
    import math
    assert len(list_archs()) == 6
    for arch in list_archs():
        pm = build_model(arch)
        jm = jax_build_model(arch)
        assert pm.cfg.param_count() == jm.cfg.param_count()
        got = tree_leaves(pm.defs)
        want = jax.tree.leaves(jm.defs, is_leaf=lambda x: hasattr(x, "axes"))
        assert [d.shape for d in got] == [tuple(d.shape) for d in want]
        assert sum(math.prod(d.shape) for d in got) > 1e8


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_each_family(arch):
    """The reference's own init tree (bf16 leaves, the MoE router f32)
    carried across leaf for leaf, bitwise, each leaf in its ParamDef's
    dtype."""
    jm = jax_build_model(arch, smoke=True)
    raw = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(1)))
    pm = build_model(arch, smoke=True)
    got = from_reference(pm.defs, raw)
    for t, d, r in zip(tree_leaves(got), tree_leaves(pm.defs),
                       jax.tree.leaves(raw)):
        assert t.dtype == d.dtype and tuple(t.shape) == d.shape
        np.testing.assert_array_equal(_np(t), r.astype(np.float32))
    if arch == "qwen2-moe-a2.7b":
        assert got["layers"]["moe"]["router"].dtype == torch.float32


# ----------------------------------------------------------------- layers

def test_new_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 64), dtype=np.float32) * 3 + 1
    w, bias = (rng.standard_normal(64, dtype=np.float32) for _ in range(2))
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, bias))
    xj, wj, bj = (jnp.asarray(a) for a in (x, w, bias))
    _close(layers.layernorm(xt, wt, bt), jax_layers.layernorm(xj, wj, bj))
    _close(layers.groupnorm_heads(xt, wt, bt, 4),
           jax_layers.groupnorm_heads(xj, wj, bj, 4))
    mlp = {"w_up": rng.standard_normal((64, 96), dtype=np.float32) * 0.3,
           "w_down": rng.standard_normal((96, 64), dtype=np.float32) * 0.1}
    _close(layers.gelu_mlp(tree_map(torch.from_numpy, mlp), xt),
           jax_layers.gelu_mlp(jax.tree.map(jnp.asarray, mlp), xj))
    for seq, d, off in ((16, 64, 0), (1, 768, 447), (1500, 768, 0)):
        _close(layers.sinusoidal_pos(seq, d, off),
               jax_layers.sinusoidal_pos(seq, d, off))


def test_mrope_matches_reference_and_reduces_to_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 32), dtype=np.float32)
    pos = rng.integers(0, 500, (2, 9, 3)).astype(np.int32)
    _close(layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                              1e6),
           jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    # text: the three position streams coincide and M-RoPE is RoPE
    text = np.broadcast_to(np.arange(3, 12, dtype=np.int32)[None, :, None],
                           (2, 9, 3)).copy()
    _close(layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(text),
                              1e6),
           layers.apply_rope(torch.from_numpy(x),
                             torch.from_numpy(text[..., 0].copy()), 1e6))


# -------------------------------------------------------------------- moe

def _moe_case(cfg, d, b, s, seed, skew=0.0):
    """Random MoE params (``skew`` added to expert 0's router column so
    that its queue overflows) and an input, numpy."""
    rng = np.random.default_rng(seed)
    e, fe = cfg.padded_experts, cfg.d_ff_expert
    p = {"router": rng.standard_normal((d, e), dtype=np.float32),
         "w_gate": rng.standard_normal((e, d, fe), dtype=np.float32) * 0.2,
         "w_up": rng.standard_normal((e, d, fe), dtype=np.float32) * 0.2,
         "w_down": rng.standard_normal((e, fe, d), dtype=np.float32) * 0.2}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * fe
        p["shared"] = {
            "w_gate": rng.standard_normal((d, fs), dtype=np.float32) * 0.2,
            "w_up": rng.standard_normal((d, fs), dtype=np.float32) * 0.2,
            "w_down": rng.standard_normal((fs, d), dtype=np.float32) * 0.2}
    x = rng.standard_normal((b, s, d), dtype=np.float32)
    p["router"][:, 0] += skew * np.sign(x.mean(axis=(0, 1)))
    return p, x


MOE_CASES = {
    # padded experts (8 of which 6 route) and a skewed router: expert 0's
    # queue overflows and drops
    "padded_overflow": (dict(n_experts=6, top_k=2, n_shared_experts=1,
                             d_ff_expert=16, group_size=32,
                             n_experts_padded=8, capacity_factor=1.0),
                        3, 40, 4.0),
    "smoke_config": (dict(n_experts=6, top_k=2, n_shared_experts=2,
                          d_ff_expert=64, group_size=64), 2, 40, 0.0),
    "decode": (dict(n_experts=60, top_k=4, n_shared_experts=4,
                    d_ff_expert=16, n_experts_padded=64), 4, 1, 0.0),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches_reference(case):
    kw, b, s, skew = MOE_CASES[case]
    cfg, jcfg = MoEConfig(**kw), JaxMoEConfig(**kw)
    p, x = _moe_case(cfg, 32, b, s, seed=4, skew=skew)
    out, aux = moe.moe_ffn(tree_map(torch.from_numpy, p),
                           torch.from_numpy(x), cfg)
    jout, jaux = jax_moe.moe_ffn(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x), jcfg)
    _close(out, jout)
    _close(aux, jaux)
    assert aux.dtype == torch.float32 and aux.shape == ()


def test_assign_positions_matches_reference_exactly():
    """Positions and keep masks as integers, equal: groups with an
    overflowing expert (dropped assignments) and the padded experts'
    indices never chosen."""
    rng = np.random.default_rng(6)
    e, cap = 8, 12
    idx = rng.integers(0, 6, (3, 80)).astype(np.int32)   # 6 of 8 route
    idx[1, :40] = 0                                      # expert 0 overflows
    pos, keep = moe.assign_positions(torch.from_numpy(idx), e, cap)
    for g in range(idx.shape[0]):
        jpos, jkeep = jax_moe.assign_positions(jnp.asarray(idx[g]), e, cap)
        np.testing.assert_array_equal(pos[g].numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(keep[g].numpy(), np.asarray(jkeep))
    assert not bool(keep[1].all()) and bool(keep[1, 40:].any())


def test_moe_ffn_drops_over_capacity():
    """The overflow case really drops: expert 0's queue holds more
    assignments than its capacity."""
    kw, b, s, skew = MOE_CASES["padded_overflow"]
    cfg = MoEConfig(**kw)
    p, x = _moe_case(cfg, 32, b, s, seed=4, skew=skew)
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, 32)
                          @ torch.from_numpy(p["router"])[:, :6], -1)
    first = torch.topk(probs, 2, -1).indices[:, 0]
    capacity = (max(int(40 * 2 * 1.0 / 6), 1) + 3) // 4 * 4
    assert int((first[:40] == 0).sum()) > capacity


# ----------------------------------------------------------------- blocks

@pytest.mark.parametrize("with_cache", [False, True])
def test_rwkv6_time_mix_matches_reference(with_cache):
    jm, _, pm, _ = _models("rwkv6-7b")
    cfg = pm.cfg
    lp, jlp = _layer_params("rwkv6-7b")
    xt, xj = _hidden(cfg.d_model, s=70)                 # a chunk + a tail
    cache = jcache = None
    if with_cache:
        rng = np.random.default_rng(7)
        h = cfg.ssm.n_ssm_heads
        dk = cfg.d_model // h
        c = {"state": rng.standard_normal((2, h, dk, dk), dtype=np.float32),
             "shift_tm": rng.standard_normal((2, cfg.d_model),
                                             dtype=np.float32)}
        # copies: JAX may alias numpy memory, and decode updates in place
        cache = tree_map(lambda a: torch.from_numpy(a.copy()), c)
        jcache = jax.tree.map(jnp.asarray, c)
    for mode in ("train", "prefill"):
        y, c = blocks.rwkv6_time_mix(lp["tm"], xt, cfg, mode=mode,
                                     cache=cache)
        jy, jc = jax_blocks.rwkv6_time_mix(jlp["tm"], xj, jm.cfg, mode=mode,
                                           cache=jcache, ctx=None)
        _close(y, jy)
        assert (c is None) == (jc is None) == (mode == "train")
        if c is not None:
            _cache_close(c, jc)
    if with_cache:                                      # one decode step
        xt1, xj1 = _hidden(cfg.d_model, s=1, seed=8)
        y, c = blocks.rwkv6_time_mix(lp["tm"], xt1, cfg, mode="decode",
                                     cache=cache)
        jy, jc = jax_blocks.rwkv6_time_mix(jlp["tm"], xj1, jm.cfg,
                                           mode="decode", cache=jcache,
                                           ctx=None)
        assert c is cache                                # in place
        _close(y, jy)
        _cache_close(c, jc)


def test_rwkv6_channel_mix_matches_reference():
    jm, _, pm, _ = _models("rwkv6-7b")
    lp, jlp = _layer_params("rwkv6-7b", 0)
    xt, xj = _hidden(pm.cfg.d_model, s=33)
    prev = np.random.default_rng(9).standard_normal((2, pm.cfg.d_model),
                                                    dtype=np.float32)
    for cache, jcache in ((None, None),
                          ({"shift_cm": torch.from_numpy(prev)},
                           {"shift_cm": jnp.asarray(prev)})):
        y, last = blocks.rwkv6_channel_mix(lp["cm"], xt, cache=cache)
        jy, jlast = jax_blocks.rwkv6_channel_mix(jlp["cm"], xj, cache=jcache)
        _close(y, jy)
        _close(last, jlast)


def test_rwkv6_block_matches_reference():
    jm, _, pm, _ = _models("rwkv6-7b")
    cfg = pm.cfg
    lp, jlp = _layer_params("rwkv6-7b")
    jblock = jax.jit(jax_blocks.rwkv6_block, static_argnames=("cfg", "mode"))
    xt, xj = _hidden(cfg.d_model, s=70)
    y, c, aux = blocks.rwkv6_block(lp, xt, cfg, mode="train")
    jy, jc, _ = jblock(jlp, xj, jm.cfg, mode="train")
    assert c is None and jc is None and float(aux) == 0.0
    _close(y, jy)
    y, c, _ = blocks.rwkv6_block(lp, xt, cfg, mode="prefill")
    jy, jc, _ = jblock(jlp, xj, jm.cfg, mode="prefill")
    _close(y, jy)
    _cache_close(c, jc)
    for t in range(2):                                  # two decode steps
        xt1, xj1 = _hidden(cfg.d_model, s=1, seed=10 + t)
        y, c2, _ = blocks.rwkv6_block(lp, xt1, cfg, mode="decode", cache=c)
        jy, jc, _ = jblock(jlp, xj1, jm.cfg, mode="decode", cache=jc)
        assert c2 is c
        _close(y, jy)
        _cache_close(c, jc)


def test_gla_step_with_bonus_matches_reference():
    """RWKV6's decode step (lag-1 read, bonus u) and Mamba2's (inclusive)
    against the reference's ``gla_step``."""
    rng = np.random.default_rng(11)
    q, k = (rng.standard_normal((2, 4, 16), dtype=np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 4, 24), dtype=np.float32)
    lw = -np.exp(rng.standard_normal((2, 4, 16), dtype=np.float32) * 2)
    st = rng.standard_normal((2, 4, 16, 24), dtype=np.float32)
    u = rng.standard_normal((4, 16), dtype=np.float32)
    for inclusive, uu in ((False, u), (True, None)):
        o, s = gla.gla_step(*(torch.from_numpy(a) for a in (q, k, v, lw, st)),
                            u=None if uu is None else torch.from_numpy(uu),
                            inclusive=inclusive)
        jo, js = jax_gla.gla_step(*(jnp.asarray(a) for a in (q, k, v, lw,
                                                             st)),
                                  u=None if uu is None else jnp.asarray(uu),
                                  inclusive=inclusive)
        _close(o, jo)
        _close(s, js)


def test_rwkv6_regime_routes_to_the_serial_design():
    """rwkv6's bf16 r/k/v with its f32 per-channel decay and bonus are not
    the SSD design's regime (per-head q/k, per-channel decay, a bonus):
    the serial design takes them. zamba2's Mamba2 inputs stay on SSD."""
    b, s, h, dk = 2, 64, 4, 64
    r, k, v = (torch.randn(b, s, h, dk).to(torch.bfloat16) for _ in range(3))
    lw = -torch.exp(torch.randn(b, s, h, dk))
    u = torch.randn(h, dk)
    assert not gla_ops.takes_ssd(r, k, v, lw, u, False)
    q1 = torch.randn(b, s, 1, dk).to(torch.bfloat16).expand(b, s, h, dk)
    lw1 = (-torch.exp(torch.randn(b, s, h, 1))).expand(b, s, h, dk)
    assert gla_ops.takes_ssd(q1, q1, v, lw1, None, True)
    assert not gla_ops.takes_ssd(q1, q1, v, lw1, u, False)


def test_cross_attention_matches_reference():
    """Prefill (Sq = 40 against 16 encoder positions) and decode (Sq = 1
    against the bf16 cached K/V, promoted to f32 as JAX promotes)."""
    jm, _, pm, _ = _models("whisper-small")
    cfg = pm.cfg
    lp, jlp = _layer_params("whisper-small")
    rng = np.random.default_rng(12)
    hd = cfg.resolved_head_dim
    ek, ev = (rng.standard_normal((2, cfg.enc_seq, cfg.n_kv_heads, hd),
                                  dtype=np.float32) for _ in range(2))
    for s, kv_dtype in ((40, np.float32), (1, "bfloat16")):
        xt, xj = _hidden(cfg.d_model, s=s, seed=13)
        jk, jv = (jnp.asarray(a).astype(kv_dtype) for a in (ek, ev))
        tk, tv = (torch.from_numpy(a) for a in (ek, ev))
        if kv_dtype != np.float32:
            tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
        y = blocks.cross_attention(lp["xattn"], xt, {"k": tk, "v": tv}, cfg)
        jy = jax_blocks.cross_attention(jlp["xattn"], xj, {"k": jk, "v": jv},
                                        jm.cfg)
        assert y.dtype == torch.float32
        _close(y, jy)


def test_encoder_block_matches_reference():
    jm, _, pm, _ = _models("whisper-small")
    lp, jlp = _layer_params("whisper-small", 0, "enc_layers")
    xt, xj = _hidden(pm.cfg.d_model, s=16)
    _close(blocks.encoder_block(lp, xt, pm.cfg),
           jax_blocks.encoder_block(jlp, xj, jm.cfg))


def test_non_causal_attention_matches_reference():
    """``attend_prefill(causal=False)`` (the flash kernel's plain version
    on the CPU) against the reference's ``attend_full`` at Sq != Skv and
    GQA."""
    from repro_torch.models import attention
    rng = np.random.default_rng(14)
    q = rng.standard_normal((2, 7, 6, 16), dtype=np.float32)
    k, v = (rng.standard_normal((2, 23, 2, 16), dtype=np.float32)
            for _ in range(2))
    for sq in (7, 1):
        _close(attention.attend_prefill(*(torch.from_numpy(a) for a in (
            q[:, :sq], k, v)), causal=False),
               jax_attn.attend_full(*(jnp.asarray(a) for a in (
                   q[:, :sq], k, v)), causal=False))


def test_decoder_xattn_block_matches_reference():
    jm, _, pm, _ = _models("whisper-small")
    cfg = pm.cfg
    lp, jlp = _layer_params("whisper-small")
    rng = np.random.default_rng(15)
    hd = cfg.resolved_head_dim
    enc = [rng.standard_normal((2, cfg.enc_seq, cfg.n_kv_heads, hd),
                               dtype=np.float32) for _ in range(2)]
    tkv = {"k": torch.from_numpy(enc[0]), "v": torch.from_numpy(enc[1])}
    jkv = {"k": jnp.asarray(enc[0]), "v": jnp.asarray(enc[1])}
    xt, xj = _hidden(cfg.d_model, s=40)
    for mode in ("train", "prefill"):
        y, c, aux = blocks.decoder_xattn_block(lp, xt, tkv, cfg, mode=mode)
        jy, jc, _ = jax_blocks.decoder_xattn_block(jlp, xj, jkv, jm.cfg,
                                                   mode=mode)
        _close(y, jy)
        assert float(aux) == 0.0
        if mode == "prefill":
            _cache_close(c, jc)
    tc, jc = _pad_kv(c, 40, 4), _pad_kv(jc, 40, 4)
    xt1, xj1 = _hidden(cfg.d_model, s=1, seed=16)
    y, c2, _ = blocks.decoder_xattn_block(lp, xt1, tkv, cfg, mode="decode",
                                          cache=tc, cache_index=40)
    jy, jc2, _ = jax_blocks.decoder_xattn_block(jlp, xj1, jkv, jm.cfg,
                                                mode="decode", cache=jc,
                                                cache_index=40)
    assert c2 is tc
    _close(y, jy)
    _cache_close(tc, jc2)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "qwen2-moe-a2.7b"])
def test_decoder_block_matches_reference(arch):
    """qwen2-vl's M-RoPE decoder block and qwen2-moe's MoE decoder block
    (its aux) in train and prefill."""
    jm, _, pm, _ = _models(arch)
    cfg = pm.cfg
    lp, jlp = _layer_params(arch)
    xt, xj = _hidden(cfg.d_model, s=40)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32)[None, :, None],
                          (2, 40, 3)).copy()
    if cfg.pos_scheme == "rope":
        pos = pos[..., 0].copy()
    pt, pj = torch.from_numpy(pos), jnp.asarray(pos)
    for mode in ("train", "prefill"):
        y, c, aux = blocks.decoder_block(lp, xt, cfg, mode=mode,
                                         positions=pt)
        jy, jc, jaux = jax_blocks.decoder_block(jlp, xj, jm.cfg, mode=mode,
                                                positions=pj)
        _close(y, jy)
        _close(aux, jaux)
        if mode == "prefill":
            _cache_close(c, jc)
    if cfg.moe is not None:
        assert float(aux) > 0


# ------------------------------------------------------------ whole model

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """train, prefill and 4 decode steps: logits within 1e-4 x
    max(|logits|, 1), caches leaf by leaf, aux."""
    jm, jp, pm, pp = _models(arch)
    jforward = jax.jit(jm.forward, static_argnames=("mode",))
    bt, bj = _batches(pm.cfg)
    logits, cache, aux = pm.forward(pp, bt, mode="train")
    jl, jc, jaux = jforward(jp, bj, mode="train")
    assert cache is None and logits.shape == (2, 40, pm.cfg.vocab)
    scale = max(float(np.abs(_np(jl)).max()), 1.0)
    _close(logits, jl, TOL * scale)
    _close(aux, jaux)
    p = 36
    logits, cache, aux = pm.forward(pp, _cut(bt, 0, p), mode="prefill")
    jl, jc, jaux = jforward(jp, _cut(bj, 0, p), mode="prefill")
    _close(logits, jl, TOL * scale)
    _close(aux, jaux)
    _cache_close(cache, jc, TOL * scale)
    cache, jc = _pad_kv(cache, p, 4), _pad_kv(jc, p, 4)
    for t in range(p, 40):
        logits, cache, aux = pm.forward(
            pp, {"tokens": bt["tokens"][:, t:t + 1]}, mode="decode",
            cache=cache, cache_index=t)
        jl, jc, jaux = jforward(jp, {"tokens": bj["tokens"][:, t:t + 1]},
                                mode="decode", cache=jc, cache_index=t)
        _close(logits, jl, TOL * scale)
        _close(aux, jaux)
    _cache_close(cache, jc, TOL * scale)


def test_moe_aux_is_positive():
    """As tests/test_models_smoke.py:122: the MoE model's load-balancing
    loss is a positive f32 scalar in train mode."""
    _, _, pm, pp = _models("qwen2-moe-a2.7b")
    bt, _ = _batches(pm.cfg, s=16)
    _, _, aux = pm.forward(pp, bt, mode="train")
    assert aux.dtype == torch.float32 and float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_greedy_tokens_match_reference(arch):
    jm, jp, pm, pp = _models(arch)
    bt, bj = _batches(pm.cfg, s=24, seed=4)
    tok, cache = make_prefill_step(pm)(pp, bt)
    jtok, jc = jax.jit(jax_prefill_step(jm))(jp, bj)
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


@pytest.mark.parametrize("arch", CONSISTENT)
def test_prefill_decode_matches_full_forward(arch):
    """The reference's tests/test_models_smoke.py check on the port, in the
    configs' own bf16: decode logits of the last 4 positions against one
    full forward, within 0.02 x max(|logits|, 1)."""
    m = build_model(arch, smoke=True)
    cfg = m.cfg
    params = m.init(torch.Generator().manual_seed(2))
    b, s, tail = 2, 64, 4
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model), dtype=np.float32)).to(
                torch.bfloat16)
    full, _, _ = m.forward(params, batch, mode="train")
    p = s - tail
    _, pre, _ = m.forward(params, _cut(batch, 0, p), mode="prefill")
    cache = serve_lm.fill_cache(m.init_cache(b, s, device="cpu"), pre)
    errs = []
    for t in range(p, s):
        dl, cache, _ = m.forward(params, {"tokens": batch["tokens"][
            :, t:t + 1]}, mode="decode", cache=cache, cache_index=t)
        errs.append(float((dl[:, 0] - full[:, t]).abs().max()))
    scale = float(full.abs().max())
    assert max(errs) < 0.02 * max(scale, 1.0), (max(errs), scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference_layout(arch):
    """Every family's decode cache has the reference's leaves, shapes and
    dtypes, zeroed on the CPU when asked."""
    jm, _, pm, _ = _models(arch)
    cache = pm.init_cache(2, 16, device="cpu")
    jcache = jm.init_cache(2, 16)
    assert set(cache) == set(jcache)
    for t, j in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).split(".")[1] == str(j.dtype)
        assert t.device.type == "cpu" and not bool(t.any())


# ---------------------------------------------------------------- example

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_example_runs_on_cpu(arch, capsys):
    out = serve_lm.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert out["tokens"].shape == (4, 16)
    assert out["logits"].shape[:2] == (4, 15)
    assert bool(torch.isfinite(out["logits"]).all())
    text = capsys.readouterr().out
    assert "prefill 4 x 48 tokens" in text and "decode: 15 steps" in text


@pytest.mark.parametrize("arch", ["rwkv6-7b", "whisper-small"])
def test_serve_lm_example_needs_a_card_unless_told_cpu(arch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError):
        serve_lm.main(["--arch", arch, "--smoke"])


def test_serve_needs_frames_for_encdec():
    m = build_model("whisper-small", smoke=True)
    params = m.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="frames"):
        serve_lm.serve(m, params, torch.zeros((1, 4), dtype=torch.long),
                       gen_len=2, max_len=8)


def test_model_refuses_an_unknown_family():
    cfg = dataclasses.replace(build_model("rwkv6-7b", smoke=True).cfg,
                              family="retnet")
    with pytest.raises(ValueError, match="family"):
        from repro_torch.models import Model
        Model(cfg)
