"""The RWKV6 design's chunk-parallel decomposition (``csrc/gla_rwkv6.cu``:
chunk states -> passing -> scan with the intra-chunk scores anchored per
16-token sub-chunk), as its plain twin ``ref.gla_rwkv6_ref`` in f32,
against the serial chunked form (``gla_chunk_ref``), the JAX package's
``gla_chunk_kernel`` in Pallas interpret mode, its model's ``gla_chunk``
at f32 ratios and its ``gla_step`` token by token. Inputs are drawn with
numpy from a seed. Tolerance 2e-4, as the neighbouring gla tests (f32
sums in another order); 3e-4 token by token (the reference's bound for
that comparison, tests/test_kernels.py:75)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gla_chunk.gla_chunk import gla_chunk_kernel
from repro.models import gla as jax_gla
from repro_torch.kernels.gla_chunk import ops as gla_ops
from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref, gla_rwkv6_ref

TOL = dict(rtol=2e-4, atol=2e-4)


def _rwkv6_np(rng, b, s, h, dk, dv, *, clip_channels=0, spread=1.0):
    """RWKV6-shaped inputs: per-head q (RWKV6's r) and k, v, the log decay
    made as rwkv6's time mix makes it, -exp(clip(x, -8, 4)) with x normal
    of standard deviation ``spread``, its first ``clip_channels`` channels
    at the clip's -e^4 per token (a chunk's cumulative decay near -3,500),
    and the bonus u [H, dk]. The JAX package's cumulative sums round
    otherwise than torch's, which at a cumulative decay of thousands moves
    a ratio by ~1e-4: the JAX comparisons draw unclipped decays
    (``spread`` 1, as tests/test_torch_lm_kernels.py), the clipped
    channels are held against ``gla_chunk_ref``."""
    q, k = (rng.standard_normal((b, s, h, dk), dtype=np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, dv), dtype=np.float32)
    x = rng.standard_normal((b, s, h, dk), dtype=np.float32) * spread
    x[..., :clip_channels] = 4.0
    lw = (-np.exp(np.clip(x, -8.0, 4.0))).astype(np.float32)
    u = rng.standard_normal((h, dk), dtype=np.float32)
    return q, k, v, lw, u


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("s,with_state,use_u,clip_channels", [
    (256, False, True, 0), (1000, True, True, 4), (2044, False, True, 4),
    (2044, True, False, 4), (100, True, True, 16), (64, False, False, 0)])
def test_gla_rwkv6_ref_matches_chunk_ref(s, with_state, use_u,
                                         clip_channels):
    """The decomposition against the serial chunked form, final state
    included, at ragged S, with and without an initial state and a bonus,
    with channels at the clip's -e^4."""
    rng = np.random.default_rng(s + 7 * with_state + clip_channels)
    b, h, dk, dv = 1, 2, 16, 32
    q, k, v, lw, u = _rwkv6_np(rng, b, s, h, dk, dv,
                               clip_channels=clip_channels, spread=3.0)
    u = u if use_u else None
    s0 = (rng.standard_normal((b, h, dk, dv), dtype=np.float32)
          if with_state else None)
    got, got_final = gla_rwkv6_ref(_t(q), _t(k), _t(v), _t(lw), _t(u),
                                   initial_state=_t(s0))
    want, want_final = gla_chunk_ref(_t(q), _t(k), _t(v), _t(lw), _t(u),
                                     inclusive=False, initial_state=_t(s0))
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(got_final, want_final, **TOL)


@pytest.mark.parametrize("bh,s,dk,dv,use_u", [
    (3, 256, 64, 64, True), (2, 192, 32, 16, True), (2, 128, 16, 32, False)])
def test_gla_rwkv6_ref_matches_pallas(bh, s, dk, dv, use_u):
    """Against the TPU kernel in interpret mode (its [BH, S, d] layout, S a
    multiple of the chunk, zero initial state)."""
    rng = np.random.default_rng(bh * s + dk)
    q, k, v, lw, u = _rwkv6_np(rng, 1, s, bh, dk, dv)
    u = u if use_u else None
    got, _ = gla_rwkv6_ref(_t(q), _t(k), _t(v), _t(lw), _t(u))
    bhsd = lambda x: jnp.asarray(x[0].transpose(1, 0, 2))  # noqa: E731
    want = gla_chunk_kernel(bhsd(q), bhsd(k), bhsd(v), bhsd(lw), _j(u),
                            inclusive=False, chunk=64, interpret=True)
    np.testing.assert_allclose(_np(got[0].permute(1, 0, 2)), _np(want),
                               **TOL)


@pytest.mark.parametrize("s,with_state", [
    (100, True), (250, False), (1000, False), (1000, True)])
def test_gla_rwkv6_ref_matches_models_gla(s, with_state):
    """Against the JAX model's ``gla_chunk`` at f32 ratios (the kernel's
    precision), ragged S (padded inside, as the JAX model pads), final
    state included."""
    rng = np.random.default_rng(3 * s + with_state)
    b, h, dk, dv = 2, 2, 32, 16
    q, k, v, lw, u = _rwkv6_np(rng, b, s, h, dk, dv)
    s0 = (rng.standard_normal((b, h, dk, dv), dtype=np.float32)
          if with_state else None)
    got, got_final = gla_rwkv6_ref(_t(q), _t(k), _t(v), _t(lw), _t(u),
                                   initial_state=_t(s0))
    want, want_final = jax_gla.gla_chunk(
        _j(q), _j(k), _j(v), _j(lw), u=_j(u), inclusive=False,
        initial_state=_j(s0), ratio_dtype=jnp.float32)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(got_final), _np(want_final), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_gla_rwkv6_ref_matches_gla_step(with_state):
    """Token by token, the JAX package's ``gla_step`` (lag-1 read and
    bonus) reproduces the decomposition's outputs and final state."""
    rng = np.random.default_rng(29 + with_state)
    b, s, h, dk, dv = 2, 70, 2, 16, 16
    q, k, v, lw, u = _rwkv6_np(rng, b, s, h, dk, dv)
    state = (rng.standard_normal((b, h, dk, dv), dtype=np.float32)
             if with_state else np.zeros((b, h, dk, dv), np.float32))
    got, got_final = gla_rwkv6_ref(
        _t(q), _t(k), _t(v), _t(lw), _t(u),
        initial_state=_t(state) if with_state else None)
    st = jnp.asarray(state)
    outs = []
    for i in range(s):
        o, st = jax_gla.gla_step(*(jnp.asarray(x[:, i]) for x in (q, k, v,
                                                                  lw)),
                                 st, u=jnp.asarray(u), inclusive=False)
        outs.append(_np(o))
    np.testing.assert_allclose(_np(got), np.stack(outs, axis=1), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(_np(got_final), _np(st), rtol=3e-4,
                               atol=3e-4)


def _unanchored_intra(q, k, v, lw, chunk=64):
    """The intra-chunk term factored without anchors, (q∘exp(Lq)) ·
    (k∘exp(−L))ᵀ masked to i < t, then times v: what the design would
    compute without its sub-chunk anchors. [B, S, H, d] with S a multiple
    of the chunk."""
    b, s, h, dk = q.shape
    n = s // chunk

    def chunks(x):
        return x.reshape(b, n, chunk, h, -1).permute(0, 3, 1, 2, 4)
    qc, kc, vc, lwc = chunks(q), chunks(k), chunks(v), chunks(lw)
    L = torch.cumsum(lwc, dim=3)
    scores = torch.einsum("bhntd,bhnid->bhnti", qc * torch.exp(L - lwc),
                          kc * torch.exp(-L))
    t = torch.arange(chunk)
    scores = scores.masked_fill(t[:, None] <= t[None, :], 0.0)
    return torch.einsum("bhnti,bhnij->bhntj", scores, vc)


def test_gla_rwkv6_anchors_keep_e4_decays_finite():
    """At rwkv6's clipped decays (channels at -e^4 per token: a chunk's
    cumulative log-decay near -3,500) the factorisation without anchors
    overflows (exp(-L) is inf) and its output is not finite; the anchored
    decomposition is finite and equals the serial chunked form."""
    rng = np.random.default_rng(31)
    b, s, h, dk, dv = 1, 128, 2, 16, 16
    q, k, v, lw, u = _rwkv6_np(rng, b, s, h, dk, dv, clip_channels=4,
                               spread=3.0)
    q, k, v, lw, u = map(_t, (q, k, v, lw, u))
    assert float(torch.cumsum(lw[:, :64], 1).min()) < -3000
    bare = _unanchored_intra(q, k, v, lw)
    assert not bool(torch.isfinite(bare).all())
    got, got_final = gla_rwkv6_ref(q, k, v, lw, u)
    want, want_final = gla_chunk_ref(q, k, v, lw, u, inclusive=False)
    assert bool(torch.isfinite(got).all())
    assert bool(torch.isfinite(got_final).all())
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(got_final, want_final, **TOL)
    # the anchors put every exponent of the off-diagonal factors at <= 0
    # (up to the rounding of the cumulative sums), where the bare
    # factorisation's reach thousands
    L = torch.cumsum(lw.reshape(b, 2, 64, h, dk), 2)
    Lq = L - lw.reshape(b, 2, 64, h, dk)
    anchor = Lq[:, :, ::16]                               # [b, n, 4, h, dk]
    for a in range(1, 4):
        assert float((Lq[:, :, 16 * a:16 * a + 16]
                      - anchor[:, :, a:a + 1]).max()) <= 1e-3
        assert float((anchor[:, :, a:a + 1]
                      - L[:, :, :16 * a]).max()) <= 1e-3
    assert float((-L).max()) > 3000


def test_gla_routing_picks_the_rwkv6_design_for_lag1_bf16():
    """``takes_rwkv6`` (which design a CUDA call launches; the predicate
    itself runs anywhere): rwkv6's bf16 lag-1 inputs, with or without the
    bonus, take the RWKV6 design at dk 16/32/64 and dv up to 128; f32,
    the inclusive read and other widths do not; the SSD design never takes
    them."""
    b, s, h = 1, 10, 4

    def inputs(dk, dv, dtype=torch.bfloat16):
        q = torch.zeros((b, s, h, dk), dtype=dtype)
        return q, q, torch.zeros((b, s, h, dv), dtype=dtype), \
            torch.zeros((b, s, h, dk))
    u = torch.zeros((h, 64))
    for dk, dv in ((64, 64), (32, 128), (16, 16)):
        q, k, v, lw = inputs(dk, dv)
        assert gla_ops.takes_rwkv6(q, v, False)
        assert not gla_ops.takes_ssd(q, k, v, lw, u[:, :dk], False)
        assert not gla_ops.takes_ssd(q, k, v, lw, None, False)
    q, k, v, lw = inputs(64, 64, torch.float32)
    assert not gla_ops.takes_rwkv6(q, v, False)
    q, k, v, lw = inputs(64, 64)
    assert not gla_ops.takes_rwkv6(q, v, True)
    for dk, dv in ((48, 64), (64, 256), (8, 16)):
        q, k, v, lw = inputs(dk, dv)
        assert not gla_ops.takes_rwkv6(q, v, False)
    assert "rwkv6" in gla_ops.DESIGNS
    assert gla_ops.launches["gla_chunk_rwkv6"] >= 0
