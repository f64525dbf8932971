"""The port's LM kernels' plain versions, reached through the ``ops``
wrappers on CPU tensors, against the JAX package: ``flash_attention`` and
``gla_chunk_kernel`` run in Pallas interpret mode, their jnp oracles, and
the model functions they stand in for (``attend_full``,
``models.gla.gla_chunk``, ``gla_step``). Inputs are drawn with numpy from
a seed and handed to both. The tolerances are those of
tests/test_kernels.py: flash 2e-5 in f32 and 2e-2 in bf16 (bf16 outputs
round once more, at different points), gla 2e-4 (f32 sums in another
order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.kernels.gla_chunk.gla_chunk import gla_chunk_kernel
from repro.kernels.gla_chunk.ref import gla_ref
from repro.models import attention as jax_attn
from repro.models import gla as jax_gla
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.gla_chunk import ops as gla_ops
from repro_torch.models import gla as port_gla

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (both round f32 to bf16 to nearest-even)."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(_TORCH[dtype]))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,dtype,tol", [
    (2, 4, 2, 256, 64, True, "float32", 2e-5),
    (1, 8, 8, 384, 128, True, "bfloat16", 2e-2),
    (2, 6, 2, 256, 64, False, "float32", 2e-5),
    (1, 12, 4, 512, 64, True, "bfloat16", 2e-2),
    (1, 2, 1, 128, 128, True, "float32", 2e-5),
])
def test_flash_plain_matches_pallas_and_oracle(b, hq, hkv, s, d, causal,
                                               dtype, tol):
    rng = np.random.default_rng(s + hq)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(shape, dtype=np.float32), dtype)
        for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    before = launch_counts()
    got = flash_ops.mha(qt, kt, vt, causal=causal)
    assert launch_counts() == before          # the CPU runs no kernel
    assert got.dtype == _TORCH[dtype] and got.shape == (b, hq, s, d)
    for want in (flash_attention(qj, kj, vj, causal=causal, interpret=True),
                 jax_attention(qj, kj, vj, causal=causal)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_ragged_s_matches_attend_full(causal):
    """S = 100, no multiple of any tile, in the model's [B, S, H, D] layout
    (transposed views, as ``models.attention.attend_prefill`` passes them)
    against the JAX model's ``attend_full`` in f32."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 100, h, 64), dtype=np.float32)
               for h in (4, 2, 2))
    got = flash_ops.mha(*(torch.from_numpy(x).transpose(1, 2)
                          for x in (q, k, v)), causal=causal)
    want = jax_attn.attend_full(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(_np(got.transpose(1, 2)), _np(want),
                               rtol=2e-5, atol=2e-5)


def _gla_np(rng, bh, s, dk, dv):
    q, k = (rng.standard_normal((bh, s, dk), dtype=np.float32)
            for _ in range(2))
    v = rng.standard_normal((bh, s, dv), dtype=np.float32)
    lw = -np.exp(rng.standard_normal((bh, s, dk), dtype=np.float32))
    return q, k, v, lw


def _bshd(x: np.ndarray) -> torch.Tensor:
    """The kernel layout [BH, S, d] as the port's [1, S, BH, d]."""
    return torch.from_numpy(x).permute(1, 0, 2)[None]


@pytest.mark.parametrize("bh,s,dk,dv,inclusive,use_u,chunk", [
    (4, 256, 64, 64, False, True, 64),     # rwkv6 regime
    (2, 128, 64, 128, True, False, 64),    # mamba2/SSD regime
    (3, 192, 32, 32, False, False, 64),
    (1, 512, 128, 64, True, False, 128),
])
def test_gla_plain_matches_pallas_and_oracle(bh, s, dk, dv, inclusive,
                                             use_u, chunk):
    rng = np.random.default_rng(bh * s)
    q, k, v, lw = _gla_np(rng, bh, s, dk, dv)
    u = rng.standard_normal((bh, dk), dtype=np.float32) if use_u else None
    out, final = gla_ops.gla(_bshd(q), _bshd(k), _bshd(v), _bshd(lw),
                             None if u is None else torch.from_numpy(u),
                             inclusive=inclusive, chunk=chunk)
    assert final.shape == (1, bh, dk, dv) and final.dtype == torch.float32
    got = _np(out[0].permute(1, 0, 2))
    uj = None if u is None else jnp.asarray(u)
    args = [jnp.asarray(x) for x in (q, k, v, lw)]
    for want in (gla_chunk_kernel(*args, uj, inclusive=inclusive,
                                  chunk=chunk, interpret=True),
                 gla_ref(*args, uj, inclusive=inclusive, chunk=chunk)):
        np.testing.assert_allclose(got, _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("inclusive,use_u,with_state", [
    (True, False, False), (False, True, True), (True, False, True)])
def test_gla_plain_ragged_s_matches_models_gla(inclusive, use_u,
                                               with_state):
    """S = 100 (padded inside, as the JAX model pads) with an initial
    state, against the JAX model's ``gla_chunk`` at f32 ratios (the
    kernel's precision), final state included."""
    rng = np.random.default_rng(11)
    b, s, h, dk, dv = 2, 100, 3, 32, 16
    q, k, lw = (rng.standard_normal((b, s, h, dk), dtype=np.float32)
                for _ in range(3))
    lw = -np.exp(lw)
    v = rng.standard_normal((b, s, h, dv), dtype=np.float32)
    u = rng.standard_normal((h, dk), dtype=np.float32) if use_u else None
    s0 = (rng.standard_normal((b, h, dk, dv), dtype=np.float32)
          if with_state else None)
    t = lambda x: None if x is None else torch.from_numpy(x)
    out, final = port_gla.gla_chunk(t(q), t(k), t(v), t(lw), u=t(u),
                                    inclusive=inclusive,
                                    initial_state=t(s0))
    j = lambda x: None if x is None else jnp.asarray(x)
    want, want_final = jax_gla.gla_chunk(
        j(q), j(k), j(v), j(lw), u=j(u), inclusive=inclusive,
        initial_state=j(s0), ratio_dtype=jnp.float32)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(final), _np(want_final), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("inclusive,use_u", [(True, False), (False, True)])
def test_gla_step_matches_chunked_form_and_reference(inclusive, use_u):
    """Token by token, the port's ``gla_step`` reproduces the chunked form
    (3e-4, the reference's own bound for this comparison,
    tests/test_kernels.py:75) and each step equals the JAX ``gla_step``
    on the same state (1e-5: the same f32 ops)."""
    rng = np.random.default_rng(13)
    b, s, h, dk, dv = 2, 70, 2, 16, 16
    q, k, lw = (rng.standard_normal((b, s, h, dk), dtype=np.float32)
                for _ in range(3))
    lw = -np.exp(lw)
    v = rng.standard_normal((b, s, h, dv), dtype=np.float32)
    u = (torch.from_numpy(rng.standard_normal((h, dk), dtype=np.float32))
         if use_u else None)
    qt, kt, vt, lt = (torch.from_numpy(x) for x in (q, k, v, lw))
    chunked, final = port_gla.gla_chunk(qt, kt, vt, lt, u=u,
                                        inclusive=inclusive)
    state = torch.zeros((b, h, dk, dv))
    outs = []
    for i in range(s):
        o, new = port_gla.gla_step(qt[:, i], kt[:, i], vt[:, i], lt[:, i],
                                   state, u=u, inclusive=inclusive)
        if i in (0, s // 2, s - 1):
            jo, jnew = jax_gla.gla_step(
                *(jnp.asarray(x[:, i]) for x in (q, k, v, lw)),
                jnp.asarray(state.numpy()),
                u=None if u is None else jnp.asarray(u.numpy()),
                inclusive=inclusive)
            np.testing.assert_allclose(_np(o), _np(jo), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(_np(new), _np(jnew), rtol=1e-5,
                                       atol=1e-5)
        outs.append(o)
        state = new
    np.testing.assert_allclose(_np(torch.stack(outs, dim=1)), _np(chunked),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(_np(state), _np(final), rtol=3e-4, atol=3e-4)


def test_gla_plain_reads_broadcast_views():
    """Mamba2's zero-stride views (q, k shared over heads, one decay per
    head) give what their materialized copies give."""
    rng = np.random.default_rng(17)
    b, s, h, d = 2, 90, 4, 16
    q, k = (torch.from_numpy(rng.standard_normal((b, s, 1, d),
                                                 dtype=np.float32))
            .expand(b, s, h, d) for _ in range(2))
    lw = torch.from_numpy(-np.exp(rng.standard_normal(
        (b, s, h, 1), dtype=np.float32))).expand(b, s, h, d)
    v = torch.from_numpy(rng.standard_normal((b, s, h, d),
                                             dtype=np.float32))
    got = gla_ops.gla(q, k, v, lw, inclusive=True)
    want = gla_ops.gla(q.contiguous(), k.contiguous(), v, lw.contiguous(),
                       inclusive=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _mamba_np(rng, b, s, h, dk, dv):
    """Mamba2-shaped inputs: q, k shared by every head, one log-decay per
    (token, head), as [B, S, H, d] arrays (broadcast materialized)."""
    q, k = (np.broadcast_to(rng.standard_normal((b, s, 1, dk),
                                                dtype=np.float32),
                            (b, s, h, dk)).copy() for _ in range(2))
    lw = np.broadcast_to(-np.exp(rng.standard_normal(
        (b, s, h, 1), dtype=np.float32)), (b, s, h, dk)).copy()
    v = rng.standard_normal((b, s, h, dv), dtype=np.float32)
    return q, k, v, lw


@pytest.mark.parametrize("s,with_state", [(256, False), (130, True),
                                          (100, False), (64, True)])
def test_gla_ssd_decomposition_matches_chunk_ref_and_reference(s,
                                                               with_state):
    """The SSD design's chunk-parallel decomposition (chunk states ->
    passing -> scan, ``ref.gla_ssd_ref``) in f32 against the serial
    chunked form (``gla_chunk_ref``) and the JAX model's ``gla_chunk`` at
    f32 ratios, final state included, at ragged S: 2e-4 (f32 sums in
    another order, as tests/test_kernels.py)."""
    from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref, gla_ssd_ref
    rng = np.random.default_rng(s + with_state)
    b, h, dk, dv = 2, 3, 16, 32
    q, k, v, lw = _mamba_np(rng, b, s, h, dk, dv)
    s0 = (rng.standard_normal((b, h, dk, dv), dtype=np.float32)
          if with_state else None)
    t = lambda x: None if x is None else torch.from_numpy(x)
    got, got_final = gla_ssd_ref(t(q), t(k), t(v), t(lw),
                                 initial_state=t(s0))
    want, want_final = gla_chunk_ref(t(q), t(k), t(v), t(lw), inclusive=True,
                                     initial_state=t(s0))
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got_final, want_final, rtol=2e-4, atol=2e-4)
    j = lambda x: None if x is None else jnp.asarray(x)
    ref, ref_final = jax_gla.gla_chunk(
        j(q), j(k), j(v), j(lw), inclusive=True, initial_state=j(s0),
        ratio_dtype=jnp.float32)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(got_final), _np(ref_final), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_gla_ssd_decomposition_matches_gla_step(with_state):
    """Token by token, the JAX package's ``gla_step`` reproduces the SSD
    decomposition's outputs and final state (3e-4, the reference's bound
    for this comparison, tests/test_kernels.py:75)."""
    from repro_torch.kernels.gla_chunk.ref import gla_ssd_ref
    rng = np.random.default_rng(19 + with_state)
    b, s, h, dk, dv = 2, 70, 2, 16, 16
    q, k, v, lw = _mamba_np(rng, b, s, h, dk, dv)
    state = (rng.standard_normal((b, h, dk, dv), dtype=np.float32)
             if with_state else np.zeros((b, h, dk, dv), np.float32))
    got, got_final = gla_ssd_ref(
        *(torch.from_numpy(x) for x in (q, k, v, lw)),
        initial_state=torch.from_numpy(state) if with_state else None)
    st = jnp.asarray(state)
    outs = []
    for i in range(s):
        o, st = jax_gla.gla_step(*(jnp.asarray(x[:, i]) for x in (q, k, v,
                                                                  lw)),
                                 st, inclusive=True)
        outs.append(_np(o))
    np.testing.assert_allclose(_np(got), np.stack(outs, axis=1), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(_np(got_final), _np(st), rtol=3e-4,
                               atol=3e-4)


def test_flash_routing_picks_the_tensor_core_design_for_the_models():
    """``takes_tc`` (which design a CUDA call launches; the predicate
    itself runs anywhere): the models' bf16 transposed [B, S, H, D] views
    at head_dim 64 and 128 take the tensor-core design; f32, head dims
    16/32 and a view TMA cannot address do not."""
    def bshd(h, d, dtype=torch.bfloat16):
        return torch.zeros((2, 40, h, d), dtype=dtype).transpose(1, 2)
    assert flash_ops.takes_tc(bshd(16, 128), bshd(8, 128), bshd(8, 128))
    assert flash_ops.takes_tc(bshd(32, 64), bshd(32, 64), bshd(32, 64))
    assert not flash_ops.takes_tc(*(bshd(4, 128, torch.float32),) * 3)
    assert not flash_ops.takes_tc(*(bshd(4, 32),) * 3)
    assert not flash_ops.takes_tc(*(bshd(4, 16),) * 3)
    odd = torch.zeros((2, 4, 40, 72), dtype=torch.bfloat16)[..., 1:65]
    assert not flash_ops.takes_tc(odd, odd, odd)
    q = bshd(4, 64)
    with pytest.raises(ValueError):              # no such design
        flash_ops.mha(q, q, q, design="wgmma")


def test_gla_routing_picks_the_ssd_design_for_mamba2_only():
    """``takes_ssd``: Mamba2's bf16 zero-stride views (as
    ``models/blocks.py`` builds them) take the SSD design; f32, a bonus,
    the lag-1 read, per-head q/k or per-channel decay do not."""
    b, s, h, d = 1, 10, 4, 64
    shared = torch.zeros((b, s, 1, d), dtype=torch.bfloat16).expand(
        b, s, h, d)
    lw = torch.zeros((b, s, h, 1)).expand(b, s, h, d)
    v = torch.zeros((b, s, h, d), dtype=torch.bfloat16)
    u = torch.zeros((h, d))
    assert gla_ops.takes_ssd(shared, shared, v, lw, None, True)
    assert not gla_ops.takes_ssd(shared.float(), shared.float(), v.float(),
                                 lw, None, True)
    assert not gla_ops.takes_ssd(shared, shared, v, lw, u, True)
    assert not gla_ops.takes_ssd(shared, shared, v, lw, None, False)
    assert not gla_ops.takes_ssd(v, v, v, lw, None, True)
    assert not gla_ops.takes_ssd(shared, shared, v, lw.contiguous() + 0.0,
                                 None, True)
    with pytest.raises(ValueError):              # no such design
        gla_ops.gla(shared, shared, v, lw, inclusive=True, design="chunked")
