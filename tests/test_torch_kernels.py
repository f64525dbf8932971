"""The port's kernels (``repro_torch.kernels``) held against the JAX
package: each plain PyTorch version against the reference's Pallas
wrapper (interpret mode, as tests/test_kernels.py runs it) and against its
numpy oracle, on the same seeded inputs. The CUDA kernels themselves are
held against these plain versions on a card in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as ref_backend
from repro.core.cache import InMemoryTable as RefTable
from repro.core.cache import hash32_np
from repro.kernels.hash_join.ops import hash_join as pallas_hash_join
from repro.kernels.segment_kpi.ops import fold_segments as pallas_fold
from repro.kernels.segment_kpi.ops import gather_stats as pallas_gather
from repro.kernels.segment_kpi.ops import segment_kpi as pallas_segment_kpi
from repro_torch.core.backend import get_backend
from repro_torch.core.cache import InMemoryTable
from repro_torch.kernels import launch_counts
from repro_torch.kernels.hash_join import ops as hj_ops
from repro_torch.kernels.hash_join.ref import hash32
from repro_torch.kernels.segment_kpi import ops as sk_ops
from repro_torch.kernels.segment_kpi import ref as sk_ref

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- hash join
def _caches(n_slots, n_keys, seed=0):
    rng = np.random.default_rng(seed)
    ref = RefTable(n_slots)
    keys = rng.choice(10**6, n_keys, replace=False).astype(np.int64)
    ref.upsert(keys, rng.normal(size=(n_keys, 8)).astype(np.float32),
               rng.integers(0, 2**40, n_keys))
    port = InMemoryTable.from_numpy(ref.keys, ref.values, ref.txn,
                                    ref.watermark,
                                    backend=get_backend("torch", device=CPU))
    return rng, keys, ref, port


@pytest.mark.parametrize("n_slots,n_keys,n_queries", [
    (512, 300, 128), (1024, 700, 512), (256, 50, 64)])
def test_hash_join_matches_pallas_and_numpy(n_slots, n_keys, n_queries):
    rng, keys, ref, port = _caches(n_slots, n_keys)
    q = np.concatenate([rng.choice(keys, n_queries // 2),
                        rng.integers(2 * 10**6, 3 * 10**6,
                                     n_queries - n_queries // 2 - 2),
                        [-1, -2]]).astype(np.int32)
    got = hj_ops.hash_join(_t(q), *port.device_state())
    pv, pf, pt = pallas_hash_join(jnp.asarray(q), *ref.device_state())
    nv, nf, nt = ref_backend._hash_probe_np(q, ref.keys, ref.values,
                                            ref.txn)
    for want_v, want_f, want_t in ((np.asarray(pv), np.asarray(pf),
                                    np.asarray(pt)),
                                   (nv, nf, nt.astype(np.int32))):
        assert got[0].numpy().tobytes() == want_v.tobytes()
        np.testing.assert_array_equal(got[1].numpy(), want_f)
        np.testing.assert_array_equal(got[2].numpy(), want_t)
    assert got[1].dtype == torch.bool and got[2].dtype == torch.int32
    assert bool(got[1][-2])            # -1 "hits" an empty slot, as in
    assert not bool(got[1][-1])        # every reference probe; -2 is pad


def test_hash32_matches_numpy():
    keys = np.concatenate([np.arange(-5, 5), [2**31 - 1, -2**31],
                           np.random.default_rng(1).integers(
                               -2**31, 2**31, 1000)]).astype(np.int64)
    np.testing.assert_array_equal(hash32(_t(keys)).numpy(),
                                  hash32_np(keys).astype(np.int64))


# -------------------------------------------------------------- segment KPI
def _kpi_inputs(rng, n, units):
    prod = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    prod[:, 1] = rng.integers(0, units, n)
    prod[:, 4] = prod[:, 3] + np.abs(prod[:, 4]) + 0.1
    eq = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    eq[:, 1] = prod[:, 1]
    eq[:, 4] = eq[:, 3] + np.abs(eq[:, 4]) + 5
    eq[:, 5] = rng.random(n) > 0.3
    qr = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    qr[:, 1] = prod[:, 1]
    eq[rng.random(n) < 0.1, 1] = -1.0          # join misses
    qr[rng.random(n) < 0.1, 1] = -1.0
    return prod, eq, qr


@pytest.mark.parametrize("n,units", [(256, 8), (1000, 20), (513, 32)])
def test_segment_kpi_matches_pallas_and_numpy(n, units):
    prod, eq, qr = _kpi_inputs(np.random.default_rng(3), n, units)
    facts, agg = sk_ops.segment_kpi(_t(prod), _t(eq), _t(qr), n_units=units)
    pf, pa = pallas_segment_kpi(jnp.asarray(prod), jnp.asarray(eq),
                                jnp.asarray(qr), n_units=units)
    np.testing.assert_allclose(facts.numpy(), np.asarray(pf),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(agg.numpy(), np.asarray(pa),
                               rtol=1e-4, atol=1e-4)
    valid = (eq[:, 1] >= 0) & (qr[:, 1] >= 0)
    want = ref_backend._kpi_facts_np(prod, eq, qr, valid)
    assert facts.numpy().tobytes() == want.tobytes()      # bitwise
    np.testing.assert_allclose(agg.numpy(),
                               ref_backend._segment_reduce_np(want, units),
                               rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------- fold
def _fold_inputs(rng, n, S, L, nan):
    seg = rng.integers(-2, S + 2, n).astype(np.int64)   # incl. out of range
    vals = rng.normal(size=(n, L)).astype(np.float32)
    vals[rng.random((n, L)) < 0.1] = 0.0
    vals[rng.random((n, L)) < 0.1] = -0.0
    if nan:
        vals[rng.random((n, L)) < 0.02] = np.nan
    return seg, vals


@pytest.mark.parametrize("n,S,L", [(8, 5, 1), (300, 20, 4), (2500, 60, 2),
                                   (1000, 32, 3)])
@pytest.mark.parametrize("nan", [False, True])
def test_fold_segments_bitwise_vs_numpy(n, S, L, nan):
    seg, vals = _fold_inputs(np.random.default_rng(n + S), n, S, L, nan)
    be = get_backend("torch", device=CPU)
    want = ref_backend.NumpyBackend().fold_segments(seg, vals, S)
    assert be.fold_segments(seg, vals, S).tobytes() == want.tobytes()
    assert be.fold_segments_scan(seg, vals, S).tobytes() == want.tobytes()


@pytest.mark.parametrize("B,S,L", [(8, 5, 1), (256, 20, 4), (2048, 60, 2)])
def test_fold_kernel_block_bitwise_vs_tree(B, S, L):
    """One padded power-of-two block, the kernel wrapper's contract:
    bitwise ``_fold_tree_np`` (signed zeros and NaN included)."""
    seg, vals = _fold_inputs(np.random.default_rng(B), B, S, L, nan=True)
    seg = np.where(seg < S, seg, -1)
    got = sk_ops.fold_segments(_t(seg), _t(vals), S).numpy()
    assert got.tobytes() == ref_backend._fold_tree_np(seg, vals, S).tobytes()


@pytest.mark.parametrize("n,S,L", [(256, 8, 2), (512, 20, 4)])
def test_fold_kernel_vs_pallas(n, S, L):
    seg, vals = _fold_inputs(np.random.default_rng(7), n, S, L, nan=False)
    seg = np.where(seg < S, seg, -1)
    got = sk_ops.fold_segments(_t(seg), _t(vals), S).numpy()
    packed = np.concatenate([seg[:, None].astype(np.float32), vals], axis=1)
    want = np.asarray(pallas_fold(jnp.asarray(packed), n_segments=S))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_np_min_max_semantics():
    a = np.array([0.0, -0.0, np.nan, 1.0, np.nan, 2.0], np.float32)
    b = np.array([-0.0, 0.0, 1.0, np.nan, np.nan, -3.0], np.float32)
    assert sk_ref.np_minimum(_t(a), _t(b)).numpy().tobytes() == \
        np.minimum(a, b).tobytes()
    assert sk_ref.np_maximum(_t(a), _t(b)).numpy().tobytes() == \
        np.maximum(a, b).tobytes()


# ------------------------------------------------------------------- gather
@pytest.mark.parametrize("S,L,n", [(20, 4, 512), (60, 2, 37), (32, 1, 8)])
def test_gather_stats_bitwise(S, L, n):
    rng = np.random.default_rng(S * n)
    table = rng.normal(size=(S, 1 + 3 * L)).astype(np.float32)
    table[:, 0] = rng.integers(0, 9, S)
    table[:2, 0] = 0.0                          # empty segments -> NaN mean
    idx = rng.integers(0, S, n)
    got = sk_ops.gather_stats(_t(table), _t(idx)).numpy()
    assert got.tobytes() == ref_backend._gather_stats_np(table,
                                                         idx).tobytes()
    np.testing.assert_array_equal(
        got, np.asarray(pallas_gather(jnp.asarray(table), idx)))
    be = get_backend("torch", device=CPU)
    assert be.batch_gather_stats(table, idx).tobytes() == got.tobytes()


# ------------------------------------------------------- structural scans
@pytest.mark.parametrize("S", [1, 5, 32, 37])
def test_prefix_fold_bitwise(S):
    rng = np.random.default_rng(S)
    seg = rng.integers(0, S, 400)
    vals = rng.normal(size=(400, 3)).astype(np.float32)
    table = ref_backend.NumpyBackend().fold_segments(seg, vals, S)
    got = get_backend("torch", device=CPU).prefix_fold(table)
    assert got.tobytes() == ref_backend._prefix_fold_np(table).tobytes()
    assert got.tobytes() == \
        ref_backend.prefix_fold_reference(table).tobytes()


def test_plain_versions_do_not_count_launches():
    before = launch_counts()
    prod, eq, qr = _kpi_inputs(np.random.default_rng(0), 16, 4)
    sk_ops.segment_kpi(_t(prod), _t(eq), _t(qr), n_units=4)
    assert launch_counts() == before
