"""The port's one-launch transform (``segment_kpi.ops.transform_kpi``: both
cache probes, the facts and the per-unit rollup) and its open faults'
repairs, held against the JAX package on the CPU, where each wrapper runs
its plain version. Inputs are made from a seed with numpy.

- The join-key cast (``hash_join.ref.key_to_int32``) is the reference's
  device cast, ``astype(jnp.int32)``: NaN to 0, saturated, truncated.
- The transform against the reference's jax backend: facts bitwise, found
  equal, the rollup within 1e-4 (bitwise at one 256-row block, where both
  add the rows in row order).
- ``segment_rollup_ref``'s order (rows within 256-row blocks, then blocks)
  against a loop written here.
- ``fill_cache`` keeps an f32 model's conv state in f32; the transformer's
  dispatch count holds under threads.

The CUDA kernels are held bitwise against these plain versions on a card
in tests/test_torch_cuda.py and chip_smoke.py."""
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as ref_backend
from repro.core.cache import InMemoryTable as RefTable
from repro.kernels.hash_join.ops import hash_join as pallas_hash_join
from repro_torch.core.backend import ComputeBackend, get_backend
from repro_torch.core.cache import InMemoryTable
from repro_torch.core.transformer import DataTransformer
from repro_torch.kernels import launch_counts
from repro_torch.kernels.hash_join.ref import (hash_join_pair_ref,
                                               key_to_int32)
from repro_torch.kernels.segment_kpi import ops as sk_ops
from repro_torch.kernels.segment_kpi.ref import (KPI_BLOCK,
                                                 segment_kpi_ref,
                                                 segment_rollup_ref)

CPU = torch.device("cpu")
I32_MIN, I32_MAX = -2**31, 2**31 - 1
SPECIAL_KEYS = [np.nan, np.inf, -np.inf, 3e9, -3e9, 2.0**31, -2.0**31, 1e19]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ C1: key cast
@pytest.mark.parametrize("key", SPECIAL_KEYS)
def test_key_cast_is_the_references_device_cast(key):
    x = np.float32([key, -0.75, 2.5, 1e9])
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    np.testing.assert_array_equal(key_to_int32(_t(x)).numpy(), want)


def _tables(rng, n_units, n_prod, slots=(64, 1024)):
    """(reference tables, port tables) for the equipment and quality
    caches: keys 0..n-1 plus INT32_MAX and INT32_MIN, so that the special
    keys' casts hit; col 1 of each row >= 0 (a valid join)."""
    ref, port = [], []
    for n_keys, n_slots in zip((n_units, n_prod), slots):
        keys = np.concatenate([np.arange(n_keys), [I32_MAX, I32_MIN]])
        vals = np.abs(rng.normal(size=(len(keys), 8))).astype(np.float32)
        vals[:, 1] = np.arange(len(keys)) % max(n_units, 1)
        vals[:, 3] = rng.uniform(0, 20, len(keys))
        vals[:, 4] = vals[:, 3] + rng.uniform(20, 80, len(keys))
        vals[:, 5] = rng.random(len(keys)) > 0.3
        vals[:, 6] = rng.uniform(1, 6, len(keys))
        vals[:, 7] = rng.uniform(10, 60, len(keys))
        tbl = RefTable(n_slots)
        tbl.upsert(keys, vals, np.arange(len(keys), dtype=np.int64))
        ref.append(tbl)
        port.append(InMemoryTable.from_numpy(
            tbl.keys, tbl.values, tbl.txn, tbl.watermark,
            backend=get_backend("torch", device=CPU)))
    return ref, port


def _prod(rng, n, n_units, n_prod, specials=True):
    """[n, 8] production payloads: keys from the caches, some absent, some
    fractional; with ``specials`` the special keys in both key columns."""
    prod = np.zeros((n, 8), np.float32)
    prod[:, 0] = rng.integers(0, n_prod + 30, n)
    prod[:, 1] = rng.integers(0, n_units + 3, n)
    prod[rng.random(n) < 0.1, 1] += np.float32(0.5)
    prod[:, 3] = rng.uniform(0, 50, n)
    prod[:, 4] = prod[:, 3] + rng.uniform(1, 30, n)
    prod[:, 5] = rng.uniform(0, 100, n)
    if specials:
        k = len(SPECIAL_KEYS)
        prod[:k, 1] = SPECIAL_KEYS
        prod[k:2 * k, 0] = SPECIAL_KEYS
    return prod


def test_pair_probe_with_special_keys_matches_pallas():
    """The plain pair probe on NaN, +-inf, +-3e9, +-2**31 and 1e19 keys
    gives the reference Pallas backend's probe outputs (its kernel in
    interpret mode, fed ``astype(jnp.int32)`` keys as the backend does):
    the same rows and found flags, a miss's key lane -1."""
    rng = np.random.default_rng(16)
    (ref_eq, ref_q), (eq, qu) = _tables(rng, 8, 300)
    prod = _prod(rng, 64, 8, 300)
    eq_rows, q_rows, found = hash_join_pair_ref(
        _t(prod), eq.device_state(), qu.device_state())
    want_found = np.ones(len(prod), bool)
    for rows, tbl, col in ((eq_rows, ref_eq, 1), (q_rows, ref_q, 0)):
        pv, pf, _ = pallas_hash_join(
            jnp.asarray(prod[:, col]).astype(jnp.int32), *tbl.device_state())
        pv, pf = np.asarray(pv), np.asarray(pf)
        rows = rows.numpy()
        assert rows[pf].tobytes() == pv[pf].tobytes()
        assert (rows[~pf][:, 1] == -1.0).all()
        assert pf[:len(SPECIAL_KEYS) * 2].any()    # the special keys hit
        want_found &= pf
    np.testing.assert_array_equal(found.numpy(), want_found)


# --------------------------------------------- the transform in one launch
def _pad(prod):
    n = len(prod)
    bucket = max(256, 1 << (n - 1).bit_length())
    return np.concatenate([prod, np.full((bucket - n, 8), -1.0,
                                         np.float32)])


@pytest.mark.parametrize("n", [200, 256, 1000, 1024])
@pytest.mark.parametrize("n_units", [8, 20])
def test_transform_kpi_matches_the_jax_backend(n, n_units):
    rng = np.random.default_rng(n + n_units)
    (ref_eq, ref_q), (eq, qu) = _tables(rng, n_units, 300)
    prod = _prod(rng, n, n_units, 300, specials=False)
    before = launch_counts()
    facts, found, agg = sk_ops.transform_kpi(
        _t(_pad(prod)), eq.device_state(), qu.device_state(),
        n_units=n_units)
    assert launch_counts() == before             # the plain version
    block = ref_backend.get_backend("jax").transform_and_rollup(
        prod, ref_eq, ref_q, n_units=n_units)
    ref_facts, ref_found = block.to_host()
    ref_agg = block.rollup_host()
    assert facts[:n].numpy().tobytes() == ref_facts.tobytes()
    np.testing.assert_array_equal(found[:n].numpy(), ref_found)
    np.testing.assert_allclose(agg.numpy(), ref_agg, rtol=0, atol=1e-4)
    if n <= KPI_BLOCK:
        assert agg.numpy().tobytes() == np.asarray(ref_agg).tobytes()


@pytest.mark.parametrize("n_units", [1, 20])
def test_transform_kpi_is_the_probe_then_the_kpi_kernel(n_units):
    """The fused plain version gives the bits of the two-call sequence it
    replaces, special keys and pad rows included, and the torch backend's
    transform returns exactly those (one dispatch, one sync)."""
    rng = np.random.default_rng(7)
    _, (eq, qu) = _tables(rng, 20, 300)
    prod = _prod(rng, 700, 20, 300)
    padded = _t(_pad(prod))
    got = sk_ops.transform_kpi(padded, eq.device_state(), qu.device_state(),
                               n_units=n_units)
    eq_rows, q_rows, found = hash_join_pair_ref(padded, eq.device_state(),
                                                qu.device_state())
    facts, agg = segment_kpi_ref(padded, eq_rows, q_rows, n_units)
    for g, w in zip(got, (facts, found, agg)):
        assert g.dtype == w.dtype and g.numpy().tobytes() == \
            w.numpy().tobytes()
    be = get_backend("torch", device=CPU)
    be.reset_stats()
    block = be.transform_and_rollup(prod, eq, qu, n_units=n_units)
    bf, bfound = block.to_host()
    assert be.op_dispatches == 1 and be.host_syncs == 1
    assert bf.tobytes() == facts[:700].numpy().tobytes()
    np.testing.assert_array_equal(bfound, found[:700].numpy())
    assert block.rollup_host().tobytes() == agg.numpy().tobytes()


def test_transform_kpi_checks_its_arguments():
    _, (eq, qu) = _tables(np.random.default_rng(0), 4, 10)
    prod = _t(_pad(_prod(np.random.default_rng(1), 20, 4, 10)))
    with pytest.raises(ValueError):
        sk_ops.transform_kpi(prod, eq.device_state(), qu.device_state(),
                             n_units=0)
    with pytest.raises(ValueError):
        sk_ops.segment_rollup(torch.zeros((4, 10)), 0)


# --------------------------------------------- C2: one upload path
def test_uploads_go_through_backend_upload(monkeypatch):
    """Every host-to-device copy of the torch backend's hot ops — a
    transform's payload, the cache mirrors it probes, a rescan's facts, a
    query batch's staged tables and ids (one buffer) — goes through
    ``backend.upload``, which on a
    card stages through pinned memory with a non-blocking copy (held on
    the card by tests/test_torch_cuda.py and chip_smoke.py's profiler
    phase) and on the CPU copies."""
    import repro_torch.core.backend as port_backend
    real, shapes = port_backend.upload, []

    def recorded(arr, device):
        shapes.append(np.shape(arr))
        return real(arr, device)
    monkeypatch.setattr(port_backend, "upload", recorded)
    rng = np.random.default_rng(2)
    _, (eq, qu) = _tables(rng, 8, 40)
    be = get_backend("torch", device=CPU)
    be.transform_and_rollup(_prod(rng, 300, 8, 40), eq, qu,
                            n_units=8).to_host()
    assert shapes == [(512, 8)] + [(64,), (64, 8), (64,),
                                   (1024,), (1024, 8), (1024,)]
    be.segment_reduce(rng.random((50, 10), dtype=np.float32), 8)
    be.batch_gather_stats(rng.random((8, 13), dtype=np.float32),
                          np.arange(8))
    staged = sk_ops.plan_gather([(8, 4, 8)]).n_words
    assert shapes[7:] == [(50, 10), (staged,)]
    src = np.arange(6, dtype=np.float32)
    copy = real(src, CPU)
    src[:] = -1.0
    assert copy.tolist() == list(range(6))


# ----------------------------------------------- segment_rollup_ref's order
def _rollup_loop(facts: np.ndarray, n_units: int) -> np.ndarray:
    """Today's order written out: per 256-row block, each unit's lanes
    summed in row order from 0 in float32; the block partials summed in
    block order from 0. A NaN unit, a row with col 9 <= 0.5 and a unit
    outside [0, n_units) after truncation count nowhere."""
    agg = np.zeros((n_units, 5), np.float32)
    for lo in range(0, len(facts), KPI_BLOCK):
        part = np.zeros((n_units, 5), np.float32)
        for row in facts[lo:lo + KPI_BLOCK]:
            if np.isnan(row[0]) or not row[9] > 0.5:
                continue
            u = int(np.trunc(row[0])) if abs(row[0]) < 2**31 else -1
            if 0 <= u < n_units:
                part[u] += np.float32([row[3], row[4], row[5], row[6], 1.0])
        agg += part
    return agg


@pytest.mark.parametrize("n", [1, 255, 257, 5000])
def test_segment_rollup_ref_keeps_its_order(n):
    rng = np.random.default_rng(n)
    f = rng.random((n, 10), dtype=np.float32)
    f[:, 0] = rng.integers(-2, 23, n) + rng.choice(
        np.float32([0.0, 0.5, -0.25]), n)
    f[rng.random(n) < 0.1, 0] = np.nan
    f[:, 9] = (rng.random(n) > 0.2).astype(np.float32)
    got = segment_rollup_ref(_t(f), 20).numpy()
    assert got.tobytes() == _rollup_loop(f, 20).tobytes()
    assert sk_ops.segment_rollup(_t(f), 20).numpy().tobytes() == \
        got.tobytes()


# ------------------------------------------- C3: fill_cache keeps f32 state
def test_fill_cache_keeps_the_prefills_dtypes():
    from repro_torch.examples.serve_lm import fill_cache
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_leaves, tree_map
    m = build_model("zamba2-1.2b", smoke=True)
    params = tree_map(lambda t: t.float(),
                      m.init(torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, m.cfg.vocab, (2, 12)))
    _, pre, _ = m.forward(params, {"tokens": toks}, mode="prefill")
    cache = fill_cache(m.init_cache(2, 16, device="cpu"), pre)
    conv, pre_conv = cache["mamba"]["conv"], pre["mamba"]["conv"]
    assert pre_conv.dtype == torch.float32
    assert conv.dtype == torch.float32 and torch.equal(conv, pre_conv)
    for got, want in zip(tree_leaves(cache), tree_leaves(pre)):
        assert got.dtype == want.dtype


# ------------------------------------------ C4: the dispatch count, locked
class _NoOpBackend(ComputeBackend):
    name = "noop"

    def transform_block(self, *args, **kwargs):
        return None


class _SlowCounter(DataTransformer):
    """``dispatches`` read and written through a property that yields the
    interpreter between the read and the write of ``+= 1``, as a
    free-threaded interpreter may: a lost update shows unless the
    increment is locked."""

    @property
    def dispatches(self):
        value = self._count
        time.sleep(0)
        return value

    @dispatches.setter
    def dispatches(self, value):
        self._count = value


def test_dispatch_count_is_exact_under_threads():
    rng = np.random.default_rng(0)
    _, (eq, qu) = _tables(rng, 4, 10)
    tr = _SlowCounter(eq, qu, buffer=None, backend=_NoOpBackend())
    batch = type("Batch", (), {"payload": np.zeros((1, 8), np.float32)})()
    n_threads, calls = 8, 300

    def work():
        for _ in range(calls):
            tr.transform_block(batch)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert tr.dispatches == n_threads * calls
