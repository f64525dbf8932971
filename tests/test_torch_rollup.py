"""The port's full-rescan rollup (``segment_rollup``, kernel 5) held against
the JAX package: the plain PyTorch version that the wrapper runs on the
CPU against the reference's Pallas ``segment_rollup_kernel`` (interpret
mode, as tests/test_kernels.py runs it) and against the numpy oracle
(``NumpyBackend.segment_reduce``), on the same seeded fact rows, at the
reference's rollup tolerance (atol 1e-4: the three add in different
orders). The wrapper and ``TorchBackend.segment_reduce`` are held bitwise
against ``segment_rollup_ref``. The CUDA kernel itself is held bitwise
against the plain version on a card in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import NumpyBackend
from repro.kernels.segment_kpi.segment_kpi import segment_rollup_kernel
from repro_torch.core.backend import get_backend
from repro_torch.kernels import launch_counts
from repro_torch.kernels.segment_kpi import ops as sk_ops
from repro_torch.kernels.segment_kpi import ref as sk_ref

CPU = torch.device("cpu")
BLOCK = 256


def _facts(seed, n, n_units):
    """Fact rows with 20% invalid rows and units that are out of range,
    negative, or fractional (some truncate into range, some out of it)."""
    rng = np.random.default_rng(seed)
    f = rng.random((n, 10), dtype=np.float32)
    f[:, 0] = rng.integers(-3, n_units + 3, n) + rng.choice(
        np.float32([0.0, 0.25, -0.5, 0.75]), n)
    f[:, 9] = (rng.random(n) > 0.2).astype(np.float32)
    return f


def _pallas_rollup(facts, n_units):
    """The reference kernel over block-padded rows (zero pad rows are
    invalid), block partials summed as the reference wrapper does."""
    pad = (-len(facts)) % BLOCK
    padded = np.concatenate([facts, np.zeros((pad, 10), np.float32)])
    agg = segment_rollup_kernel(jnp.asarray(padded), n_units=n_units,
                                block=BLOCK, interpret=True)
    return np.asarray(agg.sum(axis=0))


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4096])
@pytest.mark.parametrize("n_units", [20, 32])
def test_segment_rollup_matches_pallas_and_numpy(n, n_units):
    facts = _facts(n, n, n_units)
    t = torch.from_numpy(facts)
    got = sk_ops.segment_rollup(t, n_units)
    assert got.shape == (n_units, 5) and got.dtype == torch.float32
    assert got.numpy().tobytes() == \
        sk_ref.segment_rollup_ref(t, n_units).numpy().tobytes()
    np.testing.assert_allclose(got.numpy(), _pallas_rollup(facts, n_units),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), NumpyBackend().segment_reduce(facts, n_units),
        rtol=0, atol=1e-4)
    # counts are exact, whatever the add order
    np.testing.assert_array_equal(
        got.numpy()[:, 4], NumpyBackend().segment_reduce(facts, n_units)[:, 4])
    # the warehouse rescan's entry point gives the wrapper's bytes
    assert get_backend("torch", device=CPU).segment_reduce(
        facts, n_units).tobytes() == got.numpy().tobytes()


@pytest.mark.parametrize("n", [1, 1000])
def test_torch_backend_segment_reduce_is_the_wrapper(n):
    """``TorchBackend.segment_reduce`` on the CPU: the wrapper's bytes, one
    dispatch and one sync (the count a card run makes), no launch."""
    facts = _facts(7, n, 20)
    be = get_backend("torch", device=CPU)
    be.reset_stats()
    before = launch_counts()
    got = be.segment_reduce(facts, 20)
    assert be.op_dispatches == 1 and be.host_syncs == 1
    assert launch_counts() == before
    assert got.tobytes() == \
        sk_ops.segment_rollup(torch.from_numpy(facts), 20).numpy().tobytes()


def test_segment_reduce_empty_table():
    be = get_backend("torch", device=CPU)
    be.reset_stats()
    got = be.segment_reduce(np.zeros((0, 10), np.float32), 20)
    assert got.tobytes() == NumpyBackend().segment_reduce(
        np.zeros((0, 10), np.float32), 20).tobytes()
    assert be.op_dispatches == 0
    assert sk_ops.segment_rollup(torch.zeros((0, 10)), 4).abs().sum() == 0


def test_nan_and_huge_units_count_nowhere():
    """A NaN unit is dropped, as in the numpy oracle (a CUDA float-to-int
    conversion would make it unit 0); units far outside int32 are
    dropped too."""
    facts = _facts(11, 600, 20)
    facts[::7, 0] = np.nan
    facts[1::11, 0] = 3e9
    facts[2::13, 0] = -np.inf
    got = get_backend("torch", device=CPU).segment_reduce(facts, 20)
    want = NumpyBackend().segment_reduce(facts, 20)
    np.testing.assert_array_equal(got[:, 4], want[:, 4])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_segment_rollup_checks_n_units():
    with pytest.raises(ValueError):
        sk_ops.segment_rollup(torch.zeros((4, 10)), 0)
