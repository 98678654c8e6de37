"""Port's rolling aggregation against the JAX package's Pallas (interpret
mode) and XLA backends on the same seeded inputs.

Tolerances: count, min and max round nothing and must be equal.  sum and
mean differ only by summation order: the port sums in float64 and rounds
once, the JAX kernel sums a block-local float32 prefix (HIGHEST-precision
matmul) and the XLA backend a global float32 prefix, whose cancellation
error grows with the column's running sum.  So each comparison states an
absolute bound sized to float32 resolution of the running sums involved,
and the port alone is held to 1e-6 of a float64 reference."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rolling_agg import ops as jops  # noqa: E402
from repro_torch.kernels.rolling_agg import ops as tops  # noqa: E402

AGGS = ("sum", "mean", "count", "min", "max")


def _case(rng, n, feat, n_seg, window, ts_range=1000):
    seg = np.sort(rng.integers(0, n_seg, size=n))
    ts = np.empty(n, np.int64)
    for s in np.unique(seg):
        m = seg == s
        ts[m] = np.sort(rng.integers(0, ts_range, size=m.sum()))
    vals = rng.standard_normal((n, feat)).astype(np.float32)
    return vals, seg, ts


def _exact(vals, starts, agg):
    out = np.empty(vals.shape, np.float64)
    for i in range(len(vals)):
        w = vals[starts[i] : i + 1].astype(np.float64)
        out[i] = {"sum": w.sum(0), "mean": w.mean(0), "count": len(w),
                  "min": w.min(0), "max": w.max(0)}[agg]
    return out


def test_window_starts_identical():
    rng = np.random.default_rng(0)
    for n, n_seg, window in [(1, 1, 5), (200, 5, 30), (1000, 40, 300), (500, 1, 10_000)]:
        _, seg, ts = _case(rng, n, 1, n_seg, window)
        a = jops.window_starts(seg, ts, window)
        b = tops.window_starts(seg, ts, window)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tops.window_starts(np.zeros(0), np.zeros(0), 5).dtype == np.int32
    with pytest.raises(ValueError):
        tops.window_starts(np.array([0, 0]), np.array([5, 1]), 3)


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_rolling_agg_matches_jax(agg, backend):
    rng = np.random.default_rng(AGGS.index(agg))
    vals, seg, ts = _case(rng, 600, 3, 12, 200)
    starts = tops.window_starts(seg, ts, 200)
    want = np.asarray(
        jops.rolling_agg(jnp.asarray(vals), starts, agg, interpret=True, backend=backend)
    )
    got = tops.rolling_agg(torch.from_numpy(vals), starts, agg)
    assert got.dtype == torch.float32 and tuple(got.shape) == vals.shape
    got = got.numpy()
    if agg in ("count", "min", "max"):
        np.testing.assert_array_equal(got, want)
    else:
        # running sums over 600 rows of N(0, 1) stay below ~100: float32
        # resolution there is ~1e-5
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, _exact(vals, starts, agg), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("agg", ["sum", "mean", "min"])
def test_span_deeper_than_4096(agg):
    """Spans above 4096 rows: the JAX package leaves the Pallas kernel for
    its XLA cumsum; the port has no span limit."""
    rng = np.random.default_rng(7)
    n = 5000
    vals = rng.standard_normal((n, 2)).astype(np.float32)
    seg = np.zeros(n, np.int64)
    ts = np.arange(n, dtype=np.int64)
    starts = tops.window_starts(seg, ts, 4500)
    assert (np.arange(n) + 1 - starts).max() > 4096
    want = np.asarray(jops.rolling_agg(jnp.asarray(vals), starts, agg, interpret=True))
    got = tops.rolling_agg(torch.from_numpy(vals), starts, agg).numpy()
    exact = _exact(vals, starts, agg)
    if agg == "min":
        np.testing.assert_array_equal(got, want)
    else:
        # the JAX float32 prefix over 5000 rows carries ~1e-4 of cancellation
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-5)


def test_rolling_sum_validates_and_handles_edges():
    v = torch.ones((3, 2), dtype=torch.float32)
    np.testing.assert_array_equal(
        tops.rolling_sum(v, torch.tensor([0, 0, 1], dtype=torch.int32)).numpy(),
        [[1, 1], [2, 2], [2, 2]],
    )
    for bad in ([0, 2, 1], [-1, 0, 1]):
        with pytest.raises(ValueError):
            tops.rolling_sum(v, torch.tensor(bad, dtype=torch.int32))
    with pytest.raises(TypeError):
        tops.rolling_sum(v.double(), torch.tensor([0, 0, 1], dtype=torch.int32))
    with pytest.raises(ValueError):
        tops.rolling_agg(v, np.array([0, 2, 1]), "sum")
    assert tops.rolling_agg(v[:0], np.zeros(0, np.int32), "max").shape == (0, 2)
    with pytest.raises(ValueError):
        tops.rolling_agg(v, np.array([0, 0, 1]), "median")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_rolling_sum_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(9)
    n = 20_000
    vals = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    starts = torch.from_numpy(
        np.maximum(np.arange(n) - rng.integers(0, 6000, n), 0).astype(np.int32)
    )
    before = tops.counter.launches
    got = tops.rolling_sum(vals.to(cuda_device), starts.to(cuda_device))
    torch.cuda.synchronize()
    assert tops.counter.launches == before + 1
    # both sum in float64 and round once: at most one float32 ulp apart
    np.testing.assert_allclose(
        got.cpu().numpy(), tops.rolling_sum(vals, starts).numpy(), rtol=1e-6, atol=1e-5
    )
