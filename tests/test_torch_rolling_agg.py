"""Port's rolling aggregation against the JAX package's Pallas (interpret
mode) and XLA backends on the same seeded inputs.

Tolerances: count, min and max round nothing and must be equal.  sum and
mean differ only by summation order: the port sums in float64 and rounds
once, the JAX kernel sums a block-local float32 prefix (HIGHEST-precision
matmul) and the XLA backend a global float32 prefix, whose cancellation
error grows with the column's running sum.  So each comparison states an
absolute bound sized to float32 resolution of the running sums involved,
and the port alone is held to 1e-6 of a float64 reference.

On the card the window starts are checked by the kernel, which sets an error
word that the caller reads at its next synchronization; the CPU tests drive
that word through a stand-in for the kernel library."""

import ctypes
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rolling_agg import ops as jops  # noqa: E402
from repro_torch.core.dsl import DslTransform, RollingAgg  # noqa: E402
from repro_torch.core.table import Table  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.rolling_agg import ops as tops  # noqa: E402
from repro_torch.kernels.rolling_agg.ref import rolling_sum_ref  # noqa: E402

AGGS = ("sum", "mean", "count", "min", "max")
# kernel vs plain: both sum in float64 and round once, at most about one
# float32 ulp of the result apart
ROLL_RTOL, ROLL_ATOL = 1e-6, 1e-5


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


def _fake_library(monkeypatch, **entries):
    """A kernel library without a card: ``entries`` stand in for the C
    entries, and the error word is a ctypes int the test owns."""
    word = ctypes.c_int32(0)
    lib = type("Lib", (), {"repro_error_word_alloc": staticmethod(lambda: ctypes.addressof(word)),
                           **{k: staticmethod(v) for k, v in entries.items()}})
    monkeypatch.setattr(tops.native, "library", lambda: lib)
    monkeypatch.setattr(tops, "errors", native.ErrorWord(tops.errors.message))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: type("S", (), {"cuda_stream": 0}))
    return word


def _launch_on_cpu(values, starts):
    """The wrapper's launch through the stand-in library, on CPU tensors,
    returning the plain sums."""
    n, f = values.shape
    tops._launch(values, starts, torch.empty(n, f),
                 torch.empty(tops.scratch_len(n, f), dtype=torch.float64))
    return rolling_sum_ref(values, starts)


@pytest.mark.parametrize("n,f", [(0, 2), (5, 0), (3, 2)])
def test_rolling_entry_takes_the_error_word(monkeypatch, n, f):
    """The C entry's signature carries the error word's pointer, the launch
    passes the word it reads with a scratch of ``scratch_len`` float64, and
    nothing to sum launches nothing and counts nothing."""
    sig = native._SIGNATURES["rolling_sum_f32"]
    assert len(sig) == 9 and sig[3] is ctypes.c_void_p and sig[5] is ctypes.c_void_p
    calls = []
    word = _fake_library(monkeypatch, rolling_sum_f32=lambda *a: calls.append(a) or 0)
    before = tops.counter.launches
    _launch_on_cpu(torch.ones(n, f), torch.zeros(n, dtype=torch.int32))
    launched = n * f > 0
    assert len(calls) == launched and tops.counter.launches == before + launched
    if launched:
        (args,) = calls
        ptr = tops.errors.ptr(torch.device("cpu"))
        assert len(args) == len(sig) and args[5] == ptr == ctypes.addressof(word)
        assert args[4] == (3 + 2 * 1) * 2 and args[6:8] == (3, 2)  # scratch, N, F


@pytest.mark.parametrize("bad", [True, False])
def test_rolling_error_word_raises_at_the_dsl_and_the_next_call(monkeypatch, bad):
    """A kernel that reports a bad start makes the DSL transform raise the
    wrapper's own ValueError after its download of the sums, and, if nobody
    read the report, the next launch (not the CPU path, which reads no
    word); a clear word raises nothing."""
    def kernel(*args):
        ctypes.c_int32.from_address(args[5]).value = int(bad)
        return 0

    _fake_library(monkeypatch, rolling_sum_f32=kernel)
    wrapper = tops.rolling_sum
    monkeypatch.setattr(tops, "rolling_sum", _launch_on_cpu)
    rng = np.random.default_rng(4)
    vals, seg, ts = _case(rng, 200, 1, 6, 50)
    df = Table({"entity_id": seg, "ts": ts, "amount": vals[:, 0]})
    dsl = DslTransform("entity_id", "ts", [RollingAgg("s", "amount", 50, "sum"),
                                           RollingAgg("m", "amount", 50, "max")], device="cpu")
    msg = re.escape(tops.STARTS_MESSAGE)
    if bad:
        with pytest.raises(ValueError, match=msg):
            dsl(df, {})
        tops.errors.raise_if_set()  # the transform cleared the word
    else:
        out = dsl(df, {})  # the rows come already sorted by (entity, ts)
        assert np.array_equal(out["entity_id"], seg) and np.array_equal(out["ts"], ts)
        starts = tops.window_starts(seg, ts, 50)
        np.testing.assert_allclose(out["s"], _exact(vals, starts, "sum")[:, 0],
                                   rtol=1e-6, atol=1e-5)
    v, st = torch.ones(3, 2), torch.tensor([0, 0, 1], dtype=torch.int32)
    _launch_on_cpu(v, st)  # a report nobody read ...
    assert torch.equal(wrapper(v, st), rolling_sum_ref(v, st))  # ... is not the CPU path's
    if bad:
        with pytest.raises(ValueError, match=msg):  # ... raises at the next launch
            _launch_on_cpu(v, st)
    tops.check_error()  # and is gone after it


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


def _tile_starts(n: int, rng) -> np.ndarray:
    """Windows of one row, inside a tile, ending or starting on a tile's
    edge, crossing one edge, crossing many tiles, and from row 0."""
    t = tops.TILE_ROWS
    rows = np.arange(n)
    kind = rng.integers(0, 7, n)
    s = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3, kind == 4, kind == 5],
        [rows, rows - rng.integers(0, 12, n), rows // t * t, rows // t * t - 1,
         rows - rng.integers(t, 3 * t, n), rows // t * t - t * rng.integers(2, 4, n)],
        default=0,
    )
    return np.clip(s, 0, rows).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [1, 2, 5])
def test_rolling_sum_kernel_tiles_on_card(cuda_device, f):
    """Windows of 0, 1 and many tile edges, N not a multiple of the tile,
    F of 1, 2 and 5 (two feature chunks): within ROLL_RTOL/ROLL_ATOL of the
    plain version, and the same bits from two calls."""
    rng = np.random.default_rng(f)
    n = 4 * tops.TILE_ROWS + 777
    vals = torch.from_numpy((rng.standard_normal((n, f)) * 100).astype(np.float32))
    starts = torch.from_numpy(_tile_starts(n, rng))
    dv, ds = vals.to(cuda_device), starts.to(cuda_device)
    a, b = tops.rolling_sum(dv, ds), tops.rolling_sum(dv, ds)
    torch.cuda.synchronize()
    tops.check_error()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    torch.testing.assert_close(a.cpu(), rolling_sum_ref(vals, starts), rtol=ROLL_RTOL,
                               atol=ROLL_ATOL)


@pytest.mark.gpu
def test_rolling_sum_start_zero_on_card(cuda_device):
    """Every window from row 0: the plain float64 prefix's own worst case."""
    rng = np.random.default_rng(12)
    n = 1 << 18
    vals = torch.from_numpy((rng.standard_normal((n, 4)) * 100).astype(np.float32))
    starts = torch.zeros(n, dtype=torch.int32)
    got = tops.rolling_sum(vals.to(cuda_device), starts.to(cuda_device))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), rolling_sum_ref(vals, starts), rtol=ROLL_RTOL,
                               atol=ROLL_ATOL)


@pytest.mark.gpu
def test_rolling_sum_bad_start_on_card(cuda_device):
    """A start past its row or below 0 raises the CPU path's ValueError at
    the read after a synchronization, or at the next call; its row is NaN,
    the others are right, and the next good call succeeds."""
    n = tops.TILE_ROWS + 10
    vals = torch.ones(n, 2, device=cuda_device)
    good = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    msg = re.escape(tops.STARTS_MESSAGE)
    for row, start in ((3, 4), (n - 1, -1)):
        bad = good.clone()
        bad[row] = start
        out = tops.rolling_sum(vals, bad)  # no raise: nothing synchronized
        torch.cuda.synchronize()
        assert out[row].isnan().all() and not out[torch.arange(n) != row].isnan().any()
        with pytest.raises(ValueError, match=msg):
            tops.check_error()
        tops.rolling_sum(vals, bad)
        torch.cuda.synchronize()
        with pytest.raises(ValueError, match=msg):
            tops.rolling_sum(vals, good)
        out = tops.rolling_sum(vals, good)
        torch.cuda.synchronize()
        tops.check_error()
        assert torch.equal(out[:, 0].cpu(), torch.arange(1, n + 1, dtype=torch.float32))


@pytest.mark.gpu
def test_rolling_sum_does_not_synchronize_on_card(cuda_device):
    rng = np.random.default_rng(13)
    n = 3 * tops.TILE_ROWS + 5
    vals = torch.from_numpy(rng.standard_normal((n, 2)).astype(np.float32)).to(cuda_device)
    starts = torch.from_numpy(_tile_starts(n, rng)).to(cuda_device)
    tops.rolling_sum(vals, starts)  # the first call builds and allocates
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tops.rolling_sum(vals, starts)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    tops.check_error()
    torch.testing.assert_close(got.cpu(), rolling_sum_ref(vals.cpu(), starts.cpu()),
                               rtol=ROLL_RTOL, atol=ROLL_ATOL)
