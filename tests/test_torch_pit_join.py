"""Port's point-in-time search and per-feature-set join against the JAX
package's, on the same seeded inputs.

The JAX package has two regimes: timestamps that fit int32 after a rebase go
through its Pallas kernel (run here in interpret mode), wider spans through
its jnp oracle, which needs JAX's 64-bit mode to see int64 at all (without
it ``jnp.asarray`` truncates epoch-ms to int32), so those cases run under
``jax.enable_x64``.  The port has one regime, native int64.  The join does
no arithmetic, so ``idx``, ``valid``, ``found``, ``event_ts`` and every value
must be byte-identical.

On the card the segment bounds are checked by the kernel, which sets an error
word that the caller reads at its next synchronization; the CPU tests drive
that word through a stand-in for the kernel library."""

import ctypes
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import assets as jassets  # noqa: E402
from repro.core import pit as jpit  # noqa: E402
from repro.core.dsl import UDFTransform as JUDF  # noqa: E402
from repro.core.keys import encode_keys  # noqa: E402
from repro.core.table import Table as JTable  # noqa: E402
from repro.kernels.pit_join.ops import pit_search as jax_pit_search  # noqa: E402
from repro.kernels.pit_join.ref import pit_search_ref as jax_pit_ref  # noqa: E402
from repro_torch.core import assets as tassets  # noqa: E402
from repro_torch.core import pit as tpit  # noqa: E402
from repro_torch.core.dsl import UDFTransform as TUDF  # noqa: E402
from repro_torch.core.table import Table as TTable  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.pit_join import ops as tops  # noqa: E402
from repro_torch.kernels.pit_join.ref import pit_search_ref  # noqa: E402

EPOCH_MS = 1_700_000_000_000


def _segments(rng, n_seg, max_rows, base, span):
    """Table sorted by ts inside each segment (repeats included, so ties
    occur), with empty segments; returns (table_ts int64, bounds)."""
    sizes = rng.integers(0, max_rows, size=n_seg)
    parts, bounds, off = [], [], 0
    for sz in sizes:
        ts = np.sort(base + rng.integers(0, span, size=sz))
        if sz > 2:
            ts[1] = ts[0]  # an exact tie inside the segment
        parts.append(ts)
        bounds.append((off, off + sz))
        off += sz
    return np.concatenate(parts).astype(np.int64), bounds


def _queries(rng, table, bounds, n_q, base, span):
    segs = rng.integers(0, len(bounds), size=n_q)
    lo = np.array([bounds[s][0] for s in segs], np.int64)
    hi = np.array([bounds[s][1] for s in segs], np.int64)
    q_ts = base + rng.integers(-span // 20, span + span // 10, size=n_q)
    hit = (rng.random(n_q) < 0.3) & (hi > lo)  # exact hits on a row's ts
    q_ts[hit] = table[rng.integers(lo[hit], hi[hit])]
    return q_ts.astype(np.int64), lo, hi


def _port(table, q_ts, lo, hi, bound_dtype=torch.int32):
    idx, valid = tops.pit_search(
        torch.from_numpy(table), torch.from_numpy(q_ts),
        torch.from_numpy(lo).to(bound_dtype), torch.from_numpy(hi).to(bound_dtype),
    )
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool
    return idx.numpy(), valid.numpy()


@pytest.mark.parametrize("n_seg,max_rows,n_q", [(1, 50, 17), (6, 200, 300), (25, 30, 130)])
def test_pit_search_matches_jax_pallas(n_seg, max_rows, n_q):
    """int32-range timestamps: JAX's Pallas counting search (interpret)."""
    rng = np.random.default_rng(n_seg * 100 + n_q)
    table, bounds = _segments(rng, n_seg, max_rows, 0, 1000)
    q_ts, lo, hi = _queries(rng, table, bounds, n_q, 0, 1000)
    j_idx, j_valid = jax_pit_search(
        *(jnp.asarray(a.astype(np.int32)) for a in (table, q_ts, lo, hi)), interpret=True
    )
    for bound_dtype in (torch.int32, torch.int64):
        idx, valid = _port(table, q_ts, lo, hi, bound_dtype)
        np.testing.assert_array_equal(valid, np.asarray(j_valid))
        np.testing.assert_array_equal(idx, np.asarray(j_idx))
    assert valid.any() and not valid.all()


@pytest.mark.parametrize("seed", [0, 1])
def test_pit_search_matches_jax_oracle_wide_span(seed):
    """Epoch-ms timestamps spanning more than 2**31 ms (24.8 days): where
    the JAX package leaves its kernel for the int64 oracle."""
    rng = np.random.default_rng(seed)
    table, bounds = _segments(rng, 12, 120, EPOCH_MS, 2**33)
    q_ts, lo, hi = _queries(rng, table, bounds, 400, EPOCH_MS, 2**33)
    assert table.max() - table.min() > 2**31
    with jax.enable_x64(True):
        j_idx, j_valid = jax_pit_ref(*(jnp.asarray(a) for a in (table, q_ts, lo, hi)))
        j_idx, j_valid = np.asarray(j_idx), np.asarray(j_valid)
    idx, valid = _port(table, q_ts, lo, hi)
    np.testing.assert_array_equal(valid, j_valid)
    np.testing.assert_array_equal(idx, j_idx)
    assert valid.any() and not valid.all()


def test_pit_search_edges():
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
    i64 = lambda *v: torch.tensor(v, dtype=torch.int64)
    # empty table: every segment empty, nothing found, idx = lo - 1
    idx, valid = tops.pit_search(i64(), i64(5, 10), i32(0, 0), i32(0, 0))
    assert not valid.any() and idx.tolist() == [-1, -1]
    # empty segments inside a table
    idx, valid = tops.pit_search(i64(1, 2, 3), i64(9, 9), i32(1, 3), i32(1, 3))
    assert not valid.any() and idx.tolist() == [0, 2]
    # an observation exactly at a record's ts includes it (<=)
    idx, valid = tops.pit_search(i64(10, 20, 30), i64(20), i32(0), i32(3))
    assert valid.tolist() == [True] and idx.tolist() == [1]
    # strictly before every record: nothing from the future
    idx, valid = tops.pit_search(i64(100, 200), i64(99), i32(0), i32(2))
    assert valid.tolist() == [False]
    # ties in ts resolve to the last row of the run (the latest creation_ts)
    idx, valid = tops.pit_search(i64(5, 7, 7, 7, 9), i64(7, 8), i32(0, 0), i32(5, 5))
    assert idx.tolist() == [3, 3] and valid.all()
    # the search never leaves its segment
    idx, valid = tops.pit_search(i64(1, 2, 3, 4), i64(9), i32(1), i32(3))
    assert idx.tolist() == [2]
    # an int64 boundary: INT64_MIN and INT64_MAX timestamps compare exactly
    big = np.iinfo(np.int64)
    idx, valid = tops.pit_search(i64(big.min, 0, big.max), i64(big.max, big.min, -1),
                                 i32(0, 0, 0), i32(3, 3, 3))
    assert idx.tolist() == [2, 0, 0] and valid.all()


def test_pit_search_validates():
    t = torch.tensor([1, 2, 3], dtype=torch.int64)
    q = torch.tensor([2], dtype=torch.int64)
    ok = torch.tensor([0], dtype=torch.int32)
    for lo, hi in (([1], [0]), ([-1], [2]), ([0], [4])):
        with pytest.raises(ValueError):
            tops.pit_search(t, q, torch.tensor(lo, dtype=torch.int32),
                            torch.tensor(hi, dtype=torch.int32))
    with pytest.raises(TypeError):
        tops.pit_search(t.to(torch.int32), q, ok, ok)
    with pytest.raises(TypeError):
        tops.pit_search(t, q, ok.float(), ok)
    with pytest.raises(ValueError):
        tops.pit_search(t, q, torch.zeros(2, dtype=torch.int32), ok)


def test_pit_search_ref_records_its_probes():
    """The plain search reports the rows each bisection step reads (the
    smoke run's bytes bound counts their sectors); a query on an empty
    segment reads none."""
    probes = []
    i64 = lambda *v: torch.tensor(v, dtype=torch.int64)
    idx, valid = pit_search_ref(i64(10, 20, 30, 40), i64(25, 99), i64(0, 2), i64(4, 2), probes)
    assert idx.tolist() == [1, 1] and valid.tolist() == [True, False]
    assert torch.cat(probes).tolist() == [2, 1]


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


@pytest.mark.parametrize("n_queries", [0, 3])
def test_pit_launch_counts_only_a_launch(monkeypatch, n_queries):
    """The launch counter moves where the kernel launches and nowhere else:
    no queries, no launch and no count."""
    calls = []
    _fake_library(monkeypatch, pit_search_i64=lambda *a: calls.append(a) or 0)
    q = torch.zeros(n_queries, dtype=torch.int64)
    b = torch.zeros(n_queries, dtype=torch.int32)
    before = tops.counter.launches
    tops._launch(torch.arange(4), q, b, b, b.clone(), torch.zeros(n_queries, dtype=torch.bool))
    launched = n_queries > 0
    assert len(calls) == launched and tops.counter.launches == before + launched


def test_pit_entry_takes_the_error_word(monkeypatch):
    """The C entry's signature carries the error word's pointer, and the
    launch passes the word it reads."""
    sig = native._SIGNATURES["pit_search_i64"]
    assert len(sig) == 10 and sig[6] is ctypes.c_void_p
    calls = []
    word = _fake_library(monkeypatch, pit_search_i64=lambda *a: calls.append(a) or 0)
    q = torch.zeros(2, dtype=torch.int64)
    b = torch.zeros(2, dtype=torch.int32)
    tops._launch(torch.arange(4), q, b, b, b.clone(), torch.zeros(2, dtype=torch.bool))
    (args,) = calls
    ptr = tops.errors.ptr(torch.device("cpu"))
    assert len(args) == len(sig) and args[6] == ptr == ctypes.addressof(word)
    assert args[7:9] == (4, 2)  # M, B


@pytest.mark.parametrize("bad", [True, False])
def test_pit_error_word_raises_at_the_join_and_the_next_call(monkeypatch, bad):
    """A kernel that reports bad bounds makes the join raise the wrapper's
    own ValueError after its download, and, if nobody read the report, the
    next launch (not the CPU path, which reads no word); a clear word raises
    nothing."""
    def kernel(*args):
        ctypes.c_int32.from_address(args[6]).value = int(bad)
        return 0

    _fake_library(monkeypatch, pit_search_i64=kernel)
    wrapper = tops.pit_search

    def launched_on_cpu(table_ts, q_ts, q_lo, q_hi):
        idx, valid = pit_search_ref(table_ts, q_ts, q_lo, q_hi)
        tops._launch(table_ts, q_ts, q_lo.int(), q_hi.int(), idx, valid)
        return idx, valid

    monkeypatch.setattr(tops, "pit_search", launched_on_cpu)
    _, spec = _specs(0, ("entity_id",))
    cols = _history(np.random.default_rng(3), 50, 5, ("entity_id",), 0, 1000)
    join = lambda: tpit.pit_join_feature_set([np.arange(6)], np.full(6, 500), spec,
                                             TTable(dict(cols)), device="cpu")
    msg = re.escape(tops.BOUNDS_MESSAGE)
    if bad:
        with pytest.raises(ValueError, match=msg):
            join()
        tops.errors.raise_if_set()  # the join cleared the word
    else:
        assert join().found.any()
    launched_on_cpu(*_GOOD)  # a report nobody read ...
    got, want = wrapper(*_GOOD), pit_search_ref(*_GOOD)  # ... is not the CPU path's
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if bad:
        with pytest.raises(ValueError, match=msg):  # ... raises at the next launch
            launched_on_cpu(*_GOOD)
    tops.check_error()  # and is gone after it


def test_error_word_is_per_device(monkeypatch):
    """Each device has its own word: a report on one device raises at a
    read of that device or of every device, never at another device's."""
    words = []

    def alloc():
        words.append(ctypes.c_int32(0))
        return ctypes.addressof(words[-1])

    monkeypatch.setattr(native, "library",
                        lambda: type("Lib", (), {"repro_error_word_alloc": staticmethod(alloc)}))
    word = native.ErrorWord("bad")
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    p0, p1 = word.ptr(d0), word.ptr(d1)
    assert p0 != p1 and word.ptr(d0) == p0 and len(words) == 2
    ctypes.c_int32.from_address(p1).value = 1
    word.raise_if_set(d0)  # another device's report
    with pytest.raises(ValueError, match="bad"):
        word.raise_if_set(d1)
    word.raise_if_set(d1)  # cleared by the raise
    ctypes.c_int32.from_address(p0).value = 1
    with pytest.raises(ValueError, match="bad"):
        word.raise_if_set()
    word.raise_if_set()


_GOOD = (torch.tensor([1, 5, 9], dtype=torch.int64), torch.tensor([5, 6], dtype=torch.int64),
         torch.tensor([0, 1], dtype=torch.int32), torch.tensor([3, 3], dtype=torch.int32))


def _specs(delay, index_cols):
    out = []
    for pkg, udf in ((jassets, JUDF), (tassets, TUDF)):
        out.append(pkg.FeatureSetSpec(
            name="fs", version=1, entity=pkg.Entity("cust", index_cols),
            features=(pkg.Feature("val"), pkg.Feature("cnt", "int64")),
            source_name="src", transform=udf(lambda df, ctx: df, name="id"),
            expected_delay=delay,
        ))
    return out


def _history(rng, n, n_ent, index_cols, base, span):
    """Record-schema history with creation_ts ties broken both ways: some
    (key, event_ts) pairs appear twice with different creation_ts."""
    ents = rng.integers(0, n_ent, size=(n, len(index_cols)))
    ev = base + rng.integers(0, span, size=n)
    cr = ev + rng.integers(1, 100, size=n)
    dup = rng.random(n) < 0.2
    ents[dup], ev[dup] = np.roll(ents, 1, axis=0)[dup], np.roll(ev, 1)[dup]
    cr[dup] = np.roll(cr, 1)[dup] + rng.choice([-1, 1], size=int(dup.sum()))
    cols = {"__key__": encode_keys([ents[:, i] for i in range(len(index_cols))])}
    cols.update({c: ents[:, i].astype(np.int64) for i, c in enumerate(index_cols)})
    cols.update(event_ts=ev.astype(np.int64), creation_ts=cr.astype(np.int64),
                val=rng.standard_normal(n).astype(np.float32),
                cnt=rng.integers(0, 1000, n).astype(np.int64))
    return cols


@pytest.mark.parametrize("regime", ["rebased", "wide"])
@pytest.mark.parametrize("delay", [0, 7, 50])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_pit_join_feature_set_matches_jax(regime, delay, use_kernel):
    rng = np.random.default_rng(delay * 10 + use_kernel + (regime == "wide") * 100)
    index_cols = ("entity_id",) if delay != 7 else ("region", "entity_id")
    base, span = (0, 5_000) if regime == "rebased" else (EPOCH_MS, 2**33)
    cols = _history(rng, 600, 40, index_cols, base, span)
    # spine over 1.25x the entities (missing ones), before / inside / after
    spine_ids = [rng.integers(0, 50, size=250) for _ in index_cols]
    spine_ts = base + rng.integers(-span // 10, span + span // 10, size=250)
    jspec, tspec = _specs(delay if regime == "rebased" else delay * 3_600_000, index_cols)
    with jax.enable_x64(regime == "wide"):
        want = jpit.pit_join_feature_set(spine_ids, spine_ts, jspec, JTable(dict(cols)),
                                         use_kernel=use_kernel, interpret=True)
    got = tpit.pit_join_feature_set(spine_ids, spine_ts, tspec, TTable(dict(cols)),
                                    device="cpu", use_kernel=use_kernel)
    assert got.found.dtype == want.found.dtype and got.event_ts.dtype == want.event_ts.dtype
    np.testing.assert_array_equal(got.found, want.found)
    np.testing.assert_array_equal(got.event_ts, want.event_ts)
    assert got.values.keys() == want.values.keys()
    for k in want.values:
        assert got.values[k].dtype == want.values[k].dtype
        np.testing.assert_array_equal(got.values[k], want.values[k])
    assert got.found.any() and not got.found.all()
    assert set(got.seconds) == {"prepare", "search", "gather"}


def test_pit_join_tie_prefers_latest_creation():
    _, spec = _specs(0, ("entity_id",))
    cols = {"__key__": np.array([1, 1], np.int64), "entity_id": np.array([1, 1], np.int64),
            "event_ts": np.array([100, 100], np.int64),
            "creation_ts": np.array([300, 200], np.int64),
            "val": np.array([2.0, 1.0], np.float32), "cnt": np.array([2, 1], np.int64)}
    for use_kernel in (True, False):
        res = tpit.pit_join_feature_set([np.array([1])], np.array([150]), spec,
                                        TTable(cols), device="cpu", use_kernel=use_kernel)
        assert res.found[0] and res.values["val"][0] == 2.0


def test_pit_join_empty_history_and_spine():
    _, spec = _specs(0, ("entity_id",))
    hist = TTable({k: np.zeros(0, np.int64) for k in
                   ("__key__", "entity_id", "event_ts", "creation_ts", "cnt")}
                  | {"val": np.zeros(0, np.float32)})
    res = tpit.pit_join_feature_set([np.arange(3)], np.arange(3), spec, hist, device="cpu")
    assert not res.found.any() and res.values["val"].dtype == np.float32
    assert len(tpit.pit_join_feature_set([np.arange(0)], np.arange(0), spec, hist,
                                         device="cpu").found) == 0


def test_pit_join_defaults_to_the_card(monkeypatch):
    _, spec = _specs(0, ("entity_id",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpit.pit_join_feature_set([np.arange(3)], np.arange(3), spec,
                                  TTable({"__key__": np.arange(1)}))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_pit_search_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(11)
    table, bounds = _segments(rng, 300, 400, EPOCH_MS, 2**34)
    q_ts, lo, hi = _queries(rng, table, bounds, 20_000, EPOCH_MS, 2**34)
    args = [torch.from_numpy(a) for a in (table, q_ts, lo.astype(np.int32),
                                          hi.astype(np.int32))]
    before = tops.counter.launches
    idx, valid = tops.pit_search(*(a.to(cuda_device) for a in args))
    torch.cuda.synchronize()
    assert tops.counter.launches == before + 1
    want_idx, want_valid = pit_search_ref(*args)
    assert torch.equal(idx.cpu(), want_idx) and torch.equal(valid.cpu(), want_valid)
    empty = torch.zeros(0, dtype=torch.int64, device=cuda_device)
    idx, valid = tops.pit_search(args[0].to(cuda_device), empty, empty, empty)
    assert idx.shape == (0,) and tops.counter.launches == before + 1  # nothing launched


def _edge_segments():
    """Segments of 0..40 rows starting at every offset mod 4 (so every
    16-byte pair alignment), values with runs of ties and both int64
    extremes, and queries at, between and outside every segment's rows."""
    big = np.iinfo(np.int64)
    pool = np.array([big.min, big.min + 1, -7, 0, 0, 3, 3, 3, 8, big.max - 1, big.max], np.int64)
    rng = np.random.default_rng(5)
    parts, lo, hi, q, off = [], [], [], [], 0
    for pad in range(4):
        parts.append(np.zeros(pad, np.int64))
        off += pad
        for n in range(41):
            seg = np.sort(rng.choice(pool, n))
            parts.append(seg)
            for t in (*pool, *seg, -1, 4, 9):
                lo.append(off)
                hi.append(off + n)
                q.append(t)
            off += n
    return [torch.from_numpy(np.asarray(a, dt)) for a, dt in (
        (np.concatenate(parts), np.int64), (q, np.int64), (lo, np.int32), (hi, np.int32))]


@pytest.mark.gpu
def test_pit_search_kernel_edges_on_card(cuda_device):
    """Byte-identical to the plain search at every segment length 0..40 and
    alignment, ties and int64 extremes, and on 5,000-row segments."""
    args = _edge_segments()
    rng = np.random.default_rng(6)
    table, bounds = _segments(rng, 6, 5000, EPOCH_MS, 2**34)
    q_ts, lo, hi = _queries(rng, table, bounds, 4000, EPOCH_MS, 2**34)
    for case in (args, [torch.from_numpy(a) for a in (table, q_ts, lo.astype(np.int32),
                                                      hi.astype(np.int32))]):
        dev = [a.to(cuda_device) for a in case]
        idx = torch.empty(len(case[1]), dtype=torch.int32, device=cuda_device)
        valid = torch.empty(len(case[1]), dtype=torch.bool, device=cuda_device)
        tops._launch(*dev, idx, valid)
        torch.cuda.synchronize()
        tops.check_error()
        want = pit_search_ref(*case)
        assert torch.equal(idx.cpu(), want[0]) and torch.equal(valid.cpu(), want[1])


@pytest.mark.gpu
def test_pit_search_bad_bounds_on_card(cuda_device):
    """Bounds past the table raise the CPU path's ValueError at the read
    after a synchronization, or at the next call; the bad query is not
    valid, the others are right, and the next good call succeeds."""
    t, q, lo, hi = (a.to(cuda_device) for a in _GOOD)
    for bad_lo, bad_hi in ((0, 4), (-1, 2), (2, 1)):
        blo, bhi = lo.clone(), hi.clone()
        blo[0], bhi[0] = bad_lo, bad_hi
        idx, valid = tops.pit_search(t, q, blo, bhi)  # no raise: nothing synchronized
        torch.cuda.synchronize()
        assert not valid[0] and idx[0] == -1 and valid[1] and idx[1] == 1
        with pytest.raises(ValueError, match=re.escape(tops.BOUNDS_MESSAGE)):
            tops.check_error()
        tops.pit_search(t, q, blo, bhi.long())  # int64 bounds, the same check
        torch.cuda.synchronize()
        with pytest.raises(ValueError, match=re.escape(tops.BOUNDS_MESSAGE)):
            tops.pit_search(t, q, lo, hi)
        got, want = tops.pit_search(t, q, lo, hi), pit_search_ref(*_GOOD)
        torch.cuda.synchronize()
        tops.check_error()
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.gpu
def test_pit_search_does_not_synchronize_on_card(cuda_device):
    args = [a.to(cuda_device) for a in _edge_segments()]
    tops.pit_search(*args)  # the first call builds and allocates
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx, valid = tops.pit_search(*args)
        idx64, _ = tops.pit_search(args[0], args[1], args[2].long(), args[3].long())
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    tops.check_error()
    assert torch.equal(idx, idx64) and torch.equal(idx.cpu(), pit_search_ref(*_edge_segments())[0])
