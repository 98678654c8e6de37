"""Port's online_lookup against the JAX package: routing helpers bit-identical,
``lookup`` and ``gather_rows`` equal (CPU: the wrappers run their plain
versions; the Pallas kernel runs in interpret mode)."""

import ctypes

import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.online_lookup import ops as jops  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.online_lookup import ops as tops  # noqa: E402
from repro_torch.kernels.online_lookup.ref import lookup_ref  # noqa: E402

EDGE = np.array(
    [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**40 + 17, -1, -2, -(2**63)],
    np.int64,
)


def _ids(rng, n):
    ids = rng.integers(-(2**63), 2**63 - 1, size=n, dtype=np.int64)
    return np.concatenate([EDGE, ids])


@pytest.mark.parametrize("num_p", [1, 3, 16, 37])
def test_routing_helpers_bit_identical(num_p):
    rng = np.random.default_rng(num_p)
    ids = _ids(rng, 500)
    for a, b in zip(jops.split_i64(ids), tops.split_i64(ids)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    lo, hi = jops.split_i64(ids)
    assert np.array_equal(jops.combine_i64(lo, hi), tops.combine_i64(lo, hi))
    assert np.array_equal(tops.combine_i64(lo, hi), ids)
    assert np.array_equal(jops.partition_of(ids, num_p), tops.partition_of(ids, num_p))
    payload = rng.standard_normal((len(ids), 3)).astype(np.float32)
    for a, b in zip(jops.route_flat(num_p, ids, payload), tops.route_flat(num_p, ids, payload)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(jops.route_queries(num_p, ids), tops.route_queries(num_p, ids)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    routed, part, pos = tops.route_queries_i64(num_p, ids)
    q_lo, q_hi = jops.route_queries(num_p, ids)[:2]
    assert routed.shape == q_lo.shape and np.array_equal(routed[part, pos], ids)
    pad = routed == -2
    assert np.all(q_lo[pad] == -2) and np.all(q_hi[pad] == -2)
    for n in [0, 1, 127, 128, 129, 4096, 5000]:
        assert jops.pow2_bucket(n) == tops.pow2_bucket(n)


def _table(rng, p, c, n_query):
    """Keys (P, C) with empties (-1), duplicates, and keys whose low word is
    >= 2**31; routed queries (P, Q) with hits, misses, pads (-2)."""
    keys = rng.integers(0, 2**62, size=(p, c), dtype=np.int64)
    keys[:, 0] = 2**31 + 7  # low word >= 2**31
    keys[rng.random((p, c)) < 0.2] = -1  # tombstones / empty slots
    if c > 3:
        keys[:, c - 1] = keys[:, 1]  # duplicate key: the larger slot wins
    pick = rng.integers(0, c, size=(p, n_query))
    q = np.where(
        rng.random((p, n_query)) < 0.6,
        keys[np.arange(p)[:, None], pick],
        rng.integers(0, 2**62, size=(p, n_query), dtype=np.int64),
    )
    q[q == -1] = 5  # a query is a live id; empties must never match
    q[rng.random((p, n_query)) < 0.15] = -2
    return keys, q


def _jax_lookup(keys, q):
    klo, khi = jops.split_i64(keys)
    qlo, qhi = jops.split_i64(q)
    pad = q == -2
    qlo[pad] = -2
    qhi[pad] = -2
    return np.asarray(
        jops.lookup(
            jnp.asarray(klo), jnp.asarray(khi), jnp.asarray(qlo), jnp.asarray(qhi),
            interpret=True,
        )
    )


@pytest.mark.parametrize("p,c,q", [(1, 1, 1), (1, 300, 7), (3, 1000, 129), (5, 130, 64)])
def test_lookup_matches_jax(p, c, q):
    rng = np.random.default_rng(p * 1000 + c + q)
    keys, queries = _table(rng, p, c, q)
    got = tops.lookup(torch.from_numpy(keys), torch.from_numpy(queries))
    assert got.dtype == torch.int32 and tuple(got.shape) == (p, q)
    want = _jax_lookup(keys, queries)
    np.testing.assert_array_equal(got.numpy(), want)
    if p * q > 1:
        assert (want >= 0).any() and (want == -1).any()
    if c > 3:
        dup = queries == keys[:, 1:2]
        assert np.all(got.numpy()[dup] == c - 1)


def test_lookup_rejects_bad_input():
    k = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(TypeError):
        tops.lookup(k.to(torch.int32), k)
    with pytest.raises(ValueError):
        tops.lookup(k, torch.zeros((3, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        tops.lookup(k, torch.zeros((2, 8), dtype=torch.int64)[:, ::2])


def test_gather_rows_matches_jax():
    rng = np.random.default_rng(3)
    p, c, d, b = 3, 50, 4, 40
    values = rng.standard_normal((p, c, d)).astype(np.float32)
    cr = rng.integers(-(2**40), 2**40, size=(p, c), dtype=np.int64)
    part = rng.integers(0, p, b).astype(np.int32)
    slot = rng.integers(0, c, b).astype(np.int32)
    lo, hi = jops.split_i64(cr)
    jv, jlo, jhi = jops.gather_rows(
        jnp.asarray(values), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(part), jnp.asarray(slot),
    )
    tv, tcr = tops.gather_rows(
        torch.from_numpy(values), torch.from_numpy(cr),
        torch.from_numpy(part), torch.from_numpy(slot),
    )
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        tcr.numpy(), jops.combine_i64(np.asarray(jlo), np.asarray(jhi))
    )


def _adversarial(rng, p, c, q):
    """Keys and queries drawn from -1 (empty), -2 (pad), INT64_MIN, INT64_MAX
    and a few other values, so every partition holds each of them in many
    slots and asks for each in many columns, beside random keys."""
    i64 = np.iinfo(np.int64)
    pool = np.array([-1, -2, i64.min, i64.max, 0, 1, 2**32, -(2**31)], np.int64)
    keys = np.where(rng.random((p, c)) < 0.5, rng.choice(pool, (p, c)),
                    rng.integers(i64.min, i64.max, (p, c), dtype=np.int64))
    queries = np.where(rng.random((p, q)) < 0.7, rng.choice(pool, (p, q)),
                       keys[np.arange(p)[:, None], rng.integers(0, c, (p, q))])
    queries[:, -1] = 12345  # a miss, unless a random key is 12345
    return keys, queries


def test_lookup_plain_on_adversarial_values():
    """The plain version (the CPU path and the kernel's yardstick) gives the
    largest equal slot for every value: -1 finds the last empty slot, -2 a
    key of -2, the int64 extremes are ordinary, duplicates all answer."""
    keys, queries = _adversarial(np.random.default_rng(0), 3, 300, 200)
    got = tops.lookup(torch.from_numpy(keys), torch.from_numpy(queries)).numpy()
    for p in range(3):
        for j, v in enumerate(queries[p]):
            hits = np.flatnonzero(keys[p] == v)
            assert got[p, j] == (hits[-1] if len(hits) else -1)
    assert (got >= 0).mean() > 0.9 and (queries == -1).any() and (queries == -2).any()


def test_lookup_takes_more_than_65535_partitions():
    """P = 65,537 (grid y stopped at 65,535 on the card), against numpy."""
    p = 65_537
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 6, (p, 3)).astype(np.int64)
    queries = rng.integers(0, 8, (p, 2)).astype(np.int64)
    got = tops.lookup(torch.from_numpy(keys), torch.from_numpy(queries)).numpy()
    eq = keys[:, None, :] == queries[:, :, None]  # (P, Q, C)
    want = np.where(eq.any(-1), 2 - np.argmax(eq[..., ::-1], axis=-1), -1)
    np.testing.assert_array_equal(got, want)


def test_lookup_entry_launches_once_per_call(monkeypatch):
    """The C entry takes (keys, queries, out, P, C, Q, stream) and is called
    once per launch, which is counted; no queries, no launch."""
    sig = native._SIGNATURES["online_lookup_i64"]
    assert sig == (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
    calls = []
    lib = type("Lib", (), {"online_lookup_i64": staticmethod(lambda *a: calls.append(a) or 0)})
    monkeypatch.setattr(tops.native, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: type("S", (), {"cuda_stream": 0}))
    keys = torch.zeros((4, 9), dtype=torch.int64)
    before = tops.counter.launches
    for q in (5, 0):
        queries = torch.zeros((4, q), dtype=torch.int64)
        out = torch.empty((4, q), dtype=torch.int32)
        tops._launch(keys, queries, out)
    ((k, _, _, p, c, q, stream),) = calls  # Q = 0: no launch
    assert (k, p, c, q, stream) == (keys.data_ptr(), 4, 9, 5, 0)
    assert tops.counter.launches == before + 1


def _build_store(rng, num_p, cap, n_live, dim=4):
    """The JAX package's GET-test store (tests/kernels/test_online_lookup.py):
    live ids in their hash partitions, value = id % 97, as int64 keys."""
    ids = rng.choice(np.arange(1, 10_000_000), size=n_live, replace=False).astype(np.int64)
    keys = np.full((num_p, cap), -1, np.int64)
    values = np.zeros((num_p, cap, dim), np.float32)
    part = tops.partition_of(ids, num_p)
    fill = np.zeros(num_p, np.int64)
    kept = []
    for j in range(n_live):
        p = part[j]
        if fill[p] >= cap:
            continue
        keys[p, fill[p]] = ids[j]
        values[p, fill[p]] = float(ids[j] % 97)
        fill[p] += 1
        kept.append(ids[j])
    return keys, values, np.array(kept, np.int64)


def _route_and_lookup_both(keys, values, ids):
    """The port's route_and_lookup on the CPU, held equal to the JAX
    package's (interpret mode) on the same table."""
    lo, hi = jops.split_i64(keys)
    want = jops.route_and_lookup(lo, hi, values, ids, interpret=True)
    got = tops.route_and_lookup(keys, values, ids, device="cpu")
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g, w)
    return got


def test_route_and_lookup_end_to_end_matches_jax():
    rng = np.random.default_rng(3)
    keys, values, live = _build_store(rng, 8, 256, 900)
    hits = rng.choice(live, size=50, replace=False)
    misses = np.arange(20_000_000, 20_000_030, dtype=np.int64)
    ids = np.concatenate([hits, misses])
    rng.shuffle(ids)
    out, found = _route_and_lookup_both(keys, values, ids)
    np.testing.assert_array_equal(found, np.isin(ids, live))
    np.testing.assert_allclose(out[found], (ids[found] % 97)[:, None].repeat(4, 1))
    assert not out[~found].any()


def test_route_and_lookup_empty_batch_matches_jax():
    keys = np.full((2, 8), -1, np.int64)
    out, found = _route_and_lookup_both(keys, np.zeros((2, 8, 3), np.float32),
                                        np.zeros(0, np.int64))
    assert out.shape == (0, 3) and found.shape == (0,)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n_q=st.integers(1, 120))
def test_route_and_lookup_property_matches_jax(seed, n_q):
    """Every stored id is found with its value, every other id misses, on
    the port and on JAX alike."""
    rng = np.random.default_rng(seed)
    keys, values, live = _build_store(rng, 4, 128, 300)
    universe = np.concatenate([live, rng.integers(10**8, 10**9, size=50)])
    ids = rng.choice(universe, size=n_q)
    out, found = _route_and_lookup_both(keys, values, ids)
    np.testing.assert_array_equal(found, np.isin(ids, live))
    np.testing.assert_allclose(out[found], (ids[found] % 97)[:, None].repeat(4, 1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_lookup_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(11)
    keys, queries = _table(rng, 7, 5000, 300)
    k, q = torch.from_numpy(keys), torch.from_numpy(queries)
    before = tops.counter.launches
    got = tops.lookup(k.to(cuda_device), q.to(cuda_device))
    torch.cuda.synchronize()
    assert tops.counter.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), tops.lookup(k, q).numpy())


@pytest.mark.gpu
def test_lookup_kernel_adversarial_values_on_card(cuda_device):
    """Queries -1, -2, INT64_MIN/MAX and duplicates, against keys with the
    same values in many slots, on both designs: one block a partition
    (P=300) and a cluster a partition (P=2, C=40,000), and Q past one
    2,048-column chunk."""
    rng = np.random.default_rng(12)
    for p, c, q in ((300, 500, 64), (2, 40_000, 512), (3, 9000, 5000)):
        keys, queries = _adversarial(rng, p, c, q)
        k, qq = torch.from_numpy(keys), torch.from_numpy(queries)
        got = tops.lookup(k.to(cuda_device), qq.to(cuda_device))
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), lookup_ref(k, qq).numpy())


@pytest.mark.gpu
def test_lookup_kernel_at_65536_partitions_on_card(cuda_device):
    p = 65_536
    rng = np.random.default_rng(2)
    keys = torch.from_numpy(rng.integers(0, 6, (p, 3)).astype(np.int64))
    queries = torch.from_numpy(rng.integers(0, 8, (p, 2)).astype(np.int64))
    before = tops.counter.launches
    got = tops.lookup(keys.to(cuda_device), queries.to(cuda_device))
    torch.cuda.synchronize()
    assert tops.counter.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), lookup_ref(keys, queries).numpy())


@pytest.mark.gpu
def test_lookup_does_not_synchronize_on_card(cuda_device):
    rng = np.random.default_rng(13)
    keys, queries = (torch.from_numpy(a).to(cuda_device) for a in _table(rng, 16, 65536, 512))
    tops.lookup(keys, queries)  # the first call builds
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tops.lookup(keys, queries)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert torch.equal(got.cpu(), lookup_ref(keys.cpu(), queries.cpu()))


@pytest.mark.gpu
def test_route_and_lookup_on_card(cuda_device):
    rng = np.random.default_rng(3)
    keys, values, live = _build_store(rng, 8, 256, 900)
    misses = np.arange(2 * 10**7, 2 * 10**7 + 30)
    ids = np.concatenate([rng.choice(live, 50, replace=False), misses])
    got = tops.route_and_lookup(keys, values, ids, device=cuda_device)
    want = tops.route_and_lookup(keys, values, ids, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
