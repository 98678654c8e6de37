"""Port's online_lookup against the JAX package: routing helpers bit-identical,
``lookup`` and ``gather_rows`` equal (CPU: the wrappers run their plain
versions; the Pallas kernel runs in interpret mode)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.online_lookup import ops as jops  # noqa: E402
from repro_torch.kernels.online_lookup import ops as tops  # noqa: E402

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
