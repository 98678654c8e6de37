"""Port's resident Algorithm-2 merge (``merge_at_slots``, ``gather_slot_ts``)
against the JAX package's, byte-identical on the same seeded inputs."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.online_lookup.ops import combine_i64, split_i64  # noqa: E402
from repro.kernels.online_merge import ops as jops  # noqa: E402
from repro_torch.kernels.online_merge import ops as tops  # noqa: E402

_I32_MAX = np.iinfo(np.int32).max


def _case(rng, p, c, d, g, *, ev_base):
    keys = rng.integers(0, 2**62, size=(p, c), dtype=np.int64)
    keys[rng.random((p, c)) < 0.3] = -1  # empty / recycled slots
    ev = ev_base + rng.integers(-3, 3, size=(p, c), dtype=np.int64)
    cr = rng.integers(100, 103, size=(p, c), dtype=np.int64)
    values = rng.standard_normal((p, c, d)).astype(np.float32)
    flat = rng.choice(p * c, size=g, replace=False)  # distinct coords
    part, slot = flat // c, flat % c
    is_new = keys[part, slot] == -1
    q_keys = np.where(is_new, rng.integers(0, 2**62, size=g, dtype=np.int64), keys[part, slot])
    # event_ts equal to, above and below the stored one, so ties fall to creation_ts
    q_ev = ev[part, slot] + rng.integers(-1, 2, size=g)
    q_vals = rng.standard_normal((g, d)).astype(np.float32)
    return keys, ev, cr, values, part, slot, q_keys, is_new, q_ev, q_vals


def _jax_merge(keys, ev, cr, values, part, slot, q_keys, is_new, q_ev, creation, q_vals, gb):
    """The JAX store's call: batch padded to ``gb`` with out-of-bounds coords."""
    g = len(part)
    p32 = np.zeros(gb, np.int32)
    s32 = np.full(gb, _I32_MAX, np.int32)
    p32[:g], s32[:g] = part, slot
    pad = lambda a, dt: np.concatenate([a.astype(dt), np.zeros((gb - g,) + a.shape[1:], dt)])
    klo, khi = split_i64(pad(q_keys, np.int64))
    elo, ehi = split_i64(pad(q_ev, np.int64))
    crp = np.concatenate(split_i64(np.asarray([creation], np.int64))).astype(np.int32)
    planes = [*split_i64(keys), *split_i64(ev), *split_i64(cr)]
    out = jops.merge_at_slots(
        *map(jnp.asarray, planes), jnp.asarray(values),
        jnp.asarray(p32), jnp.asarray(s32), jnp.asarray(klo), jnp.asarray(khi),
        jnp.asarray(pad(is_new, bool)), jnp.asarray(elo), jnp.asarray(ehi),
        jnp.asarray(crp), jnp.asarray(pad(q_vals, np.float32)),
    )
    out = [np.asarray(o) for o in out]
    return (
        combine_i64(out[0], out[1]), combine_i64(out[2], out[3]),
        combine_i64(out[4], out[5]), out[6],
    )


def _torch_merge(keys, ev, cr, values, part, slot, q_keys, is_new, q_ev, creation, q_vals):
    t = [torch.from_numpy(a.copy()) for a in (keys, ev, cr, values)]
    tops.merge_at_slots(
        *t,
        torch.from_numpy(part.astype(np.int32)), torch.from_numpy(slot.astype(np.int32)),
        torch.from_numpy(q_keys), torch.from_numpy(is_new),
        torch.from_numpy(q_ev.astype(np.int64)),
        torch.tensor([creation], dtype=torch.int64), torch.from_numpy(q_vals),
    )
    return tuple(x.numpy() for x in t)


@pytest.mark.parametrize(
    "ev_base,creation",
    [
        (1_700_000_000_000, 101),  # epoch ms: low word crosses 2**31
        (2**31 - 1, 102),  # low word straddles 2**31 within the +-3 jitter
        (2**32 - 2, 100),  # hi word carries
        (-5_000, 102),  # negative event_ts
    ],
)
def test_merge_at_slots_matches_jax(ev_base, creation):
    rng = np.random.default_rng(abs(ev_base) % 1000 + creation)
    p, c, d, g = 3, 40, 5, 50
    case = _case(rng, p, c, d, g, ev_base=ev_base)
    keys, ev, cr, values, part, slot, q_keys, is_new, q_ev, q_vals = case
    assert is_new.any() and (~is_new).any()
    want = _jax_merge(*case[:9], creation, q_vals, gb=128)  # padded batch > real one
    got = _torch_merge(*case[:9], creation, q_vals)
    for w, t in zip(want, got):
        assert w.dtype == t.dtype
        np.testing.assert_array_equal(t, w)
    # every branch of the rule ran: insert, override by ev, override by a
    # creation_ts tie-break, and no-op
    old = (~is_new)
    tie = old & (q_ev == ev[part, slot])
    assert (old & (q_ev > ev[part, slot])).any() and tie.any()
    won_tie = tie & (creation > cr[part, slot])
    lost = old & ~(q_ev > ev[part, slot]) & ~won_tie
    np.testing.assert_array_equal(got[2][part[won_tie], slot[won_tie]], creation)
    np.testing.assert_array_equal(got[1][part[lost], slot[lost]], ev[part[lost], slot[lost]])


def test_gather_slot_ts_matches_jax():
    rng = np.random.default_rng(5)
    ev = rng.integers(-(2**40), 2**40, size=(4, 30), dtype=np.int64)
    cr = rng.integers(0, 2**40, size=(4, 30), dtype=np.int64)
    part = rng.integers(0, 4, 25).astype(np.int32)
    slot = rng.integers(0, 30, 25).astype(np.int32)
    out = jops.gather_slot_ts(
        *map(jnp.asarray, [*split_i64(ev), *split_i64(cr)]),
        jnp.asarray(part), jnp.asarray(slot),
    )
    out = [np.asarray(o) for o in out]
    tev, tcr = tops.gather_slot_ts(
        torch.from_numpy(ev), torch.from_numpy(cr),
        torch.from_numpy(part), torch.from_numpy(slot),
    )
    np.testing.assert_array_equal(tev.numpy(), combine_i64(out[0], out[1]))
    np.testing.assert_array_equal(tcr.numpy(), combine_i64(out[2], out[3]))
