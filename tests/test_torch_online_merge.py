"""Port's resident Algorithm-2 merge (``merge_at_slots``, ``gather_slot_ts``)
against the JAX package's, byte-identical on the same seeded inputs."""

import ctypes
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.online_lookup.ops import combine_i64, split_i64  # noqa: E402
from repro.kernels.online_merge import ops as jops  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.online_lookup.ops import partition_of  # noqa: E402
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


# -- the index-free scan merge: route_and_merge / merge --------------------------
I64 = np.iinfo(np.int64)
BOUNDARY_TS = np.array([2**31 - 1, 2**31, 2**32, -1, I64.min, 0, 2**31 + 1], np.int64)


def _scan_case(rng, p, c, d, g, *, boundary):
    """A table whose keys sit in their hash partitions, with empty slots, one
    key held by two slots, INT64_MIN-stamped fresh inserts and (if
    ``boundary``) timestamps at the int32/int64 edges; ``g`` unique winner
    ids: held keys with event_ts below, equal to and above the stored one,
    plus ids the table does not hold."""
    cand = rng.integers(0, 2**40, size=p * c, dtype=np.int64)
    home = partition_of(cand, p)
    keys = np.full((p, c), -1, np.int64)
    for q in range(p):
        mine = cand[home == q][: c * 3 // 4]
        keys[q, rng.choice(c, size=len(mine), replace=False)] = mine
    shared = keys[0][keys[0] >= 0][0]
    twin = np.flatnonzero(keys[0] == -1)[0]
    keys[0, twin] = shared  # one key in two slots of its partition
    if boundary:
        ev = rng.choice(BOUNDARY_TS, size=(p, c))
        cr = rng.choice(BOUNDARY_TS, size=(p, c))
    else:
        ev = 1_700_000_000_000 + rng.integers(-3, 3, size=(p, c))
        cr = rng.integers(100, 103, size=(p, c)).astype(np.int64)
    fresh = rng.random((p, c)) < 0.1
    ev[fresh] = cr[fresh] = I64.min
    first, twin = np.flatnonzero(keys[0] == shared)
    ev[0, twin], cr[0, twin] = ev[0, first], cr[0, first]
    values = rng.standard_normal((p, c, d)).astype(np.float32)
    values[0, twin] = values[0, first]
    live = np.unique(keys[keys >= 0])
    n_hit = min(g * 3 // 4, len(live))
    ids = np.concatenate([rng.choice(live, n_hit, replace=False),
                          rng.integers(2**41, 2**42, g - n_hit)])
    if shared not in ids:
        ids[0] = shared
    # stored event_ts of each id (any of its slots), then -1 / 0 / +1
    where = {int(k): ev[pp, cc] for (pp, cc), k in np.ndenumerate(keys) if k >= 0}
    base = np.array([where.get(int(i), 0) for i in ids], np.int64)
    step = rng.integers(-1, 2, size=g)
    q_ev = np.where((step < 0) & (base == I64.min), base, base + step)
    if boundary:
        q_ev[::3] = rng.choice(BOUNDARY_TS, size=len(q_ev[::3]))
    vals = rng.standard_normal((g, d)).astype(np.float32)
    return keys, ev, cr, values, ids, q_ev, vals


def _jax_route_and_merge(keys, ev, cr, values, ids, q_ev, vals, creation):
    klo, khi = split_i64(keys)
    return jops.route_and_merge(klo, khi, ev, cr, values, ids, q_ev, vals, creation,
                                interpret=True)


@pytest.mark.parametrize(
    "boundary,creation",
    [(False, 101), (False, 103), (True, 2**31), (True, 2**32), (True, -1), (True, 0)],
)
def test_route_and_merge_matches_jax(boundary, creation):
    rng = np.random.default_rng(creation % 997 + boundary)
    p, c, d, g = 4, 96, 3, 150
    case = _scan_case(rng, p, c, d, g, boundary=boundary)
    keep = [a.copy() for a in case]
    want = _jax_route_and_merge(*case, creation)
    got = tops.route_and_merge(*case, creation, device="cpu")
    for a, b in zip(case, keep):  # value semantics: inputs untouched
        np.testing.assert_array_equal(a, b)
    for w, t in zip(want, got):
        assert w.dtype == t.dtype
        np.testing.assert_array_equal(t, w)
    keys, ev, cr = case[:3]
    changed = got[0] != ev
    assert changed.any() and (~changed & (keys >= 0)).any()  # overrides and no-ops
    assert (got[1][cr == I64.min] != I64.min).any()  # pre-stamped inserts taken
    both = np.flatnonzero(keys[0] == keys[0][keys[0] >= 0][0])  # one key, two slots
    assert len(both) == 2
    for out in got:
        np.testing.assert_array_equal(out[0, both[0]], out[0, both[1]])


def test_route_and_merge_creation_ts_breaks_equal_event_ts():
    keys = np.array([[5, 6, -1]], np.int64)
    ev = np.array([[10, 10, 0]], np.int64)
    cr = np.array([[100, 300, 0]], np.int64)
    values = np.zeros((1, 3, 2), np.float32)
    ids, q_ev = np.array([5, 6]), np.array([10, 10])
    vals = np.ones((2, 2), np.float32)
    for use in ("jax", "port"):
        if use == "jax":
            out = _jax_route_and_merge(keys, ev, cr, values, ids, q_ev, vals, 200)
        else:
            out = tops.route_and_merge(keys, ev, cr, values, ids, q_ev, vals, 200,
                                       device="cpu")
        # greater creation_ts wins the tie on slot 0; lesser loses on slot 1
        assert out[1].tolist() == [[200, 300, 0]], use
        assert out[2][0, :, 0].tolist() == [1.0, 0.0, 0.0], use


def test_route_and_merge_empty_batch_and_pads():
    rng = np.random.default_rng(3)
    keys, ev, cr, values, ids, q_ev, vals = _scan_case(rng, 3, 40, 2, 20, boundary=False)
    for out in (_jax_route_and_merge(keys, ev, cr, values, ids[:0], q_ev[:0], vals[:0], 7),
                tops.route_and_merge(keys, ev, cr, values, ids[:0], q_ev[:0], vals[:0], 7,
                                     device="cpu")):
        for a, b in zip(out, (ev, cr, values)):
            np.testing.assert_array_equal(a, b)
            assert a is not b
    # one winner routes to a partition padded far past it: pads match nothing,
    # not even a slot whose key equals the pad value
    keys[1, 3] = tops.PAD
    q_ids, _, _ = tops.route_winners(3, ids[:1], q_ev[:1], vals[:1])
    assert q_ids.shape[1] == 128 and (q_ids == tops.PAD).sum() == 3 * 128 - 1
    wid = next(k for k in keys[0] if k >= 0 and (keys == k).sum() == 1)
    got = tops.route_and_merge(keys, ev, cr, values, np.array([wid]),
                               np.array([ev[keys == wid].max() + 10]), vals[:1], 7,
                               device="cpu")
    assert (got[0] != ev).sum() == (keys == wid).sum() == 1


def test_merge_validates_winner_keys():
    keys = torch.tensor([[1, 2]])
    ev, cr = torch.zeros((1, 2), dtype=torch.int64), torch.zeros((1, 2), dtype=torch.int64)
    values = torch.zeros((1, 2, 1))
    q_vals = torch.zeros((1, 2, 1))
    with pytest.raises(ValueError, match="distinct"):
        tops.merge(keys, ev, cr, values, torch.tensor([[1, 1]]), ev, q_vals, 5)
    with pytest.raises(ValueError, match="pad"):
        tops.merge(keys, ev, cr, values, torch.tensor([[-3, 1]]), ev, q_vals, 5)
    with pytest.raises(TypeError):
        tops.merge(keys, ev, cr, values.double(), torch.tensor([[2, 1]]), ev, q_vals, 5)
    with pytest.raises(ValueError):
        tops.merge(keys, ev, cr, values, torch.tensor([[2, 1, 3]]), ev, q_vals, 5)
    tops.merge(keys, ev, cr, values, torch.tensor([[2, -2]]), ev + 1,
               torch.ones((1, 2, 1)), 5)
    # in place, on the slot of key 2 only
    assert ev.tolist() == [[0, 1]] and cr.tolist() == [[0, 5]]
    assert values.flatten().tolist() == [0.0, 1.0]


def _fake_library(monkeypatch, **entries):
    """A kernel library without a card: ``entries`` stand in for the C
    entries, and the error word is a ctypes int the test owns."""
    word = ctypes.c_int32(0)
    lib = type("Lib", (), {"repro_error_word_alloc": staticmethod(lambda: ctypes.addressof(word)),
                           **{k: staticmethod(v) for k, v in entries.items()}})
    monkeypatch.setattr(tops.native, "library", lambda: lib)
    monkeypatch.setattr(tops, "errors", native.ErrorWord(*tops.errors.messages))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: type("S", (), {"cuda_stream": 0}))
    return word


def _fake_launch(p, c, q, d=2):
    """``_launch`` on CPU tensors of the given sizes (a fake library stands
    in for the kernel)."""
    table = torch.zeros((p, c), dtype=torch.int64)
    batch = torch.zeros((p, q), dtype=torch.int64)
    scratch = torch.empty(tops.scratch_len(p, q), dtype=torch.int64)
    tops._launch(table, table, table, torch.zeros((p, c, d)), batch, batch,
                 torch.zeros((p, q, d)), scratch, 7)
    return scratch


@pytest.mark.parametrize("p,c,q", [(2, 3, 4), (0, 3, 4), (2, 0, 4), (2, 3, 0)])
def test_merge_launch_counts_only_a_launch(monkeypatch, p, c, q):
    """The launch counter moves where the kernel launches and nowhere else:
    an empty table or batch launches nothing and counts nothing."""
    calls = []
    _fake_library(monkeypatch, merge_scan_i64=lambda *a: calls.append(a) or 0)
    before = tops.counter.launches
    _fake_launch(p, c, q)
    launched = p * c * q > 0
    assert len(calls) == launched and tops.counter.launches == before + launched


def test_merge_entry_takes_the_error_word(monkeypatch):
    """The C entry's signature carries the winners (no sorted copy), the
    scratch and its length, and the error word's pointer; the launch passes
    the word it reads and a scratch of ``scratch_len`` words."""
    sig = native._SIGNATURES["merge_scan_i64"]
    assert len(sig) == 16
    assert sig[7] is ctypes.c_void_p and sig[8] is ctypes.c_longlong  # scratch, length
    assert sig[9] is ctypes.c_void_p and sig[10] is ctypes.c_longlong  # word, creation
    calls = []
    word = _fake_library(monkeypatch, merge_scan_i64=lambda *a: calls.append(a) or 0)
    scratch = _fake_launch(3, 5, 4, d=6)
    (args,) = calls
    assert len(args) == len(sig)
    assert args[7] == scratch.data_ptr() and args[8] == scratch.numel() == tops.scratch_len(3, 4)
    assert args[9] == tops.errors.ptr(torch.device("cpu")) == ctypes.addressof(word)
    assert args[10:15] == (7, 3, 5, 4, 6)  # creation, P, C, Q, D


@pytest.mark.parametrize("q", [1, 2048, 4096, 4097, 20_000, 70_000])
def test_merge_scratch_holds_every_partitions_hash(q):
    """The scratch holds the verdict word, padded to 16 bytes, and each
    partition's hash (2q entries or more, and 4 or more, 12 bytes each) and
    filter (64 bits a key or more, at most 2**20), every one 16-byte
    aligned; up to 4,096 winners a partition the hash also fits in the 96 KiB
    of shared memory the update kernel copies it into."""
    entries, fbits = tops.hash_entries(q), tops.filter_size(q)
    assert entries >= max(2 * q, 4) and entries & (entries - 1) == 0 and entries < 4 * q + 4
    assert fbits & (fbits - 1) == 0 and 1 << 10 <= fbits <= 1 << 20
    assert fbits >= min(64 * q, 1 << 20) and (fbits == 1 << 10 or fbits < 128 * q)
    assert tops.hash_in_shared(q) == (q <= 4096)
    assert (12 * entries + fbits // 8) % 16 == 0
    assert tops.scratch_len(3, q) == 2 + 3 * (12 * entries + fbits // 8) // 8


@pytest.mark.parametrize("word", [1, 2, 3])
def test_merge_error_word_raises_at_check_and_the_next_call(monkeypatch, word):
    """A refused batch (bit 0: a bad key, bit 1: a duplicate) raises the CPU
    path's own message at ``check_error``, the bad key's where both are set,
    or at the next launch if nobody read it; then the word is clear."""
    def kernel(*args):
        ctypes.c_int32.from_address(args[9]).value = word
        return 0

    _fake_library(monkeypatch, merge_scan_i64=kernel)
    msg = tops.BAD_KEY_MESSAGE if word & 1 else tops.DUPLICATE_MESSAGE
    _fake_launch(2, 3, 4)
    with pytest.raises(ValueError, match=re.escape(msg)):
        tops.check_error()
    tops.check_error()  # cleared
    _fake_launch(2, 3, 4)  # a report nobody read ...
    with pytest.raises(ValueError, match=re.escape(msg)):  # ... raises at the next launch
        _fake_launch(2, 3, 4)
    tops.check_error()  # which did not launch, and cleared the word


def _many_partitions(rng, p):
    """P partitions of 2 slots: each of 3,000 random ids in slot 0 of its
    hash partition (some partitions stay empty), random stamps, and winners
    for 2/3 of the held ids plus ids the table does not hold."""
    ids = np.unique(rng.integers(0, 2**40, 3000))
    home = partition_of(ids, p)
    _, first = np.unique(home, return_index=True)
    held = ids[first]
    keys = np.full((p, 2), -1, np.int64)
    keys[home[first], 0] = held
    ev = rng.integers(0, 4, (p, 2)).astype(np.int64)
    cr = rng.integers(0, 4, (p, 2)).astype(np.int64)
    values = rng.standard_normal((p, 2, 3)).astype(np.float32)
    win = np.concatenate([held[: len(held) * 2 // 3], 2**41 + np.arange(50)])
    q_ev = rng.integers(0, 4, len(win)).astype(np.int64)
    q_vals = rng.standard_normal((len(win), 3)).astype(np.float32)
    return keys, ev, cr, values, win, q_ev, q_vals


def _numpy_merge(keys, ev, cr, values, win, q_ev, q_vals, creation):
    ev, cr, values = ev.copy(), cr.copy(), values.copy()
    for i, k in enumerate(win):
        pp, cc = np.nonzero(keys == k)
        take = (q_ev[i] > ev[pp, cc]) | ((q_ev[i] == ev[pp, cc]) & (creation > cr[pp, cc]))
        pp, cc = pp[take], cc[take]
        ev[pp, cc], cr[pp, cc], values[pp, cc] = q_ev[i], creation, q_vals[i]
    return ev, cr, values


def test_merge_takes_more_than_65535_partitions():
    """``merge`` and ``route_and_merge`` take P = 65,537 (grid y stopped at
    65,535 on the card), against a numpy expectation."""
    p = 65_537
    rng = np.random.default_rng(65537)
    case = _many_partitions(rng, p)
    want = _numpy_merge(*case, 2)
    got = tops.route_and_merge(*case, 2, device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert (got[0] != case[1]).any() and (got[0] == case[1])[case[0] >= 0].any()
    routed = tops.route_winners(p, *case[4:])
    table = [torch.from_numpy(a.copy()) for a in case[:4]]
    tops.merge(*table, *map(torch.from_numpy, routed), 2)
    for w, t in zip(want, table[1:]):
        np.testing.assert_array_equal(t.numpy(), w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_merge_scan_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(17)
    keys, ev, cr, values, ids, q_ev, vals = _scan_case(rng, 8, 3000, 5, 6000, boundary=True)
    routed = tops.route_winners(8, ids, q_ev, vals)
    table = [torch.from_numpy(a) for a in (keys, ev, cr, values)]
    on_card = [t.to(cuda_device) for t in table]
    before = tops.counter.launches
    tops.merge(*on_card, *(torch.from_numpy(a).to(cuda_device) for a in routed), 2**31)
    torch.cuda.synchronize()
    assert tops.counter.launches == before + 1
    tops.merge(*table, *(torch.from_numpy(a) for a in routed), 2**31)
    for a, b in zip(on_card, table):
        assert torch.equal(a.cpu(), b)
    no_winners = (torch.zeros((8, 0), dtype=torch.int64, device=cuda_device),) * 2
    tops.merge(*on_card, *no_winners, torch.zeros((8, 0, 5), device=cuda_device), 2**31)
    assert tops.counter.launches == before + 1  # an empty batch launches nothing


def _on_card(arrays, device):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("p,c,d,g", [(5, 1001, 3, 2000), (2, 3001, 4, 20_000)])
def test_merge_scan_kernel_shared_and_global_hash_on_card(cuda_device, p, c, d, g):
    """Byte-identical to the plain version with the winners' hash in shared
    memory (Q = 512) and in the scratch (Q = 16,384), D odd and a multiple
    of 4 (the 16-byte row copy)."""
    rng = np.random.default_rng(p * c)
    keys, ev, cr, values, ids, q_ev, vals = _scan_case(rng, p, c, d, g, boundary=True)
    routed = tops.route_winners(p, ids, q_ev, vals)
    assert tops.hash_in_shared(routed[0].shape[1]) == (g == 2000)
    table = [torch.from_numpy(a.copy()) for a in (keys, ev, cr, values)]
    on_card = [t.to(cuda_device) for t in table]
    tops.merge(*on_card, *_on_card(routed, cuda_device), 2**31)
    torch.cuda.synchronize()
    tops.check_error()
    tops.merge(*table, *map(torch.from_numpy, routed), 2**31)
    for a, b in zip(on_card, table):
        assert torch.equal(a.cpu(), b)
    assert not torch.equal(table[1], torch.from_numpy(ev))  # the batch changed slots


@pytest.mark.gpu
def test_merge_scan_kernel_at_65536_partitions_on_card(cuda_device):
    p = 65_536
    case = _many_partitions(np.random.default_rng(4), p)
    want = _numpy_merge(*case, 2)
    table = _on_card(case[:4], cuda_device)
    before = tops.counter.launches
    tops.merge(*table, *_on_card(tops.route_winners(p, *case[4:]), cuda_device), 2)
    torch.cuda.synchronize()
    tops.check_error()
    assert tops.counter.launches == before + 1
    for w, t in zip(want, table[1:]):
        np.testing.assert_array_equal(t.cpu().numpy(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("p,g,q", [(4, 1200, 512), (2, 18_000, 16_384)])
def test_merge_scan_refused_batch_changes_nothing_on_card(cuda_device, p, g, q):
    """A duplicate key, a bad key, or both in one batch: the wrapper returns
    without raising, every tensor stays byte-identical, the CPU path's
    message raises at ``check_error`` after a synchronization (the bad key's
    where both), and the next good call succeeds."""
    rng = np.random.default_rng(q)
    keys, ev, cr, values, ids, q_ev, vals = _scan_case(rng, p, 700, 4, g, boundary=False)
    good = tops.route_winners(p, ids, q_ev + 5, vals)
    assert good[0].shape == (p, q)
    table = _on_card((keys, ev, cr, values), cuda_device)
    start = [t.clone() for t in table]
    live = np.flatnonzero(good[0][0] >= 0)
    for bad, msg in (("dup", tops.DUPLICATE_MESSAGE), ("neg", tops.BAD_KEY_MESSAGE),
                     ("both", tops.BAD_KEY_MESSAGE)):
        q_keys = good[0].copy()
        if bad in ("dup", "both"):
            q_keys[p - 1, 0] = q_keys[p - 1, 1] = 12345  # twice in the last partition
        if bad in ("neg", "both"):
            q_keys[0, live[0]] = -7
        tops.merge(*table, *_on_card((q_keys, *good[1:]), cuda_device), 9)  # no raise
        torch.cuda.synchronize()
        for a, b in zip(table, start):
            assert torch.equal(a, b), bad
        with pytest.raises(ValueError, match=re.escape(msg)):
            tops.check_error()
    tops.merge(*table, *_on_card(good, cuda_device), 9)
    torch.cuda.synchronize()
    tops.check_error()
    cpu = [t.cpu() for t in start]
    tops.merge(*cpu, *map(torch.from_numpy, good), 9)
    for a, b in zip(table, cpu):
        assert torch.equal(a.cpu(), b)
    assert not torch.equal(table[1], start[1])


@pytest.mark.gpu
def test_merge_does_not_synchronize_on_card(cuda_device):
    rng = np.random.default_rng(8)
    keys, ev, cr, values, ids, q_ev, vals = _scan_case(rng, 8, 3000, 5, 6000, boundary=True)
    table = _on_card((keys, ev, cr, values), cuda_device)
    routed = _on_card(tops.route_winners(8, ids, q_ev, vals), cuda_device)
    tops.merge(*table, *routed, 2**31)  # the first call builds and allocates
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tops.merge(*table, *routed, 2**31 + 1)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    tops.check_error()
