"""Port's OnlineStore against the JAX package's, engine by engine, on the same
seeded stream of merges, GETs and TTL sweeps.  Everything compared is integer
state or copied floats, so all of it must be byte-identical: ``dump_all``, the
``lookup_encoded`` triples, ``MergeStats``, the recycled slots after a sweep,
the table state through capacity growth, and the ``transfers`` ledger."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import online_store as jos  # noqa: E402
from repro.core.assets import (  # noqa: E402
    Entity as JEntity,
    Feature as JFeature,
    FeatureSetSpec as JSpec,
    MaterializationSettings as JMat,
)
from repro.core.dsl import UDFTransform as JUDF  # noqa: E402
from repro.core.table import Table as JTable  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import online_store as tos  # noqa: E402
from repro_torch.core.assets import (  # noqa: E402
    Entity,
    Feature,
    FeatureSetSpec,
    MaterializationSettings,
)
from repro_torch.core.dsl import UDFTransform  # noqa: E402
from repro_torch.core.table import Table  # noqa: E402

TTL = 500
D = 3


def _identity(df, ctx):
    return df


def _specs(ttl=TTL):
    kw = dict(name="fs", version=1, source_name="src")
    j = JSpec(
        entity=JEntity("cust", ("entity_id",)),
        features=tuple(JFeature(f"f{i}") for i in range(D)),
        transform=JUDF(_identity, name="id"),
        materialization=JMat(True, True, online_ttl=ttl), **kw,
    )
    t = FeatureSetSpec(
        entity=Entity("cust", ("entity_id",)),
        features=tuple(Feature(f"f{i}") for i in range(D)),
        transform=UDFTransform(_identity, name="id"),
        materialization=MaterializationSettings(True, True, online_ttl=ttl), **kw,
    )
    return j, t


def _frame(rng, n, id_hi, ev_lo, ev_hi):
    cols = {
        "entity_id": rng.integers(0, id_hi, n).astype(np.int64),
        "ts": rng.integers(ev_lo, ev_hi, n).astype(np.int64),
    }
    for i in range(D):
        cols[f"f{i}"] = rng.standard_normal(n).astype(np.float32)
    return cols


def _stores(engine, p=4, cap=8):
    j = jos.OnlineStore(num_partitions=p, initial_capacity=cap, interpret=True,
                        merge_engine=engine)
    t = tos.OnlineStore(num_partitions=p, initial_capacity=cap, device="cpu",
                        merge_engine=engine)
    return j, t


def _assert_stats(js, ts):
    for k in ("engine", "inserts", "overrides", "noops", "creation_ts"):
        assert js[k] == ts[k], k
    for k in ("touched_parts", "touched_slots", "touched_keys", "touched_event_ts",
              "touched_values"):
        assert js[k].dtype == ts[k].dtype, k
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def _assert_state(jstore, tstore, jspec):
    jd = jstore.dump_all(jspec.name, jspec.version)
    td = tstore.dump_all(jspec.name, jspec.version)
    assert sorted(jd.columns) == sorted(td.columns)
    for c in jd.columns:
        assert jd[c].dtype == td[c].dtype, c
        np.testing.assert_array_equal(td[c], jd[c], err_msg=c)
    jt = jstore._tables[jspec.key]
    state = convert._to_numpy(tstore, jspec.name, jspec.version)
    for k in convert.STATE_FIELDS:
        np.testing.assert_array_equal(state[k], getattr(jt, k), err_msg=k)
    assert state["free"] == [list(f) for f in jt.free]
    assert jstore.transfer_stats() == tstore.transfer_stats()


def _assert_gets(jstore, tstore, rng, now, id_hi, paths=(True, False)):
    ids = rng.integers(0, int(id_hi * 1.2), 97).astype(np.int64)
    for use_kernel in paths:
        jv = jstore.lookup_encoded("fs", 1, ids, now=now, use_kernel=use_kernel)
        tv = tstore.lookup_encoded("fs", 1, ids, now=now, use_kernel=use_kernel)
        for a, b in zip(jv, tv):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
    return jv


def _run_stream(jstore, tstore, jspec, tspec, rng, *, id_hi=160):
    """Merges with inserts, overrides, no-ops and creation_ts tie-breaks
    (event_ts drawn from a narrow range, creation_ts not monotone), GETs
    against TTL, and a sweep whose freed slots the next merges recycle."""
    creations = [1_000, 1_100, 1_050, 1_100, 1_400, 1_700]
    for step, cr in enumerate(creations):
        cols = _frame(rng, 60, id_hi, 0, 4)
        js = jstore.merge(jspec, JTable(dict(cols)), cr)
        ts = tstore.merge(tspec, Table(dict(cols)), cr)
        _assert_stats(js, ts)
        _assert_gets(jstore, tstore, rng, now=cr + 10 * step, id_hi=id_hi)
        if step == 3:
            # records created at 1_000..1_050 have expired by 1_560
            n = jstore.sweep("fs", 1, now=1_560)
            assert n > 0 and tstore.sweep("fs", 1, now=1_560) == n
    _, found, _ = _assert_gets(jstore, tstore, rng, now=2_000, id_hi=id_hi)
    assert found.any() and not found.all()
    _assert_state(jstore, tstore, jspec)


@pytest.mark.parametrize("engine", ["loop", "vector", "kernel"])
def test_engine_stream_matches_jax(engine):
    jspec, tspec = _specs()
    jstore, tstore = _stores(engine)
    _run_stream(jstore, tstore, jspec, tspec, np.random.default_rng(1))
    # 160 ids over 4 partitions outgrew 8 slots mid-stream
    assert tstore._tables[tspec.key].keys_full.shape[1] > 8
    assert tstore.inserts == jstore.inserts and tstore.noops == jstore.noops


def test_kernel_engine_ledger_counts_o_batch():
    """The kernel engine's steady-state merge+GET moves O(batch) bytes, and
    the same bytes as the JAX store, with native int64 device planes."""
    jspec, tspec = _specs(ttl=None)
    jstore, tstore = _stores("kernel", p=4, cap=4096)
    rng = np.random.default_rng(2)
    cols = _frame(rng, 200, 300, 0, 10)
    jstore.merge(jspec, JTable(dict(cols)), 10)
    tstore.merge(tspec, Table(dict(cols)), 10)
    jstore.reset_transfer_stats()
    tstore.reset_transfer_stats()
    for cr in (20, 30, 40):
        cols = _frame(rng, 50, 300, 0, 10)
        _assert_stats(jstore.merge(jspec, JTable(dict(cols)), cr),
                      tstore.merge(tspec, Table(dict(cols)), cr))
        _assert_gets(jstore, tstore, rng, now=None, id_hi=300, paths=(True,))
    st = tstore.transfer_stats()
    assert st == jstore.transfer_stats()
    assert st["device_uploads"] == 0 and st["host_syncs"] == 0
    table_bytes = tstore.device_state("fs", 1).nbytes()
    assert st["h2d_bytes"] + st["d2h_bytes"] < table_bytes


def test_device_truth_does_not_alias_host_mirror():
    """On the CPU ``.to("cpu")`` would hand back the same memory: a kernel
    merge must not write through to the host planes before a sync."""
    _, tspec = _specs(ttl=None)
    store = tos.OnlineStore(num_partitions=2, initial_capacity=16, device="cpu",
                            merge_engine="kernel")
    cols = {"entity_id": np.array([1, 2], np.int64), "ts": np.array([5, 5], np.int64),
            **{f"f{i}": np.ones(2, np.float32) for i in range(D)}}
    store.merge(tspec, Table(dict(cols)), 10)
    host_ev = store._tables[tspec.key].event_ts.copy()
    cols["ts"] = np.array([9, 9], np.int64)
    store.merge(tspec, Table(dict(cols)), 20)
    np.testing.assert_array_equal(store._tables[tspec.key].event_ts, host_ev)
    assert store.dump_all("fs", 1)["event_ts"].tolist() == [9, 9]


@pytest.mark.parametrize("engine", ["vector", "kernel"])
def test_convert_round_trip_continues_jax_state(engine):
    """A JAX store's state carried into the port through numpy continues
    byte-identically under further merges, GETs and sweeps."""
    jspec, tspec = _specs()
    jstore, tstore = _stores(engine)
    rng = np.random.default_rng(3)
    for cr in (900, 950):
        jstore.merge(jspec, JTable(_frame(rng, 60, 160, 0, 4)), cr)
    jstore.sweep("fs", 1, now=1_420)  # leaves free-list entries behind
    jstore.sync_host_mirrors()
    jt = jstore._tables[jspec.key]
    state = {k: getattr(jt, k) for k in convert.STATE_FIELDS}
    state["free"] = [list(f) for f in jt.free]
    convert.online_table_from_numpy(tstore, tspec, state)
    back = convert._to_numpy(tstore, "fs", 1)
    for k in convert.STATE_FIELDS:
        np.testing.assert_array_equal(back[k], state[k], err_msg=k)
    assert back["free"] == state["free"]
    jstore.reset_transfer_stats()
    _run_stream(jstore, tstore, jspec, tspec, rng)


def test_convert_rejects_mismatched_state():
    _, tspec = _specs()
    store = tos.OnlineStore(num_partitions=4, device="cpu")
    good = {
        "keys_full": np.full((4, 8), -1, np.int64), "event_ts": np.zeros((4, 8), np.int64),
        "creation_ts": np.zeros((4, 8), np.int64), "values": np.zeros((4, 8, D), np.float32),
        "fill": np.zeros(4, np.int64), "idx_keys": np.zeros(0, np.int64),
        "idx_part": np.zeros(0, np.int64), "idx_slot": np.zeros(0, np.int64),
        "free": [[], [], [], []],
    }
    convert.online_table_from_numpy(store, tspec, good)
    for key, bad in [("values", np.zeros((4, 8, D + 1), np.float32)),
                     ("fill", np.zeros(3, np.int64)), ("free", [[]])]:
        with pytest.raises(ValueError):
            convert.online_table_from_numpy(store, tspec, {**good, key: bad})
