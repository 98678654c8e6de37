"""The offline slice end to end: ``get_offline_features`` through the JAX
``FeatureStore`` and the port's ``FeatureStore(device="cpu")``, on one
offline history written into the JAX store and installed into the port's
through ``convert.py``.

The join does no arithmetic, so every output column (spine, feature values,
``__found__``) must be byte-identical.  Histories whose event_ts span more
than 2**31 ms take the JAX package's int64 oracle, which needs JAX's 64-bit
mode (``jax.enable_x64``) to see int64; the port takes its one int64 path."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import assets as jassets  # noqa: E402
from repro.core.dsl import UDFTransform as JUDF  # noqa: E402
from repro.core.featurestore import FeatureStore as JFeatureStore  # noqa: E402
from repro.core.table import Table as JTable  # noqa: E402
from repro.data.sources import SyntheticEventSource as JSource  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import assets as tassets  # noqa: E402
from repro_torch.core.dsl import UDFTransform as TUDF  # noqa: E402
from repro_torch.core.featurestore import FeatureStore  # noqa: E402
from repro_torch.core.offline_store import OfflineStore  # noqa: E402
from repro_torch.core.table import Table as TTable  # noqa: E402
from repro_torch.data.sources import SyntheticEventSource  # noqa: E402
from repro_torch.kernels.pit_join import ops as pit_ops  # noqa: E402

HOUR = 3_600_000
EPOCH_MS = 1_700_000_000_000
N_ENT = 200


def _spec(pkg, udf, name, delay):
    return pkg.FeatureSetSpec(
        name=name, version=1, entity=pkg.Entity("customer", ("entity_id",)),
        features=(pkg.Feature("amount"), pkg.Feature("quantity")), source_name="tx",
        transform=udf(lambda df, ctx: df, name="identity"), timestamp_col="ts",
        expected_delay=delay,
        materialization=pkg.MaterializationSettings(True, False),
    )


def _frames(rng, base, step, n_frames):
    """Event frames with repeated (entity, ts) pairs across frames, so
    re-materialized records tie on event_ts and differ in creation_ts."""
    prev = None
    for k in range(n_frames):
        n = 300
        ids = rng.integers(0, N_ENT, n).astype(np.int64)
        ts = base + k * step + rng.integers(0, step, n).astype(np.int64)
        if prev is not None:
            ids[:40], ts[:40] = prev
        prev = ids[40:80].copy(), ts[40:80].copy()
        yield k, {"entity_id": ids, "ts": ts,
                  "amount": rng.gamma(2.0, 50.0, n).astype(np.float32),
                  "quantity": rng.integers(1, 9, n).astype(np.float32)}


def _stores(base, step):
    """A JAX store with two feature sets written frame by frame, and a port
    store holding the same histories through ``convert``."""
    j = JFeatureStore("fs", interpret=True)
    t = FeatureStore("fs", device="cpu")
    j.register_source(JSource("tx"))
    t.register_source(SyntheticEventSource("tx"))
    for name, delay in (("recent", 0), ("delayed", step // 3)):
        jspec = j.create_feature_set(_spec(jassets, JUDF, name, delay))
        tspec = t.create_feature_set(_spec(tassets, TUDF, name, delay))
        rng = np.random.default_rng(len(name))
        for k, cols in _frames(rng, base, step, 6):
            j.write_batch(name, 1, JTable(cols), creation_ts=base + (k + 2) * step)
        convert.offline_history_from_numpy(
            t.offline, tspec, j.offline.read(name, 1).to_dict()
        )
    return j, t


@pytest.mark.parametrize("span", ["hours", "wide"])
def test_get_offline_features_matches_jax(span):
    base, step = (0, HOUR) if span == "hours" else (EPOCH_MS, 2**30)
    j, t = _stores(base, step)
    for name in ("recent", "delayed"):
        jr, tr = j.offline.read(name, 1), t.offline.read(name, 1)
        assert list(tr.columns) == list(jr.columns)
        for c in jr.columns:  # the installed history is the JAX one, row for row
            assert tr[c].dtype == jr[c].dtype
            np.testing.assert_array_equal(tr[c], jr[c], err_msg=c)
    rng = np.random.default_rng(1)
    spine = {"entity_id": rng.integers(0, N_ENT * 5 // 4, 500).astype(np.int64),
             "ts": base + rng.integers(-step, 8 * step, 500).astype(np.int64),
             "label": rng.random(500).astype(np.float32)}
    sets = [("recent", 1), ("delayed", 1)]
    for use_kernel in (True, False):
        with jax.enable_x64(span == "wide"):
            want = j.get_offline_features(JTable(dict(spine)), sets, use_kernel=use_kernel)
        before = pit_ops.counter.launches
        got = t.get_offline_features(TTable(dict(spine)), sets, use_kernel=use_kernel)
        assert pit_ops.counter.launches == before  # CPU tensors: the plain version
        assert list(got.columns) == list(want.columns)
        for c in want.columns:
            assert got[c].dtype == want[c].dtype, c
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)
        found = got["recent:v1:__found__"]
        assert found.any() and not found.all()
        # the delay hides records the undelayed join sees
        assert got["delayed:v1:__found__"].sum() < found.sum()


def test_offline_history_round_trip_and_dedup():
    j, t = _stores(0, HOUR)
    spec = t.registry.get_feature_set("recent", 1)
    cols = convert.offline_history_to_numpy(t.offline, "recent", 1)
    other = OfflineStore(num_shards=t.offline.num_shards)
    convert.offline_history_from_numpy(other, spec, cols)
    back = convert.offline_history_to_numpy(other, "recent", 1)
    assert list(back) == list(cols)
    for c in cols:
        np.testing.assert_array_equal(back[c], cols[c], err_msg=c)
    assert other.num_rows("recent", 1) == len(cols["__key__"])
    # the full-key index came across: re-merging a written frame is a no-op,
    # on the JAX store and on the installed copy alike
    _, frame = next(_frames(np.random.default_rng(len("recent")), 0, HOUR, 1))
    assert j.offline.merge(j.registry.get_feature_set("recent", 1), JTable(frame),
                           creation_ts=2 * HOUR) == 0
    assert other.merge(spec, TTable(frame), creation_ts=2 * HOUR) == 0
    assert other.merge(spec, TTable(frame), creation_ts=10 * HOUR) == len(frame["ts"])
    with pytest.raises(ValueError, match="record schema"):
        convert.offline_history_from_numpy(other, spec, {"__key__": cols["__key__"]})
    # a store with another shard count holds the same records in another order
    three = OfflineStore(num_shards=3)
    convert.offline_history_from_numpy(three, spec, cols)
    a, b = three.canonical_history("recent", 1), t.offline.canonical_history("recent", 1)
    for c in cols:
        np.testing.assert_array_equal(a[c], b[c], err_msg=c)


def test_offline_features_default_to_the_card(monkeypatch):
    from repro_torch.core.pit import get_offline_features

    store = OfflineStore()
    spec = _spec(tassets, TUDF, "recent", 0)
    store.register(spec)
    spine = TTable({"entity_id": np.arange(3), "ts": np.arange(3)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_offline_features(store, spine, [spec])
    out = get_offline_features(store, spine, [spec], device="cpu")
    assert not out["recent:v1:__found__"].any()
