"""The slice end to end: one seeded SyntheticEventSource + DslTransform
workload through the JAX FeatureStore (Pallas in interpret mode, kernel
merge engine) and the port's (CPU, kernel merge engine).

Keys, timestamps, ``found`` flags, consistency reports, serving counters and
the transfer-ledger gauges are integers and must be equal.  Feature values
come out of the rolling sums, which the two packages add in different orders
(float64 then one rounding in the port, a float32 block prefix in JAX): they
are held to 1e-4 relative, several float32 ulps of sums of a few hundred
gamma(2, 50) amounts."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import assets as jassets  # noqa: E402
from repro.core import dsl as jdsl  # noqa: E402
from repro.core.featurestore import FeatureStore as JFeatureStore  # noqa: E402
from repro.core.serving import ServingConfig as JServingConfig  # noqa: E402
from repro.data.sources import SyntheticEventSource as JSource  # noqa: E402
from repro_torch.core import assets as tassets  # noqa: E402
from repro_torch.core import dsl as tdsl  # noqa: E402
from repro_torch.core.featurestore import FeatureStore  # noqa: E402
from repro_torch.core.serving import ServingConfig  # noqa: E402
from repro_torch.data.sources import SyntheticEventSource  # noqa: E402

HOUR = 3_600_000
N_ENT = 300
RTOL = 1e-4

AGGS = [
    ("amt_sum_2h", "amount", 2 * HOUR, "sum"),
    ("amt_mean_2h", "amount", 2 * HOUR, "mean"),
    ("qty_sum_5h", "quantity", 5 * HOUR, "sum"),
    ("cnt_5h", "amount", 5 * HOUR, "count"),
    ("amt_max_5h", "amount", 5 * HOUR, "max"),
]
COUNTERS = ("requests", "keys", "cache_hits", "cache_misses", "cache_fastpath",
            "dispatches", "coalesced_keys", "unique_keys", "store_keys",
            "cache_size", "cache_evictions", "cache_invalidations", "shed")


def _build(pkg, src_cls, dsl, store_cls, serving, **store_kw):
    fs = store_cls("fs", merge_engine="kernel", online_partitions=8,
                   serving=serving, **store_kw)
    fs.register_source(src_cls("tx", seed=3, num_entities=N_ENT, events_per_bucket=400))
    transform = dsl.DslTransform(
        "entity_id", "ts", [dsl.RollingAgg(*a) for a in AGGS],
        **({"device": "cpu"} if dsl is tdsl else {"interpret": True}),
    )
    fs.create_feature_set(pkg.FeatureSetSpec(
        name="act", version=1, entity=pkg.Entity("customer", ("entity_id",)),
        features=tuple(pkg.Feature(a[0]) for a in AGGS), source_name="tx",
        transform=transform, timestamp_col="ts", source_lookback=5 * HOUR,
        materialization=pkg.MaterializationSettings(
            True, True, schedule_interval=HOUR, online_ttl=3 * HOUR),
    ))
    return fs


@pytest.fixture(scope="module")
def stores():
    j = _build(jassets, JSource, jdsl, JFeatureStore,
               JServingConfig(cache_capacity=64, max_batch_keys=256), interpret=True)
    t = _build(tassets, SyntheticEventSource, tdsl, FeatureStore,
               ServingConfig(cache_capacity=64, max_batch_keys=256), device="cpu")
    for now in (4 * HOUR, 7 * HOUR):
        assert j.tick(now=now) == t.tick(now=now)
    return j, t


def test_materialized_state_matches(stores):
    j, t = stores
    jd, td = j.online.dump_all("act", 1), t.online.dump_all("act", 1)
    assert len(td) > 0.5 * N_ENT
    for c in ("__key__", "event_ts", "creation_ts"):
        np.testing.assert_array_equal(td[c], jd[c], err_msg=c)
    for name, _, _, agg in AGGS:
        if agg in ("count", "max"):
            np.testing.assert_array_equal(td[name], jd[name], err_msg=name)
        else:
            np.testing.assert_allclose(td[name], jd[name], rtol=RTOL, err_msg=name)
    jr, tr = j.check_consistency("act", 1), t.check_consistency("act", 1)
    assert tr.consistent and tr.summary() == jr.summary()
    assert t.offline.num_rows("act", 1) == j.offline.num_rows("act", 1)


def test_get_online_features_both_engines(stores):
    j, t = stores
    rng = np.random.default_rng(0)
    for step in range(4):
        ids = rng.integers(0, int(N_ENT * 1.3), 90).astype(np.int64)
        ids[:30] = ids[30:60]  # repeats: the cache serves them
        for use_kernel in (True, False):
            jv, jf = j.get_online_features("act", 1, [ids], use_kernel=use_kernel)
            tv, tf = t.get_online_features("act", 1, [ids], use_kernel=use_kernel)
            np.testing.assert_array_equal(tf, jf)
            np.testing.assert_allclose(tv, jv, rtol=RTOL)
            assert tf.any() and not tf.all()
        if step == 1:  # TTL: 3 h after 7 h, the rows created at 4 h expire
            j.advance_clock(7 * HOUR + 30 * 60_000)
            t.advance_clock(7 * HOUR + 30 * 60_000)
    js, ts = j.serving.stats(), t.serving.stats()
    assert ts["cache_hits"] > 0
    for k in COUNTERS:
        assert ts[k] == js[k], k


def test_monitor_gauges_match(stores):
    j, t = stores
    j.tick(now=8 * HOUR)
    t.tick(now=8 * HOUR)
    jg = {k: v for k, v in j.monitor.system.gauges.items() if k.startswith("online_store/")}
    tg = {k: v for k, v in t.monitor.system.gauges.items() if k.startswith("online_store/")}
    assert tg and tg == jg
    assert tg["online_store/h2d_bytes"] > 0


def test_dsl_matches_jax_on_one_window():
    src = SyntheticEventSource("tx", seed=5, num_entities=50, events_per_bucket=300)
    df = src.read(0, 6 * HOUR)
    jsrc = JSource("tx", seed=5, num_entities=50, events_per_bucket=300)
    jt = jdsl.DslTransform("entity_id", "ts", [jdsl.RollingAgg(*a) for a in AGGS],
                           interpret=True)
    tt = tdsl.DslTransform("entity_id", "ts", [tdsl.RollingAgg(*a) for a in AGGS],
                           device="cpu")
    assert tt.code_fingerprint() == jt.code_fingerprint()
    jo, to = jt(jsrc.read(0, 6 * HOUR), {}), tt(df, {})
    assert list(to.columns) == list(jo.columns)
    for c in to.columns:
        if c.startswith(("amt_sum", "amt_mean", "qty_sum")):
            np.testing.assert_allclose(to[c], jo[c], rtol=RTOL, err_msg=c)
        else:
            np.testing.assert_array_equal(to[c], jo[c], err_msg=c)
