"""The port's geo-replication (``repro_torch.core.replication``) against the
JAX package's on the same seeded inputs: a JAX ``GeoFeatureStore`` (Pallas in
interpret mode) and the port's (``device="cpu"``) are driven the same way and
compared after every step.

Frames go through ``write_batch``, so what ships is the frames' own values,
not a computation: replica dumps, offline histories, ``MergeStats``,
``LagStats``, ``ShipLedger`` bytes, delivery states and the monitor's
replication counters must be equal, byte for byte, under the ``vector`` and
``kernel`` merge engines.  The same holds through failover (the promoted
store and its offline join), rejoin, geo-fencing (``ComplianceError``) and a
full log (``ReplicationLogFull`` and its force-appends).

One case runs the DSL (a rolling sum, as the JAX suite's ``geo_store``
does): keys, timestamps and every integer are equal, and feature values are
held to ``ROLL_RTOL`` / ``ROLL_ATOL``, since the two packages add the
window in different orders (a float64 prefix rounded once in the port, a
float32 block prefix in JAX): several float32 ulps of sums of a few dozen
gamma(2, 50) amounts."""

import dataclasses
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core.assets as jassets  # noqa: E402
import repro.core.channel as jchannel  # noqa: E402
import repro.core.dsl as jdsl  # noqa: E402
import repro.core.regions as jregions  # noqa: E402
import repro.core.replication as jrep  # noqa: E402
import repro.core.table as jtable  # noqa: E402
import repro.data.sources as jsources  # noqa: E402
import repro_torch.core.assets as tassets  # noqa: E402
import repro_torch.core.channel as tchannel  # noqa: E402
import repro_torch.core.dsl as tdsl  # noqa: E402
import repro_torch.core.regions as tregions  # noqa: E402
import repro_torch.core.replication as trep  # noqa: E402
import repro_torch.core.table as ttable  # noqa: E402
import repro_torch.data.sources as tsources  # noqa: E402

HOUR = 3_600_000
# the DSL case's feature values: float32 rolling sums added in two orders
ROLL_RTOL, ROLL_ATOL = 1e-4, 1e-3

JAX = SimpleNamespace(name="jax", assets=jassets, channel=jchannel, dsl=jdsl, regions=jregions,
                      rep=jrep, table=jtable, sources=jsources, kw={"interpret": True})
TORCH = SimpleNamespace(name="torch", assets=tassets, channel=tchannel, dsl=tdsl,
                        regions=tregions, rep=trep, table=ttable, sources=tsources,
                        kw={"device": "cpu"})
BOTH = (JAX, TORCH)


# -- stores and frames, one constructor per package --------------------------------------------------


def make_spec(p, n_feats=2, name="fs"):
    a = p.assets
    return a.FeatureSetSpec(
        name=name, version=1, entity=a.Entity("cust", ("entity_id",)),
        features=tuple(a.Feature(f"f{i}") for i in range(n_feats)), source_name="src",
        transform=p.dsl.UDFTransform(lambda df, ctx: df, name="id"),
        materialization=a.MaterializationSettings(True, True),
    )


def frame_columns(rng, n, id_hi, ev_hi, n_feats=2):
    cols = {"entity_id": rng.integers(0, id_hi, n).astype(np.int64),
            "ts": rng.integers(0, ev_hi, n).astype(np.int64)}
    for i in range(n_feats):
        cols[f"f{i}"] = rng.random(n).astype(np.float32)
    return cols


def topo(p, fenced_home=False):
    r = p.regions
    return r.GeoTopology(
        regions={"home": r.Region("home", geo_fenced=fenced_home),
                 "near": r.Region("near"), "far": r.Region("far")},
        local_latency_ms=1.0, cross_region_latency_ms=60.0,
        link_latency_ms={("home", "near"): 30.0, ("home", "far"): 90.0},
    )


def write_store(p, engine="vector", **kw):
    """A GeoFeatureStore over home/near/far holding one UDF feature set."""
    kw.setdefault("topology", topo(p))
    kw.setdefault("home_region", "home")
    kw.setdefault("replica_regions", ("near", "far"))
    g = p.rep.GeoFeatureStore("geo", merge_engine=engine, online_partitions=4, **p.kw, **kw)
    g.register_source(p.sources.SyntheticEventSource("src"))
    g.create_feature_set(make_spec(p))
    return g


def dsl_store(p, **kw):
    """The JAX suite's ``geo_store``: a 2 h rolling sum over a synthetic
    source, materialized hourly into both planes."""
    kw.setdefault("topology", topo(p))
    kw.setdefault("home_region", "home")
    g = p.rep.GeoFeatureStore("geo", **p.kw, **kw)
    g.register_source(p.sources.SyntheticEventSource("tx", num_entities=40))
    a = p.assets
    g.create_feature_set(a.FeatureSetSpec(
        name="act", version=1, entity=a.Entity("customer", ("entity_id",)),
        features=(a.Feature("s2", "float32"),), source_name="tx",
        transform=p.dsl.DslTransform(
            "entity_id", "ts", [p.dsl.RollingAgg("s2", "amount", 2 * HOUR, "sum")], **p.kw),
        timestamp_col="ts", source_lookback=2 * HOUR,
        materialization=a.MaterializationSettings(
            offline_enabled=True, online_enabled=True, schedule_interval=HOUR),
    ))
    return g


# -- comparison across packages --------------------------------------------------


def plain(x):
    """A package-free form of a result: dataclasses and tables become dicts,
    tuples lists; arrays stay arrays."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if hasattr(x, "names") and hasattr(x, "columns"):  # a Table
        return {n: x[n] for n in x.names}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def assert_same(a, b, ctx="", float_tol=False):
    a, b = plain(a), plain(b)
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), f"{ctx}: keys {list(a)} vs {list(b)}"
        for k in a:
            assert_same(a[k], b[k], f"{ctx}.{k}", float_tol)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), ctx
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{ctx}[{i}]", float_tol)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, ctx
        if float_tol and a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=ROLL_RTOL, atol=ROLL_ATOL, err_msg=ctx)
        else:
            np.testing.assert_array_equal(b, a, err_msg=ctx)
    else:
        assert a == b, f"{ctx}: {a!r} vs {b!r}"


def planes(g, region, spec):
    """(online dump, canonical offline history) of one region's stores."""
    rep = g.replicator
    return (rep.stores[region].dump_all(spec.name, spec.version),
            rep.offline_stores[region].canonical_history(spec.name, spec.version))


def replication_counters(g):
    mon = g.fs.monitor.system
    return ({k: v for k, v in sorted(mon.counters.items()) if k.startswith("replication/")},
            {k: v for k, v in sorted(mon.gauges.items()) if k.startswith("replication/")})


def assert_geo_equal(gj, gt, spec, ctx, float_tol=False):
    """Every region's two planes, every replica's lag, ship ledger and
    delivery state, and the replication counters: equal across packages;
    each replica equal to its own home once drained."""
    rj, rt = gj.replicator, gt.replicator
    assert gj.home_region == gt.home_region and sorted(rj.stores) == sorted(rt.stores), ctx
    for region in sorted(rj.stores):
        assert_same(planes(gj, region, spec), planes(gt, region, spec), f"{ctx} {region}",
                    float_tol)
    for region in rj.replica_regions():
        assert_same(gj.lag(region), gt.lag(region), f"{ctx} lag {region}")
        assert_same(*(wire_sized(r.shipped[region], float_tol) for r in (rj, rt)),
                    f"{ctx} shipped {region}")
        assert_same(rj.delivery[region], rt.delivery[region], f"{ctx} delivery {region}")
    assert_same(*(wire_sized(replication_counters(g), float_tol) for g in (gj, gt)),
                f"{ctx} counters")


def wire_sized(x, float_tol):
    """With DSL values (``float_tol``), the compressed sizes and the modeled
    ms priced on them depend on the value bytes: drop them and keep the
    frame, batch, row and raw-byte counts, which do not."""
    x = plain(x)
    if not float_tol:
        return x
    if isinstance(x, dict):
        return {k: wire_sized(v, float_tol) for k, v in x.items()
                if k not in ("bytes", "ms") and "shipped_bytes" not in k}
    if isinstance(x, list):
        return [wire_sized(v, float_tol) for v in x]
    return x


def assert_replicas_match_home(g, spec, ctx):
    home = planes(g, g.home_region, spec)
    for region in g.replicator.replica_regions():
        if g.lag(region).batches == 0:
            assert_same(home, planes(g, region, spec), f"{ctx} {region} vs home")


def write_both(pair, rng, spec_name="fs", n=120, id_hi=60, ev_hi=10**6, cr=None):
    cols = frame_columns(rng, n, id_hi, ev_hi)
    out = [g.write_batch(spec_name, 1, p.table.Table(dict(cols)), creation_ts=cr)
           for p, g in zip(BOTH, pair)]
    assert_same(out[0], out[1], "write_batch stats")
    assert out[1]["online"]["inserts"] + out[1]["online"]["overrides"] > 0
    return out


def pair_of(build, *args, **kw):
    return tuple(build(p, *args, **kw) for p in BOTH)


# -- tests -----------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["vector", "kernel"])
def test_write_drain_read_match_jax(engine):
    """Seeded frames, drained one region at a time and then together:
    equal stats, lag, ledgers and replica planes at every step, and a
    geo-routed GET served by the consumer's own replica."""
    pair = pair_of(write_store, engine)
    spec = make_spec(TORCH)
    rng = np.random.default_rng(0)
    for i in range(4):
        write_both(pair, rng, cr=10_000 + i, ev_hi=50 * (i + 1))
        assert_geo_equal(*pair, spec, f"write {i}")
        assert pair[1].lag("near").batches > 0
        region = ("near", None)[i % 2]
        assert_same(pair[0].drain(region), pair[1].drain(region), f"drain {i}")
        assert_geo_equal(*pair, spec, f"drain {i}")
    for g in pair:
        g.drain()
        assert_replicas_match_home(g, spec, "drained")
    ids = [np.arange(70, dtype=np.int64)]
    for consumer in ("home", "near", "far"):
        got = [g.get_online_features("fs", 1, ids, consumer_region=consumer) for g in pair]
        assert_same(got[0], got[1], f"GET from {consumer}")
        assert got[1][2]["region"] == consumer and got[1][1].any() and not got[1][1].all()
    assert_geo_equal(*pair, spec, "final")


@pytest.mark.parametrize("engine", ["vector", "kernel"])
def test_failover_promote_and_rejoin_match_jax(engine):
    """An un-drained suffix, then the home is lost: the promoted store is
    byte-identical to the home's state before the failure in both
    packages, its offline join equals the join before the failure, and the
    recovered ex-home rejoins through the delta bootstrap."""
    pair = pair_of(write_store, engine)
    spec = make_spec(TORCH)
    rng = np.random.default_rng(1)
    for i in range(3):
        write_both(pair, rng, cr=10**7 + i)
        for g in pair:
            g.drain()
    for i in range(2):  # the suffix the replicas have not seen
        write_both(pair, rng, cr=10**7 + 10 + i)
    spine_cols = {"entity_id": rng.integers(0, 70, 300).astype(np.int64),
                  "ts": rng.integers(0, 10**6, 300).astype(np.int64)}
    before, joins = [], []
    for p, g in zip(BOTH, pair):
        before.append(planes(g, "home", spec))
        joins.append(g.get_offline_features(p.table.Table(dict(spine_cols)), [("fs", 1)]))
        g.mark_down("home")
    infos = [g.failover() for g in pair]
    assert_same(infos[0], infos[1], "failover info")
    assert infos[1]["promoted"] == "near" and infos[1]["replayed_batches"] > 0
    assert_same(before[0], before[1], "pre-failure home")
    for p, g, pre, join in zip(BOTH, pair, before, joins):
        assert g.home_region == "near" and g.fs.online is g.replicator.stores["near"]
        assert_same(pre, planes(g, "near", spec), f"{p.name} promoted == lost home")
        after = g.get_offline_features(p.table.Table(dict(spine_cols)), [("fs", 1)])
        assert_same(join, after, f"{p.name} offline join on the promoted plane")
    assert_geo_equal(*pair, spec, "after failover")
    write_both(pair, rng, cr=10**7 + 20)
    for g in pair:
        g.mark_up("home")
    infos = [g.rejoin("home") for g in pair]
    assert_same(infos[0], infos[1], "rejoin info")
    assert infos[1]["online_rows"] > 0 and infos[1]["offline_rows"] > 0
    for g in pair:
        g.drain()
        assert_replicas_match_home(g, spec, "rejoined")
    assert_geo_equal(*pair, spec, "after rejoin")


def test_geo_fencing_raises_compliance_error_in_both():
    errors = []
    for p in BOTH:
        g = p.rep.GeoFeatureStore("geo", topology=topo(p, fenced_home=True),
                                  home_region="home", **p.kw)
        with pytest.raises(p.regions.ComplianceError) as e:
            g.add_replica("near")
        errors.append(str(e.value))
        assert "near" not in g.replicator.stores
    assert errors[0] == errors[1]


def test_log_full_backpressure_matches_jax():
    """A raw log refuses the append past capacity with the same message; a
    store whose dead replica pins its log force-appends as often as JAX's
    and converges once the replica is back."""
    messages = []
    for p in BOTH:
        log = p.rep.ReplicationLog(capacity=2)
        log.register_replica("r")
        for i in range(2):
            log.append(("fs", 1), 1_000 + i, np.arange(3, dtype=np.int64),
                       np.arange(3, dtype=np.int64), np.zeros((3, 1), np.float32))
        with pytest.raises(p.rep.ReplicationLogFull) as e:
            log.append(("fs", 1), 1_002, np.arange(3, dtype=np.int64),
                       np.arange(3, dtype=np.int64), np.zeros((3, 1), np.float32))
        messages.append(str(e.value))
        assert len(log) == 2
    assert messages[0] == messages[1]

    pair = pair_of(write_store, "vector", log_capacity=2)
    spec = make_spec(TORCH)
    for g in pair:
        g.mark_down("far")
    rng = np.random.default_rng(2)
    for i in range(5):
        write_both(pair, rng, cr=10**7 + 30 + i)
    force = [g.fs.monitor.system.counters["replication/log_force_appends"] for g in pair]
    assert force[0] == force[1] > 0 and len(pair[0].log) == len(pair[1].log) > 2
    assert_geo_equal(*pair, spec, "pinned log")
    for g in pair:
        g.mark_up("far")
        g.drain()
        assert_replicas_match_home(g, spec, "recovered")
        assert len(g.log) <= 2
    assert_geo_equal(*pair, spec, "recovered")


def test_dsl_driven_geo_store_matches_jax_within_tolerance():
    """Hourly DSL jobs, a late replica's bootstrap, a failover with an
    un-drained suffix and a rejoin: integers equal, values within the DSL's
    tolerance; each package's replicas byte-identical to its own home."""
    pair = pair_of(dsl_store, replica_regions=("near",))
    spec = pair[1].registry.get_feature_set("act", 1)
    for g in pair:
        g.tick(now=3 * HOUR)
        g.add_replica("far", chunk_rows=16)
    assert_same(pair[0].last_bootstrap, pair[1].last_bootstrap, "bootstrap")
    assert pair[1].last_bootstrap["chunks"] > 2
    for g in pair:
        g.drain()
        assert_replicas_match_home(g, spec, "bootstrapped")
        g.tick(now=5 * HOUR)
    assert_geo_equal(*pair, spec, "dsl ticks", float_tol=True)
    for g in pair:
        g.mark_down("home")
    infos = [g.failover() for g in pair]
    assert_same(infos[0], infos[1], "dsl failover")
    ids = [np.arange(40, dtype=np.int64)]
    got = [g.get_online_features("act", 1, ids, consumer_region="far") for g in pair]
    assert_same(got[0], got[1], "dsl GET", float_tol=True)
    for g in pair:
        g.tick(now=6 * HOUR)
        g.mark_up("home")
        g.rejoin("home")
        g.drain()
        assert_replicas_match_home(g, spec, "dsl rejoined")
    assert_geo_equal(*pair, spec, "dsl rejoined", float_tol=True)
