"""The port's multi-home mesh (``repro_torch.core.multihome``) against the
JAX package's, on the scenarios of the JAX suite's ``tests/core/test_shards.py``:
shard routing swept over shard counts, concurrent writes at every home,
per-range failover, rejoin and rebalance, graceful leave, and cross-shard
reads.  Both meshes take the same seeded frames; every write's split, the
write log, failover and rebalance records, drain rounds, GET answers and
every region's online dump and offline history must be equal across the
packages, and each mesh must converge byte-identical across its regions.
The port's three stores satisfy its ``StoreFacade``."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core.keys as jkeys  # noqa: E402
import repro.core.multihome as jmh  # noqa: E402
import repro_torch.core.keys as tkeys  # noqa: E402
import repro_torch.core.multihome as tmh  # noqa: E402
from test_torch_replication import (  # noqa: E402
    BOTH,
    TORCH,
    assert_same,
    frame_columns,
    make_spec,
)

MH_REGIONS = ("r0", "r1", "r2")
MH = {"jax": jmh, "torch": tmh}
KEYS = {"jax": jkeys, "torch": tkeys}


def mh_topo(p):
    r = p.regions
    return r.GeoTopology(
        regions={n: r.Region(n) for n in MH_REGIONS},
        local_latency_ms=1.0, cross_region_latency_ms=60.0,
        link_latency_ms={("r0", "r1"): 20.0, ("r1", "r2"): 30.0, ("r0", "r2"): 90.0},
    )


def make_mh(p, engine="vector", **kw):
    kw.setdefault("regions", list(MH_REGIONS))
    mh = MH[p.name].MultiHomeGeoStore("mh", topology=mh_topo(p), online_partitions=4,
                                      merge_engine=engine, **p.kw, **kw)
    mh.create_feature_set(make_spec(p))
    mh.advance_clock(10**9)
    return mh


def write_everywhere(pair, rng, rows=400, base_ts=10**7):
    """One ingest wave: a distinct seeded frame enters at every home, the
    same frames in both packages."""
    infos = []
    for i, region in enumerate(pair[1].regions()):
        cols = frame_columns(rng, rows, 5_000, 10**6)
        got = [mh.write_batch("fs", 1, p.table.Table(dict(cols)), region=region,
                              creation_ts=base_ts + i) for p, mh in zip(BOTH, pair)]
        assert_same(got[0], got[1], f"write at {region}")
        infos.append(got[1])
    return infos


def mesh(mh):
    return {r: (mh.online[r].dump_all("fs", 1), mh.offline[r].canonical_history("fs", 1))
            for r in mh.regions()}


def assert_meshes(pair, ctx):
    """Each mesh byte-identical across its regions, and the two packages'
    meshes, shard maps and write logs equal."""
    jm, tm = pair
    assert jm.regions() == tm.regions(), ctx
    assert list(jm.shard_map.owners) == list(tm.shard_map.owners), ctx
    assert jm.write_log == tm.write_log, ctx
    assert_same(mesh(jm), mesh(tm), f"{ctx} across packages")
    dumps = mesh(tm)
    first = dumps[tm.regions()[0]]
    for r, planes in dumps.items():
        assert_same(first, planes, f"{ctx} region {r}")
    for r in tm.regions():
        assert_same(jm.lag(r), tm.lag(r), f"{ctx} lag {r}")


def converge_both(pair, ctx):
    rounds = [mh.converge() for mh in pair]
    assert rounds[0] == rounds[1], ctx
    assert pair[1].pending_batches() == 0
    assert_meshes(pair, ctx)


def pair_of(engine="vector", **kw):
    return tuple(make_mh(p, engine, **kw) for p in BOTH)


@pytest.mark.parametrize("num_shards", [1, 3, 16])
def test_shard_routing_sweep_matches_jax(num_shards):
    """Shard of every key, owners, ranges and the split of a batch by owner:
    equal across packages; every key lands in exactly one owned range."""
    rng = np.random.default_rng(num_shards)
    keys = np.concatenate([rng.integers(0, 1 << 62, 4000),
                           np.arange(512)]).astype(np.int64)  # small-id passthrough
    maps = [p.regions.ShardMap.even(list(MH_REGIONS), num_shards) for p in BOTH]
    got = [(m.shard_of(keys), list(m.owners), [m.shard_range(s) for s in range(num_shards)],
            m.split_by_owner(keys)) for m in maps]
    assert_same(got[0], got[1], "shard routing")
    shards, owners = got[1][0], got[1][1]
    coord = KEYS["torch"].shard_coordinate(keys)
    for s, (lo, hi) in enumerate(got[1][2]):
        mine = coord[shards == s].tolist()
        assert all(lo <= c < hi for c in mine), f"shard {s}"
    split = got[1][3]
    assert sorted(np.concatenate(list(split.values())).tolist()) == list(range(len(keys)))
    for region, idx in split.items():
        assert (np.array(owners)[shards[idx]] == region).all()
    assert_same(jkeys.shard_coordinate(keys), coord, "shard coordinate")


@pytest.mark.parametrize("engine,num_shards", [("vector", 3), ("vector", 16), ("kernel", 6)])
def test_concurrent_writes_converge_like_jax(engine, num_shards):
    pair = pair_of(engine, num_shards=num_shards)
    rng = np.random.default_rng(3)
    infos = write_everywhere(pair, rng)
    assert pair[1].pending_batches() == pair[0].pending_batches() > 0
    converge_both(pair, "steady state")
    for info, region in zip(infos, pair[1].regions()):
        assert sum(info["slices"].values()) == info["rows"]
        assert info["forwarded_rows"] == info["rows"] - info["slices"].get(region, 0)
    wl = pair[1].write_log
    assert wl["forwarded_rows"] == sum(i["forwarded_rows"] for i in infos)
    shipped = [sum(led.batches for rep in mh.replicators.values() for led in rep.shipped.values())
               for mh in pair]
    for mh in pair:
        mh.drain()
    assert shipped == [sum(led.batches for rep in mh.replicators.values()
                           for led in rep.shipped.values()) for mh in pair]  # echo-free
    ids = np.arange(300, dtype=np.int64)
    for consumer in MH_REGIONS:
        got = [mh.get_online_features("fs", 1, [ids], consumer_region=consumer) for mh in pair]
        assert_same(got[0], got[1], f"GET from {consumer}")
        assert {leg["region"] for leg in got[1][2]["per_range"].values()} == {consumer}


def test_per_range_failover_rejoin_and_rebalance_match_jax():
    pair = pair_of()
    rng = np.random.default_rng(8)
    write_everywhere(pair, rng)
    converge_both(pair, "before failure")
    write_everywhere(pair, rng, base_ts=10**7 + 10)  # an un-drained suffix
    lost = pair[1].shard_map.owned_shards("r2")
    for mh in pair:
        mh.mark_down("r2")
    infos = [mh.failover() for mh in pair]
    assert_same(infos[0], infos[1], "failover info")
    assert infos[1]["shards"] == lost and infos[1]["replayed_batches"] > 0
    assert "r2" not in pair[1].regions()
    converge_both(pair, "post-failover")
    write_everywhere(pair, rng, base_ts=10**7 + 20)
    converge_both(pair, "post-failover writes")
    for mh in pair:
        mh.mark_up("r2")
    back = [mh.rejoin("r2") for mh in pair]
    assert_same(back[0], back[1], "rejoin info")
    assert back[1]["online_rows"] > 0 and pair[1].shard_map.owned_shards("r2") == []
    converge_both(pair, "post-rejoin")
    moved = [mh.rebalance(lost[0], "r2") for mh in pair]
    assert_same(moved[0], moved[1], "rebalance")
    assert moved[1]["moved"] and pair[1].shard_map.owner_of(lost[0]) == "r2"
    write_everywhere(pair, rng, base_ts=10**7 + 30)
    converge_both(pair, "post-rebalance writes")
    assert (pair[1].monitor.system.counters["shards/rebalances"]
            == pair[0].monitor.system.counters["shards/rebalances"] == 1)


def test_graceful_leave_matches_jax():
    pair = pair_of()
    rng = np.random.default_rng(10)
    write_everywhere(pair, rng)
    converge_both(pair, "before leave")
    out = [mh.leave_region("r2") for mh in pair]
    assert_same(out[0], out[1], "leave")
    assert pair[1].regions() == ["r0", "r1"]
    write_everywhere(pair, rng, base_ts=10**7 + 40)
    converge_both(pair, "post-leave writes")


def test_port_stores_satisfy_the_facade():
    from repro_torch.core.facade import StoreFacade
    from repro_torch.core.featurestore import FeatureStore
    from repro_torch.core.replication import GeoFeatureStore

    fs = FeatureStore("plain", region="r0", topology=mh_topo(TORCH), device="cpu")
    geo = GeoFeatureStore("single-home", topology=mh_topo(TORCH), home_region="r0",
                          device="cpu")
    for store in (fs, geo, make_mh(TORCH)):
        assert isinstance(store, StoreFacade), type(store).__name__
    assert fs.lag("r1").batches == 0 and fs.drain() == {} and fs.failover() is None
    with pytest.raises(ValueError, match="no replica set"):
        fs.rejoin("r1")


def test_full_key_hash_keeps_rows_the_reference_drops():
    """The reference's offline full-key hash, ``mix(mix(id ^ (ev << 1)) ^ ev
    ^ cr)``, maps the distinct records (1, 9, 1000) and (11, 12, 1005) to one
    value: its offline store drops whichever arrives second as a duplicate,
    so a multi-home mesh that takes the two at different homes keeps a
    different record in different regions.  The port mixes each field in a
    round of its own: both records stay, in every region."""
    ids = np.array([1, 11], np.int64)
    ev = np.array([9, 12], np.int64)
    cr = np.array([1000, 1005], np.int64)
    j, t = jkeys.encode_full_keys(ids, ev, cr), tkeys.encode_full_keys(ids, ev, cr)
    assert j[0] == j[1] and t[0] != t[1]
    histories = {}
    for p in BOTH:
        mh = make_mh(p)
        owners = [mh.shard_map.owner_of(int(s)) for s in mh.shard_map.shard_of(ids)]
        assert owners[0] != owners[1]
        for i in range(2):
            cols = {"entity_id": ids[i:i + 1], "ts": ev[i:i + 1],
                    "f0": np.float32([i]), "f1": np.float32([i])}
            mh.write_batch("fs", 1, p.table.Table(cols), region=owners[i],
                           creation_ts=int(cr[i]))
        mh.converge()
        histories[p.name] = {r: mh.offline[r].canonical_history("fs", 1)
                             for r in mh.regions()}
    jax_keys = {r: tuple(h["__key__"]) for r, h in histories["jax"].items()}
    assert all(len(k) == 1 for k in jax_keys.values()) and len(set(jax_keys.values())) == 2
    for h in histories["torch"].values():
        assert_same(histories["torch"]["r0"], h, "port regions")
        assert h["__key__"].tolist() == [1, 11]
