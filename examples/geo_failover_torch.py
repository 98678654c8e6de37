"""Geo-distribution example on the PyTorch/CUDA port: cross-region access,
replication, fail-over, rejoin, and resumable materialization (paper
§3.1.2–3.1.3, §4.1.2; the counterpart of ``examples/geo_failover.py``).

    PYTHONPATH=src python examples/geo_failover_torch.py                # on the card
    PYTHONPATH=src python examples/geo_failover_torch.py --fast         # CI smoke sizes
    PYTHONPATH=src python examples/geo_failover_torch.py --device cpu   # on the host

Every store, DSL and replica (the daemon child too) runs on ``--device``
(default ``cuda``; with no card that raises).  A ``cuda`` daemon child opens
its own CUDA context and loads the kernel library its parent built.

Scenario:
  * a feature store homed in westus2, consumed from eastus + westeurope
  * CROSS_REGION_ACCESS (the paper's implemented mechanism): reads traverse
    the inter-region link — measured by the topology's latency model
  * GEO_REPLICATED (the road-map mechanism): add a replica, reads go local
  * a geo-fenced store refuses replication (compliance, §4.1.2)
  * region failure: fail-over promotes the replica; materialization resumes
    from persisted scheduler state without data loss (§3.1.2)
  * the full two-plane data plane (core/replication.py): online + offline
    stores replicate through one log, failover converges both planes, and
    the recovered ex-home REJOINS via delta bootstrap
  * a lossy WAN (core/channel.py): the same replication through a seeded
    FaultyChannel — the delivery state machine retries/backs off until
    both planes converge anyway, and its fault ledger + monitor counters
    (replication/retries/{replica}, replication/state/{replica}) show the
    price paid
  * a REAL process boundary (core/daemon.py): the replica lives in a child
    interpreter behind a localhost socket; frames ship pipelined with a
    bounded in-flight window, fail-over adopts the daemon's state through
    its dump stream, and the child is torn down cleanly
  * active-active multi-home (core/multihome.py): the keyspace is sharded
    into hash ranges, every region is the write home for its ranges, and
    fail-over promotes ONLY the lost range — then the recovered region
    rejoins empty and is handed a range back via rebalance
"""

import argparse

import numpy as np

from repro_torch.core.assets import Entity, Feature, FeatureSetSpec, MaterializationSettings
from repro_torch.core.channel import FaultPlan, FaultyChannel
from repro_torch.core.dsl import DslTransform, RollingAgg
from repro_torch.core.featurestore import FeatureStore
from repro_torch.core.regions import (
    ComplianceError,
    GeoTopology,
    Region,
    ReplicationPolicy,
)
from repro_torch.core.replication import DeliveryPolicy, GeoFeatureStore
from repro_torch.data.sources import SyntheticEventSource

HOUR = 3_600_000


def build_store(policy, *, geo_fenced_home=False, device="cuda"):
    topo = GeoTopology(
        regions={
            "westus2": Region("westus2", geo_fenced=geo_fenced_home),
            "eastus": Region("eastus"),
            "westeurope": Region("westeurope"),
        },
        local_latency_ms=1.0,
        cross_region_latency_ms=60.0,
    )
    fs = FeatureStore("geo-demo", region="westus2", topology=topo, replication=policy,
                      device=device)
    src = SyntheticEventSource("tx", num_entities=16, events_per_bucket=64)
    fs.register_source(src)
    fs.create_feature_set(
        FeatureSetSpec(
            name="activity",
            version=1,
            entity=Entity("customer", ("entity_id",)),
            features=(Feature("spend_2h", "float32"),),
            source_name="tx",
            transform=DslTransform(
                "entity_id", "ts", [RollingAgg("spend_2h", "amount", 2 * HOUR, "sum")],
                device=device,
            ),
            timestamp_col="ts",
            source_lookback=2 * HOUR,
            materialization=MaterializationSettings(
                offline_enabled=True, online_enabled=True, schedule_interval=HOUR
            ),
        )
    )
    return fs


def main(fast: bool = False, device: str = "cuda"):
    hours = 2 if fast else 4

    # -- cross-region access (paper's current mechanism) ------------------------
    fs = build_store(ReplicationPolicy.CROSS_REGION_ACCESS, device=device)
    fs.tick(now=hours * HOUR)
    for consumer in ("westus2", "eastus", "westeurope"):
        serving, ms = fs.geo.route_read(consumer)
        print(f"cross-region read from {consumer:11s} -> served by {serving} "
              f"({ms:.0f} ms)")

    # -- geo-replication (road-map mechanism) ------------------------------------
    fs2 = build_store(ReplicationPolicy.GEO_REPLICATED, device=device)
    fs2.tick(now=hours * HOUR)
    fs2.geo.add_replica("eastus")
    serving, ms = fs2.geo.route_read("eastus")
    print(f"\ngeo-replicated read from eastus -> served by {serving} ({ms:.0f} ms)")

    # -- compliance fencing ---------------------------------------------------------
    fenced = build_store(ReplicationPolicy.GEO_REPLICATED, geo_fenced_home=True,
                         device=device)
    try:
        fenced.geo.add_replica("eastus")
    except ComplianceError as e:
        print(f"\ncompliance fence works: {e}")

    # -- region failure + resumable materialization ----------------------------------
    print("\n--- region failure drill ---")
    state = fs2.scheduler_state()              # persisted control-plane state
    fs2.geo.mark_down("westus2")
    new_primary = fs2.geo.failover()
    print(f"westus2 down -> promoted {new_primary}")
    serving, ms = fs2.geo.route_read("westus2")
    print(f"reads from westus2 now served by {serving} ({ms:.0f} ms)")

    # the promoted region restores scheduler state and resumes the timeline:
    fs2.restore_scheduler(state)
    stats = fs2.tick(now=2 * hours * HOUR)
    print(f"resumed materialization at new primary: {stats}")
    intervals = fs2.scheduler.materialized_intervals("activity", 1)
    print(f"materialized timeline (no holes, no loss): {intervals}")
    rep = fs2.check_consistency("activity", 1)
    print(f"offline/online consistency after fail-over: {rep.consistent}")

    # -- the full two-plane data plane: replicate, fail over, REJOIN -------------
    print("\n--- two-plane replication drill (core/replication.py) ---")
    topo = GeoTopology(
        regions={r: Region(r) for r in ("westus2", "eastus", "westeurope")},
        local_latency_ms=1.0,
        cross_region_latency_ms=60.0,
        link_latency_ms={("westus2", "eastus"): 32.0},
    )
    g = GeoFeatureStore(
        "geo-data-plane",
        topology=topo,
        home_region="westus2",
        replica_regions=("eastus",),
        device=device,
    )
    g.register_source(SyntheticEventSource("tx", num_entities=16, events_per_bucket=32))
    g.create_feature_set(
        FeatureSetSpec(
            name="activity",
            version=1,
            entity=Entity("customer", ("entity_id",)),
            features=(Feature("spend_2h", "float32"),),
            source_name="tx",
            transform=DslTransform(
                "entity_id", "ts", [RollingAgg("spend_2h", "amount", 2 * HOUR, "sum")],
                device=device,
            ),
            timestamp_col="ts",
            source_lookback=2 * HOUR,
            materialization=MaterializationSettings(
                offline_enabled=True, online_enabled=True, schedule_interval=HOUR
            ),
        )
    )
    g.tick(now=hours * HOUR)
    lag = g.lag("eastus")
    print(f"replica lag after materialization: {lag.planes}")
    g.drain()
    ship = g.replicator.shipped["eastus"]
    print(
        f"wire transport: {ship.batches} batches coalesced into "
        f"{ship.frames} frames, {ship.raw_bytes} raw B -> "
        f"{ship.bytes} wire B "
        f"({ship.raw_bytes / max(ship.bytes, 1):.2f}x compression)"
    )
    ids = [np.arange(16, dtype=np.int64)]
    _, _, route = g.get_online_features("activity", 1, ids, consumer_region="eastus")
    print(f"read from eastus served by {route['region']} ({route['modeled_ms']} ms)")

    g.tick(now=(hours + 1) * HOUR)   # leave an un-drained suffix, then fail
    g.mark_down("westus2")
    info = g.failover()
    print(f"westus2 down -> promoted {info['promoted']} "
          f"(replayed {info['replayed_batches']} batches on both planes)")
    print(f"promoted offline history rows: {g.fs.offline.num_rows('activity', 1)}")

    g.mark_up("westus2")             # region recovers: its stores are gone...
    info = g.rejoin("westus2")       # ...so it rejoins via delta bootstrap
    print(f"ex-home rejoined: bootstrapped {info['online_rows']} online rows, "
          f"{info['offline_rows']} offline rows in {info['chunks']} chunks")
    g.tick(now=(hours + 2) * HOUR)
    g.drain()
    home_rows = g.fs.offline.num_rows("activity", 1)
    rejoined_rows = g.replicator.offline_stores["westus2"].num_rows("activity", 1)
    print(f"steady state: home offline rows={home_rows}, "
          f"rejoined replica rows={rejoined_rows} (identical={home_rows == rejoined_rows})")

    # -- lossy WAN: the delivery state machine earns its keep ---------------------
    print("\n--- lossy WAN drill (core/channel.py + delivery state machine) ---")
    topo2 = GeoTopology(
        regions={r: Region(r) for r in ("westus2", "eastus")},
        local_latency_ms=1.0,
        cross_region_latency_ms=60.0,
    )
    lossy = GeoFeatureStore(
        "geo-lossy-wan",
        topology=topo2,
        home_region="westus2",
        replica_regions=("eastus",),
        # every 4th frame dropped, plus duplication/corruption/lost acks —
        # all on a seeded schedule, so this walkthrough prints the same
        # ledger every run
        channel=FaultyChannel(
            FaultPlan(
                seed=8,
                drop_rate=0.25,
                dup_rate=0.10,
                corrupt_rate=0.10,
                ack_loss_rate=0.10,
            ),
            topo2,
        ),
        delivery_policy=DeliveryPolicy(
            suspect_after=2, dead_after=5, backoff_base=1, backoff_cap=2,
            probe_interval=1,
        ),
        device=device,
    )
    lossy.register_source(
        SyntheticEventSource("tx", num_entities=16, events_per_bucket=32)
    )
    lossy.create_feature_set(
        FeatureSetSpec(
            name="activity",
            version=1,
            entity=Entity("customer", ("entity_id",)),
            features=(Feature("spend_2h", "float32"),),
            source_name="tx",
            transform=DslTransform(
                "entity_id", "ts", [RollingAgg("spend_2h", "amount", 2 * HOUR, "sum")],
                device=device,
            ),
            timestamp_col="ts",
            source_lookback=2 * HOUR,
            materialization=MaterializationSettings(
                offline_enabled=True, online_enabled=True, schedule_interval=HOUR
            ),
        )
    )
    for h in range(1, (2 if fast else 4) + 1):
        lossy.tick(now=h * HOUR)
        lossy.drain()
    rounds = 0
    while lossy.lag("eastus").batches > 0:  # retry until the log drains dry
        rounds += 1
        assert rounds <= 100, "lossy WAN drill failed to converge"
        lossy.drain()
    st = lossy.replicator.delivery["eastus"]
    channel = lossy.replicator.channel
    print(
        f"channel injected: {channel.counts['dropped']} drops, "
        f"{channel.counts['duplicated']} dups, {channel.counts['corrupted']} "
        f"corruptions, {channel.counts['ack_lost']} lost acks over "
        f"{channel.counts['transmits']} transmits"
    )
    print(
        f"delivery ledger: state={st.status}, retried_batches={st.retries}, "
        f"timeouts={st.timeouts}, crc_rejected={st.corrupt_frames}, "
        f"redelivered={st.redelivered_batches}, transitions={st.transitions}"
    )
    mon = lossy.fs.monitor.system
    print(
        f"monitor: replication/retries/eastus="
        f"{mon.counters.get('replication/retries/eastus', 0):.0f}, "
        f"replication/timeout/eastus="
        f"{mon.counters.get('replication/timeout/eastus', 0):.0f}, "
        f"replication/state/eastus={mon.gauges.get('replication/state/eastus')}"
    )
    home_dump = lossy.fs.online.dump_all("activity", 1)
    rep_dump = lossy.replicator.stores["eastus"].dump_all("activity", 1)
    identical = all(
        np.array_equal(home_dump[n], rep_dump[n]) for n in home_dump.names
    )
    print(f"converged byte-identical through the lossy WAN: {identical}")

    # -- real process boundary: replica daemon over a localhost socket ------------
    print("\n--- socket transport drill (core/daemon.py) ---")
    from repro_torch.core.daemon import SocketChannel, spawn_replica_daemon
    from repro_torch.core.offline_store import OfflineStore
    from repro_torch.core.online_store import OnlineStore
    from repro_torch.core.replication import GeoReplicator, ReplicationLog
    from repro_torch.core.table import Table

    topo3 = GeoTopology(regions={r: Region(r) for r in ("westus2", "eastus")})
    home = OnlineStore(device=device)
    home_off = OfflineStore()
    repl = GeoReplicator(
        home,
        topology=topo3,
        home_region="westus2",
        home_offline=home_off,
        log=ReplicationLog(capacity=256),
        policy=DeliveryPolicy(inflight_window=8),
    )
    spec = FeatureSetSpec(
        name="activity",
        version=1,
        entity=Entity("customer", ("entity_id",)),
        features=(Feature("spend_2h", "float32"),),
        source_name="tx",
        transform=DslTransform(
            "entity_id", "ts", [RollingAgg("spend_2h", "amount", 2 * HOUR, "sum")],
            device=device,
        ),
        materialization=MaterializationSettings(
            offline_enabled=True, online_enabled=True
        ),
    )
    rng = np.random.default_rng(11)
    with spawn_replica_daemon(region="eastus", device=device) as handle:
        ch = SocketChannel(
            handle.connect(), src="westus2", dst="eastus", topology=topo3
        )
        repl.add_remote_replica("eastus", ch, offline=True)
        print(f"replica daemon pid={handle.proc.pid} on 127.0.0.1:{handle.port}")
        rows = 200 if fast else 2_000
        for i in range(hours):
            frame = Table({
                "entity_id": rng.integers(0, 16, rows).astype(np.int64),
                "ts": ((i + 1) * HOUR + rng.integers(0, HOUR, rows)).astype(
                    np.int64
                ),
                "spend_2h": rng.random(rows).astype(np.float32),
            })
            home.merge(spec, frame, 10**8 + i)
            home_off.merge(spec, frame, 10**8 + i)
        repl.drain("eastus")
        ledger = ch.ledger()
        print(
            f"daemon ledger: {ledger['frames']} frames -> "
            f"{ledger['batches_applied']} batches / "
            f"{ledger['rows_applied']} rows applied, nacks={ledger['nacks']}"
        )
        # one more merge left un-drained, then the home dies mid-stream:
        frame = Table({
            "entity_id": rng.integers(0, 16, rows).astype(np.int64),
            "ts": ((hours + 1) * HOUR + rng.integers(0, HOUR, rows)).astype(
                np.int64
            ),
            "spend_2h": rng.random(rows).astype(np.float32),
        })
        home.merge(spec, frame, 10**9)
        home_off.merge(spec, frame, 10**9)
        pre = home.dump_all("activity", 1)
        topo3.regions["westus2"].healthy = False
        promoted = repl.promote("eastus")
        post = repl.stores["eastus"].dump_all("activity", 1)
        same = all(np.array_equal(pre[n], post[n]) for n in pre.names)
        print(
            f"promoted eastus: replayed {promoted['replayed_batches']} batches, "
            f"adopted daemon state byte-identical={same}"
        )
    print(f"daemon torn down cleanly: exit={handle.proc.poll()}")

    # -- active-active multi-home: every region accepts writes --------------------
    print("\n--- active-active multi-home drill (core/multihome.py) ---")
    from repro_torch.core.multihome import MultiHomeGeoStore

    mh_regions = ("westus2", "eastus", "westeurope")
    topo4 = GeoTopology(
        regions={r: Region(r) for r in mh_regions},
        local_latency_ms=1.0,
        cross_region_latency_ms=60.0,
    )
    mh = MultiHomeGeoStore(
        "geo-multi-home",
        topology=topo4,
        regions=list(mh_regions),
        online_partitions=8,
        device=device,
    )
    mh.create_feature_set(spec)           # same schema as the socket drill
    mh.advance_clock(2 * 10**9)
    print(f"shard ownership: {dict(enumerate(mh.shard_map.owners))}")
    mh_rows = 300 if fast else 1_500
    rng = np.random.default_rng(23)
    for i, r in enumerate(mh_regions):    # concurrent ingest at ALL homes
        frame = Table({
            "entity_id": rng.integers(0, 4096, mh_rows).astype(np.int64),
            "ts": (10**8 + rng.integers(0, HOUR, mh_rows)).astype(np.int64),
            "spend_2h": rng.random(mh_rows).astype(np.float32),
        })
        info = mh.write_batch("activity", 1, frame, region=r, creation_ts=10**9 + i)
        print(
            f"write at {r:11s}: {info['rows']} rows split {info['slices']} "
            f"({info['forwarded_rows']} forwarded to their shard-homes)"
        )
    rounds = mh.converge()
    wl = mh.write_log
    print(
        f"converged in {rounds} round(s); forwarded fraction "
        f"{wl['forwarded_rows'] / wl['rows']:.2f} (~2/3 for 3 uniform ranges)"
    )
    ids4 = [rng.integers(0, 4096, 64).astype(np.int64)]
    _, _, route = mh.get_online_features(
        "activity", 1, ids4, consumer_region="eastus"
    )
    served = {sid: leg["region"] for sid, leg in route["per_range"].items()}
    print(f"read from eastus: per-range routing {served} "
          f"(worst leg {route['modeled_ms']:.0f} ms)")

    victim = mh_regions[2]                # per-shard fail-over: ONLY its range moves
    mh.write_batch("activity", 1, frame, region=mh_regions[0], creation_ts=10**9 + 9)
    mh.mark_down(victim)
    info = mh.failover(victim)
    print(
        f"{victim} down -> shards {info['shards']} promoted to {info['promoted']} "
        f"(replayed {info['replayed_batches']} un-acked batches)"
    )
    mh.converge()
    mh.mark_up(victim)
    back = mh.rejoin(victim)              # returns with ZERO owned shards...
    moved = mh.rebalance(info["shards"][0], victim)  # ...then takes one back
    print(
        f"{victim} rejoined ({back['online_rows']} online rows bootstrapped) "
        f"and re-owns shard {moved['shard']} "
        f"({moved['online_rows']} online rows topped up)"
    )
    mh.converge()
    dumps = [mh.online[r].dump_all("activity", 1) for r in mh.regions()]
    identical = all(
        np.array_equal(dumps[0][n], d[n]) for d in dumps[1:] for n in dumps[0].names
    )
    print(f"all {len(dumps)} cells byte-identical after the full drill: {identical}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="tiny CI-smoke workloads")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(fast=args.fast, device=args.device)
