"""The seeded chaos matrix of the JAX suite (``tests/core/test_chaos.py``)
run through both packages side by side.

The fault schedule is a pure function of the plan's seed, and the delivery
state machine counts logical drain ticks, not time.  So for the same seed
the port must inject exactly the faults JAX injects and react exactly as
JAX does: the channel's fault counts, every replica's ``DeliveryState``
(retries, timeouts, corrupt frames, redeliveries, transitions) and the
drain rounds to convergence are equal, integer for integer.  The workload
is the JAX suite's DSL store, so states are compared as in
``tests/test_torch_replication.py``: keys, timestamps and counts equal,
feature values within ``ROLL_RTOL`` / ``ROLL_ATOL``; and each package's
replicas converge byte-identical to its own home."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from test_torch_replication import (  # noqa: E402
    BOTH,
    HOUR,
    assert_geo_equal,
    assert_replicas_match_home,
    assert_same,
    dsl_store,
    topo,
)

FAST = dict(suspect_after=2, dead_after=4, backoff_base=1, backoff_cap=2, probe_interval=1)


def chaos_store(p, plan, policy=FAST, replicas=("near", "far")):
    t = topo(p)
    channel = p.channel.FaultyChannel(p.channel.FaultPlan(**plan), t)
    g = dsl_store(p, topology=t, channel=channel,
                  delivery_policy=p.rep.DeliveryPolicy(**policy), replica_regions=replicas)
    return g, channel, t


def converge(g, rounds=300):
    rep = g.replicator
    for n in range(rounds):
        g.drain()
        if all(rep.log.pending_count(r) == 0 for r in rep.replica_regions()) and not g.evicted:
            return n + 1
    pytest.fail(f"replicas did not converge within {rounds} drain rounds")


def run_both(plan, *, ticks=8, policy=FAST):
    """Drive both packages through ``ticks`` hourly jobs, each followed by a
    drain, then drain to convergence; return their stores and channels."""
    out = []
    for p in BOTH:
        g, channel, _ = chaos_store(p, plan, policy)
        for i in range(1, ticks + 1):
            g.tick(i * HOUR)
            g.drain()
        out.append((g, channel, converge(g)))
    (gj, cj, nj), (gt, ct, nt) = out
    assert nt == nj, "drain rounds to convergence"
    assert dict(ct.counts) == dict(cj.counts) and ct.events == cj.events
    spec = gt.registry.get_feature_set("act", 1)
    assert_geo_equal(gj, gt, spec, f"chaos {plan}", float_tol=True)
    for g in (gj, gt):
        assert_replicas_match_home(g, spec, f"chaos {plan}")
    return gj, gt, ct


@pytest.mark.parametrize("seed", [101, 202, 303])
@pytest.mark.parametrize("kind,counter", [("drop_rate", "dropped"), ("dup_rate", "duplicated"),
                                          ("reorder_rate", "reordered"),
                                          ("corrupt_rate", "corrupted")])
def test_chaos_matrix_matches_jax(seed, kind, counter):
    """Each fault kind alone at 25% for three seeds: the same faults, the
    same reaction, convergence in the same number of rounds."""
    _, gt, channel = run_both({"seed": seed, kind: 0.25})
    assert channel.counts[counter] > 0, "the schedule never injected the fault"


def test_mixed_faults_match_jax():
    plan = dict(seed=777, drop_rate=0.10, dup_rate=0.05, reorder_rate=0.05,
                corrupt_rate=0.05, ack_loss_rate=0.05, spike_rate=0.03)
    _, gt, _ = run_both(plan)
    totals = {k: sum(getattr(st, k) for st in gt.replicator.delivery.values())
              for k in ("retries", "timeouts", "corrupt_frames", "redelivered_batches")}
    assert all(v > 0 for v in totals.values()), totals


def test_partition_detection_and_eviction_match_jax():
    """A partition walks ``near`` HEALTHY -> SUSPECT -> DEAD with the same
    transitions on the same ticks; a longer one evicts it, and the
    auto-rejoin's bootstrap converges it, in both packages alike."""
    runs = []
    for p in BOTH:
        g, _, t = chaos_store(p, {"seed": 1, "partitions": (("near", 0, 8),)})
        g.tick(HOUR)
        for _ in range(30):
            g.drain()
            if g.replicator.delivery["near"].status == "dead":
                break
        assert t.regions["near"].healthy is False and g.route_read("near")[0] != "near"
        dead = list(g.replicator.delivery["near"].transitions)
        g.tick(2 * HOUR)
        rounds = converge(g)
        assert g.replicator.delivery["near"].status == "healthy"

        policy = dict(suspect_after=1, dead_after=2, backoff_base=1, backoff_cap=1,
                      probe_interval=1, evict_after=5)
        e, _, _ = chaos_store(p, {"seed": 2, "partitions": (("near", 0, 9),)}, policy)
        e.tick(HOUR)
        for _ in range(10):
            e.drain()
            if "near" in e.evicted:
                break
        assert "near" in e.evicted and "near" not in e.replicator.stores
        e.tick(2 * HOUR)
        erounds = converge(e)
        assert "near" in e.replicator.stores and e.last_bootstrap["chunks"] > 0
        runs.append((g, e, dead, rounds, erounds))
    (gj, ej, dj, rj, erj), (gt, et, dt, rt, ert) = runs
    assert [(a, b) for _, a, b in dt] == [("healthy", "suspect"), ("suspect", "dead")]
    assert (dt, rt, ert) == (dj, rj, erj)
    assert_same(ej.last_bootstrap, et.last_bootstrap, "eviction rejoin bootstrap")
    for a, b in ((gj, gt), (ej, et)):
        spec = b.registry.get_feature_set("act", 1)
        assert_geo_equal(a, b, spec, "partition", float_tol=True)
        assert_replicas_match_home(b, spec, "partition")


def test_fault_schedule_identical():
    """The plan's draws, its byte corruption and a channel's counts over
    probes are the same functions of the seed in both packages."""
    from repro.core import wire as jwire
    from repro_torch.core import wire as twire

    data = bytes(range(64))
    for seed in (7, 8, 101, 777):
        plans = [p.channel.FaultPlan(seed=seed, drop_rate=0.3, dup_rate=0.2,
                                     reorder_rate=0.1, corrupt_rate=0.1, ack_loss_rate=0.05,
                                     spike_rate=0.05, partitions=(("r", 3, 9),))
                 for p in BOTH]
        for dst in ("r", "near"):
            assert ([plans[1].decide(dst, e) for e in range(200)]
                    == [plans[0].decide(dst, e) for e in range(200)])
            assert ([plans[1].corrupt(dst, e, data) for e in range(32)]
                    == [plans[0].corrupt(dst, e, data) for e in range(32)])
    x = np.random.default_rng(0).integers(0, 2**63, 64)
    assert [BOTH[1].channel.mix64(int(v)) for v in x] == [BOTH[0].channel.mix64(int(v))
                                                           for v in x]
    counts = []
    for p, w in zip(BOTH, (jwire, twire)):
        ch = p.channel.FaultyChannel(p.channel.FaultPlan(seed=3, drop_rate=0.5), topo(p))
        got = [ch.transmit("home", "near", w.encode_probe()) for _ in range(60)]
        counts.append((dict(ch.counts), [(d.arrivals, d.ack_lost, d.faults) for d in got]))
    assert counts[1] == counts[0]


def test_promotion_replay_through_a_dead_link_raises_in_both():
    """A promotion whose replay cannot cross the link raises the package's
    ``DeliveryError`` instead of promoting a replica that lost batches."""
    messages = []
    for p in BOTH:
        g, _, _ = chaos_store(p, {"seed": 5, "partitions": (("near", 4, 10**6),)},
                              replicas=("near",))
        for i in (1, 2):
            g.tick(i * HOUR)
            g.drain()
        g.tick(3 * HOUR)
        g.mark_down("home")
        with pytest.raises(p.channel.DeliveryError, match="promotion replay") as e:
            g.failover()
        messages.append(str(e.value))
    assert messages[1] == messages[0]
