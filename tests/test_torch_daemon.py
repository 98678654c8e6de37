"""The port's replica daemon (``python -m repro_torch.core.daemon``) over a
real localhost socket, on its own and against the JAX package's.

  * ROUND TRIP — a port publisher drains both planes into a port daemon
    (``--device cpu``); acks carry exactly the shipped seqs, the ledger
    accounts for them, and redelivering acked batches changes nothing;
  * ACROSS PACKAGES — a JAX publisher drains into a port daemon, and a port
    publisher into a JAX daemon; ``promote`` adopts the daemon's state, which
    must be byte-identical online and chunk-set-identical offline to the
    other package's in-process replica fed the same frames;
  * TEARDOWN — closing the handle leaves no child behind; a child asked for
    ``cuda`` where there is none fails before it serves anything.

Marked ``proc``.  Every wait has its own bound (the spawn's
``startup_timeout``, the channel's ack timeout, ``communicate(timeout=)``),
so a hang fails the test instead of stalling the run."""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core.daemon as jdaemon  # noqa: E402
import repro_torch.core.daemon as tdaemon  # noqa: E402
from repro.core import offline_store as joffline  # noqa: E402
from repro.core import online_store as jonline  # noqa: E402
from repro_torch.core import offline_store as toffline  # noqa: E402
from repro_torch.core import online_store as tonline  # noqa: E402
from repro_torch.core import wire as twire  # noqa: E402
from test_torch_replication import JAX, TORCH, assert_same  # noqa: E402

pytestmark = pytest.mark.proc

HOUR = 3_600_000
SRC = Path(__file__).resolve().parents[1] / "src"
STARTUP_S = 60.0
PKG = {
    "jax": SimpleNamespace(p=JAX, daemon=jdaemon, online=jonline, offline=joffline,
                           spawn_kw={}),
    "torch": SimpleNamespace(p=TORCH, daemon=tdaemon, online=tonline, offline=toffline,
                             spawn_kw={"device": "cpu"}),
}


def spec(p, name="geo", offline=True):
    a = p.assets
    return a.FeatureSetSpec(
        name=name, version=1, entity=a.Entity("cust", ("entity_id",)),
        features=(a.Feature("f0"), a.Feature("f1")), source_name="src",
        transform=p.dsl.UDFTransform(lambda df, ctx: df, name="id"),
        materialization=a.MaterializationSettings(True, offline),
    )


def frames(n_merges, rows=400, seed=0):
    rng = np.random.default_rng(seed)
    return [{"entity_id": rng.integers(0, 1000, rows).astype(np.int64),
             "ts": ((i + 1) * HOUR + rng.integers(0, HOUR, rows)).astype(np.int64),
             "f0": rng.random(rows).astype(np.float32),
             "f1": rng.random(rows).astype(np.float32)} for i in range(n_merges)]


def publisher(k, offline=True, **policy):
    """A home store pair of package ``k`` and its replicator."""
    q = PKG[k]
    home = q.online.OnlineStore(**q.p.kw)
    home_off = q.offline.OfflineStore() if offline else None
    topo = q.p.regions.GeoTopology(
        regions={r: q.p.regions.Region(r) for r in ("westus2", "eastus")})
    rep = q.p.rep.GeoReplicator(home, topology=topo, home_region="westus2",
                                home_offline=home_off, log=q.p.rep.ReplicationLog(1024),
                                policy=q.p.rep.DeliveryPolicy(**policy))
    return rep, home, home_off


def publish(k, home, home_off, fs, cols, base=0):
    table = PKG[k].p.table.Table
    for i, c in enumerate(cols):
        home.merge(fs, table(dict(c)), 10**8 + base + i)
        if home_off is not None:
            home_off.merge(fs, table(dict(c)), 10**8 + base + i)


def spawn(k, **kw):
    q = PKG[k]
    return q.daemon.spawn_replica_daemon(region="eastus", startup_timeout=STARTUP_S,
                                         **q.spawn_kw, **kw)


def channel(k, handle, **kw):
    return PKG[k].daemon.SocketChannel(handle.connect(timeout=10.0), src="westus2",
                                       dst="eastus", ack_timeout_ms=10_000.0, **kw)


def planes(online, offline, fs):
    return (online.dump_all(fs.name, fs.version),
            offline.canonical_history(fs.name, fs.version) if offline is not None else None)


def test_round_trip_and_redelivery_on_a_port_daemon():
    rep, home, home_off = publisher("torch")
    fs = spec(TORCH)
    with spawn("torch") as h:
        hello = h.control({"cmd": "hello"}, timeout=10.0)
        assert hello["ok"] and hello["device"] == "cpu" and hello["engine"] == "vector"
        ch = channel("torch", h)
        rep.add_remote_replica("eastus", ch, offline=True)
        publish("torch", home, home_off, fs, frames(4))
        redeliver = list(rep.log.pending("eastus"))
        out = rep.drain("eastus")
        assert out["eastus"]["applied_batches"] == 8  # 4 online + 4 offline
        assert rep.lag_batches("eastus") == 0
        st = rep.delivery["eastus"]
        assert st.status == "healthy" and st.timeouts == 0 and st.corrupt_frames == 0
        ledger = ch.ledger()
        assert ledger["batches_applied"] == 8 and ledger["nacks"] == 0
        assert ledger["rows_applied"] > 0
        for b in redeliver:  # at-least-once delivery, exactly-once effect
            ack = ch.transmit("westus2", "eastus", twire.encode_batch(b)).remote
            assert ack is not None and ack.ok and ack.seqs == (b.seq,)
        assert ch.ledger()["frames"] == ledger["frames"] + len(redeliver)
        rep.promote("eastus")
        got = planes(rep.stores["eastus"], rep.offline_stores["eastus"], fs)
        assert_same(planes(home, home_off, fs), got, "adopted daemon state")
        ch.close()


@pytest.mark.parametrize("pub,dmn", [("jax", "torch"), ("torch", "jax")])
def test_cross_package_publisher_and_daemon(pub, dmn):
    """``pub``'s publisher drains into ``dmn``'s daemon (online drained in
    a window of 4, an un-drained tail forced by ``promote``); the adopted
    state equals ``dmn``'s own in-process replica of the same frames."""
    cols = frames(6, seed=7)
    ref_rep, ref_home, ref_off = publisher(dmn)
    q = PKG[dmn]
    replica = q.online.OnlineStore(**q.p.kw)
    replica_off = q.offline.OfflineStore()
    ref_rep.add_replica("eastus", replica, replica_off)
    publish(dmn, ref_home, ref_off, spec(q.p), cols)
    ref_rep.drain("eastus")
    assert ref_rep.lag_batches("eastus") == 0
    want = planes(replica, replica_off, spec(q.p))

    rep, home, home_off = publisher(pub, inflight_window=4)
    fs = spec(PKG[pub].p)
    with spawn(dmn) as h:
        ch = channel(pub, h)
        rep.add_remote_replica("eastus", ch, offline=True)
        publish(pub, home, home_off, fs, cols[:4])
        rep.drain("eastus")
        assert rep.lag_batches("eastus") == 0
        publish(pub, home, home_off, fs, cols[4:], base=4)
        rep.promote("eastus")
        assert rep.home_region == "eastus" and "eastus" not in rep.remote
        got = planes(rep.stores["eastus"], rep.offline_stores["eastus"], fs)
        ch.close()
    assert_same(want, got, f"{pub} publisher -> {dmn} daemon")
    assert_same(planes(home, home_off, fs), got, "adopted == publisher's home")


def test_teardown_leaves_no_orphan_and_cuda_without_card_raises():
    h = spawn("torch", offline=False)
    pid = h.proc.pid
    h.close()
    assert h.proc.poll() is not None
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: a cuda child would start")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdaemon.spawn_replica_daemon(region="eastus", device="cuda")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.daemon", "--device", "cuda",
         "--idle-timeout", "5"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
    try:
        out, err = child.communicate(timeout=STARTUP_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode != 0 and "REPLICA_DAEMON_LISTENING" not in out
    assert "no CUDA device" in err
