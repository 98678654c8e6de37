"""Multi-process transport smoke on the PyTorch/CUDA port: the CI gate for
the socket carrier (the counterpart of ``scripts/transport_smoke.py``).

    python scripts/transport_smoke_torch.py                 # on the card
    python scripts/transport_smoke_torch.py --device cpu    # on the host

Spawns a REAL replica daemon (``python -m repro_torch.core.daemon``, its own
interpreter, stores and, on ``cuda``, its own CUDA context, loading the
kernel library this process built), replicates a seeded two-plane
workload from an in-process home region to it over a localhost socket with the pipelined
in-flight window, then runs the failover drill: mark the home region
down, ``promote`` the remote replica — which force-drains the un-acked
tail and adopts the daemon's state through its dump stream — and verify
the adopted stores byte-identical (online) / chunk-set-identical
(offline) against the pre-failure home.

Hardened the way a CI gate must be:

  * HARD WALL CLOCK — the whole drill runs under a SIGALRM deadline
    (default 120 s, ``--timeout`` to change); a hang exits 124 instead of
    eating the job's timeout budget;
  * GUARANTEED TEARDOWN — the daemon handle is closed in a ``finally``
    (shutdown control -> terminate -> kill, and atexit as the last net),
    and the drill ASSERTS the child is gone afterwards: an orphaned
    daemon fails the step even when everything else passed;
  * LEDGER LOG — the daemon's shipped-frame ledger and the publisher's
    delivery counters are printed on success AND on the failure path, so
    a red run shows what crossed the wire.

Both stores run on ``--device`` (default ``cuda``; with no card that
raises).

Exit codes: 0 success, 1 drill assertion failed, 124 wall-clock timeout.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.assets import (  # noqa: E402
    Entity,
    Feature,
    FeatureSetSpec,
    MaterializationSettings,
)
from repro_torch.core.daemon import SocketChannel, spawn_replica_daemon  # noqa: E402
from repro_torch.core.dsl import UDFTransform  # noqa: E402
from repro_torch.core.offline_store import OfflineStore  # noqa: E402
from repro_torch.core.online_store import OnlineStore  # noqa: E402
from repro_torch.core.regions import GeoTopology, Region  # noqa: E402
from repro_torch.core.replication import (  # noqa: E402
    DeliveryPolicy,
    GeoReplicator,
    ReplicationLog,
)
from repro_torch.core.table import Table  # noqa: E402

HOUR = 3_600_000


def _spec() -> FeatureSetSpec:
    return FeatureSetSpec(
        name="smoke",
        version=1,
        entity=Entity("cust", ("entity_id",)),
        features=(Feature("f0"), Feature("f1")),
        source_name="src",
        transform=UDFTransform(lambda df, ctx: df, name="id"),
        materialization=MaterializationSettings(True, True),
    )


def _frame(rng, n: int, entities: int, t0: int) -> Table:
    return Table(
        {
            "entity_id": rng.integers(0, entities, n).astype(np.int64),
            "ts": (t0 + rng.integers(0, HOUR, n)).astype(np.int64),
            "f0": rng.random(n).astype(np.float32),
            "f1": rng.random(n).astype(np.float32),
        }
    )


def drill(merges: int, rows: int, device: str, evidence: dict) -> dict:
    """Replicate -> failover over a real socket; fills and returns
    ``evidence``, which holds what was gathered when an assertion fails."""
    spec = _spec()
    topo = GeoTopology(regions={r: Region(r) for r in ("westus2", "eastus")})
    home = OnlineStore(device=device)
    home_off = OfflineStore()
    repl = GeoReplicator(
        home,
        topology=topo,
        home_region="westus2",
        home_offline=home_off,
        log=ReplicationLog(capacity=8 * merges + 16),
        policy=DeliveryPolicy(inflight_window=8),
    )
    rng = np.random.default_rng(42)
    handle = spawn_replica_daemon(region="eastus", device=device)
    child_pid = handle.proc.pid
    evidence["child_pid"] = child_pid
    ch = None
    try:
        ch = SocketChannel(
            handle.connect(), src="westus2", dst="eastus", topology=topo
        )
        repl.add_remote_replica("eastus", ch, offline=True)

        # -- replicate ------------------------------------------------------
        for i in range(merges):
            f = _frame(rng, rows, 5_000, (i + 1) * HOUR)
            home.merge(spec, f, 10**8 + i)
            home_off.merge(spec, f, 10**8 + i)
        t0 = time.perf_counter()
        repl.drain("eastus")
        evidence["drain_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        assert repl.lag_batches("eastus") == 0, "drain left batches pending"
        evidence["delivery"] = {
            "status": repl.delivery["eastus"].status,
            "timeouts": repl.delivery["eastus"].timeouts,
            "retries": repl.delivery["eastus"].retries,
        }

        # -- failover: un-acked tail + promote over the socket --------------
        for i in range(2):
            f = _frame(rng, rows, 5_000, (merges + i + 1) * HOUR)
            home.merge(spec, f, 2 * 10**8 + i)
            home_off.merge(spec, f, 2 * 10**8 + i)
        pre_online = home.dump_all(spec.name, spec.version)
        pre_off = home_off.canonical_history(spec.name, spec.version)

        evidence["ledger"] = ch.ledger()
        topo.regions["westus2"].healthy = False
        t0 = time.perf_counter()
        promoted = repl.promote("eastus")
        evidence["promote_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        evidence["replayed"] = promoted

        post_online = repl.stores["eastus"].dump_all(spec.name, spec.version)
        for name in pre_online.names:
            np.testing.assert_array_equal(
                post_online[name], pre_online[name], err_msg=name
            )
        post_off = repl.offline_stores["eastus"].canonical_history(
            spec.name, spec.version
        )
        assert len(post_off) == len(pre_off), "offline row count diverged"
        for name in pre_off.names:
            np.testing.assert_array_equal(
                post_off[name], pre_off[name], err_msg=name
            )
        evidence["converged_identical"] = True
        evidence["measured_rtt_ms"] = topo.measured_latency("westus2", "eastus")
    except AssertionError:
        if ch is not None and "ledger" not in evidence:
            evidence["ledger"] = ch.ledger()  # a red run shows what crossed the wire
        raise
    finally:
        if ch is not None:
            ch.close()
        handle.close()
        # an orphaned child is a failure in its own right: the handle's
        # close must have reaped it (shutdown -> terminate -> kill)
        assert handle.proc.poll() is not None, "daemon child still running"
        try:
            os.kill(child_pid, 0)
        except ProcessLookupError:
            evidence["child_reaped"] = True
        else:
            raise AssertionError(f"daemon pid {child_pid} survived teardown")
    return evidence


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--merges", type=int, default=6)
    ap.add_argument("--rows", type=int, default=2_000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    def on_alarm(signum, frame):  # noqa: ARG001
        print(
            f"transport smoke exceeded the {args.timeout:.0f}s wall clock",
            file=sys.stderr,
        )
        # os._exit skips atexit, but SIGALRM only fires on a hang, and a
        # hung run's job teardown kills the whole process group anyway
        os._exit(124)

    signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, args.timeout)
    evidence: dict = {}
    try:
        drill(args.merges, args.rows, args.device, evidence)
    except AssertionError as e:
        print(json.dumps(evidence, indent=1, default=str), file=sys.stderr)
        print(f"transport smoke FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
    print(json.dumps(evidence, indent=1, default=str))
    print("transport smoke: PASS")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
