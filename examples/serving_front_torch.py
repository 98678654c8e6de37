"""Serving front walkthrough on the PyTorch/CUDA port: the §2.1/§3.1.4
request plane in action (the counterpart of ``examples/serving_front.py``).

    PYTHONPATH=src python examples/serving_front_torch.py                # on the card
    PYTHONPATH=src python examples/serving_front_torch.py --fast         # CI smoke sizes
    PYTHONPATH=src python examples/serving_front_torch.py --device cpu   # on the host

Shows the three mechanisms of core/serving.py on a live store:

  1.  micro-batched GETs — concurrent callers submit tickets, one flush
      coalesces them into a single deduplicated store dispatch (one launch
      of ``csrc/online_lookup.cu``)
  2.  hot-key cache — repeat traffic serves from decoded rows; a
      materializer merge invalidates exactly the touched keys
  3.  overload — with the queue budget exhausted, requests inside the
      staleness bound degrade to cached rows (age reported), the rest shed

and prints the per-stage latency histograms (queue wait / assembly /
kernel / decode) the front records into HealthMonitor.  The store and the
DSL run on ``--device`` (default ``cuda``; with no card that raises).
"""

import argparse

import numpy as np

from repro_torch.core.assets import Entity, Feature, FeatureSetSpec, MaterializationSettings
from repro_torch.core.dsl import DslTransform, RollingAgg
from repro_torch.core.featurestore import FeatureStore
from repro_torch.core.serving import ServingConfig
from repro_torch.data.sources import SyntheticEventSource

HOUR = 3_600_000


def main(fast: bool = False, device: str = "cuda"):
    entities = 500 if fast else 4_000
    callers = 8 if fast else 32
    keys_per_caller = 64 if fast else 256

    # -- 1. live store with a caching serving front ---------------------------
    fs = FeatureStore(
        "serving-demo",
        serving=ServingConfig(
            cache_capacity=entities, staleness_bound_ms=2_000
        ),
        device=device,
    )
    fs.register_source(
        SyntheticEventSource(
            "tx", num_entities=entities, events_per_bucket=entities // 2
        )
    )
    fs.create_feature_set(
        FeatureSetSpec(
            name="act",
            version=1,
            entity=fs.create_entity(Entity("customer", ("entity_id",))),
            features=(Feature("spend_2h", "float32"),),
            source_name="tx",
            transform=DslTransform(
                "entity_id",
                "ts",
                [RollingAgg("spend_2h", "amount", 2 * HOUR, "sum")],
                device=device,
            ),
            timestamp_col="ts",
            source_lookback=2 * HOUR,
            materialization=MaterializationSettings(
                offline_enabled=True, online_enabled=True,
                schedule_interval=HOUR,
            ),
        )
    )
    fs.tick(now=3 * HOUR)
    front = fs.serving

    # -- 2. concurrent callers coalesce into one dispatch ---------------------
    rng = np.random.default_rng(0)
    tickets = [
        front.submit(
            "act", 1, ids=rng.integers(0, entities, keys_per_caller)
        )
        for _ in range(callers)
    ]
    front.flush("act", 1)
    s = front.stats()
    print(f"{callers} callers x {keys_per_caller} keys")
    print(
        f"  -> {int(s['dispatches'])} dispatch(es), "
        f"{int(s['coalesced_keys'])} coalesced / "
        f"{int(s['unique_keys'])} unique keys hit the store"
    )
    hit = sum(int(t.found.sum()) for t in tickets)
    print(f"  found {hit}/{callers * keys_per_caller} rows")

    # -- 3. hot keys serve from cache -----------------------------------------
    hot = rng.integers(0, entities, keys_per_caller)
    front.get("act", 1, ids=hot)
    d_before = front.stats()["dispatches"]
    front.get("act", 1, ids=hot)  # all cached: no store dispatch
    s = front.stats()
    print(
        f"repeat GET: +{int(s['dispatches'] - d_before)} dispatches, "
        f"hit rate {s['cache_hit_rate']:.2f}"
    )

    # -- 4. a merge invalidates exactly the touched keys ----------------------
    fs.tick(now=4 * HOUR)
    s = front.stats()
    print(f"after materializer tick: {int(s['cache_invalidations'])} cached "
          f"rows marked stale")

    # -- 5. overload: degrade inside the staleness bound, shed beyond ---------
    front.get("act", 1, ids=hot)  # re-warm the hot set
    fs.tick(now=5 * HOUR)  # supersede cached rows at t=5h
    front.config.max_queue_keys = 0  # simulate a saturated queue
    fs.advance_clock(5 * HOUR + 1_500)  # age 1.5s <= 2s bound
    t = front.submit("act", 1, ids=hot)
    print(
        f"overloaded, stale age 1500 ms: status={t.status} "
        f"degraded={t.degraded} (served {int(t.found.sum())} cached rows)"
    )
    fs.advance_clock(5 * HOUR + 60_000)  # age 60s > bound
    t = front.submit("act", 1, ids=hot)
    print(f"overloaded, stale age 60 s: status={t.status} (bound enforced)")
    front.config.max_queue_keys = 1 << 30

    # -- 6. per-stage latency histograms --------------------------------------
    snap = fs.monitor.system.snapshot()
    print("per-stage latency (us):")
    for stage in ("queue_wait", "assembly", "kernel", "decode", "request"):
        h = snap["histograms"].get(f"serving/{stage}_us")
        if h and h["n"]:
            print(
                f"  {stage:>10}: p50 {h['p50']:>9.1f}  p99 {h['p99']:>9.1f}"
                f"  (n={h['n']})"
            )
    print(f"max stale age served: {front.max_stale_age_ms:.0f} ms "
          f"(bound {front.config.staleness_bound_ms} ms)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="tiny CI-smoke workloads")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(fast=args.fast, device=args.device)
