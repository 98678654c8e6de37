"""Quickstart on the PyTorch/CUDA port: the paper's end-to-end feature-store
story in one script (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py                 # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --fast          # CI smoke sizes
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu    # on the host

Walks through every §2.1 capability on a synthetic transaction stream:

  1.  create a feature store + register a source system
  2.  define an entity and a DSL feature set (rolling-window aggregations —
      the paper's customer-churn example: 30day_transactions_sum et al.)
      [the rolling sum: ``csrc/rolling_sum.cu``]
  3.  scheduled incremental materialization (tick) + on-demand backfill
  4.  point-in-time-correct offline retrieval (a training frame)  [§4.4]
      [the as-of search: ``csrc/pit_search.cu``]
  5.  low-latency online retrieval (the lookup kernel)            [§3.1.4]
      [``csrc/online_lookup.cu``]
  6.  offline/online consistency check + Fig.5 record semantics   [§4.5]
  7.  feature->model lineage                                      [§4.6]

The store, the DSL and the GET run on ``--device`` (default ``cuda``; with
no card that raises).  The output is the JAX example's, line for line.
"""

import argparse

import numpy as np

from repro_torch.core.assets import Entity, Feature, FeatureSetSpec, MaterializationSettings
from repro_torch.core.dsl import DslTransform, RollingAgg
from repro_torch.core.featurestore import FeatureStore
from repro_torch.core.lineage import ModelNode
from repro_torch.core.table import Table
from repro_torch.data.sources import SyntheticEventSource

HOUR = 3_600_000
DAY = 24 * HOUR


def main(fast: bool = False, device: str = "cuda"):
    # --fast: tiny workloads for the CI examples-smoke step
    hours = 6 if fast else 12
    events_per_bucket = 40 if fast else 200

    # -- 1. store + source -----------------------------------------------------
    fs = FeatureStore("quickstart", region="westus2", device=device)
    src = SyntheticEventSource(
        "transactions", num_entities=40, events_per_bucket=events_per_bucket
    )
    fs.register_source(src)

    # -- 2. entity + DSL feature set -------------------------------------------
    customer = fs.create_entity(Entity("customer", ("entity_id",)))
    spec = fs.create_feature_set(
        FeatureSetSpec(
            name="customer_activity",
            version=1,
            entity=customer,
            features=(
                Feature("spend_6h_sum", "float32"),
                Feature("spend_6h_mean", "float32"),
                Feature("txn_6h_count", "float32"),
                Feature("qty_6h_max", "float32"),
            ),
            source_name="transactions",
            transform=DslTransform(
                entity_col="entity_id",
                timestamp_col="ts",
                aggs=[
                    RollingAgg("spend_6h_sum", "amount", 6 * HOUR, "sum"),
                    RollingAgg("spend_6h_mean", "amount", 6 * HOUR, "mean"),
                    RollingAgg("txn_6h_count", "amount", 6 * HOUR, "count"),
                    RollingAgg("qty_6h_max", "quantity", 6 * HOUR, "max"),
                ],
                device=device,
            ),
            timestamp_col="ts",
            source_lookback=6 * HOUR,
            materialization=MaterializationSettings(
                offline_enabled=True, online_enabled=True, schedule_interval=HOUR
            ),
        )
    )
    print(f"created feature set {spec.name} v{spec.version} "
          f"(fingerprint {spec.transform.code_fingerprint()})")

    # -- 3. scheduled materialization + backfill --------------------------------
    stats = fs.tick(now=hours * HOUR)       # N hours of scheduled incremental jobs
    print(f"scheduled materialization: {stats}")
    stats = fs.backfill("customer_activity", 1, start=0, end=4 * HOUR)
    print(f"backfill(0..4h): {stats} (overlap-free per §4.3 — see scheduler)")

    # -- 4. point-in-time offline retrieval -------------------------------------
    rng = np.random.default_rng(0)
    spine = Table({
        "entity_id": rng.integers(0, 40, size=8).astype(np.int64),
        "ts": rng.integers(2 * HOUR, (hours - 1) * HOUR, size=8).astype(np.int64),
        "label": rng.integers(0, 2, size=8).astype(np.float32),
    })
    frame = fs.get_offline_features(spine, [("customer_activity", 1)])
    print("\ntraining frame (PIT-correct — no feature from the future):")
    print("  cols:", sorted(frame.columns))
    print("  spend_6h_sum:",
          np.round(frame["customer_activity:v1:spend_6h_sum"], 1))

    # -- 5. online retrieval ------------------------------------------------------
    vals, found = fs.get_online_features(
        "customer_activity", 1, [np.arange(8, dtype=np.int64)]
    )
    print(f"\nonline lookup: found={found.tolist()}")
    print(f"  latest spend_6h_sum: {np.round(vals[:, 0], 1)}")
    lat = fs.monitor.system.snapshot()["histograms"].get("online_lookup_us", {})
    print(f"  latency p50/p99 = {lat.get('p50', 0):.0f}/{lat.get('p99', 0):.0f} µs")

    # -- 6. consistency (the §4.5.2 invariant) ------------------------------------
    rep = fs.check_consistency("customer_activity", 1)
    print(f"\nconsistency: online==max(event_ts,creation_ts) per id: {rep.consistent}"
          f" ({rep.checked_ids} ids)")

    # -- 7. lineage ---------------------------------------------------------------
    model = ModelNode("churn-model", version=3, region="eastus")
    fs.track_model(model, [("customer_activity", 1)])
    deps = fs.lineage.features_of_model(model)
    print(f"\nlineage: churn-model v3 <- {len(deps)} features "
          f"(cross-region: westus2 store, eastus model)")
    print("\nquickstart complete.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="tiny CI-smoke workloads")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(fast=args.fast, device=args.device)
