#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one GPU.

    python3 chip_profile.py

Runs ``chip_smoke.py``'s main path (``txn_rolling``: 24 hourly jobs over 1M
entities and 200k events an hour, then 16 GETs of 4,096 ids) on the card
under ``cProfile`` and prints one JSON line with the host seconds spent in
each layer (cumulative, so a layer includes the layers below it).  Then it
runs two more jobs and 16 more GETs under ``torch.profiler`` and prints the
device's busy share of that window and its kernel time by name.  The
untraced times are those ``chip_smoke.py`` prints.  Exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import cProfile
import pstats
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

# (label, file suffix, function) of each layer, from the entry point down
LAYERS = [
    ("tick", "core/featurestore.py", "tick"),
    ("run_job", "core/materializer.py", "run_job"),
    ("source_read", "data/sources.py", "read"),
    ("dsl_transform", "core/dsl.py", "__call__"),
    ("dsl_window_starts", "rolling_agg/ops.py", "window_starts"),
    ("rolling_sum", "rolling_agg/ops.py", "rolling_sum"),
    ("validate_feature_frame", "core/assets.py", "validate_feature_frame"),
    ("offline_merge", "core/offline_store.py", "merge_with_stats"),
    ("online_merge", "core/online_store.py", "merge"),
    ("online_merge_plan", "core/merge_engine.py", "plan_online_batch"),
    ("merge_at_slots", "online_merge/ops.py", "merge_at_slots"),
    ("get_online_features", "core/featurestore.py", "get_online_features"),
    ("lookup_encoded", "core/online_store.py", "lookup_encoded"),
    ("lookup_kernel_wrapper", "online_lookup/ops.py", "lookup"),
    ("gather_rows", "online_lookup/ops.py", "gather_rows"),
]


def layer_seconds(stats: pstats.Stats) -> dict:
    out = {}
    for label, suffix, func in LAYERS:
        ct = calls = 0
        for (fname, _, fn), (_, nc, _, cum, _) in stats.stats.items():
            if fn == func and fname.endswith(suffix):
                ct += cum
                calls += nc
        out[label] = {"s": ct, "calls": calls}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device visible; this run needs one GPU", file=sys.stderr)
        return 2
    card = cs.card_line()
    cs.native.library()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    txn = cs.phase_txn("cuda", cs.TXN_ENTITIES, cs.TXN_EVENTS_PER_HOUR, cs.TXN_HOURS, 16)
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof)
    cs.emit({"phase": "host_breakdown", "card": card, "wall_s": wall,
             "layers": layer_seconds(stats)})

    fs = txn["store"]
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, int(1.1 * cs.TXN_ENTITIES), cs.GET_BATCH) for _ in range(16)]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as tp:
        t1 = time.perf_counter()
        for h in (cs.TXN_HOURS + 1, cs.TXN_HOURS + 2):
            fs.tick(now=h * cs.HOUR)
        t2 = time.perf_counter()
        for ids in batches:
            fs.get_online_features("txn_rolling", 1, [ids])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    # device-side activity only (kernels, copies, fills): host ops report
    # their children's device time too, which would count it twice
    on_device = {}
    for e in tp.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            row = on_device.setdefault(e.key[:80], {"device_ms": 0.0, "count": 0})
            row["device_ms"] += e.self_device_time_total / 1e3
            row["count"] += e.count
    if not on_device:
        raise RuntimeError("the profiler recorded no device activity: time with CUDA events")
    busy_ms = sum(v["device_ms"] for v in on_device.values())
    copy_ms = sum(v["device_ms"] for k, v in on_device.items() if k.startswith("Memcpy"))
    top = dict(sorted(on_device.items(), key=lambda kv: -kv[1]["device_ms"])[:10])
    cs.emit({"phase": "device_trace", "card": card, "window": "2 jobs + 16 GETs of 4,096 ids",
             "jobs_s": t2 - t1, "gets_s": t3 - t2, "window_s": t3 - t1,
             "device_busy_ms": busy_ms, "device_copy_ms": copy_ms,
             "device_busy_share": busy_ms / 1e3 / (t3 - t1), "top_device_ops": top})
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
