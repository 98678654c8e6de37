#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives the
port's online path on the card through the entry points a user calls:

  1. the card: name and power limit (``nvidia-smi``);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes of the phases below and at two larger shapes;
  3. ``profile``: 2**23 entities x 32 float32 features written through
     ``FeatureStore.write_batch`` into a kernel-engine store on the card
     (online only, with a TTL, 256 partitions: ~2.5 GB of device tensors)
     and a vector-engine twin on the host; state, merge tallies and 64
     served batches of 4,096 ids must be byte-identical;
  4. the main path, ``txn_rolling``: 24 hourly scheduled materialization
     jobs over 1M entities and 200k events an hour, a 10-feature rolling
     DSL (sum/mean of two columns over 1 h and 6 h, counts), merged into the
     offline and the online store and read back through the serving front.
     The launch counts are zeroed just before it and read just after;
  5. the ``kernels`` line: launches, errors, times and bounds per kernel.

Each phase prints one JSON line; any failed check raises, so the run exits
non-zero.  The last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core.assets import (  # noqa: E402
    Entity,
    Feature,
    FeatureSetSpec,
    MaterializationSettings,
)
from repro_torch.core.dsl import DslTransform, RollingAgg, UDFTransform  # noqa: E402
from repro_torch.core.featurestore import FeatureStore  # noqa: E402
from repro_torch.core.table import Table  # noqa: E402
from repro_torch.data.sources import SyntheticEventSource  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.online_lookup import ops as lookup_ops  # noqa: E402
from repro_torch.kernels.online_lookup.ref import lookup_ref  # noqa: E402
from repro_torch.kernels.rolling_agg import ops as rolling_ops  # noqa: E402
from repro_torch.kernels.rolling_agg.ref import rolling_sum_ref  # noqa: E402

HOUR = 3_600_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
# rolling_sum: kernel and plain both sum in float64 and round once to float32,
# so they differ by at most about one float32 ulp of the result
ROLL_RTOL, ROLL_ATOL = 1e-6, 1e-5

PROFILE_ENTITIES = 1 << 23
PROFILE_FEATURES = 32
PROFILE_PARTITIONS = 256
PROFILE_TTL = 15_000
TXN_ENTITIES = 1_000_000
TXN_EVENTS_PER_HOUR = 200_000
TXN_HOURS = 24
GET_BATCH = 4096
COUNTERS = (lookup_ops.counter, rolling_ops.counter)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate vs operations over
    the float32 rate, in ms, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- kernel against plain ------------------------------------------------------
def check_lookup(keys: torch.Tensor, queries: torch.Tensor, label: str) -> dict:
    """Kernel vs plain on the card: slots must be equal.  Bytes: keys and
    queries read once, slots written once; operations: one int64 compare
    per key and per query (the least any GET does on these inputs)."""
    got = lookup_ops.lookup(keys, queries)
    want = lookup_ref(keys, queries)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"lookup kernel == plain ({label})")
    p, c = keys.shape
    q = queries.shape[1]
    b_ms, b_by = bound(8 * p * c + 12 * p * q, 2 * (p * c + p * q))
    row = {
        "phase": "kernel_check", "kernel": "online_lookup", "shape": label,
        "P": p, "C": c, "Q": q, "hits": int((got >= 0).sum()),
        "max_abs_err": float((got.long() - want.long()).abs().max()),
        "ms": cuda_ms(lambda: lookup_ops.lookup(keys, queries), 20),
        "plain_ms": cuda_ms(lambda: lookup_ref(keys, queries), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    emit(row)
    return row


def check_rolling(values: torch.Tensor, starts: torch.Tensor, label: str) -> dict:
    """Kernel vs plain on the card within ROLL_RTOL/ROLL_ATOL.  Bytes: values
    and starts read once, sums written once; operations: a prefix and a
    difference, two float32 adds per element."""
    got = rolling_ops.rolling_sum(values, starts)
    want = rolling_sum_ref(values, starts)
    torch.cuda.synchronize()
    check(
        torch.allclose(got, want, rtol=ROLL_RTOL, atol=ROLL_ATOL),
        f"rolling_sum kernel within rtol {ROLL_RTOL}, atol {ROLL_ATOL} of plain ({label})",
    )
    n, f = values.shape
    spans = torch.arange(1, n + 1, device=starts.device) - starts.long()
    b_ms, b_by = bound(8 * n * f + 4 * n, 2 * n * f)
    row = {
        "phase": "kernel_check", "kernel": "rolling_sum", "shape": label,
        "N": n, "F": f, "max_span": int(spans.max()), "mean_span": float(spans.double().mean()),
        "max_abs_err": float((got - want).abs().max()),
        "ms": cuda_ms(lambda: rolling_ops.rolling_sum(values, starts), 20),
        "plain_ms": cuda_ms(lambda: rolling_sum_ref(values, starts), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    emit(row)
    return row


def routed_queries(store, ids: np.ndarray) -> torch.Tensor:
    routed = lookup_ops.route_queries_i64(store.num_partitions, ids)[0]
    return torch.from_numpy(routed).to(store.device)


# -- phase 3: the profile table -------------------------------------------------
def profile_spec() -> FeatureSetSpec:
    return FeatureSetSpec(
        name="profile", version=1, entity=Entity("user", ("entity_id",)),
        features=tuple(Feature(f"f{i}") for i in range(PROFILE_FEATURES)),
        source_name="profile_src",
        transform=UDFTransform(lambda df, ctx: df, name="identity"),
        materialization=MaterializationSettings(
            offline_enabled=False, online_enabled=True, online_ttl=PROFILE_TTL
        ),
    )


def profile_store(device: str, engine: str, partitions: int) -> FeatureStore:
    fs = FeatureStore("profile-" + engine, device=device, merge_engine=engine,
                      online_partitions=partitions)
    fs.register_source(SyntheticEventSource("profile_src"))
    fs.create_feature_set(profile_spec())
    return fs


def profile_frames(n_entities: int, frame_rows: int, seed: int):
    """8 frames of inserts (every id once, in random order), then 4 frames
    of random ids: event_ts below, above or equal to the inserted one
    (no-ops, overrides, creation_ts tie-breaks), duplicates inside a frame,
    and two frames that share a creation_ts."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_entities).astype(np.int64)
    ev0 = rng.integers(1_000_000, 2_000_000, n_entities).astype(np.int64)
    cols = lambda ids, ev: {
        "entity_id": ids, "ts": ev,
        **{f"f{i}": rng.standard_normal(len(ids)).astype(np.float32)
           for i in range(PROFILE_FEATURES)},
    }
    for k in range(0, n_entities, frame_rows):
        ids = perm[k:k + frame_rows]
        yield Table(cols(ids, ev0[ids])), 10_000 + k // frame_rows
    for cr in (20_000, 20_001, 20_002, 20_002):
        ids = rng.integers(0, n_entities, frame_rows).astype(np.int64)
        mode = rng.integers(0, 3, frame_rows)
        ev = ev0[ids] + np.where(mode == 0, -rng.integers(1, 50, frame_rows),
                                 np.where(mode == 1, rng.integers(1, 50, frame_rows), 0))
        yield Table(cols(ids, ev)), cr


def phase_profile(device: str, n_entities: int, frame_rows: int,
                  partitions: int, n_batches: int, seed: int = 0) -> dict:
    for c in COUNTERS:
        c.reset()
    t0 = time.perf_counter()
    dev = profile_store(device, "kernel", partitions)
    host = profile_store("cpu", "vector", partitions)
    tallies = np.zeros(3, np.int64)
    merge_s = 0.0
    for frame, cr in profile_frames(n_entities, frame_rows, seed):
        t1 = time.perf_counter()
        a = dev.write_batch("profile", 1, frame, creation_ts=cr)["online"]
        merge_s += time.perf_counter() - t1
        b = host.write_batch("profile", 1, frame, creation_ts=cr)["online"]
        for k in ("inserts", "overrides", "noops", "creation_ts"):
            check(a[k] == b[k], f"profile MergeStats {k} equal")
        for k in ("touched_parts", "touched_slots", "touched_keys",
                  "touched_event_ts", "touched_values"):
            check(np.array_equal(a[k], b[k]), f"profile MergeStats {k} equal")
        tallies += (a["inserts"], a["overrides"], a["noops"])
    check(tallies[1] > 0 and tallies[2] > 0, "updates hold overrides and no-ops")
    state = dev.online.device_state("profile", 1)
    device_gb = state.nbytes() / 1e9
    da, db = dev.online.dump_all("profile", 1), host.online.dump_all("profile", 1)
    check(len(da) == n_entities and sorted(da.columns) == sorted(db.columns),
          "profile dump holds every entity")
    for c in da.columns:
        check(np.array_equal(da[c], db[c]), f"profile dump_all column {c} byte-identical")
    del da, db

    rng = np.random.default_rng(seed + 1)
    get_ms, found_frac = [], []
    for now in [20_100] * n_batches + [10_004 + PROFILE_TTL]:
        dev.advance_clock(now)
        host.advance_clock(now)
        ids = rng.integers(0, int(1.1 * n_entities), GET_BATCH).astype(np.int64)
        t1 = time.perf_counter()
        va, fa = dev.get_online_features("profile", 1, [ids])
        get_ms.append((time.perf_counter() - t1) * 1e3)
        vb, fb = host.get_online_features("profile", 1, [ids], use_kernel=False)
        check(np.array_equal(fa, fb) and np.array_equal(va, vb),
              "profile GET byte-identical to the host twin")
        found_frac.append(float(fa.mean()))
    check(found_frac[-1] < min(found_frac[:-1]), "TTL expires rows past the TTL")
    row = {
        "phase": "profile", "device": str(dev.device), "entities": n_entities,
        "features": PROFILE_FEATURES, "partitions": partitions,
        "capacity": int(state.keys.shape[1]), "device_table_gb": device_gb,
        "inserts": int(tallies[0]), "overrides": int(tallies[1]), "noops": int(tallies[2]),
        "kernel_store_merge_s": merge_s, "get_batches": n_batches + 1,
        "found_frac": found_frac[0], "found_frac_past_ttl": found_frac[-1],
        "get_p50_ms": float(np.percentile(get_ms[:-1], 50)),
        "get_p99_ms": float(np.percentile(get_ms[:-1], 99)),
        "launches": {c.name: c.launches for c in COUNTERS},
        "seconds": time.perf_counter() - t0,
    }
    emit(row)
    return {"row": row, "store": dev}


# -- phase 4: the main path -----------------------------------------------------
def txn_aggs() -> list[RollingAgg]:
    aggs = []
    for w, tag in ((HOUR, "1h"), (6 * HOUR, "6h")):
        for col in ("amount", "quantity"):
            for agg in ("sum", "mean"):
                aggs.append(RollingAgg(f"{col}_{agg}_{tag}", col, w, agg))
        aggs.append(RollingAgg(f"count_{tag}", "amount", w, "count"))
    return aggs


def txn_store(device: str, n_entities: int, events_per_hour: int):
    source = SyntheticEventSource("events", seed=0, num_entities=n_entities,
                                  events_per_bucket=events_per_hour, bucket_ms=HOUR)
    transform = DslTransform("entity_id", "ts", txn_aggs(), device=device)
    fs = FeatureStore("txn", device=device, merge_engine="kernel")
    fs.register_source(source)
    fs.create_feature_set(FeatureSetSpec(
        name="txn_rolling", version=1, entity=Entity("customer", ("entity_id",)),
        features=tuple(Feature(a.output) for a in txn_aggs()), source_name="events",
        transform=transform, timestamp_col="ts", source_lookback=6 * HOUR,
        materialization=MaterializationSettings(
            offline_enabled=True, online_enabled=True, schedule_interval=HOUR),
    ))
    return fs, source, transform


def phase_txn(device: str, n_entities: int, events_per_hour: int, hours: int,
              n_batches: int, seed: int = 0) -> dict:
    fs, source, transform = txn_store(device, n_entities, events_per_hour)
    rng = np.random.default_rng(seed)
    batches = [rng.integers(0, int(1.1 * n_entities), GET_BATCH).astype(np.int64)
               for _ in range(n_batches)]
    for c in COUNTERS:
        c.reset()
    t0 = time.perf_counter()
    jobs = {"succeeded": 0, "retried": 0, "failed": 0}
    for h in range(1, hours + 1):
        for k, v in fs.tick(now=h * HOUR).items():
            jobs[k] += v
    tick_s = time.perf_counter() - t0
    served = [fs.get_online_features("txn_rolling", 1, [ids]) for ids in batches]
    launches = {c.name: c.launches for c in COUNTERS}
    path_s = time.perf_counter() - t0

    check(jobs["succeeded"] == hours and jobs["failed"] == 0, f"{hours} jobs succeeded")
    for ids, (v, f) in zip(batches, served):
        hv, hf = fs.get_online_features("txn_rolling", 1, [ids], use_kernel=False)
        check(np.array_equal(f, hf) and np.array_equal(v, hv),
              "kernel GET byte-identical to host GET")
    report = fs.check_consistency("txn_rolling", 1)
    check(report.consistent, f"txn_rolling consistent: {report.summary()}")

    # one job's DSL output on the card against the same transform on the CPU
    mid = hours // 2 * HOUR
    df = source.read(mid - 6 * HOUR, mid + HOUR)
    on_card = transform(df, {})
    on_cpu = DslTransform("entity_id", "ts", txn_aggs(), device="cpu")(df, {})
    dsl_err = 0.0
    for c in on_cpu.columns:
        a, b = on_card[c], on_cpu[c]
        if a.dtype.kind == "f":
            check(np.allclose(a, b, rtol=ROLL_RTOL, atol=ROLL_ATOL), f"DSL column {c} card vs cpu")
            dsl_err = max(dsl_err, float(np.abs(a - b).max()) if len(a) else 0.0)
        else:
            check(np.array_equal(a, b), f"DSL column {c} card vs cpu")
    row = {
        "phase": "txn_rolling", "device": str(fs.device), "entities": n_entities,
        "events_per_hour": events_per_hour, "jobs": jobs,
        "online_records": fs.online.num_records("txn_rolling", 1),
        "offline_rows": fs.offline.num_rows("txn_rolling", 1),
        "consistency": report.summary(), "dsl_rows_checked": len(df),
        "dsl_max_abs_err_card_vs_cpu": dsl_err, "launches": launches,
        "tick_s": tick_s, "path_s": path_s,
        "found_frac": float(np.mean([f.mean() for _, f in served])),
    }
    emit(row)
    return {"row": row, "store": fs, "source": source, "batch": batches[0], "mid": mid}


def dsl_inputs(source, mid: int, window: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The (values, starts) one job's DSL hands the rolling sum for
    ``window``: rows of [mid - 6 h, mid + 1 h) sorted by (entity, ts)."""
    df = source.read(mid - 6 * HOUR, mid + HOUR)
    order = np.lexsort((df["ts"], df["entity_id"]))
    ent, ts = df["entity_id"][order], df["ts"][order].astype(np.int64)
    seg = np.concatenate([[0], np.cumsum(ent[1:] != ent[:-1])]).astype(np.int64)
    starts = rolling_ops.window_starts(seg, ts, window)
    vals = np.stack([df["amount"][order], df["quantity"][order]], axis=1).astype(np.float32)
    return torch.from_numpy(vals).to(device), torch.from_numpy(starts).to(device)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this run needs one GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    native.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "cached": native.build_log.get("cached"), "library": Path(native.build_log["path"]).name})
    cuda = torch.device("cuda", torch.cuda.current_device())

    # quick kernel checks first, so a broken kernel stops the run early
    rng = np.random.default_rng(1)
    keys = torch.from_numpy(rng.integers(0, 2**62, (16, 1 << 18), dtype=np.int64)).to(cuda)
    q = np.full((16, 512), -2, np.int64)  # routed: 256 hits, 128 misses, pads
    q[:, :256] = keys[:, ::1024].cpu().numpy()
    q[:, 256:384] = rng.integers(0, 2**62, (16, 128))
    checks = {"online_lookup": [check_lookup(keys, torch.from_numpy(q).to(cuda),
                                             "P=16 C=2^18 Q=512 synthetic")]}
    n = 1 << 20
    vals = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32) * 100).to(cuda)
    starts = torch.from_numpy(
        np.maximum(np.arange(n) - rng.integers(0, 8192, n), 0).astype(np.int32)).to(cuda)
    checks["rolling_sum"] = [check_rolling(vals, starts, "N=2^20 F=4 spans<=8192 synthetic")]
    del keys, vals, starts

    prof = phase_profile("cuda", PROFILE_ENTITIES, 1 << 20, PROFILE_PARTITIONS, 64)
    prof_row, pstore = prof["row"], prof["store"].online
    check(prof_row["launches"]["online_lookup"] == prof_row["get_batches"],
          "one lookup launch per profile GET batch")
    checks["online_lookup"].append(check_lookup(
        pstore.device_state("profile", 1).keys,
        routed_queries(pstore, rng.integers(0, PROFILE_ENTITIES, GET_BATCH)),
        "profile table P=256, one 4,096-id GET"))
    del prof, pstore
    torch.cuda.empty_cache()

    txn = phase_txn("cuda", TXN_ENTITIES, TXN_EVENTS_PER_HOUR, TXN_HOURS, 16)
    ostore = txn["store"].online
    main_lookup = check_lookup(
        ostore.device_state("txn_rolling", 1).keys, routed_queries(ostore, txn["batch"]),
        "main path: txn_rolling table, one 4,096-id GET")
    checks["online_lookup"].append(main_lookup)
    for window, tag in ((HOUR, "1h"), (6 * HOUR, "6h")):
        v, s = dsl_inputs(txn["source"], txn["mid"], window, cuda)
        checks["rolling_sum"].append(check_rolling(v, s, f"main path: one job's {tag} window"))
    main_roll = checks["rolling_sum"][-1]  # the 6 h window: the longer spans

    launches = txn["row"]["launches"]
    check(all(launches[c.name] > 0 for c in COUNTERS), "every kernel launched on the main path")
    check(launches["rolling_sum"] == 2 * txn["row"]["jobs"]["succeeded"],
          "two rolling_sum launches per job (one per window)")
    check(launches["online_lookup"] == 16, "one lookup launch per GET batch")
    sources = {"online_lookup": ("src/repro_torch/csrc/online_lookup.cu",
                                 "src/repro/kernels/online_lookup/kernel.py:38"),
               "rolling_sum": ("src/repro_torch/csrc/rolling_sum.cu",
                               "src/repro/kernels/rolling_agg/kernel.py:39")}
    kernels = []
    for name, main_row in (("online_lookup", main_lookup), ("rolling_sum", main_roll)):
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in checks[name]),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": None, "shape": main_row["shape"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    emit({"card": card, "get_batch": GET_BATCH, "get_p50_ms": prof_row["get_p50_ms"],
          "get_p99_ms": prof_row["get_p99_ms"], "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
