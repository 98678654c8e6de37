"""The port's spans and counters (``repro_torch.core.monitoring``): off
without a profiler session (one shared null context, no record, no counter
argument touched), on under ``torch.profiler.profile``; nesting, request
ids, self time and per-thread stacks; the span clock against the
profiler's own events; and the program's spans where the work happens (the
GET, the offline read, the prefill and train steps, MLA, MoE, RMSNorm) with
MoE's counters against an independent count.  No JAX: the ``gpu`` test
runs on the card as it is."""

import dataclasses
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import deepseek_v2_lite_16b  # noqa: E402
from repro_torch.core import monitoring  # noqa: E402
from repro_torch.core.monitoring import count, read_out, span, tracing  # noqa: E402
from repro_torch.models import moe  # noqa: E402

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _fresh_records():
    read_out()
    yield
    read_out()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the span's events and the trace's kernels")
    return torch.device("cuda")


class _Untouchable:
    """Raises on every use a counter could make of it."""

    def __getattribute__(self, name):
        raise AssertionError(f"counter argument touched: {name}")


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


def test_off_records_nothing_and_touches_no_counter_argument(monkeypatch):
    assert not tracing()
    assert span("a") is span("b")
    with span("a"), span("b"):
        count("c", _Untouchable())
    # the MoE dispatch guards its device count: none is made with tracing off
    monkeypatch.setattr(moe, "count", lambda *a: pytest.fail("counted with tracing off"))
    cfg = _tiny_cfg()
    params = moe.MoE(torch.Generator().manual_seed(0), cfg, dtype=torch.float32)
    moe.moe_apply(params, torch.randn(2, 16, cfg.d_model), cfg)
    got = read_out()
    assert got == {"records": [], "counters": {}, "spans": {}}


def test_nested_spans_carry_parent_request_and_self_time():
    with torch.profiler.profile(activities=CPU):
        assert tracing()
        with span("root"):
            time.sleep(0.002)
            with span("child"):
                time.sleep(0.002)
                with span("leaf"):
                    time.sleep(0.001)
            with span("child"):
                time.sleep(0.001)
        with span("other"):
            pass
    assert not tracing()
    got = read_out()
    by = _by_name(got["records"])
    (root,), (leaf,), (other,) = by["root"], by["leaf"], by["other"]
    assert root["parent"] is None and root["request"] == root["id"]
    assert all(c["parent"] == root["id"] for c in by["child"])
    assert leaf["parent"] == by["child"][0]["id"]
    assert {r["request"] for r in by["child"] + by["leaf"]} == {root["id"]}
    assert other["parent"] is None and other["request"] == other["id"] != root["id"]
    s = got["spans"]
    assert s["child"]["calls"] == 2 and s["root"]["calls"] == 1
    assert s["root"]["self_s"] == pytest.approx(s["root"]["host_s"] - s["child"]["host_s"])
    assert s["child"]["self_s"] == pytest.approx(s["child"]["host_s"] - s["leaf"]["host_s"])
    assert s["root"]["self_s"] >= 0.002 and s["leaf"]["self_s"] == s["leaf"]["host_s"]
    for r in got["records"]:
        assert r["end_ns"] >= r["start_ns"] and r["device_s"] is None
    assert read_out()["records"] == []  # read-out clears: the next window starts from none


def test_threads_keep_separate_stacks():
    inside = threading.Event()
    release = threading.Event()

    def worker():
        with span("worker"):
            inside.set()
            assert release.wait(10)
            with span("inner"):
                count("hits", 2)

    with torch.profiler.profile(activities=CPU):
        with span("main"):
            t = threading.Thread(target=worker)
            t.start()
            assert inside.wait(10)
            with span("main.child"):
                count("hits", 1)
            release.set()
            t.join(10)
    assert not t.is_alive()
    got = read_out()
    by = _by_name(got["records"])
    (main,), (child,), (work,), (inner,) = (by[n] for n in ("main", "main.child", "worker",
                                                            "inner"))
    assert child["parent"] == main["id"] and work["parent"] is None
    assert inner["parent"] == work["id"] and inner["request"] == work["id"]
    assert got["counters"] == {"hits": 3}


def _span_brackets_its_ops(device):
    acts = CPU + ([torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else [])
    a = torch.randn(256, 256, device=device)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            with span("mm"):
                torch.mm(a, a)
    got = read_out()
    spans = [(r["start_ns"], r["end_ns"]) for r in got["records"]]
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm" and e.device_type() != torch.autograd.DeviceType.CUDA]
    assert len(spans) == len(ops) == 3
    for (s0, s1), (o0, o1) in zip(sorted(spans), sorted(ops)):
        assert s0 <= o0 <= o1 <= s1, (s0, o0, o1, s1)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "mm" not in names  # the program opens no profiler range of its own
    return got


def test_span_clock_is_the_profilers():
    got = _span_brackets_its_ops(torch.device("cpu"))
    assert got["spans"]["mm"]["device_s"] is None


@pytest.mark.gpu
def test_span_clock_is_the_profilers_on_card(cuda_device):
    got = _span_brackets_its_ops(cuda_device)
    assert all(r["device_s"] > 0 for r in got["records"])
    assert got["spans"]["mm"]["device_s"] > 0


# -- the program's spans -----------------------------------------------------------
HOUR = 3_600_000


def _store(cache_capacity=0):
    from repro_torch.core import assets, dsl
    from repro_torch.core.featurestore import FeatureStore
    from repro_torch.core.serving import ServingConfig
    from repro_torch.data.sources import SyntheticEventSource

    fs = FeatureStore("trace", device="cpu", online_partitions=4,
                      serving=ServingConfig(cache_capacity=cache_capacity))
    fs.register_source(SyntheticEventSource("tx", seed=3, num_entities=64,
                                            events_per_bucket=100))
    fs.create_feature_set(assets.FeatureSetSpec(
        name="act", version=1, entity=assets.Entity("customer", ("entity_id",)),
        features=(assets.Feature("amt_sum_2h"),), source_name="tx",
        transform=dsl.DslTransform("entity_id", "ts",
                                   [dsl.RollingAgg("amt_sum_2h", "amount", 2 * HOUR, "sum")],
                                   device="cpu"),
        timestamp_col="ts", source_lookback=2 * HOUR,
        materialization=assets.MaterializationSettings(True, True, schedule_interval=HOUR)))
    fs.tick(now=4 * HOUR)
    return fs


HISTS = ("online_lookup_us", "serving/assembly_us", "serving/kernel_us",
         "serving/decode_us")


def test_get_records_store_get_over_the_front_stages():
    fs = _store()
    ids = [np.arange(16, dtype=np.int64)]
    read_out()
    hist = fs.monitor.system.histograms
    before = {h: hist[h].n for h in HISTS}
    off = fs.get_online_features("act", 1, ids)
    assert {h: hist[h].n for h in HISTS} == {h: before[h] + 1 for h in HISTS}
    assert read_out()["records"] == []
    with torch.profiler.profile(activities=CPU):
        on = fs.get_online_features("act", 1, ids)
        fs.offline.read("act", 1)
    assert {h: hist[h].n for h in HISTS} == {h: before[h] + 2 for h in HISTS}
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    by = _by_name(read_out()["records"])
    (get,) = by["store.get"]
    assert get["parent"] is None
    for stage in ("serving.assembly", "serving.lookup", "serving.decode"):
        (rec,) = by[stage]
        assert rec["parent"] == get["id"] and rec["request"] == get["id"]
        assert get["start_ns"] <= rec["start_ns"] <= rec["end_ns"] <= get["end_ns"]
    (offline,) = by["offline.read"]
    assert offline["parent"] is None


def _tiny_cfg(**kw):
    return dataclasses.replace(deepseek_v2_lite_16b.reduced(), param_dtype="float32",
                               compute_dtype="float32", **kw)


def test_tiny_mla_moe_steps_record_their_layers():
    """One ``mla`` span a layer, one ``moe`` a routed layer, and RMSNorm's
    ``norm`` spans (two a block, MLA's latent norms, the final norm) under
    one ``step.prefill``; ``step.optimizer`` under ``step.train``."""
    from repro_torch.launch.steps import TrainState, make_prefill_step, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import adamw

    cfg = _tiny_cfg()
    model = lm.LM(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), torch.profiler.profile(activities=CPU):
        make_prefill_step(cfg)(model, {"tokens": tokens})
    got = read_out()
    by = _by_name(got["records"])
    (step,) = by["step.prefill"]
    latent_norms = 1 + bool(cfg.q_lora_rank)
    assert len(by["mla"]) == cfg.num_layers
    assert len(by["moe"]) == cfg.num_layers - cfg.first_dense_layers
    assert len(by["norm"]) == cfg.num_layers * (2 + latent_norms) + 1
    assert {r["request"] for r in got["records"]} == {step["id"]}
    mla_ids = {r["id"] for r in by["mla"]}
    assert sum(r["parent"] in mla_ids for r in by["norm"]) == cfg.num_layers * latent_norms

    optimizer = adamw(1e-3)
    state = TrainState.create(model, optimizer)
    train = make_train_step(cfg, optimizer)
    with torch.profiler.profile(activities=CPU):
        train(state, {"tokens": tokens})
    by = _by_name(read_out()["records"])
    (step,), (opt,) = by["step.train"], by["step.optimizer"]
    assert step["parent"] is None and opt["parent"] == step["id"]


def test_moe_counters_match_an_independent_count():
    cfg = _tiny_cfg()
    params = moe.MoE(torch.Generator().manual_seed(0), cfg, dtype=torch.float32)
    x = torch.randn(4, 32, cfg.d_model, generator=torch.Generator().manual_seed(2))
    x = x + 2.0 * torch.randn(cfg.d_model, generator=torch.Generator().manual_seed(3))
    group, cf = 64, 1.0
    with torch.profiler.profile(activities=CPU):
        moe.moe_apply(params, x, cfg, group_size=group, capacity_factor=cf)
    got = read_out()["counters"]
    xg = moe._group(x, group)
    cap = moe._capacity(cfg, xg.shape[1], cf)
    _, idx_k, _ = moe._route(params, xg, cfg)
    _, keep = moe._dispatch_indices(idx_k, cfg.num_experts, cap)
    assert got["moe.slots"] == xg.shape[0] * cfg.num_experts * cap
    assert got["moe.kept"] == int(keep.sum())
    assert 0 < got["moe.kept"] < xg.shape[0] * xg.shape[1] * cfg.top_k  # some dropped


def test_count_sums_host_and_device_numbers():
    with torch.profiler.profile(activities=CPU):
        count("n", 2)
        count("n", torch.tensor(3))
        count("m", 1.5)
    assert read_out()["counters"] == {"n": 5, "m": 1.5}
    assert monitoring.read_out()["counters"] == {}
