"""BENCHMARK.json's contract and the files each cell finds by name."""

import json
import re

import pytest
import torch

from fsbench import flops, spec, weights

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "fsbench/run.py"] and BENCH["paths"] == ["fsbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = CONFIGS + CELLS + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_resolve_by_name(name):
    cell = spec.cell(BENCH, name)
    assert spec.kind(cell.traffic).run and spec.reference(cell.config).forward
    assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_states_its_cuts(name):
    """The file keeps the published values; ``reduced`` names its cuts as
    BENCHMARK.json does, every setting of ``run`` has its reason under
    ``assumed``, and the port's ModelConfig is mapped from the same keys."""
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    with open(spec.ROOT / entry["file"]) as f:
        raw = json.load(f)
    c = spec.as_run(raw)
    assert entry["file"] == f"fsbench/configs/{name}.json" and entry["source"] == raw["source"]
    assert sorted(entry["reduced"]) == sorted(raw["reduced"])
    assert set(raw["run"]) <= set(raw["assumed"]) and not set(raw["run"]) & set(raw["reduced"])
    assert all(c[k] == v for k, v in raw["run"].items())
    cfg = spec.model_config(c)
    assert (cfg.d_model, cfg.num_layers, cfg.vocab_size, cfg.num_heads, cfg.num_kv_heads) == (
        raw["hidden_size"], raw["num_hidden_layers"], raw["vocab_size"],
        raw["num_attention_heads"], raw["num_key_value_heads"])
    assert cfg.norm_eps == raw["rms_norm_eps"] and cfg.rope_theta == raw["rope_theta"]
    if raw.get("n_routed_experts"):
        assert (cfg.num_experts, cfg.top_k, cfg.moe_d_ff, cfg.first_dense_layers) == (
            raw["n_routed_experts"], raw["num_experts_per_tok"],
            raw["moe_intermediate_size"], raw["first_k_dense_replace"])
    with pytest.raises(ValueError):
        spec.model_config(raw)  # a published setting the port lacks, with no `run` over it


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_are_the_ports_parameters_at_full_width(name):
    from repro_torch.models import lm

    c = spec.cell(BENCH, next(w["name"] for w in BENCH["workloads"]
                              if w["config"] == name)).config
    model = lm.LM(spec.model_config(c), None, device="meta")
    want = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32, "zero": torch.bfloat16}
    got = {n: (shape, dtype[kind]) for g in weights.groups(c) for n, shape, _, kind in g}
    assert got == want
    body = sum(p.numel() for n, p in model.named_parameters()
               if p.ndim >= 2 and n != "embed" and "router" not in n)
    router = sum(p.numel() for n, p in model.named_parameters() if "router" in n)
    if not c.get("n_routed_experts"):
        assert flops.matmul_params(c) == body + router
