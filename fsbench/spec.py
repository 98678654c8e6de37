"""``BENCHMARK.json`` and the files it names, found by name under this
folder: ``configs/<config>.json`` (and the reference module it names),
``traffic/<traffic>.json`` (whose ``kind`` names its module in
``kinds/``), ``limits/<cell>.json`` and ``metrics/<metric>.py``.

A configuration file holds the published keys with their published values;
its ``run`` holds what the run sets on top of them (the port's departures
and settings the source does not give), each with its reason under
``assumed``.  ``Cell.config`` is the file with ``run`` applied, and
``model_config`` maps it to the port's ``ModelConfig``."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

__all__ = ["Cell", "load", "cell", "as_run", "model_config", "metric_reader"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list       # the metric entries this cell reports
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def as_run(config: dict) -> dict:
    """The configuration as it is run: the published keys, ``run`` on top."""
    return {**config, **config.get("run", {})}


def model_config(c: dict):
    """The port's ``ModelConfig`` of a configuration as run (``as_run``)."""
    from repro_torch.models.config import ModelConfig

    if c["hidden_act"] != "silu" or c.get("rope_scaling") or c.get("sliding_window"):
        raise ValueError(f"{c['name']}: the port runs no {c['hidden_act']}, rope scaling "
                         "or sliding window; state its departure under `run`")
    kw = dict(name=c["name"], family="dense", num_layers=c["num_hidden_layers"],
              d_model=c["hidden_size"], vocab_size=c["vocab_size"],
              num_heads=c["num_attention_heads"], num_kv_heads=c["num_key_value_heads"],
              head_dim=c["hidden_size"] // c["num_attention_heads"],
              d_ff=c["intermediate_size"], mlp_variant="swiglu",
              rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
              param_dtype=c["torch_dtype"], compute_dtype=c["torch_dtype"],
              attn_impl=c["attn_impl"])
    if c.get("kv_lora_rank"):
        kw.update(use_mla=True, q_lora_rank=c["q_lora_rank"] or 0,
                  kv_lora_rank=c["kv_lora_rank"], qk_nope_dim=c["qk_nope_head_dim"],
                  qk_rope_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"])
    if c.get("n_routed_experts"):
        kw.update(family="moe", moe=True, num_experts=c["n_routed_experts"],
                  num_shared_experts=c["n_shared_experts"], top_k=c["num_experts_per_tok"],
                  moe_d_ff=c["moe_intermediate_size"],
                  first_dense_layers=c["first_k_dense_replace"],
                  capacity_factor=c["capacity_factor"], router_aux_coef=c["router_aux_coef"])
    return ModelConfig(**kw)


def _reports(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def cell(bench: dict, name: str) -> Cell:
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name) and m["moves"] in moved]
    return Cell(name=name, chips=entry["chips"],
                config=as_run(_json(HERE / "configs" / f"{entry['config']}.json")),
                traffic=_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                limits=_json(HERE / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def kind(traffic: dict):
    return importlib.import_module(f"fsbench.kinds.{traffic['kind']}")


def reference(config: dict):
    return importlib.import_module(f"fsbench.configs.{config['reference']}")


def metric_reader(name: str):
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "fsbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
