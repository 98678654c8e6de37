"""``BENCHMARK.json`` and the files it names, found by name under this
folder: ``configs/<config>.json`` (and the reference module it names),
``traffic/<traffic>.json`` (whose ``kind`` names its module in
``kinds/``), ``limits/<cell>.json`` and ``metrics/<metric>.py``.

A configuration file holds the published keys with their published values;
its ``run`` holds what the run sets on top of them (the port's departures
and settings the source does not give), each with its reason under
``assumed``.  ``Cell.config`` is the file with ``run`` applied, and
``model_config`` maps it to the port's ``ModelConfig``.

Every published key is accounted for, or ``model_config`` refuses the file
with a ``ValueError`` that names the key: it is mapped (``MAPPED``), shapes
the forward at the value the port runs by default (``DEFAULTS``), shapes no
forward the benchmark runs (``IDLE``), is set by ``run``, or is listed in
the file's ``port_reads``; the last two with a reason under ``assumed``
(for ``port_reads``: how the port, and the reference, take the published
value).  ``run.port`` holds ``ModelConfig`` keyword arguments applied
after the mapping, under the port's own names.

A chip's share of a deployment (``share``) gives, for each cut key, the
published count (``of``) and the chips that share the layer (``chips``);
the top-level key then holds this chip's count and ``reduced`` names it.
``extra_leaves`` lists further weight leaves, for ``dense``, ``moe`` or
``all`` layers (``weights.py``)."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

__all__ = ["Cell", "load", "cell", "as_run", "head_dim", "model_config", "published",
           "metric_reader"]


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


#: Keys the mapping below reads (``run.port`` aside).
MAPPED = frozenset({
    "name", "num_hidden_layers", "hidden_size", "vocab_size", "num_attention_heads",
    "num_key_value_heads", "head_dim", "intermediate_size", "rope_theta", "rms_norm_eps",
    "torch_dtype", "attn_impl", "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
    "qk_rope_head_dim", "v_head_dim", "n_routed_experts", "n_shared_experts",
    "num_experts_per_tok", "moe_intermediate_size", "first_k_dense_replace",
    "capacity_factor", "router_aux_coef"})

#: Keys that shape the forward, with the values at which the port runs them
#: without being told: any other value is a model the mapping cannot give.
DEFAULTS = {
    "hidden_act": ("silu",), "scoring_func": ("softmax",), "topk_method": ("greedy",),
    "n_group": (1, None), "topk_group": (1, None), "routed_scaling_factor": (1,),
    "norm_topk_prob": (True,), "seq_aux": (False,), "moe_layer_freq": (1,),
    "rope_scaling": (None,), "sliding_window": (None,), "use_sliding_window": (False,),
    "layer_types": (None,), "partial_rotary_factor": (1,), "attention_bias": (False,),
    "mlp_bias": (False,), "tie_word_embeddings": (False,),
    "num_nextn_predict_layers": (0, None)}

#: Published keys that shape no forward the benchmark runs.
IDLE = frozenset({
    "model_type", "bos_token_id", "eos_token_id", "pad_token_id", "max_position_embeddings",
    "original_max_position_embeddings", "ep_size", "initializer_range", "use_cache",
    "attention_dropout", "architectures", "transformers_version"})

#: The file's own keys: provenance, cuts and reasons, and what ``run`` adds.
_META = frozenset({
    "source", "paper", "reference", "reduced", "assumed", "run", "port_reads", "share",
    "extra_leaves"})


def published(c: dict, key: str) -> int:
    """The published count of ``key``: ``share``'s ``of`` where this chip
    holds a share of it, else the file's own value."""
    return c.get("share", {}).get(key, {}).get("of", c[key])


def head_dim(c: dict) -> int:
    """The file's ``head_dim``, else hidden size over the published heads."""
    return c.get("head_dim") or c["hidden_size"] // published(c, "num_attention_heads")


def _check_keys(c: dict) -> None:
    """Raises naming every key of the configuration as run (``as_run``)
    that is neither mapped, at the port's default, idle, set by ``run`` nor
    read by the port (``port_reads``), and every key of ``run`` or
    ``port_reads`` without its reason under ``assumed``."""
    run, reads, why = c.get("run", {}), set(c.get("port_reads", ())), c.get("assumed", {})
    bad = [f"{k} (no reason under `assumed`)" for k in sorted((set(run) | reads) - set(why))]
    bad += [f"{k} (listed in `port_reads`, not in the file)" for k in sorted(reads - set(c))]
    for k, v in c.items():
        if k in _META or k in MAPPED or k in IDLE or k in reads:
            continue
        if k in DEFAULTS:
            if v not in DEFAULTS[k]:
                bad.append(f"{k}={v!r} (the port runs {DEFAULTS[k][0]!r})")
        elif k not in run:
            bad.append(f"{k} (neither mapped, at a default of the port nor listed)")
    for k, s in c.get("share", {}).items():
        held = c.get(k)
        if set(s) != {"of", "chips"} or not isinstance(held, int) or held * s["chips"] != s["of"]:
            bad.append(f"share.{k} ({held} held x {s.get('chips')} chips is not {s.get('of')})")
    if bad:
        raise ValueError(f"{c['name']}: the harness cannot take " + ", ".join(bad)
                         + "; map a key, set it under `run` or list it in `port_reads`, "
                         "with its reason under `assumed`")


def model_config(c: dict):
    """The port's ``ModelConfig`` of a configuration as run (``as_run``)."""
    from repro_torch.models.config import ModelConfig

    _check_keys(c)
    kw = dict(name=c["name"], family="dense", num_layers=c["num_hidden_layers"],
              d_model=c["hidden_size"], vocab_size=c["vocab_size"],
              num_heads=c["num_attention_heads"], num_kv_heads=c["num_key_value_heads"],
              head_dim=head_dim(c),
              d_ff=c["intermediate_size"], mlp_variant="swiglu",
              rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
              param_dtype=c["torch_dtype"], compute_dtype=c["torch_dtype"])
    kw.update((k, c[k]) for k in ("attn_impl", "capacity_factor", "router_aux_coef") if k in c)
    if c.get("kv_lora_rank"):
        kw.update(use_mla=True, q_lora_rank=c["q_lora_rank"] or 0,
                  kv_lora_rank=c["kv_lora_rank"], qk_nope_dim=c["qk_nope_head_dim"],
                  qk_rope_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"])
    if c.get("n_routed_experts"):
        kw.update(family="moe", moe=True, num_experts=c["n_routed_experts"],
                  num_shared_experts=c["n_shared_experts"], top_k=c["num_experts_per_tok"],
                  moe_d_ff=c["moe_intermediate_size"],
                  first_dense_layers=c["first_k_dense_replace"])
    port = c.get("run", {}).get("port", {})
    unknown = sorted(set(port) - {f.name for f in dataclasses.fields(ModelConfig)})
    if unknown:
        raise ValueError(f"{c['name']}: `run.port` names {unknown}, which ModelConfig lacks")
    return ModelConfig(**{**kw, **port})


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
