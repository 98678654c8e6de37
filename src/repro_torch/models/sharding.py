"""Sharding rules: parameter/batch/cache trees -> specs, and specs ->
DTensor placements.  The JAX package's ``models/sharding.py``.

Strategy (1000+-chip posture):
  * params — TP over ``model`` (attention heads / FFN hidden / vocab /
    experts) + FSDP over ``data`` on the complementary dim; replicated over
    ``pod`` (gradients cross pods once per step).
  * batch — over every non-model axis; falls back to replication when the
    global batch does not divide the shard count (long_500k's batch=1).
  * caches/states — batch-sharded; the KV/state "width" dim shards over
    ``model`` when divisible (heads for GQA, SSM heads for mamba); otherwise
    the SEQUENCE dim shards over ``model`` (sequence-parallel attention).

A spec is a tuple with one entry per tensor dim: None, an axis name, or a
tuple of axis names (``PartitionSpec``'s entries).  Rules are name-based
over parameter names and rank-generalized: a leaf's base spec is
right-aligned and leading dims get None.  The JAX package stacks a
``tail``'s (and an encoder/decoder's ``enc``/``dec``) layers layer-leading
and a hybrid's ``groups`` (G, L, ...); the port keeps one parameter per
layer.  So each port leaf's spec is computed on the shape of the JAX leaf
it belongs to (the stack dims in front), and the stack dims are dropped:
the port's spec is the JAX spec without its leading entries.  Those are
None but in one case: the dense MLP of a ``tail`` layer sits under
``ffn``, so the JAX table gives its stacked (L, D, F) leaves the MoE rule
(``moe.w_gate`` matches by parent name, and its rank-3 base lands on the
layer dim), which puts ``model`` on the layer dim where L divides.  A
port parameter is one layer, so it keeps the rest of that spec (D over
``data``) and is replicated over ``model``.

``placements`` turns a spec into DTensor placements on a ``DeviceMesh``
(one per mesh dim: ``Shard(d)`` where the spec puts that axis on tensor dim
d, else ``Replicate()``); ``distribute_model`` replaces a model's
parameters by DTensors placed so.  ``opt_state_specs`` (the JAX package
keeps it in ``launch/dryrun.py``) mirrors the parameter specs onto the
optimizer's moments.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import torch
from torch import nn

from repro_torch.launch.mesh import axis_names, batch_axes, mesh_shape
from repro_torch.models.config import ModelConfig

__all__ = [
    "batch_specs",
    "cache_specs",
    "distribute_cache",
    "distribute_model",
    "distribute_tensor",
    "opt_state_specs",
    "param_specs",
    "placements",
    "replace_parameters",
]

FSDP = "data"
TP = "model"

# leaf name -> base spec (right-aligned over the trailing dims)
_BASE_RULES: dict[str, tuple] = {
    # embeddings / heads
    "embed": (TP, FSDP),          # (V, D): vocab over model => sharded xent
    "lm_head": (FSDP, TP),        # (D, V)
    "pos_dec": (None, None),
    "vision_proj": (None, FSDP),
    # attention
    "wq": (FSDP, TP),
    "wk": (FSDP, TP),
    "wv": (FSDP, TP),
    "wo": (TP, FSDP),
    "bq": (TP,),
    "bk": (TP,),
    "bv": (TP,),
    # MLA
    "wq_a": (FSDP, None),
    "wq_b": (None, TP),
    "wkv_a": (FSDP, None),
    "wkv_b": (None, TP),
    # dense MLP
    "w_gate": (FSDP, TP),
    "w_up": (FSDP, TP),
    "w_down": (TP, FSDP),
    # MoE (expert-stacked leaves are rank-3; E is the leading dim => EP)
    "router": (FSDP, None),
    "moe.w_gate": (TP, FSDP, None),
    "moe.w_up": (TP, FSDP, None),
    "moe.w_down": (TP, None, FSDP),
    # mamba
    "w_in": (FSDP, TP),
    "w_out": (TP, FSDP),
    "conv_w": (None, TP),
    "conv_b": (TP,),
    "gate_norm": (TP,),
    # mtp
    "proj": (FSDP, TP),
}

_MOE_PARENT = "ffn"  # MoE leaves live under layers' "ffn" subtree
# port name head -> how many stacked dims the JAX leaf has in front
_STACK_DIMS = {"tail": 1, "enc": 1, "dec": 1, "groups": 2}


def _leaf_rule(names: list[str]) -> tuple:
    name = names[-1] if names else ""
    # expert-stacked MoE weights: under ffn, not the (dense) "shared" experts
    if (name in ("w_gate", "w_up", "w_down") and _MOE_PARENT in names
            and "shared" not in names):
        return _BASE_RULES[f"moe.{name}"]
    return _BASE_RULES.get(name, ())


def _right_align(base: tuple, ndim: int) -> tuple:
    if not base or ndim < len(base):
        # scalar-ish leaf (reduced configs can shrink ranks); replicate
        return ()
    return (None,) * (ndim - len(base)) + tuple(base)


def _drop_missing_axes(spec: tuple, names: tuple[str, ...]) -> tuple:
    """Replace axis names absent from the mesh with None (elasticity)."""
    cleaned = []
    for s in spec:
        if s is None:
            cleaned.append(None)
        elif isinstance(s, (tuple, list)):
            kept = tuple(a for a in s if a in names)
            cleaned.append(kept if kept else None)
        else:
            cleaned.append(s if s in names else None)
    return tuple(cleaned)


def _divisible(spec: tuple, shape: tuple, sizes: Mapping[str, int]) -> tuple:
    """Drop shardings that do not divide the dim (for tiny dims — MQA's
    single KV head — padding 15/16 of the axis is worse than replicating)."""
    out = []
    for dim, s in zip(shape, spec):
        if s is None:
            out.append(None)
            continue
        axes = (s,) if isinstance(s, str) else tuple(s)
        size = math.prod(sizes[a] for a in axes)
        out.append(s if dim % size == 0 and dim >= size else None)
    return tuple(out)


def _leaf_spec(names: list[str], shape: tuple, mesh) -> tuple:
    """The JAX ``param_specs`` of one leaf of ``shape`` (its full JAX shape)."""
    spec = _drop_missing_axes(_right_align(_leaf_rule(names), len(shape)),
                              axis_names(mesh))
    spec = spec + (None,) * (len(shape) - len(spec))
    return _divisible(spec, shape, mesh_shape(mesh))


def _shapes(tree) -> dict[str, tuple]:
    if isinstance(tree, nn.Module):
        return {n: tuple(p.shape) for n, p in tree.named_parameters()}
    return {n: tuple(getattr(x, "shape", x)) for n, x in tree.items()}


def _stack_sizes(names) -> dict[str, tuple]:
    """Port head ("tail", "groups", ...) -> the JAX leaf's stack dims."""
    idx: dict[str, list] = {}
    for n in names:
        parts = n.split(".")
        k = _STACK_DIMS.get(parts[0])
        if k:
            idx.setdefault(parts[0], []).append(tuple(int(p) for p in parts[1:1 + k]))
    return {h: tuple(max(ix[d] for ix in v) + 1 for d in range(_STACK_DIMS[h]))
            for h, v in idx.items()}


def param_specs(params: Any, cfg: Optional[ModelConfig], mesh) -> dict[str, tuple]:
    """Spec of every parameter: ``params`` a model (its named parameters) or
    a dict of name -> tensor or shape; ``mesh`` a ``DeviceMesh`` or an
    ``AbstractMesh``.  ``cfg`` is unused, as in the JAX package."""
    shapes = _shapes(params)
    stacks = _stack_sizes(shapes)
    out = {}
    for name, shape in shapes.items():
        head = name.split(".")[0]
        lead = stacks.get(head, ()) if head in _STACK_DIMS else ()
        names = [p for p in name.split(".") if not p.isdigit()]
        out[name] = _leaf_spec(names, lead + shape, mesh)[len(lead):]
    return out


def _batch_spec_first_dim(global_batch: int, mesh) -> Optional[tuple]:
    ba = batch_axes(mesh)
    sizes = mesh_shape(mesh)
    size = math.prod(sizes[a] for a in ba)
    if global_batch % size == 0 and global_batch >= size:
        return ba
    # try data-only
    if "data" in sizes and global_batch % sizes["data"] == 0:
        return ("data",)
    return None


def batch_specs(batch: Mapping[str, Any], mesh) -> dict[str, tuple]:
    """Specs of a training/prefill batch (tokens, frames, patch_embeds...):
    first dim over the batch axes, rest replicated."""
    out = {}
    for name, leaf in batch.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        out[name] = ((_batch_spec_first_dim(shape[0], mesh),)
                     + (None,) * (len(shape) - 1))
    return out


def _cache_leaf_spec(name: str, shape: tuple, mesh) -> tuple:
    """The JAX ``cache_specs`` of one leaf of ``shape`` (its full JAX shape)."""
    sizes = mesh_shape(mesh)
    tp_size = sizes.get(TP, 1)
    ndim = len(shape)
    if ndim == 0 or name == "t":
        return ()
    if name in ("k", "v"):          # (.., B, S, KV, hd)
        base = ["__batch__", None, None, None]
    elif name == "pos":              # (.., B, S)
        base = ["__batch__", None]
    elif name in ("c_kv", "k_pe"):   # (.., B, S, R/pe) — MLA latent
        base = ["__batch__", TP if shape[-2] % tp_size == 0 else None, None]
    elif name == "ssm":              # (.., B, H, P, N)
        base = ["__batch__", TP if shape[-3] % tp_size == 0 else None, None, None]
    elif name == "conv":             # (.., B, W-1, C)
        base = ["__batch__", None, TP if shape[-1] % tp_size == 0 else None]
    elif name in ("self_k", "self_v", "mem_k", "mem_v"):  # (L,B,S,H,hd)
        heads_ok = shape[-2] % tp_size == 0
        base = [None, "__batch__", None if heads_ok else TP, TP if heads_ok else None,
                None]
    else:
        return (None,) * ndim
    if name in ("k", "v"):
        if shape[-2] % tp_size == 0:
            base[-2] = TP          # shard KV heads
        elif shape[-3] % tp_size == 0:
            base[-3] = TP          # MQA: sequence-parallel cache
    b_slot = base.index("__batch__")
    base[b_slot] = _batch_spec_first_dim(shape[ndim - len(base) + b_slot], mesh)
    spec = (None,) * (ndim - len(base)) + tuple(base)
    return _divisible(spec, shape, sizes)


def cache_specs(cache: dict, cfg: Optional[ModelConfig], mesh) -> dict:
    """Decode-state specs in the port cache's own structure (``t`` gets
    ``()``).  Per-layer caches of ``tail`` and ``groups`` take the spec of
    the JAX package's stacked leaf without its leading stack dims."""
    def layer_spec(lc: dict, lead: tuple) -> dict:
        out = {}
        for name, x in lc.items():
            spec = _cache_leaf_spec(name, lead + tuple(x.shape), mesh)
            out[name] = spec[len(lead):]
        return out

    out: dict = {"t": ()}
    for name, x in cache.items():
        if name == "t":
            continue
        if name in ("prefix", "shared"):
            out[name] = [layer_spec(lc, ()) for lc in x]
        elif name == "tail":
            out[name] = [layer_spec(lc, (len(x),)) for lc in x]
        elif name == "groups":
            out[name] = [[layer_spec(lc, (len(x), len(gc))) for lc in gc] for gc in x]
        else:  # an encoder/decoder's stacked self/cross K and V
            out[name] = _cache_leaf_spec(name, tuple(x.shape), mesh)
    return out


def opt_state_specs(opt: dict, specs: dict[str, tuple], mesh=None) -> dict:
    """Optimizer-state specs mirroring the parameter specs (quantized
    moments: ``q`` inherits the parameter's spec, the per-block ``scale``
    drops the last-dim shard); ``count`` is replicated.

    ZeRO-across-pod: parameters replicate over ``pod``, but the moments need
    not: each pod owns a slice (the first spec-free dim divisible by the
    pod count), so the update becomes reduce-scatter over pod + update +
    all-gather.  As for the parameters, the choice is made on the JAX
    package's stacked leaf and its stack dims are dropped: where JAX puts
    ``pod`` on a stacked moment's layer dim, the port's per-layer moment is
    replicated over ``pod``."""
    sizes = mesh_shape(mesh) if mesh is not None else {}
    stacks = _stack_sizes(specs)

    def pod_shard(ps: tuple, shape: tuple) -> tuple:
        if sizes.get("pod", 1) == 1:
            return ps
        npod = sizes["pod"]
        entries = list(ps) + [None] * (len(shape) - len(ps))
        for i, (e, dim) in enumerate(zip(entries, shape)):
            if e is None and dim % npod == 0 and dim >= npod:
                entries[i] = "pod"
                return tuple(entries)
        return ps

    def mirror(name: str, leaf) -> Any:
        head = name.split(".")[0]
        lead = stacks.get(head, ()) if head in _STACK_DIMS else ()
        ps = (None,) * len(lead) + specs[name]
        if isinstance(leaf, dict):  # {"q": ..., "scale": ...}
            qs = pod_shard(ps, lead + tuple(leaf["q"].shape))
            return {"q": qs[len(lead):],
                    "scale": (qs[:-1] + (None,))[len(lead):] if qs else ()}
        return pod_shard(ps, lead + tuple(leaf.shape))[len(lead):]

    return {"count": (), "m": {n: mirror(n, x) for n, x in opt["m"].items()},
            "v": {n: mirror(n, x) for n, x in opt["v"].items()}}


# -----------------------------------------------------------------------------
# DTensor placement
# -----------------------------------------------------------------------------
def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim d's entry names that axis, else
    ``Replicate()``.  A tensor dim over several axes must list them in the
    mesh's order (DTensor shards a dim over mesh dims outer to inner, as a
    ``PartitionSpec`` tuple does major to minor).  A mesh dim of size 1
    replicates: its one shard is the whole tensor, and DTensor's
    propagation handles a replicated dim more simply (some torch releases
    refuse to flatten a dim sharded over one rank)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    sizes = mesh_shape(mesh)
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec}: axes {axes} of dim {d} are not in the mesh's "
                f"order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return out


def distribute_tensor(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """``t`` (the whole tensor, the same on every rank) as a DTensor placed
    by ``spec``: each rank keeps its own slice, no communication."""
    from torch.distributed.tensor import distribute_tensor as dt

    return dt(t.detach(), mesh, placements(spec, mesh), src_data_rank=None)


def distribute_cache(cache: dict, cfg: Optional[ModelConfig], mesh) -> dict:
    """A decode cache (the whole of it, the same on every rank) with every
    tensor a DTensor placed by ``cache_specs``; ``t`` stays an int."""
    specs = cache_specs(cache, cfg, mesh)

    def place(x, spec):
        if isinstance(x, dict):
            return {k: place(x[k], spec[k]) for k in x}
        if isinstance(x, list):
            return [place(a, b) for a, b in zip(x, spec)]
        if isinstance(x, torch.Tensor):
            return distribute_tensor(x, spec, mesh)
        return x

    return place(cache, specs)


def distribute_model(model: nn.Module, cfg: Optional[ModelConfig],
                     mesh) -> dict[str, tuple]:
    """Replace every parameter of ``model`` by a DTensor placed by
    ``param_specs`` (its ``requires_grad`` kept); returns the specs."""
    specs = param_specs(model, cfg, mesh)
    replace_parameters(model, lambda name, p: distribute_tensor(p, specs[name], mesh))
    return specs


def replace_parameters(model: nn.Module, make) -> None:
    """Swap each parameter of ``model`` for ``make(name, parameter)`` (its
    ``requires_grad`` kept), in place."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._parameters[leaf] = nn.Parameter(make(name, p),
                                             requires_grad=p.requires_grad)
