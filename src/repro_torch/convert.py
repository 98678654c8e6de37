"""Carry store state between the JAX package and the port as numpy.

``online_table_from_numpy`` installs one table's host state (the arrays a
JAX ``OnlineStore`` table holds) into a port ``OnlineStore``, which uploads
it to its device at its next kernel operation; ``_to_numpy`` reads a port
table back out in the same form.  The JAX store's int32 key planes are not
part of that state: ``keys_full`` carries the same keys as int64.

``offline_history_from_numpy`` installs one feature set's offline history
(the record-schema columns an ``OfflineStore.read`` returns) into a port
``OfflineStore``; ``offline_history_to_numpy`` reads it back out.

``lm_params_from_numpy`` builds a port model from the JAX package's
parameter tree (numpy leaves): an ``LM`` (the scanned ``tail`` holds
layer-leading arrays and a hybrid config's ``groups`` group- then
layer-leading (G, L, ...) ones, unstacked here into one block per layer;
``shared_attn``, ``mtp`` and ``vision_proj`` sit at the top), or for an
encoder/decoder config an ``EncDec`` (``enc`` and ``dec`` layer-leading like
``tail``; ``pos_dec``'s rows size it).  ``lm_params_to_numpy`` gives the
tree back; ``kv_cache_to_numpy`` gives a decode cache in the JAX package's
layout.  bfloat16 leaves come back as float32 (exact), since numpy has no
bfloat16 of its own.

``train_state_from_numpy`` and ``train_state_to_numpy`` do the same for a
whole ``TrainState``: the tree of the JAX package's ``TrainState``
(``params``, ``opt`` with ``count`` and the moments ``m`` and ``v``, float32
or quantized ``{"q", "scale"}``, laid out like ``params``, and ``step``).
``train_state_tree`` gives that tree as CPU tensors in their true dtypes,
for the checkpoint manager.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from repro_torch.core.assets import FeatureSetSpec
from repro_torch.core.keys import encode_full_keys
from repro_torch.core.offline_store import (
    CREATION_TS,
    EVENT_TS,
    OfflineStore,
    _record_schema,
    _Shard,
)
from repro_torch.core.online_store import OnlineStore, _PartitionedTable
from repro_torch.core.table import Table
from repro_torch.device import resolve_device
from repro_torch.kernels.online_lookup.ops import partition_of
from repro_torch.launch.steps import TrainState
from repro_torch.models.api import Model
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM

__all__ = [
    "STATE_FIELDS",
    "kv_cache_to_numpy",
    "lm_params_from_numpy",
    "lm_params_to_numpy",
    "offline_history_from_numpy",
    "offline_history_to_numpy",
    "online_table_from_numpy",
    "train_state_from_numpy",
    "train_state_to_numpy",
    "train_state_tree",
    "whole_tensor",
]

STATE_FIELDS = (
    "keys_full", "event_ts", "creation_ts", "values", "fill",
    "idx_keys", "idx_part", "idx_slot",
)
_DTYPES = {
    "keys_full": np.int64, "event_ts": np.int64, "creation_ts": np.int64,
    "values": np.float32, "fill": np.int64,
    "idx_keys": np.int64, "idx_part": np.int64, "idx_slot": np.int64,
}


def online_table_from_numpy(
    store: OnlineStore, spec: FeatureSetSpec, state: dict
) -> None:
    """Install ``state`` (``STATE_FIELDS`` arrays plus ``free``, a list of P
    sequences of freed slots) as ``spec``'s table in ``store``, replacing
    any table it held.  The arrays are copied; shapes are checked against
    the store's partition count and the spec's feature width."""
    p = store.num_partitions
    arrays = {k: np.array(state[k], dtype=_DTYPES[k], copy=True) for k in STATE_FIELDS}
    c = arrays["keys_full"].shape[1] if arrays["keys_full"].ndim == 2 else -1
    expect = {
        "keys_full": (p, c), "event_ts": (p, c), "creation_ts": (p, c),
        "values": (p, c, len(spec.features)), "fill": (p,),
    }
    for k, shape in expect.items():
        if arrays[k].shape != shape:
            raise ValueError(f"{k} has shape {arrays[k].shape}, expected {shape}")
    k = len(arrays["idx_keys"])
    if arrays["idx_part"].shape != (k,) or arrays["idx_slot"].shape != (k,):
        raise ValueError("idx_keys, idx_part and idx_slot must have one length")
    if len(state["free"]) != p:
        raise ValueError(f"free needs one list per partition ({p})")
    store._tables[spec.key] = _PartitionedTable(
        **arrays, free=[deque(int(s) for s in f) for f in state["free"]]
    )
    store._specs[spec.key] = spec


def _to_numpy(store: OnlineStore, name: str, version: int) -> dict:
    """One port table's host state (synced from device truth first), as the
    arrays ``online_table_from_numpy`` takes, copied."""
    store.sync_host_mirrors(name, version)
    t = store._tables[(name, version)]
    out = {k: np.array(getattr(t, k), copy=True) for k in STATE_FIELDS}
    out["free"] = [list(f) for f in t.free]
    return out


def offline_history_from_numpy(
    store: OfflineStore, spec: FeatureSetSpec, columns: dict
) -> None:
    """Install ``columns`` (the record schema of ``spec``: ``__key__``, the
    index columns, ``event_ts``, ``creation_ts`` and the features) as
    ``spec``'s whole history in ``store``, replacing any it held.  Rows go
    to their key's shard in the order given, one chunk per shard, with the
    full-key index later merges dedup against; the arrays are copied.  A
    history read from a store with as many shards comes back from
    ``store.read`` in the same row order."""
    schema = _record_schema(spec)
    if set(columns) != set(schema):
        raise ValueError(f"columns {sorted(columns)} are not the record schema {sorted(schema)}")
    cols = {k: np.array(columns[k], dtype=dt, copy=True) for k, dt in schema.items()}
    if len({len(v) for v in cols.values()}) != 1:
        raise ValueError("history columns must have one length")
    shard_of = partition_of(cols["__key__"], store.num_shards)
    shards = []
    for s in range(store.num_shards):
        rows = np.flatnonzero(shard_of == s)
        chunk = Table({k: v[rows] for k, v in cols.items()})
        index = np.sort(encode_full_keys(chunk["__key__"], chunk[EVENT_TS], chunk[CREATION_TS]))
        shards.append(_Shard([chunk], index=index, num_rows=len(rows)))
    store._shards[spec.key] = shards
    store._specs[spec.key] = spec


def offline_history_to_numpy(store: OfflineStore, name: str, version: int) -> dict:
    """One feature set's whole port history as record-schema columns, in
    ``store.read`` order, copied: what ``offline_history_from_numpy`` takes."""
    return {k: np.array(v, copy=True) for k, v in store.read(name, version).columns.items()}


# -- the LM's weights, its train state and decode cache -------------------------
def _is_leaf(v) -> bool:
    """An array, or a quantized moment ``{"q", "scale"}`` (one leaf here)."""
    return not isinstance(v, dict) or "q" in v


def _leaves(tree: dict, prefix: str = ""):
    """(dotted path, leaf) over a nested dict of leaves."""
    for k, v in tree.items():
        if _is_leaf(v):
            yield f"{prefix}{k}", v
        else:
            yield from _leaves(v, f"{prefix}{k}.")


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype, copy=True)
    a = np.array(a, copy=True)  # writable and contiguous: JAX's arrays are read-only
    if a.dtype.name == "bfloat16":  # JAX hands bfloat16 out as an ml_dtypes array
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _stack_leaf(xs: list, stack):
    if isinstance(xs[0], dict):
        return {k: stack([x[k] for x in xs]) for k in xs[0]}
    return stack(xs)


# the layer lists held stacked layer-leading: the LM's ``tail``, an
# encoder/decoder's ``enc`` and ``dec``
_STACKED = ("tail", "enc", "dec")


def _jax_tree(named, stack) -> dict:
    """The JAX package's tree of port-named leaves (``(name, leaf)`` pairs):
    ``prefix`` a list of blocks, the per-layer leaves of ``tail``, ``enc``
    and ``dec`` stacked layer-leading with ``stack``, those of ``groups``
    stacked (G, L, ...)."""
    top, prefix, groups = {}, {}, {}
    stacked: dict = {k: {} for k in _STACKED}
    for name, x in named:
        head, _, rest = name.partition(".")
        if head == "prefix":
            i, _, path = rest.partition(".")
            prefix.setdefault(int(i), {})[path] = x
        elif head == "groups":
            g, i, path = rest.split(".", 2)
            groups.setdefault(path, {}).setdefault(int(g), {})[int(i)] = x
        elif head in stacked:
            j, _, path = rest.partition(".")
            stacked[head].setdefault(path, {})[int(j)] = x
        else:
            top[name] = x
    top = _nest(top)  # top-level subtrees (``mtp``, ``shared_attn``) nest like a block
    if prefix:
        top["prefix"] = [_nest(prefix[i]) for i in sorted(prefix)]
    if groups:
        top["groups"] = _nest({
            k: _stack_leaf([_stack_leaf([v[g][i] for i in sorted(v[g])], stack)
                            for g in sorted(v)], stack)
            for k, v in groups.items()})
    for head, layers in stacked.items():
        if layers:
            top[head] = _nest({k: _stack_leaf([v[j] for j in sorted(v)], stack)
                               for k, v in layers.items()})
    return top


def _unstack(v, index: tuple):
    """One layer of a stacked leaf (a quantized moment's ``q`` and ``scale``
    alike)."""
    return {n: x[index] for n, x in v.items()} if isinstance(v, dict) else v[index]


def _port_named(tree: dict) -> dict:
    """The inverse of ``_jax_tree``: port parameter name -> leaf, the stacked
    leaves of ``groups``, ``tail``, ``enc`` and ``dec`` split into one per
    layer."""
    flat = dict(_leaves({k: v for k, v in tree.items()
                         if k not in ("prefix", "groups", *_STACKED)}))
    for i, bp in enumerate(tree.get("prefix", [])):
        flat.update((f"prefix.{i}.{k}", v) for k, v in _leaves(bp))
    for k, v in _leaves(tree.get("groups", {})):
        n_g, n_l = np.shape(v["q"] if isinstance(v, dict) else v)[:2]
        flat.update((f"groups.{g}.{i}.{k}", _unstack(v, (g, i)))
                    for g in range(n_g) for i in range(n_l))
    for head in _STACKED:
        for k, v in _leaves(tree.get(head, {})):
            n_l = np.shape(v["q"] if isinstance(v, dict) else v)[0]
            flat.update((f"{head}.{j}.{k}", _unstack(v, (j,))) for j in range(n_l))
    return flat


def lm_params_from_numpy(cfg: ModelConfig, tree: dict, *,
                         device: str | torch.device = "cuda") -> Model:
    """A port model holding the JAX package's weights ``tree`` (the dict
    ``api.init_params`` returns, leaves as numpy arrays or tensors): an
    ``LM``, or an ``EncDec`` with as many decoder positions as the tree's
    ``pos_dec`` for an encoder/decoder config; each leaf cast to its
    parameter's dtype (``cfg.param_dtype``; an MoE router stays float32) on
    ``device``.  Raises if the tree's names or shapes are not the model's."""
    dev = resolve_device(device)
    if cfg.encoder_decoder:
        model = EncDec(cfg, None, max_pos=np.shape(tree["pos_dec"])[0], device=dev)
    else:
        model = LM(cfg, None, device=dev)
    flat = _port_named(tree)
    state = dict(model.named_parameters())
    if set(flat) != set(state):
        raise ValueError(f"parameter names differ: tree only {sorted(set(flat) - set(state))}, "
                         f"model only {sorted(set(state) - set(flat))}")
    with torch.no_grad():
        for name, p in state.items():
            src = _tensor(flat[name], p.dtype, dev)
            if src.shape != p.shape:
                raise ValueError(f"{name}: tree {tuple(src.shape)}, model {tuple(p.shape)}")
            p.copy_(src)
    return model


def lm_params_to_numpy(model: Model) -> dict:
    """The JAX package's parameter tree of ``model``: per-layer blocks of
    ``tail``, ``enc`` and ``dec`` stacked into layer-leading arrays,
    ``prefix`` a list."""
    return _jax_tree(((n, _numpy(p)) for n, p in model.named_parameters()), np.stack)


def _state_tree(state: TrainState, leaf, stack=torch.stack) -> dict:
    """``state`` in the JAX ``TrainState``'s tree, each tensor through ``leaf``
    and the stacked layers through ``stack``."""
    def moments(tree: dict) -> dict:
        return _jax_tree(((n, _map(leaf, x)) for n, x in tree.items()), stack)

    return {
        "params": _jax_tree(((n, leaf(p.detach())) for n, p in state.params.named_parameters()),
                            stack),
        "opt": {"count": leaf(state.opt["count"]), "m": moments(state.opt["m"]),
                "v": moments(state.opt["v"])},
        "step": leaf(state.step),
    }


def whole_tensor(t: torch.Tensor) -> torch.Tensor:
    """``t``, gathered whole if it is a DTensor (a collective: every rank
    of its mesh must call it, in the same order)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def train_state_tree(state: TrainState) -> dict:
    """The JAX ``TrainState``'s tree of ``state`` as CPU tensors in their own
    dtypes (bfloat16 stays bfloat16); a sharded state's DTensors gathered
    whole, on every rank."""
    return _state_tree(state, lambda t: whole_tensor(t.detach()).cpu())


def train_state_to_numpy(state: TrainState) -> dict:
    """The JAX ``TrainState``'s tree of ``state`` as numpy arrays (bfloat16
    as float32, exact)."""
    return _map(_numpy, train_state_tree(state))


def train_state_from_numpy(cfg: ModelConfig, tree: dict, *,
                           device: str | torch.device = "cuda") -> TrainState:
    """A port ``TrainState`` from the JAX ``TrainState``'s tree (leaves numpy
    arrays or tensors): weights as ``lm_params_from_numpy`` builds them,
    moments float32 or quantized as the tree holds them, counters int32.
    Raises if a moment's names or shapes are not the model's."""
    model = lm_params_from_numpy(cfg, tree["params"], device=device)
    dev = model.device
    shapes = {n: p.shape for n, p in model.named_parameters()}

    def moments(t: dict) -> dict:
        flat = _port_named(t)
        if set(flat) != set(shapes):
            raise ValueError(
                f"moment names differ from the model's: {sorted(set(flat) ^ set(shapes))}")
        out = {}
        for n, x in flat.items():
            if isinstance(x, dict):
                out[n] = {"q": _tensor(x["q"], torch.int8, dev),
                          "scale": _tensor(x["scale"], torch.float32, dev)}
                got = out[n]["q"].shape
            else:
                out[n] = _tensor(x, torch.float32, dev)
                got = out[n].shape
            if got != shapes[n]:
                raise ValueError(f"moment {n}: tree {tuple(got)}, model {tuple(shapes[n])}")
        return out

    opt = tree["opt"]
    return TrainState(model, {"count": _tensor(opt["count"], torch.int32, dev),
                              "m": moments(opt["m"]), "v": moments(opt["v"])},
                      _tensor(tree["step"], torch.int32, dev))


def kv_cache_to_numpy(cache: dict) -> dict:
    """A decode cache in the JAX package's layout: ``t`` an int32 scalar,
    ``prefix`` and ``shared`` lists of layer caches, ``groups`` stacked
    (G, L, ...), ``tail`` stacked layer-leading (KV, MLA or Mamba caches
    alike); an encoder/decoder's ``self_k``, ``self_v``, ``mem_k`` and
    ``mem_v``, already stacked."""
    out = {"t": np.int32(cache["t"])}
    if "self_k" in cache:
        return {**out, **{k: _numpy(v) for k, v in cache.items() if k != "t"}}
    for part in ("prefix", "shared"):
        if part in cache:
            out[part] = [{k: _numpy(v) for k, v in lc.items()} for lc in cache[part]]
    if "groups" in cache:
        out["groups"] = {k: np.stack([np.stack([_numpy(lc[k]) for lc in gc])
                                      for gc in cache["groups"]])
                         for k in cache["groups"][0][0]}
    if "tail" in cache:
        out["tail"] = {k: np.stack([_numpy(lc[k]) for lc in cache["tail"]])
                       for k in cache["tail"][0]}
    return out
