"""Rank bodies of the port's multi-rank CPU tests (no tests here).

``repro_torch.launch.mesh.run_ranks`` starts each rank as a fresh
interpreter (the ``spawn`` start method) that imports the function it runs
by module name: this module, which imports torch and the port only, so a
rank never pays for importing JAX.  Each body takes its inputs as numpy
arrays and returns numpy arrays; the test files compare them with JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _mesh(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, axes, device="cpu")


def _np(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy().copy()


# -- expert parallelism --------------------------------------------------------
def ep(rank: int, cfg, params: dict, x: np.ndarray, group_size: int, cf: float,
       shape: tuple) -> dict:
    """``moe_apply`` on ``shape``'s mesh: outputs, aux, the gradient of
    y.sum() by leaf, each dispatch's (idx_k, dst, keep) on this rank, and
    which path ran."""
    from repro_torch.models import moe, sharding
    from repro_torch.models.pspec import activation_mesh

    mesh = _mesh(shape)
    named = {f"ffn.{k}": torch.from_numpy(v) for k, v in _flat(params).items()}
    specs = sharding.param_specs(named, cfg, mesh)
    leaves = {n: sharding.distribute_tensor(t, specs[n], mesh).requires_grad_(True)
              for n, t in named.items()}
    p = _nest({n.removeprefix("ffn."): t for n, t in leaves.items()})
    xt = sharding.distribute_tensor(torch.from_numpy(x), ("data", None, None), mesh)
    routes, paths = [], []
    dispatch, ep_fn, local_fn = moe._dispatch_indices, moe._moe_ep, moe._moe_local

    def logged(idx_k, e, cap):
        dst, keep = dispatch(idx_k, e, cap)
        routes.append((idx_k.numpy().copy(), dst.numpy().copy(), keep.numpy().copy()))
        return dst, keep

    def tag(name, fn):
        def run(*a, **k):
            paths.append(name)
            return fn(*a, **k)
        return run

    moe._dispatch_indices = logged
    moe._moe_ep, moe._moe_local = tag("ep", ep_fn), tag("local", local_fn)
    try:
        with activation_mesh(mesh):
            y, aux = moe.moe_apply(p, xt, cfg, group_size=group_size, capacity_factor=cf)
            grads = torch.autograd.grad(y.sum(), list(leaves.values()))
    finally:
        moe._dispatch_indices, moe._moe_ep, moe._moe_local = dispatch, ep_fn, local_fn
    return {"y": _np(y), "aux": float(_np(aux)), "routes": routes, "paths": paths,
            "grads": {n.removeprefix("ffn."): _np(g) for n, g in zip(leaves, grads)}}


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split(".")
        node = out
        for q in parents:
            node = node.setdefault(q, {})
        node[leaf] = v
    return out


# -- compressed pod all-reduce -------------------------------------------------
def pod_allreduce(rank: int, grads: list, residuals: list) -> dict:
    """``pod_allreduce_compressed`` on a (pod=2, data=1, model=1) mesh, each
    rank with its own gradient tree and residual; plain and DTensor leaves."""
    from repro_torch.models import sharding
    from repro_torch.optim.compression import pod_allreduce_compressed

    mesh = _mesh((2, 1, 1), ("pod", "data", "model"))
    g = {k: torch.from_numpy(v) for k, v in grads[rank].items()}
    r = {k: torch.from_numpy(v) for k, v in residuals[rank].items()}
    out, new_r = pod_allreduce_compressed(g, r, mesh)

    def spec(v):  # the first dim over data (size 1 here), as a parameter's may be
        return (("data",) + (None,) * v.ndim)[:v.ndim]

    gd = {k: sharding.distribute_tensor(v, spec(v), mesh) for k, v in g.items()}
    rd = {k: sharding.distribute_tensor(v, spec(v), mesh) for k, v in r.items()}
    out_d, new_rd = pod_allreduce_compressed(gd, rd, mesh)
    return {"out": {k: _np(v) for k, v in out.items()},
            "residual": {k: _np(v) for k, v in new_r.items()},
            "out_dtensor": {k: _np(v) for k, v in out_d.items()},
            "residual_dtensor": {k: _np(v) for k, v in new_rd.items()}}


def q8_on_mesh(rank: int, arrays: dict) -> dict:
    """``quantize_q8`` and ``dequantize_q8`` of each array as a DTensor on a
    (data=1, model=2) mesh, its last dim over ``model``: q, scale and the
    round trip, gathered, and the scales' placements."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.optim.adamw import dequantize_q8, quantize_q8

    mesh = _mesh((1, 2))
    out = {}
    for k, v in arrays.items():
        x = distribute_tensor(torch.from_numpy(v), mesh, [Replicate(), Shard(v.ndim - 1)])
        qs = quantize_q8(x)
        out[k] = {"q": _np(qs["q"]), "scale": _np(qs["scale"]),
                  "back": _np(dequantize_q8(qs, x.shape)),
                  "scale_whole_last": all(p == Replicate() for p in qs["scale"].placements)}
    return out


# -- sharded training and elastic resume ---------------------------------------
def _state(cfg, tree: dict, opt, mesh):
    """A train state from the JAX weight tree, placed on ``mesh``."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.steps import TrainState, train_state_placements
    from repro_torch.models import sharding

    params = lm_params_from_numpy(cfg, tree, device="cpu")
    sharding.distribute_model(params, cfg, mesh)
    state = TrainState.create(params, opt)
    return state, train_state_placements(state, mesh)


def _batch(batch: dict, mesh) -> dict:
    from repro_torch.models import sharding

    specs = sharding.batch_specs(batch, mesh)
    return {k: sharding.distribute_tensor(torch.from_numpy(v), specs[k], mesh)
            for k, v in batch.items()}


def _steps(cfg, state, step, batches, mesh) -> list:
    from repro_torch.models.pspec import activation_mesh

    losses = []
    with activation_mesh(mesh):
        for b in batches:
            state, m = step(state, _batch(b, mesh))
            losses.append({k: float(_np(v)) for k, v in m.items()})
    return losses, state


def sharded_train(rank: int, cases: list, ckpt_dir: str) -> dict:
    """Each case (name, cfg, JAX weight tree, batches, mesh shape, lr
    schedule steps): its losses and final state over the batches on the
    mesh, and the flash launches (the CPU path's forward calls) under it.
    Then the elastic run of the first case: 2 steps on (2,2), a checkpoint,
    its restores on (4,1) and (1,4) taking the third step, and the third
    step on (2,2) itself."""
    from repro_torch.checkpoint.manager import restore_checkpoint, save_checkpoint
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.launch.steps import make_train_step, train_state_placements
    from repro_torch.optim import adamw, schedules

    out = {}
    calls = []
    ref = flash_ops.attention_lse_ref

    def counted(*a, **k):
        calls.append(1)
        return ref(*a, **k)

    flash_ops.attention_lse_ref = counted
    try:
        for name, cfg, tree, batches, shape in cases:
            opt = adamw.adamw(schedules.warmup_cosine(3e-3, 2, len(batches)),
                              weight_decay=0.01, grad_clip=1.0)
            mesh = _mesh(shape)
            state, _ = _state(cfg, tree, opt, mesh)
            calls.clear()
            losses, state = _steps(cfg, state, make_train_step(cfg, opt), batches, mesh)
            out[name] = {"losses": losses, "state": train_state_to_numpy(state),
                         "flash_calls": len(calls)}
    finally:
        flash_ops.attention_lse_ref = ref

    name, cfg, tree, batches, shape = cases[0]
    opt = adamw.adamw(1e-3)
    step = make_train_step(cfg, opt)
    mesh = _mesh((2, 2))
    state, _ = _state(cfg, tree, opt, mesh)
    _, state = _steps(cfg, state, step, batches[:2], mesh)
    save_checkpoint(ckpt_dir, 2, state)
    elastic = {}
    for shape in ((4, 1), (1, 4)):
        other = _mesh(shape)
        template, placements = _state(cfg, tree, opt, other)
        restored, _ = restore_checkpoint(ckpt_dir, 2, template, placements=placements)
        placed = {n: tuple(p.placements) for n, p in restored.params.named_parameters()}
        want = train_state_placements(restored, other)["params"]
        assert all(placed[n] == tuple(want[n]) for n in placed), "restored off its placements"
        local = [p.to_local() for p in restored.params.parameters()]
        local += [x.to_local() for part in ("m", "v") for x in restored.opt[part].values()]
        assert all(t.untyped_storage().nbytes() == t.numel() * t.element_size()
                   for t in local), "a restored shard holds more than its own chunk"
        elastic[f"{shape[0]}x{shape[1]}"] = _steps(cfg, restored, step, batches[2:3], other)[0]
    elastic["2x2"] = _steps(cfg, state, step, batches[2:3], mesh)[0]
    out["elastic"] = elastic
    return out


def train_driver(rank: int, argv: list) -> dict:
    """``launch/train.main(argv)`` on this rank (the CPU)."""
    from repro_torch.launch import train

    try:
        return {"result": train.main(argv, device="cpu")}
    except ValueError as e:
        return {"error": str(e)}


# -- decoding on a mesh -----------------------------------------------------------
def _whole_cache(cache: dict) -> dict:
    """A decode cache with every DTensor gathered whole (a collective)."""
    from repro_torch.convert import whole_tensor

    def whole(x):
        if isinstance(x, dict):
            return {k: whole(v) for k, v in x.items()}
        if isinstance(x, list):
            return [whole(v) for v in x]
        return whole_tensor(x) if isinstance(x, torch.Tensor) else x

    return whole(cache)


def decode_run(cfg, tree: dict, prompt: np.ndarray, steps: int, max_len: int,
               frames, mesh=None) -> dict:
    """The port's serving from the JAX weights ``tree``: the prompt but its
    last token stepped through ``api.decode_step``, then ``steps`` greedy
    ``serve_step``s, the first fed the prompt's last token and each next
    one the token before; on ``mesh`` (unsharded with None) the model
    placed by ``param_specs`` and the cache by ``cache_specs``.  Every
    step's logits (B, V) and each serve step's tokens as numpy, the final
    cache whole in the JAX layout (``kv_cache_to_numpy``), and the repr of
    the placements of the first cache leaf of each name."""
    from repro_torch.convert import kv_cache_to_numpy, lm_params_from_numpy
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import api, sharding
    from repro_torch.models.pspec import activation_mesh

    model = lm_params_from_numpy(cfg, tree, device="cpu")
    cache = api.init_cache(cfg, prompt.shape[0], max_len, device="cpu")
    if frames is not None:
        cache = api.attach_memory(cache, api.encode_memory(model, frames, cfg), model, cfg)
    if mesh is not None:
        sharding.distribute_model(model, cfg, mesh)
        cache = sharding.distribute_cache(cache, cfg, mesh)
    placements = {}
    for name, leaf in _cache_leaves(cache):
        if hasattr(leaf, "placements"):
            placements.setdefault(name, [repr(p) for p in leaf.placements])
    logits, tokens = [], []
    decode = api.decode_step

    def recorded(*a):
        out, c = decode(*a)
        logits.append(_np(out)[:, -1])
        return out, c

    serve = steps_mod.make_serve_step(cfg)
    with torch.no_grad(), activation_mesh(mesh):
        for i in range(prompt.shape[1] - 1):
            recorded(model, cache, torch.from_numpy(prompt[:, i:i + 1]), cfg)
        tok = torch.from_numpy(prompt[:, -1:])
        api.decode_step = recorded
        try:
            for _ in range(steps):
                nxt, cache = serve(model, cache, tok)
                tokens.append(_np(nxt))
                tok = torch.from_numpy(tokens[-1][:, None])
        finally:
            api.decode_step = decode
    return {"logits": logits, "tokens": tokens, "placements": placements,
            "cache": kv_cache_to_numpy(_whole_cache(cache))}


def _cache_leaves(tree):
    """(leaf name, tensor) of a decode cache, depth first."""
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list)):
            yield from _cache_leaves(v)
        elif isinstance(v, torch.Tensor):
            yield k, v


def sharded_decode(rank: int, cases: list, shape: tuple) -> dict:
    """``decode_run`` of each case (name, cfg, JAX weights, prompt, steps,
    max_len, frames) on ``shape``'s mesh."""
    mesh = _mesh(shape)
    return {name: decode_run(*case, mesh=mesh) for name, *case in cases}


def cache_writes(rank: int, cases: list) -> dict:
    """Each case (name, arch, max_len, positions) on a (2,2) mesh: one
    mixer of the reduced arch (float32, seeded weights) decodes a seeded
    token at each position into its layer cache, filled with seeded values
    first (positions below the first one valid), once unsharded and once
    placed by ``cache_specs``: the cache before, and after each run, whole."""
    from repro_torch.configs import get_config
    from repro_torch.models import api, attention, mla, sharding, ssm
    from repro_torch.models.pspec import BATCH, activation_mesh, constrain

    mesh = _mesh((2, 2))
    out = {}
    for name, arch, max_len, positions in cases:
        cfg = dataclasses.replace(get_config(arch, reduced=True), param_dtype="float32",
                                  compute_dtype="float32")
        gen = torch.Generator().manual_seed(len(out))
        model = api.init_params(0, cfg, device="cpu")
        if cfg.ssm:
            cache = ssm.init_mamba_state(cfg, 4, dtype=torch.float32, device="cpu")
            step = lambda p, x, c, t: ssm.mamba_decode(p, x, c, cfg)  # noqa: E731
        elif cfg.use_mla:
            cache = mla.init_mla_cache(cfg, 4, max_len, dtype=torch.float32, device="cpu")
            step = lambda p, x, c, t: mla.mla_decode(p, x, c, t, cfg)  # noqa: E731
        else:
            cache = attention.init_kv_cache(cfg, 4, max_len, dtype=torch.float32, device="cpu")
            step = lambda p, x, c, t: attention.attention_decode(p, x, c, t, cfg)  # noqa: E731
        for k, v in cache.items():
            if k == "pos":
                v.copy_(torch.where(torch.arange(max_len) < positions[0],
                                    torch.arange(max_len), -1).expand_as(v))
            else:
                v.copy_(torch.randn(v.shape, generator=gen))
        xs = [torch.randn((4, 1, cfg.d_model), generator=gen) for _ in positions]
        before = {k: v.clone() for k, v in cache.items()}
        mixer = model.tail[0].mixer
        with torch.no_grad():
            for t, x in zip(positions, xs):
                step(mixer, x, cache, t)
            plain = {k: v.clone() for k, v in cache.items()}
            placed = sharding.distribute_cache({"tail": [before]}, cfg, mesh)["tail"][0]
            before = {k: v.clone() for k, v in before.items()}  # distribute may share storage
            sharding.distribute_model(model, cfg, mesh)
            with activation_mesh(mesh):
                for t, x in zip(positions, xs):
                    xd = constrain(sharding.distribute_tensor(x, (None, None, None), mesh),
                                   BATCH, None, None)
                    step(mixer, xd, placed, t)
        out[name] = {"before": {k: _np(v) for k, v in before.items()},
                     "plain": {k: _np(v) for k, v in plain.items()},
                     "mesh": {k: _np(v) for k, v in placed.items()},
                     "placements": {k: [repr(p) for p in v.placements]
                                    for k, v in placed.items()}}
    return out


def dense_config(arch: str, **kw):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch, reduced=True), param_dtype="float32",
                               compute_dtype="float32", **kw)
