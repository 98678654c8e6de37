"""input_specs(): stand-ins for every input of a step, on the meta device:
the JAX package's ``launch/specs.py``.

JAX's ``ShapeDtypeStruct``s become tensors on the meta device (shapes and
dtypes, no storage): the model is built there (its ``__init__`` with no
generator leaves every weight uninitialised), the optimizer state is
``TrainState.create`` over it, and the batches and caches are made to the
assigned shape cells.  On a mesh every stand-in is a DTensor placed by the
sharding tables, each rank's local shards on the meta device too.  The
dry-run runs the step against exactly these: what proves that a 671B
train step fits without ever allocating it.

Each cell runs at its config's own ``attn_impl`` (the configs' default is
``"xla"``), as in the JAX package.  A meta tensor never reaches a ctypes
kernel: the flash forward and backward are dispatcher ops whose fake
implementations give the kernels' output shapes (``pallas_flash``,
``kernels/flash_attn/ops.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.launch.steps import TrainState, make_prefill_step, make_serve_step, make_train_step
from repro_torch.models import encdec, lm, sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.optim.adamw import Optimizer, adamw

__all__ = [
    "ACT_BUDGET_BYTES", "abstract_params", "abstract_state", "batch_struct",
    "default_optimizer", "input_specs", "microbatches_for", "step_fn_for",
]

META = torch.device("meta")


def abstract_params(cfg: ModelConfig, *, max_decode_len: int = 4096, mesh=None):
    """The model on the meta device (placed by ``param_specs`` on ``mesh``)."""
    if cfg.encoder_decoder:
        model = encdec.EncDec(cfg, None, max_pos=max_decode_len, device=META)
    else:
        model = lm.LM(cfg, None, device=META)
    if mesh is not None:
        sharding.distribute_model(model, cfg, mesh)
    return model


def default_optimizer(cfg: ModelConfig) -> Optimizer:
    # 8-bit moments: the memory-fit configuration for the large cells.
    return adamw(lr=3e-4, weight_decay=0.1, quantize_moments=True)


def abstract_state(cfg: ModelConfig, optimizer: Optional[Optimizer] = None, *, mesh=None):
    """``TrainState.create`` over ``abstract_params``; on ``mesh`` the
    moments are placed by ``sharding.opt_state_specs``."""
    opt = optimizer or default_optimizer(cfg)
    params = abstract_params(cfg, mesh=mesh)
    state = TrainState.create(params, opt)
    if mesh is None:
        return state
    specs = sharding.opt_state_specs(state.opt, sharding.param_specs(params, cfg, mesh), mesh)

    def place(x, spec):
        if isinstance(x, dict):
            return {k: place(x[k], spec[k]) for k in x}
        return x.redistribute(mesh, sharding.placements(spec, mesh))

    for part in ("m", "v"):
        state.opt[part] = {n: place(x, specs[part][n]) for n, x in state.opt[part].items()}
    return state


def batch_struct(cfg: ModelConfig, batch: int, seq: int, *, mesh=None) -> dict:
    out: dict[str, Any] = {"tokens": torch.empty((batch, seq), dtype=torch.int32, device=META)}
    cdt = torch_dtype(cfg.compute_dtype)
    if cfg.encoder_decoder:
        out["frames"] = torch.empty((batch, cfg.encoder_seq, cfg.d_model), dtype=cdt, device=META)
    if cfg.vision_prefix:
        out["patch_embeds"] = torch.empty((batch, cfg.num_patches, cfg.vision_dim), dtype=cdt,
                                          device=META)
    if mesh is not None:
        specs = sharding.batch_specs(out, mesh)
        out = {k: sharding.distribute_tensor(x, specs[k], mesh) for k, x in out.items()}
    return out


def input_specs(arch: str, shape: str, *, reduced: bool = False, cfg_override=None,
                mesh=None, optimizer: Optional[Optimizer] = None,
                batch: Optional[int] = None, seq: Optional[int] = None) -> dict:
    """Returns {'kind', 'cfg', 'args': tuple of stand-in inputs} for the
    (arch x shape) cell.  ``args`` matches the step function's signature:
      train:   (TrainState, batch)
      prefill: (params, batch)
      decode:  (params, cache, tokens_new)

    ``cfg_override`` substitutes another config (a cut depth) keeping the
    cell's batch geometry; ``batch``/``seq`` override the cell's global
    batch and sequence (the one-card cells of ``chip_smoke.py``);
    ``optimizer`` the default int8-moment AdamW.  On ``mesh`` every input
    is placed by the sharding tables."""
    cfg = cfg_override if cfg_override is not None else get_config(arch, reduced=reduced)
    spec: ShapeSpec = SHAPES[shape]
    b, s = spec.global_batch, spec.seq_len
    if reduced:
        b, s = max(2, b // 64), min(s, 64)
    b, s = batch or b, seq or s

    if spec.kind == "train":
        state = abstract_state(cfg, optimizer, mesh=mesh)
        return {"kind": "train", "cfg": cfg, "args": (state, batch_struct(cfg, b, s, mesh=mesh))}
    if spec.kind == "prefill":
        # enc-dec archs size their learned decoder position table from
        # max_decode_len; it must cover the prefill sequence
        return {"kind": "prefill", "cfg": cfg,
                "args": (abstract_params(cfg, max_decode_len=max(4096, s), mesh=mesh),
                         batch_struct(cfg, b, s, mesh=mesh))}
    # decode: one new token against a seq_len-deep cache
    params = abstract_params(cfg, max_decode_len=s, mesh=mesh)
    init = encdec.init_cache if cfg.encoder_decoder else lm.init_cache
    cache = init(cfg, b, s, device=META)
    tokens_new = torch.empty((b, 1), dtype=torch.int32, device=META)
    if mesh is not None:
        cache = sharding.distribute_cache(cache, cfg, mesh)
        tokens_new = sharding.distribute_tensor(
            tokens_new, sharding.batch_specs({"t": tokens_new}, mesh)["t"], mesh)
    return {"kind": "decode", "cfg": cfg, "args": (params, cache, tokens_new)}


#: per-device budget for saved (remat) activations, bytes: the JAX
#: package's figure (2 GiB, sized for a 16 GB TPU v5e), kept as it is so
#: the two dry-runs choose the same microbatch counts
ACT_BUDGET_BYTES = 2 * 2**30


def microbatches_for(kind: str, cfg: ModelConfig, batch: int, seq: int, mesh) -> int:
    """Gradient-accumulation factor: smallest divisor of the global batch
    whose per-microbatch saved-residual footprint
    (tokens_per_dev · d_model · 2 B · num_layers, + MoE routed copies)
    fits ACT_BUDGET_BYTES."""
    if kind != "train":
        return 1
    from repro_torch.launch.mesh import axis_names, mesh_shape

    sizes = mesh_shape(mesh)
    dp = 1
    for a in axis_names(mesh):
        if a != "model":
            dp *= sizes[a]
    tokens_per_dev = batch * seq / dp
    per_layer = tokens_per_dev * cfg.d_model * 2
    if cfg.moe:  # dispatched activations survive the checkpoint boundary
        per_layer *= 1.0 + 0.35
    act = per_layer * cfg.num_layers
    for mu in sorted({d for d in range(1, batch + 1) if batch % d == 0}):
        if act / mu <= ACT_BUDGET_BYTES:
            return mu
    return batch


def step_fn_for(kind: str, cfg: ModelConfig, *, num_microbatches: int = 1,
                optimizer: Optional[Optimizer] = None):
    if kind == "train":
        return make_train_step(cfg, optimizer or default_optimizer(cfg),
                               num_microbatches=num_microbatches)
    if kind == "prefill":
        return make_prefill_step(cfg)
    return make_serve_step(cfg)


def scaled_cfg(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """``cfg`` at ``n_layers`` decoder layers (an encoder/decoder's encoder
    scaled alike), as the JAX dry-run's depth points cut it."""
    reps = {"num_layers": n_layers}
    if cfg.encoder_decoder and cfg.encoder_layers:
        reps["encoder_layers"] = max(1, round(cfg.encoder_layers * n_layers / cfg.num_layers))
    return dataclasses.replace(cfg, **reps)
