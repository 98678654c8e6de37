#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one GPU.

    python3 chip_profile.py

Runs ``chip_smoke.py``'s main path (``txn_rolling``: 24 hourly jobs over 1M
entities and 200k events an hour, then 16 GETs of 4,096 ids) on the card
under ``cProfile`` and prints one JSON line with the host seconds spent in
each layer (cumulative, so a layer includes the layers below it).  Then it
runs two more jobs and 16 more GETs under ``torch.profiler`` and prints the
device's busy share of that window and its kernel time by name.  Last, the
LM serving slice at phi3-medium-14b's full width (seeded bf16 weights):
8 decode steps of 8 requests and one flash prefill forward at 4 x 2,048,
each under ``torch.profiler``, with the host time per step, the device's
busy share and its time by kernel.  Then the train step at gemma-2b's full
width (seeded bf16 weights, ``attn_impl="pallas_flash"``, a 4 x 2,048
batch): after one warm-up step, its forward + backward and its AdamW update
each under ``torch.profiler`` (``lm_train_trace``; the flash forward's and
backward's kernels summed apart).  Between the two, 8
decode steps of deepseek-v2-lite-16b at full width (8 requests, seeded bf16
weights) under ``torch.profiler`` (``moe_decode_trace``), their device time
split into the MoE dispatch, the expert einsums, the shared experts, MLA and
the rest, and 8 decode steps of mamba2-2.7b at full width (``ssm_decode_trace``),
split into the input projection, the recurrent step and the rest.  Last,
one train step of ``chip_smoke.py``'s ``lm_moe_train``
(deepseek-v2-lite-16b at full width cut to ``MOE_TRAIN_LAYERS`` layers, a
4 x 2,048 batch): its forward + backward traced with the forward and the
backward each split into those parts, then its AdamW update
(``moe_train_trace``), with the peak memory of that depth's steps, and
the same for one train step of mamba2-2.7b at full depth
(``ssm_train_trace``), split into the input projection, the conv, the
SSD's intra-chunk term, chunk states and inter-chunk loop, the gated norm,
the output projection, the loss and the rest.  The untraced times are
those ``chip_smoke.py`` prints.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import cProfile
import dataclasses
import pstats
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from repro_torch.models import lm as lm_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod

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


def device_ops(tp, ranges=()) -> dict:
    """Device-side activity only (kernels, copies, fills) by name: host ops
    report their children's device time too, which would count it twice, and
    so would the device side of the ``record_function`` ``ranges``."""
    on_device = {}
    for e in tp.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
                and e.key not in ranges):
            row = on_device.setdefault(e.key[:80], {"device_ms": 0.0, "count": 0})
            row["device_ms"] += e.self_device_time_total / 1e3
            row["count"] += e.count
    if not on_device:
        raise RuntimeError("the profiler recorded no device activity: time with CUDA events")
    return on_device


def profiled(fn, device: torch.device):
    """(wall seconds, the profiler) of ``fn()`` under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as tp:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    return wall, tp


def traced(fn, device: torch.device) -> tuple[float, dict]:
    """(wall seconds, device ops by name) of ``fn()`` under torch.profiler."""
    wall, tp = profiled(fn, device)
    return wall, device_ops(tp)


def summary(window: str, wall: float, ops: dict, **extra) -> dict:
    busy = sum(v["device_ms"] for v in ops.values())
    top = dict(sorted(ops.items(), key=lambda kv: -kv[1]["device_ms"])[:10])
    return {"window": window, "window_s": wall, "device_busy_ms": busy,
            "device_busy_share": busy / 1e3 / wall, **extra, "top_device_ops": top}


def flash_device_ms(ops: dict) -> tuple[float, float]:
    """Device ms of the flash forward kernels (``flash_fwd``, either route)
    and of the flash backward's kernels (``flash_bwd``: the tensor-core
    ``flash_bwd_delta`` and ``flash_bwd_fused`` passes, the CUDA-core
    ``flash_bwd_cc`` ones, and the ``flash_bwd::`` group sum)."""
    return (sum(v["device_ms"] for k, v in ops.items() if "flash_fwd" in k),
            sum(v["device_ms"] for k, v in ops.items() if "flash_bwd" in k))


def lm_traces(card: str, steps: int = 8) -> None:
    """The LM slice's two units on the card: ``steps`` decode steps of
    ``cs.LM_REQUESTS`` requests against a 32-token cache, and one flash
    prefill forward at ``cs.PREFILL_BATCH`` x ``cs.PREFILL_SEQ``."""
    cfg = cs.get_config(cs.LM_ARCH)
    dev = torch.device("cuda", torch.cuda.current_device())
    params = cs.api.init_params(0, cfg, device=dev)
    toks = cs.api.make_dummy_batch(cfg, cs.LM_REQUESTS, 32 + steps, seed=1, device=dev)["tokens"]
    cache = cs.api.init_cache(cfg, cs.LM_REQUESTS, 32 + steps, device=dev)
    for i in range(32):  # fill the cache as the served prompts would
        cs.api.decode_step(params, cache, toks[:, i:i + 1], cfg)

    def decode():
        for i in range(32, 32 + steps):
            cs.api.decode_step(params, cache, toks[:, i:i + 1], cfg)

    wall, ops = traced(decode, dev)
    cs.emit({"phase": "lm_decode_trace", "card": card, "arch": cfg.name,
             **summary(f"{steps} decode steps of {cs.LM_REQUESTS} requests", wall, ops,
                       ms_per_step=wall / steps * 1e3,
                       device_launches_per_step=sum(v["count"] for v in ops.values()) / steps)})
    del cache
    flash = cs.make_prefill_step(dataclasses.replace(cfg, attn_impl="pallas_flash"))
    batch = cs.api.make_dummy_batch(cfg, cs.PREFILL_BATCH, cs.PREFILL_SEQ, seed=2, device=dev)
    flash(params, batch)  # warm-up
    wall, ops = traced(lambda: flash(params, batch), dev)
    flash_ms, bwd_ms = flash_device_ms(ops)
    busy = sum(v["device_ms"] for v in ops.values())
    cs.emit({"phase": "lm_prefill_trace", "card": card, "arch": cfg.name,
             **summary(f"one flash forward at {cs.PREFILL_BATCH} x {cs.PREFILL_SEQ}", wall, ops,
                       flash_device_ms=flash_ms, flash_share_of_device=flash_ms / busy,
                       flash_bwd_device_ms=bwd_ms)})


# (range label, module, function): the parts of a MoE/MLA decode step
MOE_RANGES = (
    ("moe_apply", moe_mod, "moe_apply"),
    ("moe_route", moe_mod, "_route"),
    ("moe_dispatch_ffn_combine", moe_mod, "_dispatch_ffn_combine_local"),
    ("moe_expert_ffn", moe_mod, "_expert_ffn"),
    ("mla_decode", mla_mod, "mla_decode"),
)


def _in_range(label: str, fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapped


def moe_decode_trace(card: str, steps: int = 8) -> None:
    """``steps`` decode steps of ``cs.MOE_ARCH`` at full width for
    ``cs.LM_REQUESTS`` requests against a 32-token cache, traced.  For the
    trace only, each function of ``MOE_RANGES`` runs inside a
    ``record_function`` range of its name; a range's device time is that of
    the kernels launched inside it.  Split: the dispatch (routing, the
    stable sort and ranks, the scatters, gathers and combine) = route +
    dispatch_ffn_combine - expert_ffn; the expert einsums = expert_ffn; the
    shared experts = moe_apply - route - dispatch_ffn_combine; MLA =
    mla_decode; the rest (norms, the dense first layer's FFN, embedding,
    head) = busy - moe_apply - mla_decode."""
    cfg = cs.get_config(cs.MOE_ARCH)
    dev = torch.device("cuda", torch.cuda.current_device())
    params = cs.api.init_params(0, cfg, device=dev)
    toks = cs.api.make_dummy_batch(cfg, cs.LM_REQUESTS, 32 + steps, seed=1, device=dev)["tokens"]
    cache = cs.api.init_cache(cfg, cs.LM_REQUESTS, 32 + steps, device=dev)
    for i in range(32):  # fill the cache as the served prompts would
        cs.api.decode_step(params, cache, toks[:, i:i + 1], cfg)

    def decode():
        for i in range(32, 32 + steps):
            cs.api.decode_step(params, cache, toks[:, i:i + 1], cfg)

    real = {label: getattr(mod, name) for label, mod, name in MOE_RANGES}
    for label, mod, name in MOE_RANGES:
        setattr(mod, name, _in_range(label, real[label]))
    try:
        wall, tp = profiled(decode, dev)
    finally:
        for label, mod, name in MOE_RANGES:
            setattr(mod, name, real[label])
    ops = device_ops(tp, ranges=real)
    part = {label: sum(e.device_time_total for e in tp.key_averages()
                       if e.key == label and e.device_type == torch.autograd.DeviceType.CPU)
            / 1e3 for label in real}
    busy = sum(v["device_ms"] for v in ops.values())
    split = {
        "dispatch": part["moe_route"] + part["moe_dispatch_ffn_combine"]
        - part["moe_expert_ffn"],
        "expert_einsums": part["moe_expert_ffn"],
        "shared_experts": part["moe_apply"] - part["moe_route"]
        - part["moe_dispatch_ffn_combine"],
        "mla": part["mla_decode"],
        "rest": busy - part["moe_apply"] - part["mla_decode"],
    }
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    cs.emit({"phase": "moe_decode_trace", "card": card, "arch": cfg.name,
             **summary(f"{steps} decode steps of {cs.LM_REQUESTS} requests", wall, ops,
                       ms_per_step=wall / steps * 1e3,
                       device_launches_per_step=sum(v["count"] for v in ops.values()) / steps,
                       device_ms_per_step={k: v / steps for k, v in split.items()},
                       weight_read_bound_ms=weight_bytes / cs.HBM_BYTES_PER_S * 1e3)})


# (range label, module, function): the parts of a Mamba2 decode step
SSM_RANGES = (
    ("mamba_decode", ssm_mod, "mamba_decode"),
    ("mamba_in_proj", ssm_mod, "_split_proj"),
)


def ssm_decode_trace(card: str, steps: int = 8) -> None:
    """``steps`` decode steps of ``cs.SSM_ARCH`` at full width for
    ``cs.LM_REQUESTS`` requests after 32 prompt steps, traced, each function
    of ``SSM_RANGES`` in a ``record_function`` range of its name (for the
    trace only).  Split: the input projection (the (D, 2·DI + 2·G·N + H)
    product) = mamba_in_proj; the recurrent step (the conv over the ring,
    the SSM state's decay and outer-product update and its read-out, the
    gated norm and the output projection) = mamba_decode - mamba_in_proj;
    the rest (embedding, block norms and residuals, the final norm and the
    head) = busy - mamba_decode.  The bound is one read of every weight and
    one read and one write of every layer's state."""
    cfg = cs.get_config(cs.SSM_ARCH)
    dev = torch.device("cuda", torch.cuda.current_device())
    params = cs.api.init_params(0, cfg, device=dev)
    toks = cs.api.make_dummy_batch(cfg, cs.LM_REQUESTS, 32 + steps, seed=1, device=dev)["tokens"]
    cache = cs.api.init_cache(cfg, cs.LM_REQUESTS, 32 + steps, device=dev)
    for i in range(32):  # advance the state as the served prompts would
        cs.api.decode_step(params, cache, toks[:, i:i + 1], cfg)

    def decode():
        for i in range(32, 32 + steps):
            cs.api.decode_step(params, cache, toks[:, i:i + 1], cfg)

    real = {label: getattr(mod, name) for label, mod, name in SSM_RANGES}
    for label, mod, name in SSM_RANGES:
        setattr(mod, name, _in_range(label, real[label]))
    try:
        wall, tp = profiled(decode, dev)
    finally:
        for label, mod, name in SSM_RANGES:
            setattr(mod, name, real[label])
    ops = device_ops(tp, ranges=real)
    part = {label: sum(e.device_time_total for e in tp.key_averages()
                       if e.key == label and e.device_type == torch.autograd.DeviceType.CPU)
            / 1e3 for label in real}
    busy = sum(v["device_ms"] for v in ops.values())
    split = {"in_proj": part["mamba_in_proj"],
             "recurrent_step": part["mamba_decode"] - part["mamba_in_proj"],
             "rest": busy - part["mamba_decode"]}
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    state_bytes = cs.recurrent_state_bytes(cfg, cs.LM_REQUESTS)
    cs.emit({"phase": "ssm_decode_trace", "card": card, "arch": cfg.name,
             **summary(f"{steps} decode steps of {cs.LM_REQUESTS} requests", wall, ops,
                       ms_per_step=wall / steps * 1e3,
                       device_launches_per_step=sum(v["count"] for v in ops.values()) / steps,
                       device_ms_per_step={k: v / steps for k, v in split.items()},
                       bound_ms=(weight_bytes + 2 * state_bytes) / cs.HBM_BYTES_PER_S * 1e3)})


# the parts of a MoE/MLA train step, by the innermost range an op runs in;
# a block's own ops (norms, residual adds, the dense layer's FFN) are the rest
TRAIN_RANGES = (*(r for r in MOE_RANGES if r[0] != "mla_decode"),
                ("mla_attention", mla_mod, "mla_attention"), ("block", lm_mod, "_block_apply"))
PART_OF = {"moe_expert_ffn": "expert_einsums", "moe_route": "dispatch",
           "moe_dispatch_ffn_combine": "dispatch", "moe_apply": "shared_experts",
           "mla_attention": "mla", "block": "rest"}
BACKWARD_NODE = "autograd::engine::evaluate_function"


def train_split(tp, time_of, part_of: dict = PART_OF) -> dict:
    """Device time of a traced forward + backward by phase and part.  Each
    host op's own device time (``time_of``) goes to the innermost range of
    ``part_of`` (range label -> part) or backward node above it.  Under a range: that
    range's part, in the forward, or in the backward when a backward node
    is above the range (a checkpointed block recomputed).  Under a backward
    node first: the part of the forward op that created the node (matched
    by sequence number), else the rest."""
    def owner(e):
        """(range label or backward node, whether a backward node is above)."""
        first, node = None, e
        while node is not None:
            if first is None and (node.name in part_of or node.name.startswith(BACKWARD_NODE)):
                first = node
            elif first is not None and node.name.startswith(BACKWARD_NODE):
                return first, True
            node = node.cpu_parent
        return first, False

    events = [e for e in tp.events() if e.device_type == torch.autograd.DeviceType.CPU]
    fwd_part = {}
    for e in events:
        top, in_bwd = owner(e)
        if e.sequence_nr >= 0 and not in_bwd and not (
                top is not None and top.name.startswith(BACKWARD_NODE)):
            fwd_part[e.sequence_nr] = part_of.get(getattr(top, "name", None), "rest")
    parts = [*dict.fromkeys(part_of.values()), "rest"]
    split = {ph: dict.fromkeys(parts, 0.0) for ph in ("forward", "backward")}
    for e in events:
        t = time_of(e)
        if not t:
            continue
        top, in_bwd = owner(e)
        if top is None:
            split["forward"]["rest"] += t
        elif top.name.startswith(BACKWARD_NODE):
            split["backward"][fwd_part.get(top.sequence_nr, "rest")] += t
        else:
            split["backward" if in_bwd else "forward"][part_of[top.name]] += t
    return split


def moe_train_trace(card: str) -> None:
    """One train step of ``chip_smoke.py``'s ``lm_moe_train`` (its depth,
    batch and optimizer) after a warm-up step: ``loss_and_grads`` traced
    with each function of ``TRAIN_RANGES`` in a ``record_function`` range
    of its name (for the trace only), its device time split by
    ``train_split``; then the AdamW update traced alone, with the peak
    memory of the warm-up and the traced step."""
    cfg = dataclasses.replace(cs.get_config(cs.MOE_ARCH), num_layers=cs.MOE_TRAIN_LAYERS)
    dev = torch.device("cuda", torch.cuda.current_device())
    optimizer = cs.lm_train.train_optimizer(cs.TRAIN_LR, cs.TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    state = cs.TrainState.create(cs.api.init_params(0, cfg, device=dev), optimizer)
    batch = cs.api.make_dummy_batch(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ, seed=3, device=dev)
    state, _ = cs.make_train_step(cfg, optimizer)(state, batch)  # warm-up
    grads = {}
    real = {label: getattr(mod, name) for label, mod, name in TRAIN_RANGES}
    for label, mod, name in TRAIN_RANGES:
        setattr(mod, name, _in_range(label, real[label]))
    try:
        wall, tp = profiled(
            lambda: grads.update(cs.loss_and_grads(state.params, batch, cfg)[1]), dev)
    finally:
        for label, mod, name in TRAIN_RANGES:
            setattr(mod, name, real[label])
    ops = device_ops(tp, ranges=real)
    split = train_split(tp, lambda e: e.self_device_time_total / 1e3)
    cs.emit({"phase": "moe_train_trace", "card": card, "arch": cfg.name,
             "layers": cfg.num_layers, "part": "fwd_bwd",
             **summary(f"loss_and_grads at {cs.TRAIN_BATCH} x {cs.TRAIN_SEQ}", wall, ops,
                       device_ms=split,
                       device_launches=sum(v["count"] for v in ops.values()))})
    named = dict(state.params.named_parameters())
    wall, ops = traced(lambda: optimizer.update(grads, state.opt, named), dev)
    cs.emit({"phase": "moe_train_trace", "card": card, "arch": cfg.name,
             "layers": cfg.num_layers, "part": "optimizer",
             **summary("one AdamW update (float32 moments)", wall, ops,
                       device_launches=sum(v["count"] for v in ops.values())),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9})


# the parts of a Mamba2 train step (mamba2-2.7b): each function's range and
# its part; the Mamba block's own ops (the output projection, dt's softplus,
# the D skip, casts) are "out_proj", the block's norms and residual adds
# "block_norms", ``_ssd_chunked``'s own (dt·A, x·dt, the cumsum, the sum of
# the two terms) "ssd_other"; outside every range: the embedding, the final
# norm and the head
SSM_TRAIN_RANGES = (
    ("ssm_in_proj", ssm_mod, "_split_proj"), ("ssm_conv", ssm_mod, "_causal_conv"),
    ("ssd_intra", ssm_mod, "_ssd_intra"), ("ssd_states", ssm_mod, "_ssd_chunk_states"),
    ("ssd_inter", ssm_mod, "_ssd_inter"), ("ssd", ssm_mod, "_ssd_chunked"),
    ("ssm_gated_norm", ssm_mod, "_gated_norm"), ("mamba", ssm_mod, "mamba_forward"),
    ("block", lm_mod, "_block_apply"), ("loss", lm_mod, "next_token_loss"),
)
SSM_PART_OF = {"ssm_in_proj": "in_proj", "ssm_conv": "conv", "ssd_intra": "ssd_intra_chunk",
               "ssd_states": "ssd_chunk_states", "ssd_inter": "ssd_inter_chunk_loop",
               "ssd": "ssd_other", "ssm_gated_norm": "gated_norm", "mamba": "out_proj",
               "block": "block_norms", "loss": "loss"}


def ssm_train_trace(card: str) -> None:
    """One train step of ``chip_smoke.py``'s ``lm_ssm_train`` (mamba2-2.7b at
    full depth, a 4 x 2,048 batch) after a warm-up step: ``loss_and_grads``
    traced with each function of ``SSM_TRAIN_RANGES`` in a
    ``record_function`` range of its name (for the trace only), its device
    time split by ``train_split`` into ``SSM_PART_OF``'s parts and the rest
    (embedding, final norm, head), forward and backward (the checkpointed
    blocks' recompute counts as backward); then the AdamW update traced
    alone, with the peak memory of the warm-up and the traced step."""
    cfg = cs.get_config(cs.SSM_ARCH)
    dev = torch.device("cuda", torch.cuda.current_device())
    optimizer = cs.lm_train.train_optimizer(cs.TRAIN_LR, cs.TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    state = cs.TrainState.create(cs.api.init_params(0, cfg, device=dev), optimizer)
    batch = cs.api.make_dummy_batch(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ, seed=3, device=dev)
    state, _ = cs.make_train_step(cfg, optimizer)(state, batch)  # warm-up
    grads = {}
    real = {label: getattr(mod, name) for label, mod, name in SSM_TRAIN_RANGES}
    for label, mod, name in SSM_TRAIN_RANGES:
        setattr(mod, name, _in_range(label, real[label]))
    try:
        wall, tp = profiled(
            lambda: grads.update(cs.loss_and_grads(state.params, batch, cfg)[1]), dev)
    finally:
        for label, mod, name in SSM_TRAIN_RANGES:
            setattr(mod, name, real[label])
    ops = device_ops(tp, ranges=real)
    split = train_split(tp, lambda e: e.self_device_time_total / 1e3, SSM_PART_OF)
    cs.emit({"phase": "ssm_train_trace", "card": card, "arch": cfg.name,
             "layers": cfg.num_layers, "part": "fwd_bwd",
             **summary(f"loss_and_grads at {cs.TRAIN_BATCH} x {cs.TRAIN_SEQ}", wall, ops,
                       device_ms=split,
                       device_launches=sum(v["count"] for v in ops.values()))})
    named = dict(state.params.named_parameters())
    wall, ops = traced(lambda: optimizer.update(grads, state.opt, named), dev)
    cs.emit({"phase": "ssm_train_trace", "card": card, "arch": cfg.name,
             "layers": cfg.num_layers, "part": "optimizer",
             **summary("one AdamW update (float32 moments)", wall, ops,
                       device_launches=sum(v["count"] for v in ops.values())),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9})


def flash_bwd_kernels(ops: dict) -> dict:
    """Device ms of each flash backward kernel, by name."""
    return {k: v["device_ms"] for k, v in ops.items() if "flash_bwd" in k}


def flash_bwd_turn_waits(step, dev: torch.device, fused_ms: float) -> dict:
    """What summing in a fixed order costs the tensor-core backward within
    ``step()``: as shares of the fused pass's consumer warpgroup time (two a
    block, a block an SM, ``fused_ms`` of it), the cycles its consumers
    waited to hand a dQ share over and for a dK/dV turn, and its writer
    lanes for a dQ turn, counted by the kernel (``flash_ops.wait_cycles``)
    and converted at the card's maximum SM clock (so each share is a lower
    bound)."""
    fo = cs.flash_ops
    waits = torch.zeros(3, dtype=torch.int64, device=dev)
    fo.wait_cycles = waits
    try:
        step()
        torch.cuda.synchronize(dev)
    finally:
        fo.wait_cycles = None
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]) * 1e6
    wg_ms = 2 * torch.cuda.get_device_properties(dev).multi_processor_count * fused_ms
    dq, dkv, lane = (int(x) / clock_hz * 1e3 / wg_ms for x in waits.tolist())
    return {"turn_wait_dq_share": dq, "turn_wait_dkv_share": dkv,
            "writer_lane_wait_share": lane}


def train_trace(card: str) -> None:
    """One train step of ``chip_smoke.py``'s ``lm_train`` shape, split into
    its forward + backward (``loss_and_grads``) and its optimizer update,
    each traced on its own after a warm-up step.  The forward + backward's
    row adds each flash backward kernel's device ms and, from
    ``flash_bwd_turn_waits``, what the backward's fixed order costs."""
    cfg = dataclasses.replace(cs.get_config(cs.TRAIN_ARCH), attn_impl="pallas_flash")
    dev = torch.device("cuda", torch.cuda.current_device())
    optimizer = cs.lm_train.train_optimizer(cs.TRAIN_LR, cs.TRAIN_STEPS)
    state = cs.TrainState.create(cs.api.init_params(0, cfg, device=dev), optimizer)
    batch = cs.api.make_dummy_batch(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ, seed=3, device=dev)
    state, _ = cs.make_train_step(cfg, optimizer)(state, batch)  # warm-up
    grads = {}
    wall, ops = traced(lambda: grads.update(cs.loss_and_grads(state.params, batch, cfg)[1]), dev)
    flash_ms, bwd_ms = flash_device_ms(ops)
    bwd_kernels = flash_bwd_kernels(ops)
    costs = flash_bwd_turn_waits(lambda: cs.loss_and_grads(state.params, batch, cfg), dev,
                                 sum(v for k, v in bwd_kernels.items() if "flash_bwd_fused" in k))
    cs.emit({"phase": "lm_train_trace", "card": card, "arch": cfg.name, "part": "fwd_bwd",
             **summary(f"loss_and_grads at {cs.TRAIN_BATCH} x {cs.TRAIN_SEQ}", wall, ops,
                       flash_fwd_device_ms=flash_ms, flash_bwd_device_ms=bwd_ms,
                       flash_bwd_kernels_ms=bwd_kernels, flash_bwd_order=costs,
                       device_launches=sum(v["count"] for v in ops.values()))})
    named = dict(state.params.named_parameters())
    wall, ops = traced(lambda: optimizer.update(grads, state.opt, named), dev)
    cs.emit({"phase": "lm_train_trace", "card": card, "arch": cfg.name, "part": "optimizer",
             **summary("one AdamW update (float32 moments)", wall, ops,
                       device_launches=sum(v["count"] for v in ops.values()))})


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
    on_device = device_ops(tp)
    busy_ms = sum(v["device_ms"] for v in on_device.values())
    copy_ms = sum(v["device_ms"] for k, v in on_device.items() if k.startswith("Memcpy"))
    top = dict(sorted(on_device.items(), key=lambda kv: -kv[1]["device_ms"])[:10])
    cs.emit({"phase": "device_trace", "card": card, "window": "2 jobs + 16 GETs of 4,096 ids",
             "jobs_s": t2 - t1, "gets_s": t3 - t2, "window_s": t3 - t1,
             "device_busy_ms": busy_ms, "device_copy_ms": copy_ms,
             "device_busy_share": busy_ms / 1e3 / (t3 - t1), "top_device_ops": top})
    del txn, fs
    torch.cuda.empty_cache()
    lm_traces(card)
    torch.cuda.empty_cache()
    moe_decode_trace(card)
    torch.cuda.empty_cache()
    ssm_decode_trace(card)
    torch.cuda.empty_cache()
    train_trace(card)
    torch.cuda.empty_cache()
    moe_train_trace(card)
    torch.cuda.empty_cache()
    ssm_train_trace(card)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
