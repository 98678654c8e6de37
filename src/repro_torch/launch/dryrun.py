"""Multi-pod dry-run: prove a distribution config is coherent and size it,
without allocating it.  The JAX package's ``launch/dryrun.py``.

For every (architecture x input-shape) cell, against both production meshes
(single-pod 16x16 and multi-pod 2x16x16), each cell in a process of its own:

    the ``fake`` process-group backend at the mesh's world size (256 or
    512 ranks; this process plays rank 0 and every collective completes
    at once), a ``DeviceMesh`` over it;
    the step's inputs from ``launch/specs.input_specs``: the model, the
    optimizer state and the batch or cache on the meta device, placed as
    DTensors by the sharding tables (``models/sharding.py``);
    the step run once under ``activation_mesh``, inside three recorders:
      * ``FlopCounterMode``;
      * ``torch.distributed._tools.mem_tracker.MemTracker``: the peak of
        the live tensors rank 0 holds (its local shards), by category;
      * ``launch/trace_tools.Recorder``: every op rank 0 runs on its local
        shards, and every collective's operands.

Per-device FLOPs.  ``FlopCounterMode`` counts a DTensor op once, at its
global shape (a matmul sharded over a (16,16) mesh reports the global
2·M·N·K), the ops of the explicit local blocks (the vocab-sharded loss
and embedding, the MoE blocks, the attention, MLA, Mamba and flash
blocks of ``pspec.local_call``) at their local
shapes, and also the ops DTensor runs on fake tensors to propagate
shapes the first time it meets an op: its total is neither global nor
per device, and is reported as ``flop_counter_total`` only.  The
roofline's ``flops_per_dev`` is the recorder's sum, over the ops rank 0
runs on its local shards, of the same formulas
(``torch.utils.flop_counter.flop_registry``): replicated work is counted
on each rank as it runs there.  On a 1x1 mesh it is the step's FLOPs, and
equals a ``FlopCounterMode`` count of the unsharded step.
``bytes_per_dev`` sums the operand and output bytes of every op that is
not a view; collective bytes, the operands of each collective.

Memory: ``peak_bytes_per_dev`` is the tracker's peak, arguments (state
and batch, tracked from the start) included; ``argument_bytes_per_dev``
the local bytes of the step's inputs; ``temp_bytes_per_dev`` the rest;
the train step updates its state in place, and the serve step its cache,
so the output aliases those arguments (``alias_bytes_per_dev``), as JAX's
donated state and cache do.

``cost_method`` is always ``"full"``: the port's layers are a Python loop
that every recorder sees whole, so nothing is unrolled or extrapolated
(the JAX package's two-point depth extrapolation and its rolled/unrolled
compile pair have no counterpart; ``compile_s`` is the traced step's
seconds, ``compile_rolled_s`` 0).  One cell's error is recorded against
it and the sweep goes on.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2-7b --shape train_4k \\
        --mesh-shape 4x1 --batch 4 --seq 2048 --optimizer float32

``--mesh-shape dxm`` replaces the production meshes by one (data, model)
mesh, and ``--mesh-shape none`` by one device without a mesh (the
unsharded step, as one card runs it: no process group, no DTensor);
``--layers``, ``--batch``, ``--seq``, ``--optimizer`` (the default
``int8`` moments, or the train driver's ``float32``) and ``--microbatches``
(default: ``microbatches_for``'s count, from the JAX package's 2 GiB
activation budget) size a cell as ``chip_smoke.py``'s one-card runs are
sized; ``--attn-impl pallas_flash`` runs the flash path (its fake
implementation on meta tensors, ``kernels/flash_attn/ops.py``) where the
config's default is ``xla``.

Decode cells (``--shape decode_32k``, ``long_500k``) run ``serve_step``
against a cache placed by ``sharding.cache_specs`` and written in place.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import LONG_CTX_ARCHS, SHAPES, cells_for

__all__ = ["MESHES", "main", "run_cell", "run_cell_process"]

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh_of(mesh_kind: str):
    if mesh_kind in MESHES:
        return MESHES[mesh_kind]
    if mesh_kind == "none":
        return (), ()
    d, m = (int(x) for x in mesh_kind.split("x"))
    return (d, m), ("data", "model")


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _tensors(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        total += t.numel() * t.element_size()
    return total


def _tensors(tree) -> list:
    """Every tensor of a step's arguments: a train state's parameters and
    moments, batches, caches."""
    from repro_torch.launch.steps import TrainState

    if isinstance(tree, TrainState):
        return (list(tree.params.parameters()) + _tensors(tree.opt["m"])
                + _tensors(tree.opt["v"]) + [tree.opt["count"], tree.step])
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def run_cell(arch: str, shape: str, mesh_kind: str, *, reduced: bool = False,
             layers: int | None = None, batch: int | None = None, seq: int | None = None,
             optimizer: str = "int8", microbatches: int | None = None,
             attn_impl: str | None = None) -> dict:
    """One cell in this process: starts the ``fake`` backend at the mesh's
    size (a process holds one cell: the backend cannot be restarted at
    another size in the same process reliably) and returns its JSON."""
    import torch.distributed as dist
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import roofline as rf
    from repro_torch.launch.mesh import AbstractMesh, make_mesh
    from repro_torch.launch.specs import (
        input_specs,
        microbatches_for,
        scaled_cfg,
        step_fn_for,
    )
    from repro_torch.launch.trace_tools import Recorder, collective_sites, top_tensors
    from repro_torch.models.pspec import activation_mesh
    from repro_torch.optim.adamw import adamw

    mesh_shape, axes = _mesh_of(mesh_kind)
    n_dev = math.prod(mesh_shape)
    mesh = None
    if mesh_shape:
        if not dist.is_initialized():
            dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_dev)
        mesh = make_mesh(mesh_shape, axes, device="cpu")
    cfg = get_config(arch, reduced=reduced)
    if layers:
        cfg = scaled_cfg(cfg, layers)
    if attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    opt = (adamw(lr=3e-4, weight_decay=0.1, quantize_moments=True) if optimizer == "int8"
           else adamw(lr=3e-4, weight_decay=0.1, quantize_moments=False))
    spec = input_specs(arch, shape, reduced=reduced, cfg_override=cfg, mesh=mesh,
                       optimizer=opt, batch=batch, seq=seq)
    kind, args = spec["kind"], spec["args"]
    sh = SHAPES[shape]
    b = args[-1].shape[0] if kind == "decode" else args[1]["tokens"].shape[0]
    s = sh.seq_len if kind == "decode" else args[1]["tokens"].shape[1]
    mu = microbatches or microbatches_for(kind, cfg, b, s,
                                          mesh or AbstractMesh((1, 1), ("data", "model")))
    step = step_fn_for(kind, cfg, num_microbatches=mu, optimizer=opt)

    arg_bytes = _local_bytes(args)
    # what the step updates in place: a train state, a decode cache
    state_bytes = (_local_bytes(args[0]) if kind == "train"
                   else _local_bytes(args[1]) if kind == "decode" else 0)
    tracker = MemTracker()
    tracker.track_external(*[t.to_local() if isinstance(t, DTensor) else t
                             for t in _tensors(args)])
    rec = Recorder()
    flop_counter = FlopCounterMode(display=False)
    t0 = time.time()
    grad = torch.enable_grad() if kind == "train" else torch.no_grad()
    with grad, activation_mesh(mesh), tracker, flop_counter, rec:
        out = step(*args)
    seconds = time.time() - t0
    snap = tracker.get_tracker_snapshot("peak")
    peak = sum(v.get("Total", 0) for v in snap.values())
    by_category: dict[str, int] = {}
    for per_device in snap.values():
        for k, v in per_device.items():
            name = getattr(k, "value", k)
            by_category[name] = by_category.get(name, 0) + int(v)
    out_bytes = state_bytes if kind == "train" else _local_bytes(out)
    del out

    counts = cfg.param_counts()
    tokens = b * (s if kind != "decode" else 1)
    mult = 3.0 if kind == "train" else 1.0  # fwd+bwd
    report = rf.roofline_from_terms(
        float(rec.flops), float(rec.bytes), rf.collective_bytes(rec),
        model_flops_global=2.0 * counts["active"] * tokens * mult, num_devices=n_dev)
    return {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "kind": kind, "devices": n_dev,
        "mesh_shape": list(mesh_shape), "layers": cfg.num_layers, "batch": b, "seq": s,
        "attn_impl": cfg.attn_impl,
        "optimizer": optimizer, "microbatches": mu, "cost_method": "full",
        "compile_s": round(seconds, 1), "compile_rolled_s": 0.0,
        "memory": {
            "argument_bytes_per_dev": int(arg_bytes),
            "output_bytes_per_dev": int(out_bytes),
            "temp_bytes_per_dev": int(max(0, peak - arg_bytes)),
            "alias_bytes_per_dev": int(state_bytes),
            "peak_bytes_per_dev": int(peak),
            "peak_by_category": by_category,
        },
        "roofline": report.to_json(),
        "flop_counter_total": int(flop_counter.get_total_flops()),
        "ops": rec.ops,
        "top_tensors": top_tensors(rec, 8),
        "collective_sites": collective_sites(rec, 8),
    }


def run_cell_process(arch: str, shape: str, mesh_kind: str, *, timeout: float = 3600,
                     **kw) -> dict:
    """``run_cell`` in a child interpreter (its own ``fake`` world); its
    error, or its exit without a result, comes back as ``{"error": ...}``
    naming the cell."""
    opts = []
    for key in ("layers", "batch", "seq", "microbatches", "attn_impl"):
        if kw.get(key):
            opts += [f"--{key.replace('_', '-')}", str(kw[key])]
    if kw.get("reduced"):
        opts.append("--reduced")
    opts += ["--optimizer", kw.get("optimizer", "int8")]
    cell = f"{arch}|{shape}|{mesh_kind}"
    with tempfile.TemporaryDirectory(prefix="repro_torch_dryrun_") as d:
        out = Path(d) / "cell.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--one", "--arch", arch,
               "--shape", shape,
               "--mesh" if mesh_kind in ("single", "multi") else "--mesh-shape", mesh_kind,
               "--out", str(out), *opts]
        env = dict(os.environ)
        src = str(Path(__file__).resolve().parents[2])  # the port's package root
        env["PYTHONPATH"] = os.pathsep.join(p for p in (src, env.get("PYTHONPATH")) if p)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)
        except subprocess.TimeoutExpired:
            return {"error": f"{cell}: no result within {timeout} s"}
        if proc.returncode != 0 or not out.exists():
            tail = (proc.stderr or proc.stdout).strip().splitlines()[-3:]
            return {"error": f"{cell}: exit {proc.returncode}: {' | '.join(tail)}"}
        return json.loads(out.read_text())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list_archs() + ["all"], default="all")
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"], default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--mesh-shape", default="",
                    help="dxm: one (data, model) mesh instead; none: one device, no mesh")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke variant (small dims) — for CI only")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this many layers")
    ap.add_argument("--batch", type=int, default=0, help="global batch (default: the cell's)")
    ap.add_argument("--seq", type=int, default=0, help="sequence (default: the cell's)")
    ap.add_argument("--optimizer", choices=["int8", "float32"], default="int8")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="gradient-accumulation count (default: microbatches_for's)")
    ap.add_argument("--attn-impl", choices=["xla", "pallas_flash"], default="",
                    help="attention path (default: the config's, xla)")
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    kw = dict(reduced=args.reduced, layers=args.layers or None, batch=args.batch or None,
              seq=args.seq or None, optimizer=args.optimizer,
              microbatches=args.microbatches or None, attn_impl=args.attn_impl or None)

    if args.one:  # the child: one cell, its JSON to --out
        cell = run_cell(args.arch, args.shape, args.mesh_shape or args.mesh, **kw)
        Path(args.out).write_text(json.dumps(cell))
        return

    archs = list_archs() if args.arch == "all" else [args.arch]
    meshes = ([args.mesh_shape] if args.mesh_shape
              else ["single", "multi"] if args.mesh == "both" else [args.mesh])
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = json.loads(out_path.read_text()) if out_path.exists() else {}

    for arch in archs:
        shapes = [s for _, s in cells_for(arch)] if args.shape == "all" else [args.shape]
        for shape in shapes:
            if shape == "long_500k" and arch not in LONG_CTX_ARCHS:
                print(f"SKIP {arch} x {shape} (full attention)")
                results[f"{arch}|{shape}|-"] = {"skip": True}
                continue
            for mesh_kind in meshes:
                key = f"{arch}|{shape}|{mesh_kind}"
                if results.get(key) and not results[key].get("error"):
                    print(f"CACHED {key}")
                    continue
                print(f"RUN {key} ...", flush=True)
                try:
                    cell = run_cell_process(arch, shape, mesh_kind, **kw)
                except Exception as e:  # noqa: BLE001 - one cell never stops the sweep
                    traceback.print_exc()
                    cell = {"error": f"{key}: {type(e).__name__}: {e}"}
                results[key] = cell
                if "error" in cell:
                    print(f"  error: {cell['error']}", flush=True)
                else:
                    r = cell["roofline"]
                    print(
                        f"  ok: {cell['compile_s']}s "
                        f"peak={cell['memory']['peak_bytes_per_dev']/2**30:.2f}GiB/dev "
                        f"compute={r['compute_s']*1e3:.2f}ms "
                        f"memory={r['memory_s']*1e3:.2f}ms "
                        f"coll={r['collective_s']*1e3:.2f}ms "
                        f"dom={r['dominant']}",
                        flush=True,
                    )
                out_path.write_text(json.dumps(results, indent=1))
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
