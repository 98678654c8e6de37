"""Checkpoints of a ``TrainState`` in the JAX package's on-disk layout.

Layout per step:  <dir>/step_<N:08d>/
    manifest.json   — step, leaf paths/shapes/dtypes, extra state (data-plane
                      scheduler JSON, loader cursor)
    arrays.npz      — flattened "path/to/leaf" -> host array

The leaf paths are the JAX ``TrainState``'s (``params/tail/mixer/wq`` stacked
layer-leading, ``opt/count``, ``opt/m/...`` with ``q``/``scale`` when the
moments are quantized, ``step``), so a checkpoint written by either package
restores in the other.  As there:
  * atomic (tmp dir + ``os.replace``): a torn write never becomes "latest";
  * deterministic resume: restoring step N and running step N+1 gives the
    same state, bit for bit, as running on;
  * retention: ``keep_last`` bounds disk usage;
  * the data plane resumes too (scheduler state and loader clock ride in
    ``extra``), the paper's §3.1.2 "resume from where it left off".
bfloat16 is stored as a ``uint16`` view with its true dtype in the manifest.
The JAX package's ``shardings=`` (re-placing leaves on the current mesh)
becomes ``device=``: the port runs on one device.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.convert import _state_tree, train_state_from_numpy, train_state_tree
from repro_torch.launch.steps import TrainState

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint", "save_checkpoint"]

_SEP = "/"


def _flatten(tree, prefix: str = ""):
    """("path/to/leaf", tensor) over a nested dict/list tree."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _flatten(v, f"{prefix}{k}{_SEP}")
        else:
            yield f"{prefix}{k}", v


def _unflatten(flat: dict) -> dict:
    """The nested tree of "path/to/leaf" keys; a level whose keys are all
    digits (the prefix's blocks) becomes a list."""
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split(_SEP)
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(out)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def save_checkpoint(
    directory: str | Path,
    step: int,
    state: TrainState,
    *,
    extra: Optional[dict] = None,
    keep_last: int = 3,
) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat, dtypes = {}, {}
    for key, t in _flatten(train_state_tree(state)):
        dtypes[key] = _dtype_name(t)
        flat[key] = (t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16
                     else t.numpy())
    final = directory / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_"))
    try:
        np.savez(tmp / "arrays.npz", **flat)
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]} for k, v in flat.items()},
            "extra": extra or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(directory, keep_last)
    return final


def _gc(directory: Path, keep_last: int) -> None:
    steps = sorted(
        (p for p in directory.glob("step_*") if p.is_dir()),
        key=lambda p: int(p.name.split("_")[1]),
    )
    for p in steps[:-keep_last]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in directory.glob("step_*")
        if p.is_dir() and (p / "manifest.json").exists()
    ]
    return max(steps, default=None)


def restore_checkpoint(
    directory: str | Path,
    step: int,
    template: TrainState,
    *,
    device: Optional[str | torch.device] = None,
) -> tuple[TrainState, dict]:
    """Restore into ``template``'s structure (its config, leaf paths, shapes
    and dtypes; a missing leaf raises ``KeyError``, a shape ``ValueError``)
    on ``device`` (default: the template's)."""
    path = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as npz:
        flat = {k: npz[k] for k in npz.files}

    out = {}
    for key, tmpl in _flatten(_state_tree(template, lambda t: t.detach().to("meta"))):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        saved_dtype = manifest["leaves"].get(key, {}).get("dtype", "")
        if saved_dtype == "bfloat16" and arr.dtype == np.uint16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"leaf {key!r}: checkpoint shape {tuple(t.shape)} != template {tuple(tmpl.shape)}"
            )
        out[key] = t.to(tmpl.dtype)
    state = train_state_from_numpy(template.params.cfg, _unflatten(out),
                                   device=device if device is not None else template.params.device)
    return state, manifest.get("extra", {})


class CheckpointManager:
    """Convenience wrapper binding a directory + cadence + retention."""

    def __init__(self, directory: str | Path, *, every: int = 50, keep_last: int = 3):
        self.directory = Path(directory)
        self.every = every
        self.keep_last = keep_last

    def maybe_save(self, step: int, state: TrainState, extra: Optional[dict] = None):
        if step % self.every == 0 and step > 0:
            return save_checkpoint(
                self.directory, step, state, extra=extra, keep_last=self.keep_last
            )
        return None

    def restore_latest(self, template: TrainState, *, device=None):
        step = latest_step(self.directory)
        if step is None:
            return None, None, None
        state, extra = restore_checkpoint(self.directory, step, template, device=device)
        return step, state, extra
