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

On a mesh (a state of DTensors) every rank calls ``save_checkpoint``: the
leaves are gathered whole (``full_tensor()``) one at a time, rank 0 streams
each into the archive as it comes and the other ranks drop it at once, so
no rank holds more than one whole leaf; the files are the same, written
atomically as above, and every rank waits at a barrier until they are
there.  ``restore_checkpoint(..., placements=)`` is the counterpart of the
JAX package's ``shardings=``: every rank reads one leaf at a time on the
host, keeps only its own chunk of the placements it is given
(``launch/steps.train_state_placements`` of any mesh) and moves that chunk
to its device, into the template's model.  So a checkpoint written on one
mesh restores on another, on one device, and in the JAX package, and a
state larger than one device restores onto a mesh that holds it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.convert import _jax_tree, _state_tree, train_state_from_numpy, whole_tensor
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


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as the archive stores it (bfloat16 as its uint16 bits)."""
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


def _gathered(leaf) -> torch.Tensor:
    """One leaf of ``_state_tree(state, detach, tuple)`` whole on the host: a
    tensor, or a (nested) tuple of per-layer tensors stacked layer-leading.
    On a mesh every rank must call it, leaf for leaf in the same order."""
    if isinstance(leaf, tuple):
        return torch.stack([_gathered(x) for x in leaf])
    return whole_tensor(leaf).cpu()


def save_checkpoint(
    directory: str | Path,
    step: int,
    state: TrainState,
    *,
    extra: Optional[dict] = None,
    keep_last: int = 3,
) -> Path:
    directory = Path(directory)
    leaves = list(_flatten(_state_tree(state, lambda t: t.detach(), stack=tuple)))
    final = directory / f"step_{step:08d}"
    if _rank() != 0:
        for _, leaf in leaves:  # take part in each gather, keep nothing
            _gathered(leaf)
        _barrier()
        return final
    directory.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_"))
    try:
        shapes = {}
        # the layout np.savez writes, one member per leaf as it is gathered
        with zipfile.ZipFile(tmp / "arrays.npz", "w", zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for key, leaf in leaves:
                t = _gathered(leaf)
                shapes[key] = {"shape": list(t.shape), "dtype": _dtype_name(t)}
                with zf.open(f"{key}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, _host_array(t), allow_pickle=False)
                del t
        manifest = {"step": step, "leaves": shapes, "extra": extra or {}}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(directory, keep_last)
    _barrier()
    return final


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


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


def _saved_tensor(arr: np.ndarray, saved_dtype: str) -> torch.Tensor:
    if saved_dtype == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(
    directory: str | Path,
    step: int,
    template: TrainState,
    *,
    device: Optional[str | torch.device] = None,
    placements: Optional[dict] = None,
) -> tuple[TrainState, dict]:
    """Restore into ``template``'s structure (its config, leaf paths, shapes
    and dtypes; a missing leaf raises ``KeyError``, a shape ``ValueError``)
    on ``device`` (default: the template's), or, given ``placements``
    (``steps.train_state_placements`` on the mesh to restore onto), as
    DTensors in the template's own model, each rank reading only its
    chunks (see the module docstring)."""
    path = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    saved = manifest["leaves"]
    if placements is not None:
        with np.load(path / "arrays.npz") as npz:
            return _restore_placed(npz, saved, template, placements), manifest.get("extra", {})
    with np.load(path / "arrays.npz") as npz:
        flat = {k: npz[k] for k in npz.files}

    out = {}
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")  # noqa: E731
    for key, tmpl in _flatten(_state_tree(template, meta)):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = _saved_tensor(flat[key], saved.get(key, {}).get("dtype", ""))
        _check_shape(key, t, tmpl)
        out[key] = t.to(tmpl.dtype)
    state = train_state_from_numpy(template.params.cfg, _unflatten(out),
                                   device=device if device is not None else template.params.device)
    return state, manifest.get("extra", {})


def _check_shape(key: str, t: torch.Tensor, tmpl: torch.Tensor) -> None:
    if tuple(t.shape) != tuple(tmpl.shape):
        raise ValueError(
            f"leaf {key!r}: checkpoint shape {tuple(t.shape)} != template {tuple(tmpl.shape)}")


def _restore_placed(npz, saved: dict, template: TrainState, placements: dict) -> TrainState:
    """The checkpoint's leaves as DTensors placed by ``placements``, read one
    stacked leaf at a time, each rank keeping its own chunk of each layer."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.models.sharding import replace_parameters

    mesh = placements["mesh"]
    model = template.params
    dev = next(_local_device(p) for p in model.parameters())
    named = dict(model.named_parameters())
    like = {"params": named, "m": template.opt["m"], "v": template.opt["v"]}
    # each JAX leaf path -> the (part, port name) it holds, in tuples (nested
    # for the hybrid's groups) where JAX stacks layers
    names = {"params": _jax_tree(((n, _Ref("params", n)) for n in named), tuple),
             "opt": {part: _jax_tree(((n, _Ref(part, n)) for n in named), tuple)
                     for part in ("m", "v")}}
    out: dict = {"params": {}, "m": {}, "v": {}}

    def local_chunk(t: torch.Tensor, pl) -> torch.Tensor:
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                t = torch.chunk(t, mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
        return t

    def place(arr: torch.Tensor, ref, key: str) -> None:
        if isinstance(ref, tuple):  # a stacked layer dim
            for j, r in enumerate(ref):
                place(arr[j], r, key)
            return
        tmpl = like[ref.part][ref.name]
        _check_shape(f"{key} ({ref.name})", arr, tmpl)
        pl = placements[ref.part][ref.name]
        chunk = local_chunk(arr, pl)  # a fresh buffer: nothing keeps the whole leaf
        loc = torch.empty(chunk.shape, dtype=tmpl.dtype, device=dev).copy_(chunk)
        out[ref.part][ref.name] = DTensor.from_local(
            loc, mesh, pl, run_check=False, shape=arr.shape, stride=_contiguous(arr.shape))

    for key, ref in _flatten(names):
        if key not in npz.files:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        place(_saved_tensor(npz[key], saved.get(key, {}).get("dtype", "")), ref, key)
    replace_parameters(model, lambda name, p: out["params"][name])
    count = _saved_tensor(npz["opt/count"], "").to(template.opt["count"].device)
    step = _saved_tensor(npz["step"], "").to(template.step.device)
    return TrainState(model, {"count": count, "m": out["m"], "v": out["v"]}, step)


@dataclasses.dataclass(frozen=True)
class _Ref:
    part: str  # "params", "m" or "v"
    name: str  # the port's parameter name


def _local_device(t: torch.Tensor) -> torch.device:
    """The device a tensor's data lies on (a DTensor's local shard's)."""
    from torch.distributed.tensor import DTensor

    return t.to_local().device if isinstance(t, DTensor) else t.device


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


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

    def restore_latest(self, template: TrainState, *, device=None, placements=None):
        step = latest_step(self.directory)
        if step is None:
            return None, None, None
        state, extra = restore_checkpoint(self.directory, step, template, device=device,
                                          placements=placements)
        return step, state, extra
