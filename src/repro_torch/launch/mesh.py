"""Production mesh construction: the JAX package's ``launch/mesh.py`` over
``torch.distributed``.

One rank is one process on one device.  A JAX mesh becomes a ``DeviceMesh``
over the process group, with the same axis names:

  pod   — one pod per index; the feature store's "region" axis
          (geo-replication = replicate over pod; cross-region access =
          collectives over pod).
  data  — data parallel + FSDP parameter sharding within a pod.
  model — tensor/expert parallel.

Elastic scaling: any (pod, data, model) factorization is accepted; sharding
rules reference axis NAMES only, and checkpoints reshard on load.  A mesh
is never shrunk to fit: ``make_mesh`` raises when the world size is not the
mesh's size.  On cards, ``torchrun`` starts the ranks (NCCL); the tests and
``chip_smoke.py`` start them with ``run_ranks``, which initialises every
rank from a ``file://`` store in a fresh temporary directory (no TCP port,
so concurrent test workers cannot collide).

``AbstractMesh`` is a mesh's shape without devices or a process group
(``jax.sharding.AbstractMesh``'s counterpart): the sharding rules take
either, so the spec tables of a 512-device mesh are computed in any
process.
"""

from __future__ import annotations

import contextlib
import math
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

__all__ = ["AbstractMesh", "axis_names", "axis_size", "batch_axes", "make_mesh",
           "make_production_mesh", "mesh_shape", "process_group", "run_ranks"]


class AbstractMesh:
    """Axis names and sizes of a mesh, nothing else."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]) -> None:
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} differ in rank")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def ndim(self) -> int:
        return len(self.axis_names)

    def size(self, mesh_dim: int | None = None) -> int:
        """The mesh's size, or one dim's (``DeviceMesh.size``'s contract)."""
        if mesh_dim is None:
            return math.prod(self.shape.values())
        return self.shape[self.axis_names[mesh_dim]]

    def __repr__(self) -> str:
        return f"AbstractMesh({tuple(self.shape.values())}, {self.axis_names})"


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device: str | torch.device = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    process group, each rank on its own ``device`` (``"cuda"``: the card of
    the rank's ``LOCAL_RANK``, or the current one).  Raises when no process
    group is up or its world size is not the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torchrun, or run_ranks)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs {math.prod(shape)} ranks, "
                         f"the world has {world}")
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh was requested but no CUDA device is available; "
                               "pass device='cpu' to run on the host")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", torch.cuda.current_device())))
    elif dev_type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return init_device_mesh(dev_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str | torch.device = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes that carry the global batch (everything except 'model')."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def axis_size(mesh, *names: str) -> int:
    shape = mesh_shape(mesh)
    out = 1
    for n in names:
        if n in shape:
            out *= shape[n]
    return out


# -----------------------------------------------------------------------------
# starting ranks
# -----------------------------------------------------------------------------
@contextlib.contextmanager
def process_group(backend: str, rank: int, world_size: int, store_dir: str):
    """The default process group of ``world_size`` ranks for the duration of
    the block, initialised from ``<store_dir>/store``; destroyed on exit."""
    dist.init_process_group(backend, init_method=f"file://{os.path.join(store_dir, 'store')}",
                            rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(fn, rank, world_size, backend, store_dir, args, out) -> None:
    try:
        torch.set_num_threads(1)
        with process_group(backend, rank, world_size, store_dir):
            result = fn(rank, *args)
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 - the parent re-raises it
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable[..., Any], world_size: int, *, args: tuple = (),
              backend: str = "gloo", timeout: float = 120.0) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` fresh processes (the
    ``spawn`` start method: ``fn`` must be importable), each inside
    ``process_group``; return their results in rank order.  Every rank is
    joined within ``timeout`` seconds in all; a rank that raised re-raises
    here with its traceback (the lowest such rank's), and a rank still
    running at the limit is killed and reported."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as store_dir:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, backend, store_dir, args, out),
                             daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        results: dict[int, tuple[bool, Any]] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    rank, ok, value = out.get(timeout=min(remaining, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} died with exit code "
                                           f"{procs[dead[0]].exitcode} and no report")
                    continue
                results[rank] = (ok, value)
                if not ok:
                    break
        finally:
            for p in procs:
                p.join(timeout=max(0.0, min(5.0, deadline - time.monotonic())))
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    failed = sorted(r for r, (ok, _) in results.items() if not ok)
    if failed:
        raise RuntimeError(f"rank {failed[0]} of {world_size} failed:\n{results[failed[0]][1]}")
    if len(results) < world_size:
        missing = sorted(set(range(world_size)) - set(results))
        raise TimeoutError(f"ranks {missing} of {world_size} did not finish in {timeout} s")
    return [results[r][1] for r in range(world_size)]
