"""Activation sharding constraints, context-scoped: the JAX package's
``models/pspec.py`` over DTensor.

With parameters sharded for FSDP (weight dims over ``data``) and TP (over
``model``), DTensor's propagation picks each op's output placement from its
inputs', which may leave activations sharded on the feature dim or
replicated across the batch axes.  Model code therefore pins activation
layouts at the JAX package's block boundaries with ``constrain(x, ...)``,
which ``redistribute``s a DTensor to the spec's placements (the counterpart
of ``with_sharding_constraint``).

The mesh is provided by the launcher through ``activation_mesh``, so model
code stays mesh-agnostic and runs unchanged with no mesh: then
``constrain`` and ``placed`` return their argument as it is.  The JAX
package keeps the mesh in a contextvar; here it is process-wide, because
autograd runs the backward of CUDA tensors (and so the recompute of each
checkpointed block) on a thread of its own, which a contextvar set by the
caller does not reach.

Convention: '__batch__' in a spec expands to every non-'model' mesh axis;
axis names absent from the active mesh drop to None; dims that don't divide
their shard count fall back to None, exactly as in the JAX package.

Tensors the model creates itself (positions, masks, rotary tables, zero
buffers) are plain tensors; under a mesh ``placed`` makes them DTensors
replicated over every mesh axis, so they combine with the sharded
activations (DTensor refuses to mix the two).

Some ops DTensor cannot place by itself, or places differently from one
torch release to the next (einsums that flatten a sharded dim, views of a
padded or sliced tensor): those blocks run on each rank's local shards
through ``local_call``, with the placements computed here
(``head_placements`` for attention, ``row_placements`` for per-row work)
and each replicated input's gradient declared a partial sum over the mesh
dims that split the rows (``weight_grad_placements``).  This is the
counterpart of a ``shard_map`` block; the block runs with no mesh active,
so the model code inside it sees plain tensors only.

Decoding writes into its caches in place, and on a mesh only a block over
local shards can do that: a cache passed to ``local_call`` with its own
placements comes in as its local tensor, the same storage, so a write into
it lands in the cache.  Any other placement makes ``redistribute`` build a
temporary copy, and the write is lost.  So is a write through DTensor's
``__setitem__`` into a cache whose sequence dim is sharded: it writes
nothing and raises nothing.  A decode block therefore takes each cache with
its own placements and what goes into it with ``seq_placements`` (the
cache's batch and head shards, the sequence whole); ``shard_of`` tells the
block which chunk of a sharded dim it holds, so only the owner of a slot
writes it.  Over a sequence split into chunks, attention joins the chunks'
softmax with ``split_softmax`` and ``sum_over`` (float32, as GSPMD joins a
sequence-parallel cache); ``gather_over`` gathers a dim split over a group.

The JAX module's ``unrolled_scans``/``scan_unroll`` are not ported: they
work around XLA's cost analysis counting a ``while`` body once, and the
port's layers are a Python loop, which every counter sees whole.
"""

from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["BATCH", "activation_mesh", "constrain", "current_mesh", "gather_over",
           "head_placements", "is_dtensor", "local_call", "placed", "resolve_spec",
           "row_placements", "seq_placements", "shard_of", "split_last", "split_softmax",
           "sum_over", "weight_grad_placements"]

BATCH = "__batch__"

_meshes: list = [None]  # the stack activation_mesh pushes onto; the last is current


def current_mesh():
    """The mesh the launcher scoped for activation sharding (None on one
    device without a mesh: model code must degrade gracefully)."""
    return _meshes[-1]


@contextlib.contextmanager
def activation_mesh(mesh):
    _meshes.append(mesh)
    try:
        yield
    finally:
        _meshes.pop()


def _resolve(entry, names: tuple[str, ...]):
    if entry is None:
        return None
    if entry == BATCH:
        axes = tuple(a for a in names if a != "model")
        return axes if axes else None
    if isinstance(entry, (tuple, list)):
        kept = tuple(a for a in entry if a in names)
        return kept if kept else None
    return entry if entry in names else None


def resolve_spec(shape, spec, mesh) -> tuple:
    """The spec ``constrain`` applies to a tensor of ``shape``: names
    resolved against ``mesh``, entries past the rank dropped, non-dividing
    dims None, padded with None to the rank."""
    from repro_torch.launch.mesh import axis_names, mesh_shape

    names, sizes = axis_names(mesh), mesh_shape(mesh)
    spec = tuple(spec)[: len(shape)]
    entries = []
    for dim, e in zip(shape, spec):
        r = _resolve(e, names)
        if r is not None:
            axes = (r,) if isinstance(r, str) else r
            size = math.prod(sizes[a] for a in axes)
            if dim % size != 0 or dim < size:
                r = None
        entries.append(r)
    return tuple(entries) + (None,) * (len(shape) - len(entries))


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """``x`` redistributed to ``spec``'s placements on the context mesh;
    ``x`` itself when no mesh is active."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import placements

    if not isinstance(x, DTensor):
        raise TypeError(f"constrain under a mesh takes a DTensor, got a {type(x).__name__} "
                        f"of shape {tuple(x.shape)}: place it first")
    want = placements(resolve_spec(x.shape, spec, mesh), mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh, want)


def placed(t: torch.Tensor) -> torch.Tensor:
    """A tensor the model made itself, as a DTensor replicated over every
    axis of the context mesh (it must be the same on every rank); ``t``
    itself when no mesh is active or it is a DTensor already."""
    mesh = current_mesh()
    if mesh is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def split_last(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(*shape)``, the last dim of ``x`` split into
    ``shape[-2:]`` (heads and head dim, or q8 blocks and their 128
    entries).  A DTensor's last dim sharded over more ranks than divide
    ``shape[-2]`` is gathered first: DTensor refuses a view that would
    split a shard (GSPMD pads or regathers there by itself)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(x, DTensor):
        mesh, last = x.device_mesh, Shard(x.ndim - 1)
        ranks = math.prod(mesh.size(i) for i, p in enumerate(x.placements) if p == last)
        if shape[-2] % ranks:
            x = x.redistribute(mesh, [Replicate() if p == last else p for p in x.placements])
    return x.reshape(*shape)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def row_placements(x, row_pl: list) -> list:
    """Placements of ``x`` for per-row work on rows placed by ``row_pl``:
    its ``Shard(0)`` entries, ``Replicate()`` elsewhere; ``x`` with a
    leading dim of 1 (a mask shared by the rows) is replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if x.shape[0] != 1 and p == Shard(0) else Replicate() for p in row_pl]


def head_placements(q, k) -> tuple[list, list]:
    """(q's, k's and v's) placements for attention on local shards: the
    batch (dim 0) may stay sharded, and the heads (dim 2) where q's and
    k's are sharded alike (a rank's q heads then map onto its own KV heads:
    on a ``model`` axis wider than the KV heads, q's heads are gathered);
    the sequence dims are gathered."""
    from torch.distributed.tensor import Replicate, Shard

    def keep(p, allowed) -> bool:
        return p == Replicate() or (isinstance(p, Shard) and p.dim in allowed)

    q_pl = [p if keep(p, (0, 2)) else Replicate() for p in q.placements]
    kv_pl = [p if keep(p, (2,)) else Replicate() for p in k.placements]
    kv_pl = [Shard(0) if qp == Shard(0) else kp for qp, kp in zip(q_pl, kv_pl)]
    q_pl = [Replicate() if qp == Shard(2) and kp != Shard(2) else qp
            for qp, kp in zip(q_pl, kv_pl)]
    kv_pl = [Replicate() if kp == Shard(2) and qp != Shard(2) else kp
             for qp, kp in zip(q_pl, kv_pl)]
    return q_pl, kv_pl


def weight_grad_placements(row_pl: list, owned=()) -> list:
    """The gradient placements of a tensor used whole (or by a block of its
    dim 0, on the mesh dims in ``owned``) by every rank on its own rows
    (``row_pl``): a partial sum over the mesh dims that split the rows,
    whole over those that replicate them."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return [Shard(0) if i in owned else Replicate() if p == Replicate() else Partial()
            for i, p in enumerate(row_pl)]


def seq_placements(cache, dims: dict) -> list:
    """The placements, for a decode block over ``cache`` (a DTensor), of a
    tensor whose dim ``dims[d]`` lines up with the cache's dim d: each
    ``Shard(d)`` of the cache with d in ``dims`` as ``Shard(dims[d])``,
    every other entry ``Replicate()``.  Leaving the cache's sequence dim
    out of ``dims`` keeps the new entry and the query whole over the
    ranks that split the sequence."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in cache.placements]


def shard_of(x, dim: int):
    """(process group, this rank's index, count) of the mesh dim that
    shards dim ``dim`` of the DTensor ``x``; None when no mesh dim of more
    than one rank does."""
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    found = [i for i, p in enumerate(x.placements) if p == Shard(dim) and mesh.size(i) > 1]
    if not found:
        return None
    if len(found) > 1:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is split over mesh dims {found}: "
                         "a decode block takes one")
    i = found[0]
    return mesh.get_group(i), mesh.get_local_rank(i), mesh.size(i)


def _reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(x, op, group))


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (``x`` when None)."""
    return x if group is None else _reduce(x, "sum", group)


def gather_over(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` joined along ``dim`` in rank order."""
    from torch.distributed import _functional_collectives as funcol

    # all_gather_single where the torch release has it (all_gather_tensor
    # is its older name, deprecated since)
    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    return funcol.wait_tensor(gather(x.contiguous(), dim, group))


def split_softmax(scores: torch.Tensor, group) -> torch.Tensor:
    """The softmax over the last dim of float32 ``scores`` when that dim is
    split in chunks over the ranks of ``group``, each rank holding its own:
    this rank's chunk of the weights.  The row max and then the sum of
    exp(score - max) are all-reduced, so the weights are the whole row's;
    the caller sums its weighted values over ``group`` (``sum_over``).
    With ``group`` None, ``torch.softmax``."""
    if group is None:
        return torch.softmax(scores, dim=-1)
    p = torch.exp(scores - _reduce(scores.amax(dim=-1, keepdim=True), "max", group))
    return p / _reduce(p.sum(dim=-1, keepdim=True), "sum", group)


def local_call(fn, args, in_placements, out_placements, grad_placements=None):
    """``fn(*local shards)`` as a DTensor of ``out_placements``: each DTensor
    of ``args`` redistributed to its entry of ``in_placements`` and taken
    as its local tensor, whose gradient has its entry of
    ``grad_placements`` (default: ``in_placements``); an entry of None
    passes its argument as it is.  Every sharded dim must divide evenly
    (``constrain`` and the sharding tables only shard such dims).  A
    DTensor given its own placements comes in as its local tensor, the
    same storage: ``fn`` writes into it in place."""
    from torch.distributed.tensor import DTensor

    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    grad_placements = grad_placements or in_placements
    local = [a if pl is None else
             a.redistribute(mesh, pl).to_local(grad_placements=gp)
             for a, pl, gp in zip(args, in_placements, grad_placements)]
    with activation_mesh(None):  # the block sees plain tensors only
        out = fn(*local)
    return DTensor.from_local(out, mesh, out_placements, run_check=False)
