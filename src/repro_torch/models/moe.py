"""Mixture-of-Experts FFN: sort-based (dropping) dispatch on one device.

The JAX package's ``models/moe.py`` on tensors.  Dispatch never
materializes the GShard (G, S, E, C) one-hot products.  Instead:

  1. argsort the (token, k)-assignments by expert id (stable: earlier
     tokens keep priority, then lower choice rank, matching GShard's cumsum
     drop policy),
  2. rank within expert via a per-row searchsorted; rank >= capacity drops,
  3. scatter tokens into the (G, E·C + 1, D) expert buffer (k scatters of
     (G, S, D); the last row is the overflow sentinel every dropped
     assignment writes, sliced off),
  4. batched expert FFN einsum,
  5. combine: k gathers (a zero row stands in for the sentinel) weighted by
     the renormalized router gates.

Router: softmax -> top-k -> renormalize among the chosen (deepseek V2
convention), with the switch-style load-balance auxiliary loss.  Nothing in
``moe_apply`` synchronizes the host with the card: the aux loss counts each
expert's top-1 tokens with ``scatter_add_``, not ``bincount``.

Under a mesh (``models/pspec.py``; the parameters and ``x`` DTensors)
``moe_apply`` takes the JAX package's gate (the same five conditions):

  * ``_moe_ep``, the expert-parallel block, when the mesh has a ``model``
    axis of size > 1 that divides E and each rank holds >= 64 of the
    tokens.  Tokens are sharded over every mesh axis and each rank routes
    its own groups (``gs`` snapped to a divisor of the local token count);
    the dispatch is local; an ``all_to_all_single`` over the ``model``
    group on the expert dim sends each expert's slots to the rank that owns
    it (expert weights ``Shard(0)`` over ``model``); that rank runs the FFN
    on its E/ep experts; the all-to-all back and the local combine follow.
    The all-to-alls are the autograd-aware functional collectives, so the
    gradient returns through both.  ``aux`` is each rank's aux averaged
    over all ranks (JAX's ``pmean``).  The block is the JAX ``shard_map``
    body on local tensors: ``to_local`` in, ``from_local`` out.
  * otherwise ``_moe_local``, the JAX GSPMD path's counterpart: the groups
    sharded over the batch axes, the weights gathered whole, each rank
    routing and dispatching its own groups, and the aux loss of the global
    means (each expert's mean probability and top-1 share summed over the
    ranks before their product), as GSPMD computes it.

On one rank of a 1x1 mesh ``_moe_ep`` runs the ops of the one-device path
on the same groups (the all-to-alls move nothing), so its output and
gradient are those of ``moe_apply`` bit for bit.

``moe_apply_einsum`` keeps the textbook GShard einsum formulation as the
oracle of the tests and of ``chip_smoke.py``; no model path calls it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import axis_names, mesh_shape
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamModule, dense_init, torch_dtype
from repro_torch.models.pspec import (BATCH, constrain, current_mesh,
                                      weight_grad_placements)

__all__ = ["MoE", "moe_apply", "moe_apply_einsum", "moe_init"]


def moe_init(gen, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
             device: Optional[torch.device] = None) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts

    def init(shape, **kw):
        return dense_init(gen, shape, device=device, **kw)

    p = {
        "router": init((d, e), dtype=torch.float32),  # float32 whatever param_dtype is
        "w_gate": init((e, d, f), fan_in=d, dtype=dtype),
        "w_up": init((e, d, f), fan_in=d, dtype=dtype),
        "w_down": init((e, f, d), fan_in=f, dtype=dtype),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": init((d, fs), dtype=dtype),
            "w_up": init((d, fs), dtype=dtype),
            "w_down": init((fs, d), fan_in=fs, dtype=dtype),
        }
    return p


class MoE(ParamModule):
    """One MoE FFN: ``router`` (D, E) in float32, the expert stacks
    ``w_gate``/``w_up`` (E, D, F) and ``w_down`` (E, F, D), and with shared
    experts a ``shared`` child holding ``w_gate``/``w_up``/``w_down`` at
    F·num_shared_experts."""

    def __init__(self, gen, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: Optional[torch.device] = None) -> None:
        p = moe_init(gen, cfg, dtype, device)
        shared = p.pop("shared", None)
        super().__init__(p)
        if shared is not None:
            self.shared = ParamModule(shared)


def _capacity(cfg: ModelConfig, group_size: int, capacity_factor: float) -> int:
    c = int(group_size * cfg.top_k / cfg.num_experts * capacity_factor)
    return max(8, (c + 7) // 8 * 8)  # 8-aligned, as in the JAX package


def _group(x: torch.Tensor, group_size: int) -> torch.Tensor:
    b, s, d = x.shape
    tokens = b * s
    gs = min(group_size, tokens)
    while tokens % gs:  # snap to the largest divisor (e.g. MTP's B*(S-1))
        gs -= 1
    return x.reshape(tokens // gs, gs, d)


def _route(params, xg: torch.Tensor,
           cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router probs -> (gate_k, idx_k (G,S,k) int64, aux_loss).  float32."""
    gate_k, idx_k, me, ce = _route_parts(params, xg, cfg)
    return gate_k, idx_k, _aux(me, ce, cfg)


def _aux(me: torch.Tensor, ce: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The switch load-balance loss E * sum_e f_e * p_e."""
    return cfg.router_aux_coef * cfg.num_experts * torch.sum(me * ce)


def _route_parts(params, xg: torch.Tensor, cfg: ModelConfig):
    """(gate_k, idx_k, each expert's mean probability, each expert's top-1
    share) of the groups ``xg``."""
    g, gs, _ = xg.shape
    e, k = cfg.num_experts, cfg.top_k
    logits = xg.float() @ params["router"]                       # (G,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_k, idx_k = torch.topk(probs, k, dim=-1)                 # (G,S,k)
    gate_k = gate_k / torch.clamp(gate_k.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux (switch): E * sum_e f_e * p_e.  f_e counts each
    # expert's top-1 tokens (an indicator: no gradient path, as standard)
    me = probs.mean(dim=(0, 1))                                  # (E,)
    top1 = idx_k[..., 0].reshape(-1)
    counts = torch.zeros(e, dtype=torch.float32, device=xg.device)
    counts.scatter_add_(0, top1, torch.ones_like(top1, dtype=torch.float32))
    return gate_k, idx_k, me, counts / float(g * gs)


def _dispatch_indices(idx_k: torch.Tensor, e: int,
                      cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(G,S,k) expert ids -> (dst (G,S,k) int32 slot in [0, E·cap],
    keep (G,S,k) bool).

    dst == E·cap is the overflow sentinel (dropped assignment); all kept
    dst values are unique within a group by construction.
    """
    g, gs, k = idx_k.shape
    flat = idx_k.reshape(g, gs * k).long()
    order = torch.argsort(flat, dim=1, stable=True)              # (G,S*k)
    e_sorted = torch.gather(flat, 1, order)
    # first sorted position of each expert -> rank within expert
    experts = torch.arange(e, device=idx_k.device).expand(g, e).contiguous()
    starts = torch.searchsorted(e_sorted, experts)               # (G,E)
    rank = torch.arange(gs * k, device=idx_k.device)[None, :] - torch.gather(
        starts, 1, e_sorted)                                     # (G,S*k)
    keep_sorted = rank < cap
    dst_sorted = torch.where(keep_sorted, e_sorted * cap + rank, e * cap)
    # unsort back to (s, k) layout
    dst = torch.zeros((g, gs * k), dtype=torch.int32, device=idx_k.device).scatter_(
        1, order, dst_sorted.to(torch.int32))
    keep = torch.zeros((g, gs * k), dtype=torch.bool, device=idx_k.device).scatter_(
        1, order, keep_sorted)
    return dst.reshape(g, gs, k), keep.reshape(g, gs, k)


def _expert_ffn(xe: torch.Tensor, params) -> torch.Tensor:
    """xe (..., E, C, D) x expert-stacked weights -> (..., E, C, D)."""
    hgate = F.silu(torch.einsum("...ecd,edf->...ecf", xe, params["w_gate"]))
    hup = torch.einsum("...ecd,edf->...ecf", xe, params["w_up"])
    return torch.einsum("...ecf,efd->...ecd", hgate * hup, params["w_down"])


def _dispatch_ffn_combine_local(params, xg: torch.Tensor, gate_k: torch.Tensor,
                                idx_k: torch.Tensor, cfg: ModelConfig,
                                cap: int) -> torch.Tensor:
    """Steps 3-5 on the groups: scatter, expert FFN, gather and combine."""
    xe, rows, gate_k = _dispatch(xg, gate_k, idx_k, cfg, cap)
    return _combine(_expert_ffn(xe, params), rows, gate_k, cfg)


def _dispatch(xg: torch.Tensor, gate_k: torch.Tensor, idx_k: torch.Tensor,
              cfg: ModelConfig, cap: int):
    """Step 3: (the expert buffer (G, E, C, D), the slot rows (G,S,k,D) of
    each assignment, the gates with the dropped assignments zeroed)."""
    g, gs, d = xg.shape
    e, k = cfg.num_experts, cfg.top_k
    cdt = torch_dtype(cfg.compute_dtype)

    dst, keep = _dispatch_indices(idx_k, e, cap)
    gate_k = gate_k * keep.to(gate_k.dtype)                      # drop overflow
    rows = dst.long()[..., None].expand(g, gs, k, d)             # (G,S,k,D) view

    xe_flat = torch.zeros((g, e * cap + 1, d), dtype=cdt, device=xg.device)
    xgc = xg.to(cdt)
    for j in range(k):
        xe_flat.scatter_(1, rows[:, :, j], xgc)
    return xe_flat[:, : e * cap].reshape(g, e, cap, d), rows, gate_k


def _combine(he: torch.Tensor, rows: torch.Tensor, gate_k: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """Step 5: each token's k expert outputs, weighted by its gates."""
    g, gs, k, d = rows.shape
    e, cap = he.shape[1], he.shape[2]
    cdt = torch_dtype(cfg.compute_dtype)
    he_flat = torch.cat([he.reshape(g, e * cap, d),
                         torch.zeros((g, 1, d), dtype=he.dtype, device=he.device)],
                         dim=1)
    y = torch.zeros((g, gs, d), dtype=cdt, device=he.device)
    for j in range(k):
        yj = torch.gather(he_flat, 1, rows[:, :, j])             # (G,S,D)
        y = y + yj * gate_k[:, :, j, None].to(cdt)
    return y


def _shared_experts(params, x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    sp = params["shared"]
    xc = x.to(cdt)
    hs = F.silu(xc @ sp["w_gate"]) * (xc @ sp["w_up"])
    return hs @ sp["w_down"]


# -----------------------------------------------------------------------------
# on a mesh: local blocks over DTensors
# -----------------------------------------------------------------------------
_ROUTED = ("w_gate", "w_up", "w_down")


def _local(t, mesh, placements: list, grad_placements: list) -> torch.Tensor:
    """``t`` redistributed to ``placements``, as its local tensor; the
    gradient of that local tensor has ``grad_placements``."""
    return t.redistribute(mesh, placements).to_local(grad_placements=grad_placements)


def _mean_over_ranks(local: torch.Tensor, mesh, token_pl: list):
    """The mean over the token-splitting mesh dims of a per-rank mean
    (every rank holds as many tokens), replicated: a DTensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    n = math.prod(mesh.size(i) for i, p in enumerate(token_pl) if p != Replicate())
    pl = [Replicate() if p == Replicate() else Partial() for p in token_pl]
    return DTensor.from_local(local / n, mesh, pl, run_check=False).redistribute(
        mesh, [Replicate()] * mesh.ndim)


def _moe_local(params, x, cfg: ModelConfig, mesh, group_size: int,
               capacity_factor: float):
    """The GSPMD path on a mesh: groups over the batch axes, the weights
    whole on every rank, local routing and dispatch, the aux loss of the
    global means."""
    from torch.distributed.tensor import DTensor, Replicate

    b, s, d = x.shape
    gs = _group(torch.empty((b, s, 0), device="meta"), group_size).shape[1]
    xg = constrain(_unflatten_tokens(x.reshape(b * s, d), mesh, b * s // gs, gs),
                   BATCH, None, None)
    cap = _capacity(cfg, gs, capacity_factor)
    pl = list(xg.placements)
    whole = [Replicate()] * mesh.ndim
    gpl = weight_grad_placements(pl, ())
    local = {n: _local(params[n], mesh, whole, gpl) for n in ("router", *_ROUTED)}
    xg_loc = xg.to_local()
    gate_k, idx_k, me, ce = _route_parts(local, xg_loc, cfg)
    y = _dispatch_ffn_combine_local(local, xg_loc, gate_k, idx_k, cfg, cap)
    aux = _aux(_mean_over_ranks(me, mesh, pl), _mean_over_ranks(ce, mesh, pl), cfg)
    y = DTensor.from_local(y.reshape(-1, d), mesh, pl, run_check=False)
    return constrain(_unflatten_tokens(y, mesh, b, s), BATCH, None, None), aux


def _unflatten_tokens(y, mesh, b: int, s: int):
    """(B·S, D) tokens sharded on dim 0 -> (B, S, D) (or groups: (G, gs,
    D)).  DTensor splits a sharded dim only into a leading dim the shards
    divide: otherwise the tokens are gathered first (GSPMD regathers there
    by itself)."""
    from torch.distributed.tensor import Replicate, Shard

    ranks = math.prod(mesh.size(i) for i, p in enumerate(y.placements) if p == Shard(0))
    if b % ranks:
        y = y.redistribute(mesh,
                           [Replicate() if p == Shard(0) else p for p in y.placements])
    return y.reshape(b, s, y.shape[-1])


def _moe_ep(params, x, cfg: ModelConfig, mesh, group_size: int, capacity_factor: float):
    """Expert parallelism: tokens sharded over every mesh axis, experts
    owned by ``model`` ranks, dispatch and return as explicit all-to-alls.
    Returns (y (B, S, D), aux): the routed experts only."""
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd,
        wait_tensor,
    )
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    b, s, d = x.shape
    e = cfg.num_experts
    names = axis_names(mesh)
    m_dim = names.index("model")
    ep = mesh.size(m_dim)
    tok_axes = tuple(names)        # (*batch axes, "model"), in the mesh's order
    x = constrain(x, BATCH, None, None)
    toks = constrain(x.reshape(b * s, d), tok_axes, None)
    t_loc = toks.shape[0] // mesh.size()
    gs = min(group_size, t_loc)
    while t_loc % gs:  # snap to the largest local divisor (odd token counts)
        gs -= 1
    cap = _capacity(cfg, gs, capacity_factor)

    tok_pl = list(toks.placements)
    router = _local(params["router"], mesh, [Replicate()] * mesh.ndim,
                    weight_grad_placements(tok_pl, ()))
    owned = [Shard(0) if i == m_dim else Replicate() for i in range(mesh.ndim)]
    w = {n: _local(params[n], mesh, owned, weight_grad_placements(tok_pl, (m_dim,)))
         for n in _ROUTED}
    group = mesh.get_group(m_dim)

    def a2a(t: torch.Tensor) -> torch.Tensor:
        return wait_tensor(
            all_to_all_single_autograd(t.contiguous(), None, None, group))

    xg = toks.to_local().reshape(-1, gs, d)                      # (G_loc,S,D)
    gate_k, idx_k, me, ce = _route_parts({"router": router}, xg, cfg)
    xe, rows, gate_k = _dispatch(xg, gate_k, idx_k, cfg, cap)    # (G_loc,E,C,D)
    g = xg.shape[0]
    # -> expert owners: (G_loc, E, C, D) -> (ep·G_loc, E/ep, C, D), source-major
    xe = a2a(xe.reshape(g, ep, e // ep, cap, d).transpose(0, 1))
    he = _expert_ffn(xe.reshape(ep * g, e // ep, cap, d), w)
    # <- back to token owners: expert block j from rank j
    he = a2a(he.reshape(ep, g, e // ep, cap, d)).transpose(0, 1).reshape(g, e, cap, d)
    y = _combine(he, rows, gate_k, cfg)
    aux = DTensor.from_local(_aux(me, ce, cfg) / mesh.size(), mesh,
                             [Partial()] * mesh.ndim, run_check=False
                             ).redistribute(mesh, [Replicate()] * mesh.ndim)
    y = DTensor.from_local(y.reshape(-1, d), mesh, tok_pl, run_check=False)
    y = constrain(y, tok_axes, None)
    return constrain(_unflatten_tokens(y, mesh, b, s), BATCH, None, None), aux


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig, *, group_size: int = 2048,
              capacity_factor: Optional[float] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux_loss scalar).  Tokens go to groups of
    ``group_size`` (snapped to a divisor of B·S); each expert takes at most
    the capacity of ``capacity_factor`` (default ``cfg.capacity_factor``)
    assignments a group and drops the rest."""
    if capacity_factor is None:
        capacity_factor = cfg.capacity_factor
    b, s, d = x.shape
    mesh = current_mesh()
    if mesh is not None:
        sizes = mesh_shape(mesh)
        use_ep = (
            sizes.get("model", 1) > 1
            and cfg.num_experts % sizes["model"] == 0
            and (b * s) % mesh.size() == 0
            and (b * s) // mesh.size() >= 64   # decode cells: payload too small for EP
        )
        run = _moe_ep if use_ep else _moe_local
        y, aux = run(params, x, cfg, mesh, group_size, capacity_factor)
    else:
        xg = _group(x, group_size)
        cap = _capacity(cfg, xg.shape[1], capacity_factor)
        gate_k, idx_k, aux = _route(params, xg, cfg)
        y = _dispatch_ffn_combine_local(params, xg, gate_k, idx_k, cfg, cap).reshape(
            b, s, d)

    # shared experts: dense on every token
    if "shared" in params:
        y = y + _shared_experts(params, x, torch_dtype(cfg.compute_dtype))
    return y.to(x.dtype), aux


# =============================================================================
# reference: textbook GShard einsum dispatch (test oracle; O(S^2·E·C) memory —
# never use on large cells)
# =============================================================================
def moe_apply_einsum(params, x: torch.Tensor, cfg: ModelConfig, *,
                     group_size: int = 2048, capacity_factor: float = 1.25
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    xg = _group(x, group_size)
    g, gs, _ = xg.shape
    cap = _capacity(cfg, gs, capacity_factor)

    gate_k, idx_k, aux = _route(params, xg, cfg)

    # capacity positions: cumulative count of each expert along (s, k) order
    oh = F.one_hot(idx_k, e).float()                             # (G,S,k,E)
    flat = oh.reshape(g, gs * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, gs, k, e)
    pos = torch.einsum("gske,gske->gsk", pos, oh)                # (G,S,k)
    keep = pos < cap
    gate_k = gate_k * keep.to(gate_k.dtype)

    # one-hot of the slot; a dropped position (>= cap) has none, as
    # jax.nn.one_hot gives out of range
    slots = torch.arange(cap, device=x.device, dtype=pos.dtype)
    pos_oh = (pos[..., None] == slots).float() * keep[..., None]
    dispatch = torch.einsum("gske,gskc->gsec", oh, pos_oh)       # 0/1
    combine = torch.einsum("gsk,gske,gskc->gsec", gate_k, oh, pos_oh)

    cdt = torch_dtype(cfg.compute_dtype)
    xe = torch.einsum("gsec,gsd->gecd", dispatch.to(cdt), xg.to(cdt))
    hgate = F.silu(torch.einsum("gecd,edf->gecf", xe, params["w_gate"]))
    hup = torch.einsum("gecd,edf->gecf", xe, params["w_up"])
    he = torch.einsum("gecf,efd->gecd", hgate * hup, params["w_down"])
    y = torch.einsum("gsec,gecd->gsd", combine.to(cdt), he)

    if "shared" in params:
        y = y + _shared_experts(params, xg, cdt)
    return y.reshape(b, s, d).to(x.dtype), aux
