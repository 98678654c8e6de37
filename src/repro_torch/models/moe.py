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

``moe_apply`` is the JAX package's single-device path (``_moe_gspmd``).  Its
expert-parallel path (``_moe_ep``: a ``shard_map`` block with all-to-alls
over the mesh's ``model`` axis) is mesh code that has one device here; it is
queued with ``sharding.py`` (ROADMAP queue 5).

``moe_apply_einsum`` keeps the textbook GShard einsum formulation as the
oracle of the tests and of ``chip_smoke.py``; no model path calls it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamModule, dense_init, torch_dtype

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
    ce = counts / float(g * gs)
    aux = cfg.router_aux_coef * e * torch.sum(me * ce)
    return gate_k, idx_k, aux


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
    xe = xe_flat[:, : e * cap].reshape(g, e, cap, d)

    he = _expert_ffn(xe, params)

    he_flat = torch.cat([he.reshape(g, e * cap, d),
                         torch.zeros((g, 1, d), dtype=he.dtype, device=he.device)], dim=1)
    y = torch.zeros((g, gs, d), dtype=cdt, device=xg.device)
    for j in range(k):
        yj = torch.gather(he_flat, 1, rows[:, :, j])             # (G,S,D)
        y = y + yj * gate_k[:, :, j, None].to(cdt)
    return y


def _shared_experts(params, x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    sp = params["shared"]
    xc = x.to(cdt)
    hs = F.silu(xc @ sp["w_gate"]) * (xc @ sp["w_up"])
    return hs @ sp["w_down"]


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig, *, group_size: int = 2048,
              capacity_factor: Optional[float] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux_loss scalar).  Tokens go to groups of
    ``group_size`` (snapped to a divisor of B·S); each expert takes at most
    the capacity of ``capacity_factor`` (default ``cfg.capacity_factor``)
    assignments a group and drops the rest."""
    if capacity_factor is None:
        capacity_factor = cfg.capacity_factor
    b, s, d = x.shape
    xg = _group(x, group_size)
    cap = _capacity(cfg, xg.shape[1], capacity_factor)
    gate_k, idx_k, aux = _route(params, xg, cfg)
    y = _dispatch_ffn_combine_local(params, xg, gate_k, idx_k, cfg, cap).reshape(b, s, d)

    # shared experts: dense on every token
    if "shared" in params:
        y = y + _shared_experts(params, x, torch_dtype(cfg.compute_dtype))
    return y.to(x.dtype), aux


# =============================================================================
# reference: textbook GShard einsum dispatch (test oracle; O(S^2·E·C) memory —
# never use on large cells)
# =============================================================================
def moe_apply_einsum(params, x: torch.Tensor, cfg: ModelConfig, *, group_size: int = 2048,
                     capacity_factor: float = 1.25) -> tuple[torch.Tensor, torch.Tensor]:
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
