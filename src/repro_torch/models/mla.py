"""Multi-head Latent Attention (DeepSeek V2/V3).

The JAX package's ``models/mla.py`` on tensors.  Train/prefill: expand the
compressed KV latent to full K/V heads and run standard attention
(``mla_attention``).  Decode: the ABSORBED path (``mla_decode``) — fold the
up-projections into the query/output so attention runs directly against the
compressed cache of (kv_lora_rank + qk_rope_dim) per token, independent of
head count.  Both score products and the softmax run in float32, as in the
JAX package; MLA never routes to the flash kernel (its query/key width,
nope + rope, is not its value width).  Decoding writes the new latent, rope
key and position into the cache tensors in place (JAX returns new arrays)
and returns the same cache dict.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    ParamModule,
    apply_rope,
    dense_init,
    reduce_boundary,
    rms_norm,
    rope,
)
from repro_torch.models.pspec import (
    head_placements,
    is_dtensor,
    local_call,
    row_placements,
    split_last,
)

__all__ = ["MLA", "init_mla_cache", "mla_attention", "mla_decode", "mla_init"]

NEG_INF = -1e30


def mla_init(gen, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
             device: Optional[torch.device] = None) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    nope, pe, v = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dev = gen.device if gen is not None else device

    def init(shape, **kw):
        return dense_init(gen, shape, dtype=dtype, device=device, **kw)

    p: dict = {}
    if cfg.q_lora_rank:
        p["wq_a"] = init((d, cfg.q_lora_rank))
        p["q_norm"] = torch.zeros((cfg.q_lora_rank,), dtype=dtype, device=dev)
        p["wq_b"] = init((cfg.q_lora_rank, h * (nope + pe)))
    else:
        p["wq"] = init((d, h * (nope + pe)))
    p["wkv_a"] = init((d, cfg.kv_lora_rank + pe))
    p["kv_norm"] = torch.zeros((cfg.kv_lora_rank,), dtype=dtype, device=dev)
    p["wkv_b"] = init((cfg.kv_lora_rank, h * (nope + v)))
    p["wo"] = init((h * v, d), fan_in=h * v)
    return p


class MLA(ParamModule):
    """One MLA mixer: ``wq`` (or ``wq_a``, ``q_norm``, ``wq_b`` with a query
    LoRA), ``wkv_a`` (D, R + pe), ``kv_norm``, ``wkv_b`` (R, H·(nope + v))
    and ``wo``, in JAX's (in, out) layout."""

    def __init__(self, gen, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: Optional[torch.device] = None) -> None:
        super().__init__(mla_init(gen, cfg, dtype, device))


def _q_proj(params, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    h, nope, pe = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = rms_norm(x @ params["wq_a"], params["q_norm"], cfg.norm_eps)
        q = q @ params["wq_b"]
    else:
        q = x @ params["wq"]
    q = split_last(q, b, s, h, nope + pe)
    return q[..., :nope], q[..., nope:]


def _rope(positions: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    cos, sin = rope(positions, cfg.qk_rope_dim, cfg.rope_theta)
    if positions.ndim == 1:
        cos, sin = cos[None], sin[None]
    return cos, sin


def _kv_latent(params, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (c_kv normed (B,S,R), k_pe roped (B,S,pe))."""
    kv_a = x @ params["wkv_a"]
    c_kv = rms_norm(kv_a[..., : cfg.kv_lora_rank], params["kv_norm"], cfg.norm_eps)
    k_pe = kv_a[..., cfg.kv_lora_rank:]
    cos, sin = _rope(positions, cfg)
    k_pe = apply_rope(k_pe[:, :, None, :], cos, sin)[:, :, 0, :]
    return c_kv, k_pe


def mla_attention(params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence MLA (train / prefill): expand the latent, float32
    attention masked causally by ``positions`` (S,) or (B, S)."""
    b, s, _ = x.shape
    h, nope, vd = cfg.num_heads, cfg.qk_nope_dim, cfg.v_head_dim
    q_nope, q_pe = _q_proj(params, x, cfg)
    cos, sin = _rope(positions, cfg)
    q_pe = apply_rope(q_pe, cos, sin)

    c_kv, k_pe = _kv_latent(params, x, positions, cfg)
    kv = split_last(c_kv @ params["wkv_b"], b, s, h, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]

    pos2 = positions if positions.ndim == 2 else positions[None]
    causal = pos2[..., None, :] <= pos2[..., :, None]
    args = (q_nope, q_pe, k_nope, k_pe, v, causal)
    if is_dtensor(q_nope):
        # each rank's batch rows and heads (pspec.local_call); k_pe serves
        # every head, so its gradient sums over the ranks of split heads
        from torch.distributed.tensor import Partial, Shard

        q_pl, kv_pl = head_placements(q_nope, k_nope)
        pe_pl = row_placements(k_pe, q_pl)
        pe_grad = [Partial() if p == Shard(2) else r for p, r in zip(q_pl, pe_pl)]
        out = local_call(_attend, args, (q_pl, q_pl, kv_pl, pe_pl, kv_pl,
                                         row_placements(causal, q_pl)), q_pl,
                         (q_pl, q_pl, kv_pl, pe_grad, kv_pl, None))
    else:
        out = _attend(*args)
    return reduce_boundary(out, x.dtype) @ params["wo"]


def _attend(q_nope, q_pe, k_nope, k_pe, v, causal) -> torch.Tensor:
    """Float32 softmax attention of the expanded heads -> (B, S, H·vd)."""
    b, s, h, nope = q_nope.shape
    scale = 1.0 / math.sqrt(nope + q_pe.shape[-1])
    s_nope = torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope.float())
    s_pe = torch.einsum("bshd,btd->bhst", q_pe.float(), k_pe.float())
    scores = (s_nope + s_pe) * scale
    scores = scores.masked_fill(~causal[:, None, :, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", w, v.float())
    return out.reshape(b, s, h * v.shape[-1])


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Optional[torch.device] = None) -> dict:
    """Compressed cache: latent + shared rope key.  Per token per layer:
    kv_lora_rank + qk_rope_dim values (576 for deepseek), vs 2·H·head_dim
    for plain GQA.  ``pos`` -1 marks an empty slot."""
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_pe": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype, device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
    }


def mla_decode(params, x: torch.Tensor, cache: dict, t: int,
               cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Absorbed single-token decode against the compressed cache, written in
    place at position ``t``:

    score_h(t) = q_nope_h^T W_uk_h c_t + q_pe_h^T k_pe_t
    out_h      = (Σ_t w_t c_t)^T W_uv_h
    """
    b = x.shape[0]
    h, nope, pe, vd = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank

    q_nope, q_pe = _q_proj(params, x, cfg)          # (B,1,H,nope), (B,1,H,pe)
    pos_new = torch.full((b, 1), t, dtype=torch.int32, device=x.device)
    cos, sin = _rope(pos_new, cfg)
    q_pe = apply_rope(q_pe, cos, sin)

    c_new, k_pe_new = _kv_latent(params, x, pos_new, cfg)
    cache["c_kv"][:, t] = c_new[:, 0]
    cache["k_pe"][:, t] = k_pe_new[:, 0]
    cache["pos"][:, t] = t
    c_kv, k_pe, pos = cache["c_kv"], cache["k_pe"], cache["pos"]

    wkv_b = params["wkv_b"].reshape(r, h, nope + vd)
    w_uk = wkv_b[..., :nope]                         # (R, H, nope)
    w_uv = wkv_b[..., nope:]                         # (R, H, vd)

    # absorb W_uk into q: (B,1,H,nope) x (R,H,nope) -> (B,1,H,R)
    q_c = torch.einsum("bshn,rhn->bshr", q_nope.float(), w_uk.float())
    s_c = torch.einsum("bshr,btr->bhst", q_c, c_kv.float())
    s_pe = torch.einsum("bshd,btd->bhst", q_pe.float(), k_pe.float())
    scores = (s_c + s_pe) / math.sqrt(nope + pe)
    valid = (pos <= t) & (pos >= 0)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)                # (B,H,1,T)
    out_c = torch.einsum("bhst,btr->bshr", w, c_kv.float())
    out = torch.einsum("bshr,rhv->bshv", out_c, w_uv.float())
    out = out.reshape(b, 1, h * vd).to(x.dtype) @ params["wo"]
    return out, cache
