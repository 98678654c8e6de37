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

On a mesh decoding runs on local shards (``pspec.local_call``): the
compressed cache is sharded on its sequence over ``model``
(``sharding.cache_specs``), so only the rank whose chunk holds position t
writes it, and the absorbed scores over the chunks are joined by
``pspec.split_softmax``.  ``wkv_b`` keeps its placement: where its output
dim splits over ``model`` on head boundaries, each rank absorbs its own
heads' queries, the absorbed queries are gathered, and each rank projects
its own heads' values out of the joined latent.
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
    gather_over,
    head_placements,
    is_dtensor,
    local_call,
    placed,
    row_placements,
    seq_placements,
    shard_of,
    split_last,
    split_softmax,
    sum_over,
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


def _q_proj(params, x: torch.Tensor,
            cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    h, nope, pe = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = rms_norm(x @ params["wq_a"], params["q_norm"], cfg.norm_eps)
        q = q @ params["wq_b"]
    else:
        q = x @ params["wq"]
    q = split_last(q, b, s, h, nope + pe)
    return q[..., :nope], q[..., nope:]


def _rope(positions: torch.Tensor,
          cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
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
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_pe": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                            device=device),
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
    q_nope, q_pe = _q_proj(params, x, cfg)          # (B,1,H,nope), (B,1,H,pe)
    pos_new = placed(torch.full((b, 1), t, dtype=torch.int32, device=x.device))
    cos, sin = _rope(pos_new, cfg)
    q_pe = apply_rope(q_pe, cos, sin)
    c_new, k_pe_new = _kv_latent(params, x, pos_new, cfg)

    args = (q_nope, q_pe, c_new, k_pe_new, cache["c_kv"], cache["k_pe"], cache["pos"],
            params["wkv_b"])
    if is_dtensor(q_nope):
        out = _absorbed_on_mesh(args, t, cfg)
    else:
        out = _absorbed(*args, t, cfg)
    return out.to(x.dtype) @ params["wo"], cache


def _absorbed_on_mesh(args, t: int, cfg: ModelConfig):
    """``_absorbed`` on each rank's batch rows, cache chunk and (where
    ``wkv_b`` splits on head boundaries) heads."""
    from torch.distributed.tensor import Replicate, Shard

    c_kv, k_pe, pos, wkv_b = args[4:]
    seq, heads = shard_of(c_kv, 1), shard_of(wkv_b, 1)
    if heads is not None and cfg.num_heads % heads[2]:
        heads = None  # a shard boundary inside a head: every rank takes them all
    rows = seq_placements(c_kv, {0: 0})
    w_pl = list(wkv_b.placements) if heads is not None else [Replicate()] * len(rows)
    q_pl = [Shard(2) if w == Shard(1) else r for w, r in zip(w_pl, rows)]
    return local_call(lambda *a: _absorbed(*a, t, cfg, seq, heads), args,
                      (q_pl, rows, rows, rows, c_kv.placements, k_pe.placements,
                       pos.placements, w_pl), q_pl)


def _absorbed(q_nope, q_pe, c_new, k_pe_new, c_kv, k_pe, pos, wkv_b, t: int,
              cfg: ModelConfig, seq=None, heads=None) -> torch.Tensor:
    """Writes the new latent, rope key and position at t in place, then
    attends the absorbed queries over the cache: (B, 1, H·vd), float32.
    ``seq`` (``pspec.shard_of`` the cache's sequence): c_kv and k_pe are
    this rank's chunk, its owner alone writes them, ``pos`` (whole) is
    sliced to the chunk.  ``heads`` (``shard_of`` ``wkv_b``'s output dim):
    q_nope and wkv_b hold this rank's heads, q_pe all of them."""
    b = q_nope.shape[0]
    nope, pe, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    chunk = c_kv.shape[1]
    lo = 0 if seq is None else seq[1] * chunk
    if seq is None or lo <= t < lo + chunk:
        c_kv[:, t - lo] = c_new[:, 0]
        k_pe[:, t - lo] = k_pe_new[:, 0]
    pos[:, t] = t
    pos = pos[:, lo:lo + chunk]

    # (R, H or this rank's heads, nope+vd)
    wkv_b = wkv_b.reshape(r, -1, nope + vd)
    w_uk = wkv_b[..., :nope]                         # (R, H, nope)
    w_uv = wkv_b[..., nope:]                         # (R, H, vd)

    # absorb W_uk into q: (B,1,H,nope) x (R,H,nope) -> (B,1,H,R)
    q_c = torch.einsum("bshn,rhn->bshr", q_nope.float(), w_uk.float())
    if heads is not None:
        q_c = gather_over(q_c, 2, heads[0])
    group = None if seq is None else seq[0]
    s_c = torch.einsum("bshr,btr->bhst", q_c, c_kv.float())
    s_pe = torch.einsum("bshd,btd->bhst", q_pe.float(), k_pe.float())
    scores = (s_c + s_pe) / math.sqrt(nope + pe)
    valid = (pos <= t) & (pos >= 0)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = split_softmax(scores, group)                 # (B,H,1,T)
    out_c = sum_over(torch.einsum("bhst,btr->bshr", w, c_kv.float()), group)
    if heads is not None:
        n = w_uv.shape[1]
        out_c = out_c[:, :, heads[1] * n:(heads[1] + 1) * n]
    out = torch.einsum("bshr,rhv->bshv", out_c, w_uv.float())
    return out.reshape(b, 1, -1)
