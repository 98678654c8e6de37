"""GQA/MQA attention with causal + sliding-window masks and KV-cache decode.

The JAX package's ``models/attention.py`` on tensors.  Covers phi3 (GQA),
gemma-2b (MQA, head_dim 256), qwen1.5 (MHA + QKV bias), gemma3 (5:1
local:global sliding window, ring-buffer local caches) and the whisper
decoder's cross attention.  Full-sequence causal attention goes to the flash
kernel (``kernels/flash_attn``) under the same five conditions as in the JAX
package; everything else is the einsum path in plain PyTorch.  Decoding
writes the new key/value into the cache tensors in place (JAX returns new
arrays) and returns the same cache dict.

On a mesh decoding runs on local shards (``pspec.local_call``), each cache
with its own placements (``sharding.cache_specs``), so the writes land in
it.  A head-sharded cache (KV heads dividing ``model``): each rank writes
and attends over its own heads.  A sequence-parallel cache (MQA, or KV
heads that do not divide ``model``): only the rank whose chunk holds the
slot writes the key and value, every rank writes the position (``pos`` is
whole over ``model``) and scores the query over its own chunk, and the
chunks are joined by ``pspec.split_softmax``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamModule, apply_rope, dense_init, reduce_boundary, rope
from repro_torch.models.pspec import (
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

__all__ = [
    "Attention",
    "attn_init",
    "attention",
    "attention_decode",
    "init_kv_cache",
    "cross_attn_init",
    "cross_attention",
    "make_mask",
]

NEG_INF = -1e30


def attn_init(gen, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
              device: Optional[torch.device] = None) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h * hd), dtype=dtype, device=device),
        "wk": dense_init(gen, (d, kv * hd), dtype=dtype, device=device),
        "wv": dense_init(gen, (d, kv * hd), dtype=dtype, device=device),
        "wo": dense_init(gen, (h * hd, d), fan_in=h * hd, dtype=dtype, device=device),
    }
    if cfg.qkv_bias:
        dev = gen.device if gen is not None else device
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
    return p


class Attention(ParamModule):
    """One attention mixer's projections (``wq``, ``wk``, ``wv``, ``wo`` and
    the optional ``bq``/``bk``/``bv``), in JAX's (in, out) layout."""

    def __init__(self, gen, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: Optional[torch.device] = None) -> None:
        super().__init__(attn_init(gen, cfg, dtype, device))


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return split_last(q, b, s, h, hd), split_last(k, b, s, kv, hd), split_last(v, b, s, kv, hd)


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap > 0:
        return cap * torch.tanh(scores / cap)
    return scores


def _sdpa(q, k, v, mask, cfg: ModelConfig, group=None) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,KV,hd), mask (B|1, S, T) bool -> (B,S,H*hd).
    fp32 scores; GQA via head grouping.  DTensors run on each rank's batch
    rows and heads (``pspec.local_call``): DTensor cannot place the einsum's
    flattening of a sharded head dim on every torch release.  With
    ``group``, k, v and the mask are this rank's chunk of a sequence split
    over the group's ranks, and the chunks are joined
    (``pspec.split_softmax``)."""
    if is_dtensor(q):
        q_pl, kv_pl = head_placements(q, k)
        return local_call(lambda *a: _sdpa(*a, cfg), (q, k, v, mask),
                          (q_pl, kv_pl, kv_pl, row_placements(mask, q_pl)), q_pl)
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / math.sqrt(hd)
    scores = _softcap(scores, cfg.attn_logit_softcap)
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    w = split_softmax(scores, group)
    out = sum_over(torch.einsum("bkgst,btkd->bskgd", w, v.float()), group)
    return out.reshape(b, s, h * hd).to(q.dtype)


def make_mask(
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    is_global=True,
    k_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B|1, S, T) boolean mask.  ``is_global`` is a bool or a bool tensor."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    if causal:
        m = kp <= qp
    else:
        m = placed(torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
                              device=qp.device))
    if window:
        local = (qp - kp) < window
        m = m & (local | is_global)
    if k_valid is not None:
        m = m & k_valid[..., None, :]
    if m.ndim == 2:
        m = m[None]
    return m


def attention(
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    is_global=True,
    causal: bool = True,
) -> torch.Tensor:
    """Full-sequence attention (train / prefill).  positions (B, S) or (S,)."""
    q, k, v = _project_qkv(params, x, cfg)
    cos, sin = rope(positions, cfg.head_dim, cfg.rope_theta)
    if positions.ndim == 1:
        cos, sin = cos[None], sin[None]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    # flash path: plain causal attention only (windowed/softcap/cross take
    # the einsum path, as in the JAX package)
    if (
        cfg.attn_impl == "pallas_flash"
        and causal
        and not cfg.sliding_window
        and not cfg.attn_logit_softcap
        and positions.ndim == 1
    ):
        from repro_torch.kernels.flash_attn.ops import flash_attention

        b, s = q.shape[:2]
        out = flash_attention(q, k, v, causal=True)
        out = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
        return reduce_boundary(out, x.dtype) @ params["wo"]

    pos2 = positions if positions.ndim == 2 else positions[None]
    mask = make_mask(pos2, pos2, causal=causal, window=cfg.sliding_window, is_global=is_global)
    return reduce_boundary(_sdpa(q, k, v, mask, cfg), x.dtype) @ params["wo"]


# -- decode with KV cache -----------------------------------------------------
def init_kv_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, window_cache: bool = False,
    dtype: torch.dtype = torch.bfloat16, device: Optional[torch.device] = None,
) -> dict:
    """One layer's cache.  window_cache=True allocates a ring buffer of the
    sliding window size — the sub-quadratic memory plan for local layers."""
    size = (
        min(max_len, cfg.sliding_window)
        if window_cache and cfg.sliding_window
        else max_len
    )
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, size, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, kv, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, size), -1, dtype=torch.int32, device=device),  # -1 = empty
    }


def attention_decode(
    params,
    x: torch.Tensor,
    cache: dict,
    t: int,
    cfg: ModelConfig,
    *,
    is_global=True,
) -> tuple[torch.Tensor, dict]:
    """One-token decode.  x (B, 1, D); t the current position.  Writes the
    new key/value into ``cache`` in place; returns (out (B, 1, D), cache)."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(params, x, cfg)
    pos_new = placed(torch.full((b, 1), t, dtype=torch.int32, device=x.device))
    cos, sin = rope(pos_new, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)

    args = (q, k_new, v_new, cache["k"], cache["v"], cache["pos"])
    if is_dtensor(q):
        k = cache["k"]
        new_pl = seq_placements(k, {0: 0, 2: 2})
        seq = shard_of(k, 1)
        out = local_call(lambda *a: _cached_attend(*a, t, cfg, is_global, seq), args,
                         (new_pl, new_pl, new_pl, k.placements, cache["v"].placements,
                          cache["pos"].placements), new_pl)
    else:
        out = _cached_attend(*args, t, cfg, is_global)
    return reduce_boundary(out, x.dtype) @ params["wo"], cache


def _cached_attend(q, k_new, v_new, k, v, pos, t: int, cfg: ModelConfig, is_global,
                   seq=None) -> torch.Tensor:
    """Writes the new key, value and position at slot t % size (ring
    semantics; == t when size == max_len) in place, then attends q over the
    cache: (B, 1, H·hd).  ``seq`` is ``pspec.shard_of`` the cache's
    sequence: k and v are then this rank's chunk, the slot's owner alone
    writes them, and ``pos`` (whole) is sliced to the chunk."""
    size = pos.shape[1]
    slot = t % size
    chunk = k.shape[1]
    lo = 0 if seq is None else seq[1] * chunk
    if lo <= slot < lo + chunk:
        k[:, slot - lo] = k_new[:, 0]
        v[:, slot - lo] = v_new[:, 0]
    pos[:, slot] = t
    pos = pos[:, lo:lo + chunk]
    mask = make_mask(
        torch.full_like(pos[:, :1], t),
        pos,
        causal=True,
        window=cfg.sliding_window,
        is_global=is_global,
        k_valid=pos >= 0,
    )
    return _sdpa(q, k, v, mask, cfg, None if seq is None else seq[0])


# -- cross attention (whisper decoder) ------------------------------------------
def cross_attn_init(gen, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                    device: Optional[torch.device] = None) -> dict:
    """``wq``, ``wk``, ``wv`` (D, H·hd) and ``wo`` (H·hd, D): every head has
    its own key and value, and there is no bias."""
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (d, h * hd), dtype=dtype, device=device),
        "wk": dense_init(gen, (d, h * hd), dtype=dtype, device=device),
        "wv": dense_init(gen, (d, h * hd), dtype=dtype, device=device),
        "wo": dense_init(gen, (h * hd, d), fan_in=h * hd, dtype=dtype, device=device),
    }


def cross_attention(params, x: torch.Tensor, memory: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """x (B,S,D) attends to encoder memory (B,T,D); no positions (whisper
    applies learned/sinusoidal pos upstream)."""
    b, s, _ = x.shape
    t = memory.shape[1]
    h, hd = cfg.num_heads, cfg.head_dim
    q = split_last(x @ params["wq"], b, s, h, hd)
    k = split_last(memory @ params["wk"], b, t, h, hd)
    v = split_last(memory @ params["wv"], b, t, h, hd)
    mask = placed(torch.ones((1, s, t), dtype=torch.bool, device=x.device))
    return reduce_boundary(_sdpa(q, k, v, mask, cfg), x.dtype) @ params["wo"]
