"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

The JAX package's ``models/encdec.py`` as ``nn.Module``s.  The conv/mel
frontend is a stub: the caller supplies frame embeddings (B, T_enc, D).  The
backbone: a pre-LayerNorm transformer encoder (bidirectional) over the frames
plus sinusoidal positions, a decoder with causal self-attention and
cross-attention to the encoder memory, learned decoder positions
(``pos_dec``), GELU MLPs and a head tied to the embedding.

An ``EncDec`` holds ``embed`` (V, D), ``pos_dec`` (max_pos, D), ``enc`` (a
``ModuleList`` of layers with ``ln1``, ``attn``, ``ln2``, ``mlp``),
``enc_ln``, ``dec`` (layers with ``ln1``, ``self_attn``, ``ln2``,
``cross_attn``, ``ln3``, ``mlp``) and ``dec_ln``; each LayerNorm has ``g``
and ``b``.  Parameter names are the JAX dict keys and weights keep JAX's
(in, out) layout; ``convert.py`` stacks ``enc`` and ``dec`` layer-leading,
as JAX's scans hold them.  A Python loop over the layers replaces
``lax.scan``; where JAX wraps each encoder and decoder layer in
``jax.checkpoint``, the port runs it under ``torch.utils.checkpoint``
whenever a gradient is recorded for trainable weights.

Attention is the einsum path everywhere, as in JAX (the encoder is
bidirectional, and flash runs causal attention only), and its output goes
straight into ``wo``, with no ``reduce_boundary`` cast.  Decoding keeps
JAX's cache layout, self K/V (L, B, max_len, H, hd) and cross K/V (L, B,
T_enc, H, hd), writes the new key and value in place, and clamps an
out-of-range position as ``lax.dynamic_slice`` and
``lax.dynamic_update_slice`` do: ``pos_dec``'s last row and the cache's last
slot.  On a mesh each decode attention runs on local shards, the caches
placed by ``sharding.cache_specs`` on heads, or else on the sequence
(``_cache_attend``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import _sdpa, cross_attn_init, make_mask
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MLP,
    ParamModule,
    dense_init,
    embedding,
    layer_norm,
    mlp_apply,
    torch_dtype,
)
from repro_torch.models.losses import next_token_loss
from repro_torch.models.pspec import (
    BATCH,
    constrain,
    is_dtensor,
    local_call,
    placed,
    seq_placements,
    shard_of,
    split_last,
)

__all__ = [
    "EncDec",
    "decode_full",
    "decode_step",
    "encode",
    "init_cache",
    "init_params",
    "precompute_cross",
    "train_loss",
]


def _ln(d: int, dtype: torch.dtype, device) -> ParamModule:
    return ParamModule({"g": torch.ones((d,), dtype=dtype, device=device),
                        "b": torch.zeros((d,), dtype=dtype, device=device)})


class EncoderLayer(ParamModule):
    def __init__(self, gen, cfg: ModelConfig, *, dtype: torch.dtype, device) -> None:
        super().__init__()
        self.ln1 = _ln(cfg.d_model, dtype, device)
        self.attn = ParamModule(cross_attn_init(gen, cfg, dtype, device))
        self.ln2 = _ln(cfg.d_model, dtype, device)
        self.mlp = MLP(gen, cfg.d_model, cfg.d_ff, "gelu", dtype=dtype, device=device)


class DecoderLayer(ParamModule):
    def __init__(self, gen, cfg: ModelConfig, *, dtype: torch.dtype, device) -> None:
        super().__init__()
        self.ln1 = _ln(cfg.d_model, dtype, device)
        self.self_attn = ParamModule(cross_attn_init(gen, cfg, dtype, device))
        self.ln2 = _ln(cfg.d_model, dtype, device)
        self.cross_attn = ParamModule(cross_attn_init(gen, cfg, dtype, device))
        self.ln3 = _ln(cfg.d_model, dtype, device)
        self.mlp = MLP(gen, cfg.d_model, cfg.d_ff, "gelu", dtype=dtype, device=device)


class EncDec(ParamModule):
    """The encoder/decoder.  ``gen`` draws every weight in a fixed order
    (other weights than the JAX package's from one seed); with ``gen=None``
    the weights are left uninitialised on ``device`` for loading.
    ``max_pos`` sizes the learned decoder positions."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None, *,
                 max_pos: int, device: Optional[torch.device] = None) -> None:
        dtype = torch_dtype(cfg.param_dtype)
        dev = gen.device if gen is not None else device
        d = cfg.d_model
        super().__init__({
            "embed": dense_init(gen, (cfg.vocab_size, d), fan_in=d, dtype=dtype, device=dev),
            "pos_dec": dense_init(gen, (max_pos, d), fan_in=d, dtype=dtype, device=dev),
        })
        self.cfg = cfg
        self.enc = nn.ModuleList(EncoderLayer(gen, cfg, dtype=dtype, device=dev)
                                 for _ in range(cfg.encoder_layers))
        self.enc_ln = _ln(d, dtype, dev)
        self.dec = nn.ModuleList(DecoderLayer(gen, cfg, dtype=dtype, device=dev)
                                 for _ in range(cfg.num_layers))
        self.dec_ln = _ln(d, dtype, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig, *, max_pos: int,
                device: Optional[torch.device] = None) -> EncDec:
    return EncDec(cfg, gen, max_pos=max_pos, device=device)


def _tokens(params: EncDec, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.device).long()


def _remat(params: EncDec) -> bool:
    return torch.is_grad_enabled() and any(p.requires_grad for p in params.parameters())


def _heads(params, x: torch.Tensor, name: str, cfg: ModelConfig) -> torch.Tensor:
    b, s, _ = x.shape
    return split_last(x @ params[name], b, s, cfg.num_heads, cfg.head_dim)


def _attn_nope(params, x: torch.Tensor, cfg: ModelConfig, *, causal: bool) -> torch.Tensor:
    q, k, v = (_heads(params, x, w, cfg) for w in ("wq", "wk", "wv"))
    pos = placed(torch.arange(x.shape[1], device=x.device))[None]
    mask = make_mask(pos, pos, causal=causal)
    return _sdpa(q, k, v, mask, cfg) @ params["wo"]


def _cross(params, x: torch.Tensor, mem_k: torch.Tensor, mem_v: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    q = _heads(params, x, "wq", cfg)
    mask = placed(torch.ones((1, x.shape[1], mem_k.shape[1]), dtype=torch.bool, device=x.device))
    return _sdpa(q, mem_k, mem_v, mask, cfg) @ params["wo"]


def _sinusoid(length: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-math.log(10_000.0) * dim / max(d // 2 - 1, 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _norm(x: torch.Tensor, ln) -> torch.Tensor:
    return layer_norm(x, ln["g"], ln["b"])


def _enc_layer(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = constrain(x, BATCH, None, None)
    x = x + _attn_nope(lp["attn"], _norm(x, lp["ln1"]), cfg, causal=False)
    return x + mlp_apply(lp["mlp"], _norm(x, lp["ln2"]), "gelu")


def encode(params: EncDec, frames, cfg: ModelConfig) -> torch.Tensor:
    """frames (B, T_enc, D) from the stub frontend -> encoder memory."""
    cdt = torch_dtype(cfg.compute_dtype)
    frames = placed(torch.as_tensor(frames, device=params.device))
    x = frames.to(cdt) + placed(_sinusoid(frames.shape[1], cfg.d_model, frames.device)).to(cdt)
    remat = _remat(params)
    for lp in params["enc"]:
        x = (checkpoint(_enc_layer, lp, x, cfg, use_reentrant=False) if remat
             else _enc_layer(lp, x, cfg))
    return _norm(x, params["enc_ln"])


def _cross_kv(params, memory: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    return _heads(params, memory, "wk", cfg), _heads(params, memory, "wv", cfg)


def _dec_layer(lp, x: torch.Tensor, memory: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = constrain(x, BATCH, None, None)
    x = x + _attn_nope(lp["self_attn"], _norm(x, lp["ln1"]), cfg, causal=True)
    mem_k, mem_v = _cross_kv(lp["cross_attn"], memory, cfg)
    x = x + _cross(lp["cross_attn"], _norm(x, lp["ln2"]), mem_k, mem_v, cfg)
    return x + mlp_apply(lp["mlp"], _norm(x, lp["ln3"]), "gelu")


def decode_full(params: EncDec, memory: torch.Tensor, tokens, cfg: ModelConfig) -> torch.Tensor:
    """Logits (B, S, V) of the whole token sequence against ``memory``, in
    the compute dtype."""
    cdt = torch_dtype(cfg.compute_dtype)
    tokens = _tokens(params, tokens)
    x = (constrain(embedding(tokens, params["embed"]), BATCH, None, None).to(cdt)
         + params["pos_dec"][:tokens.shape[1]].to(cdt))
    remat = _remat(params)
    for lp in params["dec"]:
        x = (checkpoint(_dec_layer, lp, x, memory, cfg, use_reentrant=False) if remat
             else _dec_layer(lp, x, memory, cfg))
    return constrain(_norm(x, params["dec_ln"]) @ params["embed"].T, BATCH, None, "model")


def train_loss(params: EncDec, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Next-token loss of ``batch["tokens"]`` decoded against the encoding of
    ``batch["frames"]``; metrics ``lm_loss`` and ``total_loss``, as JAX's."""
    memory = encode(params, batch["frames"], cfg)
    logits = decode_full(params, memory, batch["tokens"], cfg)
    loss = next_token_loss(logits, _tokens(params, batch["tokens"]))
    return loss, {"lm_loss": loss, "total_loss": loss}


# -- serving -------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: Optional[torch.device] = None) -> dict:
    """``t`` (the next position, a Python int), ``self_k``/``self_v`` (L, B,
    max_len, H, hd) and ``mem_k``/``mem_v`` (L, B, T_enc, H, hd), zeros until
    ``precompute_cross`` fills the cross ones."""
    dtype = torch_dtype(cfg.compute_dtype)
    h, hd, n = cfg.num_heads, cfg.head_dim, cfg.num_layers
    zeros = lambda t: torch.zeros((n, batch, t, h, hd), dtype=dtype, device=device)  # noqa: E731
    return {"t": 0, "self_k": zeros(max_len), "self_v": zeros(max_len),
            "mem_k": zeros(cfg.encoder_seq), "mem_v": zeros(cfg.encoder_seq)}


def precompute_cross(params: EncDec, memory: torch.Tensor, cfg: ModelConfig,
                     cache: dict) -> dict:
    """Each decoder layer's cross-attention K/V of ``memory`` into
    ``cache["mem_k"]``/``["mem_v"]`` (L, B, T, H, hd); returns ``cache``."""
    kv = [_cross_kv(lp["cross_attn"], memory, cfg) for lp in params["dec"]]
    cache["mem_k"] = torch.stack([k for k, _ in kv])
    cache["mem_v"] = torch.stack([v for _, v in kv])
    return cache


def decode_step(params: EncDec, cache: dict, tokens_new,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens_new (B, 1).  Writes the self K/V at ``t`` in
    place and returns (logits (B, 1, V) in the compute dtype, cache).  On a
    mesh each attention runs on local shards (``_cache_attend``), the
    caches placed by ``sharding.cache_specs``: on heads, or else on the
    sequence."""
    cdt = torch_dtype(cfg.compute_dtype)
    t = cache["t"]
    tokens = _tokens(params, tokens_new)
    pos_row = params["pos_dec"][min(t, params["pos_dec"].shape[0] - 1)]
    x = (constrain(embedding(tokens, params["embed"]), BATCH, None, None).to(cdt)
         + pos_row.to(cdt))
    slot = min(t, cache["self_k"].shape[2] - 1)
    for i, lp in enumerate(params["dec"]):
        sa = lp["self_attn"]
        hdn = _norm(x, lp["ln1"])
        q, k, v = (_heads(sa, hdn, w, cfg) for w in ("wq", "wk", "wv"))
        x = x + _cache_attend(q, cache["self_k"], cache["self_v"], i, cfg, (k, v), slot, t) \
            @ sa["wo"]
        ca = lp["cross_attn"]
        q = _heads(ca, _norm(x, lp["ln2"]), "wq", cfg)
        x = x + _cache_attend(q, cache["mem_k"], cache["mem_v"], i, cfg) @ ca["wo"]
        x = x + mlp_apply(lp["mlp"], _norm(x, lp["ln3"]), "gelu")
    cache["t"] = t + 1
    return constrain(_norm(x, params["dec_ln"]) @ params["embed"].T, BATCH, None, "model"), cache


def _cache_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, layer: int,
                  cfg: ModelConfig, new=(None, None), slot: int = 0, t: int = 0) -> torch.Tensor:
    """q (B, 1, H, hd) over layer ``layer`` of the stacked K/V ``ck``/``cv``
    (L, B, S, H, hd) -> (B, 1, H·hd).  The self attention's ``new`` key and
    value (B, 1, H, hd) go in at ``slot`` first, and the query sees the
    positions <= t; without them (the cross attention's memory), every
    position.  On a mesh: each rank's batch rows and heads, and its chunk
    of a sequence-sharded cache (the slot's owner alone writes it;
    ``pspec.split_softmax`` joins the chunks)."""
    args = (q, ck, cv, *new)
    if not is_dtensor(q):
        return _attend_layer(*args, layer, cfg, slot, t)
    q_pl = seq_placements(ck, {1: 0, 3: 2})
    new_pl = None if new[0] is None else q_pl
    seq = shard_of(ck, 2)
    return local_call(lambda *a: _attend_layer(*a, layer, cfg, slot, t, seq), args,
                      (q_pl, ck.placements, cv.placements, new_pl, new_pl), q_pl)


def _attend_layer(q, ck, cv, k_new, v_new, layer: int, cfg: ModelConfig, slot: int, t: int,
                  seq=None) -> torch.Tensor:
    k, v = ck[layer], cv[layer]
    chunk = k.shape[1]
    lo = 0 if seq is None else seq[1] * chunk
    if k_new is None:
        mask = torch.ones((1, 1, chunk), dtype=torch.bool, device=q.device)
    else:
        if lo <= slot < lo + chunk:
            k[:, slot - lo] = k_new[:, 0]
            v[:, slot - lo] = v_new[:, 0]
        mask = (torch.arange(lo, lo + chunk, device=q.device)[None] <= t)[:, None, :]
    return _sdpa(q, k, v, mask, cfg, None if seq is None else seq[0])
