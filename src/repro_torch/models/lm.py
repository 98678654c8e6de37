"""Decoder-only LM: the dense configs (phi3, gemma-2b, qwen1.5, gemma3), the
MLA + MoE family (deepseek-v2-lite, deepseek-v3), the pure SSM (mamba2) and
the hybrid SSM + shared attention (zamba2).

The JAX package's ``models/lm.py`` as ``nn.Module``s: an ``LM`` holds
``embed``, ``final_norm``, ``lm_head`` (unless tied), the layer plan's
``prefix``, ``groups`` and ``tail`` as ``ModuleList``s of ``Block``s, each
with ``norm1``, ``mixer`` (attention, ``MLA`` or ``Mamba``), and, except in
a Mamba block, ``norm2`` and ``ffn`` (an ``MLP``, or an ``MoE`` outside the
leading dense layers); a hybrid config's ``groups`` (``groups`` of
``group_len`` Mamba blocks) come with one ``shared_attn`` block (attention
and a GELU MLP) applied after each group; with MTP the ``mtp`` subtree
(``proj``, an MoE ``block``, ``norm``).  Parameter names are the JAX dict
keys and weights keep JAX's (in, out) layout, so ``x @ w`` is the same
product (``convert.py`` moves weights across, stacking ``groups`` (G, L,
...) and ``tail`` (L, ...) as JAX's scans hold them).  A Python loop over
the blocks replaces ``lax.scan``.  Where JAX wraps a scan body in
``jax.checkpoint`` (full rematerialisation of each tail or group block), the
port runs each such block under ``torch.utils.checkpoint`` whenever a
gradient is recorded for trainable weights; the prefix and the shared block
are not checkpointed, as in JAX.
Serving's weights are frozen, so it runs the blocks plainly.  Local/global
layer flags are plain bools per layer.  The token embedding is
``F.embedding`` (the same rows as indexing): its backward on CUDA sums each
row's gradient in a fixed order, where indexing's backward (an accumulating
``index_put_``) is deterministic on CUDA only under
``torch.use_deterministic_algorithms``; so a train step is bit-reproducible
and a resumed run repeats an uninterrupted one.

``forward`` sums the MoE blocks' aux losses over the stack.  Decode runs
MoE no-drop (one group of the batch, capacity factor E/k), MLA absorbed
against its compressed cache, and a Mamba block as one recurrent step on
its conv ring and SSM state.  Serving ignores the ``mtp`` subtree, as the
JAX package does; ``train_loss`` runs it (the MTP loss branch, one extra
block predicting the token after next).  A hybrid config's gradient flows
through each group's checkpointed Mamba blocks and through the one shared
block, whose weights collect a gradient from every group (autograd sums
them in a fixed order).

A vision-prefix config (pixtral) holds ``vision_proj`` (vision_dim, D): a
batch's ``patch_embeds`` (B, P, vision_dim), projected in the compute dtype,
go before the token embeddings, positions run over the whole sequence (so
flash runs causal over patches and tokens alike), and ``train_loss`` drops
the prefix's logits.  Decoding is text-only, as in JAX.  The
encoder/decoder (whisper) is ``models/encdec.py``; ``models/api.py``
dispatches between the two.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MLP,
    ParamModule,
    dense_init,
    embedding,
    mlp_apply,
    rms_norm,
    torch_dtype,
)
from repro_torch.models.losses import next_token_loss, softmax_cross_entropy
from repro_torch.models.pspec import BATCH, constrain, placed

__all__ = [
    "Block",
    "LM",
    "SharedAttnBlock",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "prefill",
    "train_loss",
]

# =============================================================================
# init
# =============================================================================
class Block(ParamModule):
    """One transformer or Mamba block: ``norm1``, ``mixer`` (``Mamba`` when
    ``cfg.ssm``, ``MLA`` when ``cfg.use_mla``), and ``norm2`` and ``ffn``: an
    ``MoE`` when ``cfg.moe`` and not ``dense_ffn``, else a dense ``MLP``
    (when ``cfg.d_ff``).  A Mamba block is the whole layer, with no FFN: a
    hybrid config's ``d_ff`` sizes the shared attention block's MLP only."""

    def __init__(self, gen, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: Optional[torch.device] = None,
                 dense_ffn: bool = False) -> None:
        dev = gen.device if gen is not None else device
        super().__init__(
            {"norm1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev)})
        mixer = (ssm_mod.Mamba if cfg.ssm else mla_mod.MLA if cfg.use_mla
                 else attn.Attention)
        self.mixer = mixer(gen, cfg, dtype=dtype, device=device)
        moe = cfg.moe and not dense_ffn
        if moe or (cfg.d_ff and not cfg.ssm):
            self.register_parameter("norm2", nn.Parameter(
                torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
                requires_grad=False))
        if moe:
            self.ffn = moe_mod.MoE(gen, cfg, dtype=dtype, device=device)
        elif cfg.d_ff and not cfg.ssm:
            self.ffn = MLP(gen, cfg.d_model, cfg.d_ff, cfg.mlp_variant, dtype=dtype,
                           device=device)


class SharedAttnBlock(ParamModule):
    """zamba2's shared transformer block, one copy: ``norm1``, ``attn``,
    ``norm2`` and a GELU ``mlp`` of width ``cfg.d_ff`` (4·D when unset)."""

    def __init__(self, gen, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: Optional[torch.device] = None) -> None:
        dev = gen.device if gen is not None else device
        super().__init__(
            {"norm1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev)})
        self.attn = attn.Attention(gen, cfg, dtype=dtype, device=device)
        self.register_parameter("norm2", nn.Parameter(
            torch.zeros((cfg.d_model,), dtype=dtype, device=dev), requires_grad=False))
        self.mlp = MLP(gen, cfg.d_model, cfg.d_ff or 4 * cfg.d_model, "gelu",
                       dtype=dtype, device=device)


def _layer_plan(cfg: ModelConfig) -> dict:
    """How the depth dimension is organized (must match init & apply): a
    hybrid config's ``groups`` of ``group_len`` blocks, each followed by the
    shared attention block, then a ``tail`` of the rest; otherwise the
    leading dense ``prefix`` and the ``tail``."""
    if cfg.hybrid_attn_period:
        per = cfg.hybrid_attn_period
        return {"prefix": 0, "groups": cfg.num_layers // per, "group_len": per,
                "tail": cfg.num_layers % per}
    return {"prefix": cfg.first_dense_layers, "groups": 0, "group_len": 0,
            "tail": cfg.num_layers - cfg.first_dense_layers}


class LM(ParamModule):
    """The decoder-only LM.  ``gen`` draws every weight in a fixed
    order (the JAX package draws from split keys, so the two packages give
    different weights from one seed); with ``gen=None`` the weights are left
    uninitialised on ``device`` for loading."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None, *,
                 device: Optional[torch.device] = None) -> None:
        dtype = torch_dtype(cfg.param_dtype)
        dev = gen.device if gen is not None else device
        plan = _layer_plan(cfg)
        tensors = {
            "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), fan_in=cfg.d_model,
                                dtype=dtype, device=dev),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        }
        if not cfg.tie_embeddings:
            tensors["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                            dtype=dtype, device=dev)
        super().__init__(tensors)
        self.cfg = cfg
        self.prefix = nn.ModuleList(
            Block(gen, cfg, dtype=dtype, device=dev, dense_ffn=True)
            for _ in range(plan["prefix"]))
        self.groups = nn.ModuleList(
            nn.ModuleList(Block(gen, cfg, dtype=dtype, device=dev)
                          for _ in range(plan["group_len"]))
            for _ in range(plan["groups"]))
        if plan["groups"]:
            self.shared_attn = SharedAttnBlock(gen, cfg, dtype=dtype, device=dev)
        self.tail = nn.ModuleList(
            Block(gen, cfg, dtype=dtype, device=dev) for _ in range(plan["tail"]))
        if cfg.vision_prefix:
            self.register_parameter("vision_proj", nn.Parameter(
                dense_init(gen, (cfg.vision_dim, cfg.d_model), dtype=dtype, device=dev),
                requires_grad=False))
        if cfg.mtp_depth:
            # MTP depth-1 (deepseek-v3): the training loss runs it, serving
            # does not
            self.mtp = ParamModule({
                "proj": dense_init(gen, (2 * cfg.d_model, cfg.d_model), dtype=dtype,
                                   device=dev),
                "norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
            })
            self.mtp.block = Block(gen, cfg, dtype=dtype, device=dev,
                                   dense_ffn=not cfg.moe)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig, *,
                device: Optional[torch.device] = None) -> LM:
    return LM(cfg, gen, device=device)


# =============================================================================
# forward (train / prefill shared body)
# =============================================================================
def _block_apply(bp, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, *,
                 is_global=True, dense_ffn: bool = False) -> tuple[torch.Tensor,
                                                                   torch.Tensor]:
    """Returns (y, aux_loss)."""
    aux = placed(torch.zeros((), dtype=torch.float32, device=x.device))
    x = constrain(x, BATCH, None, None)
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    if cfg.ssm:
        x = x + ssm_mod.mamba_forward(bp["mixer"], h, cfg)
    elif cfg.use_mla:
        x = x + mla_mod.mla_attention(bp["mixer"], h, positions, cfg)
    else:
        x = x + attn.attention(bp["mixer"], h, positions, cfg, is_global=is_global)
    if "ffn" in bp:
        h = rms_norm(x, bp["norm2"], cfg.norm_eps)
        if cfg.moe and not dense_ffn:
            y, aux = moe_mod.moe_apply(bp["ffn"], h, cfg)
            x = x + y
        else:
            x = x + mlp_apply(bp["ffn"], h, cfg.mlp_variant)
    return x, aux


def _shared_attn_apply(sp, x: torch.Tensor, positions: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, sp["norm1"], cfg.norm_eps)
    x = x + attn.attention(sp["attn"], h, positions, cfg, is_global=True)
    h = rms_norm(x, sp["norm2"], cfg.norm_eps)
    return x + mlp_apply(sp["mlp"], h, "gelu")


def _tokens(params: LM, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.device).long()


def _embed_inputs(params: LM, cfg: ModelConfig, batch: dict) -> tuple[torch.Tensor,
                                                                      torch.Tensor]:
    """Token (+ optional vision-prefix) embedding.  Returns (x, positions)."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = constrain(embedding(_tokens(params, batch["tokens"]), params["embed"]),
                  BATCH, None, None).to(cdt)
    if cfg.vision_prefix and "patch_embeds" in batch:
        patches = placed(
            torch.as_tensor(batch["patch_embeds"], device=params.device)).to(cdt)
        x = torch.cat([(patches @ params["vision_proj"]).to(cdt), x], dim=1)
    positions = placed(torch.arange(x.shape[1], dtype=torch.int32, device=x.device))
    return x, positions


def _layers(params: LM, cfg: ModelConfig) -> list:
    """(block, is_global, dense_ffn) over the whole stack in order: prefix,
    each group's blocks followed by ``None`` (the shared attention block
    applies there), then tail.  The flags are JAX's: the prefix's and the
    tail's by their index in prefix + tail, a group block's global."""
    n_prefix = len(params["prefix"])
    out = [(bp, cfg.is_global_layer(i), True) for i, bp in enumerate(params["prefix"])]
    for group in params["groups"]:
        out += [(bp, True, False) for bp in group]
        out.append(None)
    out += [(bp, cfg.is_global_layer(n_prefix + j), False)
            for j, bp in enumerate(params["tail"])]
    return out


def forward(params: LM, batch: dict,
            cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (x before the final norm (B,S,D),
    logits, aux_loss summed over the stack).  While a gradient is recorded,
    each tail and group block is recomputed in the backward
    (``jax.checkpoint`` of the JAX scan bodies)."""
    x, positions = _embed_inputs(params, cfg, batch)
    x = constrain(x, BATCH, None, None)
    aux_total = placed(torch.zeros((), dtype=torch.float32, device=x.device))
    remat = torch.is_grad_enabled() and any(p.requires_grad
                                            for p in params.parameters())
    for layer in _layers(params, cfg):
        if layer is None:
            x = _shared_attn_apply(params["shared_attn"], x, positions, cfg)
            continue
        bp, is_global, dense_ffn = layer
        if remat and not dense_ffn:
            x, aux = checkpoint(_block_apply, bp, x, positions, cfg,
                                is_global=is_global,
                                use_reentrant=False)
        else:
            x, aux = _block_apply(bp, x, positions, cfg, is_global=is_global,
                                  dense_ffn=dense_ffn)
        aux_total = aux_total + aux
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = constrain(hidden @ params.head(), BATCH, None, "model")
    return x, logits, aux_total


def _mtp_loss(params: LM, pre_final: torch.Tensor, tokens: torch.Tensor,
              cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """MTP depth 1 (deepseek-v3): h_t joined with emb(tok_{t+1}) predicts
    tok_{t+2} through one extra block, sharing the embedding and the head.
    The shifted embedding keeps all S positions (a zero row pads the last),
    so the block's MoE sees B·S tokens, as in JAX; the last two positions'
    logits have no target.  The block is not checkpointed, as in JAX.
    Returns (cross-entropy, the block's aux loss)."""
    mp = params["mtp"]
    cdt = torch_dtype(cfg.compute_dtype)
    emb_next = constrain(embedding(tokens, params["embed"]), BATCH, None, None).to(cdt)
    emb_next = torch.cat([emb_next[:, 1:], torch.zeros_like(emb_next[:, :1])], dim=1)
    h_in = torch.cat([pre_final, emb_next], dim=-1) @ mp["proj"]
    positions = placed(
        torch.arange(h_in.shape[1], dtype=torch.int32, device=h_in.device))
    h_out, aux = _block_apply(mp["block"], h_in, positions, cfg, dense_ffn=not cfg.moe)
    mtp_logits = rms_norm(h_out, mp["norm"], cfg.norm_eps) @ params.head()
    return softmax_cross_entropy(mtp_logits[:, :-2], tokens[:, 2:]), aux


def train_loss(params: LM, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Next-token loss plus the MoE aux loss summed over the stack (zero for
    the dense configs) and, with MTP, 0.3 x the MTP loss plus its block's
    aux.  Returns (total, metrics): ``lm_loss``, ``aux_loss``, ``mtp_loss``
    (MTP configs only) and ``total_loss``, as the JAX package's.  The
    logits of a vision prefix are dropped: the loss is the tokens'."""
    pre_final, logits, aux = forward(params, batch, cfg)
    tokens = _tokens(params, batch["tokens"])
    n_prefix = logits.shape[1] - tokens.shape[1]
    loss = next_token_loss(logits[:, n_prefix:], tokens)
    metrics = {"lm_loss": loss, "aux_loss": aux}
    if cfg.mtp_depth:
        mtp_loss, mtp_aux = _mtp_loss(params, pre_final[:, n_prefix:], tokens, cfg)
        metrics["mtp_loss"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
        aux = aux + mtp_aux
    total = loss + aux
    metrics["total_loss"] = total
    return total, metrics


# =============================================================================
# serving: cache init / prefill / decode
# =============================================================================
def _layer_cache(cfg: ModelConfig, batch: int, max_len: int, window_cache: bool,
                 dtype: torch.dtype, device: Optional[torch.device]) -> dict:
    if cfg.ssm:
        return ssm_mod.init_mamba_state(cfg, batch, dtype=dtype, device=device)
    if cfg.use_mla:
        return mla_mod.init_mla_cache(cfg, batch, max_len, dtype=dtype, device=device)
    return attn.init_kv_cache(cfg, batch, max_len, window_cache=window_cache,
                              dtype=dtype, device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: Optional[torch.device] = None) -> dict:
    """Decode state organized like the layer plan: ``t`` (the next
    position, a Python int) and one cache dict per layer of ``prefix``,
    ``groups`` (a list per group) and ``tail`` (compressed MLA caches when
    ``cfg.use_mla``, conv ring and SSM state when ``cfg.ssm``), and with
    groups one full-length KV cache per group for the shared attention
    block (``shared``).  As in the JAX package, an attention tail keeps
    full-length caches when any of its layers is global, and ring buffers
    only when all are local."""
    dtype = torch_dtype(cfg.compute_dtype)
    plan = _layer_plan(cfg)
    cache: dict[str, Any] = {"t": 0}

    def local(i: int) -> bool:
        return bool(cfg.sliding_window) and not cfg.is_global_layer(i)

    if plan["prefix"]:
        cache["prefix"] = [_layer_cache(cfg, batch, max_len, local(i), dtype, device)
                           for i in range(plan["prefix"])]
    if plan["groups"]:
        per = plan["group_len"]
        cache["groups"] = [
            [_layer_cache(cfg, batch, max_len, local(g * per + i), dtype, device)
             for i in range(per)] for g in range(plan["groups"])]
        cache["shared"] = [
            attn.init_kv_cache(cfg, batch, max_len, dtype=dtype, device=device)
            for _ in range(plan["groups"])]
    if plan["tail"]:
        window_all = all(local(plan["prefix"] + i) for i in range(plan["tail"]))
        cache["tail"] = [_layer_cache(cfg, batch, max_len, window_all, dtype, device)
                         for _ in range(plan["tail"])]
    return cache


def _layer_caches(cache: dict) -> list:
    """The caches in ``_layers``' order: the shared block's cache of each
    group after its blocks'."""
    out = list(cache.get("prefix", []))
    for gc, sc in zip(cache.get("groups", []), cache.get("shared", [])):
        out += [*gc, sc]
    return out + list(cache.get("tail", []))


def _block_decode(bp, x: torch.Tensor, lcache: dict, t: int, cfg: ModelConfig, *,
                  is_global=True, dense_ffn: bool = False) -> torch.Tensor:
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    if cfg.ssm:
        y, _ = ssm_mod.mamba_decode(bp["mixer"], h, lcache, cfg)
    elif cfg.use_mla:
        y, _ = mla_mod.mla_decode(bp["mixer"], h, lcache, t, cfg)
    else:
        y, _ = attn.attention_decode(bp["mixer"], h, lcache, t, cfg,
                                     is_global=is_global)
    x = x + y
    if "ffn" in bp:
        h = rms_norm(x, bp["norm2"], cfg.norm_eps)
        if cfg.moe and not dense_ffn:
            # serving runs NO-DROP (cf = E/k caps capacity at the group size):
            # inference must not silently drop tokens from experts.  On a
            # mesh a decode batch is below EP's 64 tokens a rank: the local
            # path, one group of the whole batch, as JAX's gate picks
            y, _ = moe_mod.moe_apply(bp["ffn"], h, cfg, group_size=h.shape[0],
                                     capacity_factor=cfg.num_experts / cfg.top_k)
            x = x + y
        else:
            x = x + mlp_apply(bp["ffn"], h, cfg.mlp_variant)
    return x


def _shared_attn_decode(sp, x: torch.Tensor, lcache: dict, t: int,
                        cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, sp["norm1"], cfg.norm_eps)
    y, _ = attn.attention_decode(sp["attn"], h, lcache, t, cfg, is_global=True)
    x = x + y
    h = rms_norm(x, sp["norm2"], cfg.norm_eps)
    return x + mlp_apply(sp["mlp"], h, "gelu")


def decode_step(params: LM, cache: dict, tokens_new,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One decode step for the whole stack.  tokens_new (B, 1).  Updates
    ``cache`` in place and returns (logits (B, 1, V), cache).  On a mesh
    the cache is placed by ``sharding.cache_specs``, and the embedded token
    and the logits are pinned where JAX pins them (the batch; the logits'
    vocab over ``model``)."""
    cdt = torch_dtype(cfg.compute_dtype)
    t = cache["t"]
    x = constrain(embedding(_tokens(params, tokens_new), params["embed"]),
                  BATCH, None, None).to(cdt)
    for layer, lc in zip(_layers(params, cfg), _layer_caches(cache), strict=True):
        if layer is None:
            x = _shared_attn_decode(params["shared_attn"], x, lc, t, cfg)
        else:
            bp, is_global, dense_ffn = layer
            x = _block_decode(bp, x, lc, t, cfg, is_global=is_global,
                              dense_ffn=dense_ffn)
    cache["t"] = t + 1
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return constrain(hidden @ params.head(), BATCH, None, "model"), cache


def prefill(params: LM, tokens, cfg: ModelConfig,
            max_len: int) -> tuple[torch.Tensor, dict]:
    """Prefill by stepping decode over the prompt (reference implementation —
    simple and correct for every family; the serving benchmark uses the
    full-sequence forward for throughput numbers)."""
    tokens = _tokens(params, tokens)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, device=params.device)
    logits = []
    for i in range(s):
        step_logits, cache = decode_step(params, cache, tokens[:, i:i + 1], cfg)
        logits.append(step_logits[:, 0])
    return torch.stack(logits, dim=1), cache
