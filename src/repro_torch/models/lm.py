"""Decoder-only LM, dense subset: phi3, gemma-2b, qwen1.5, gemma3.

The JAX package's ``models/lm.py`` as ``nn.Module``s: an ``LM`` holds
``embed``, ``final_norm``, ``lm_head`` (unless tied) and the layer plan's
``prefix`` and ``tail`` as ``ModuleList``s of ``Block``s, each with
``norm1``, ``mixer`` (attention), ``norm2`` and ``ffn``.  Parameter names
are the JAX dict keys and weights keep JAX's (in, out) layout, so ``x @ w``
is the same product (``convert.py`` moves weights across).  A Python loop
over the blocks replaces ``lax.scan``.  Where JAX wraps the tail's scan body
in ``jax.checkpoint`` (full rematerialisation of each block), the port runs
each tail block under ``torch.utils.checkpoint`` whenever a gradient is
recorded for trainable weights; the prefix is not checkpointed, as in JAX.
Serving's weights are frozen, so it runs the blocks plainly.  Local/global
layer flags are plain bools per layer.  The token embedding is
``F.embedding`` (the same rows as indexing): its backward on CUDA sums each
row's gradient in a fixed order, where indexing's backward (an accumulating
``index_put_``) is deterministic on CUDA only under
``torch.use_deterministic_algorithms``; so a train step is bit-reproducible
and a resumed run repeats an uninterrupted one.

MoE, MLA, SSM, hybrid, encoder/decoder, vision-prefix and MTP configs raise
``NotImplementedError``: those families are not ported yet (ROADMAP queue 1,
item 4).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, ParamModule, dense_init, mlp_apply, rms_norm, torch_dtype
from repro_torch.models.losses import next_token_loss

__all__ = [
    "Block",
    "LM",
    "check_supported",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "prefill",
    "train_loss",
]

_UNPORTED = ("moe", "use_mla", "ssm", "hybrid_attn_period", "encoder_decoder",
             "vision_prefix", "mtp_depth")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config family the port does not run yet."""
    on = [f for f in _UNPORTED if getattr(cfg, f)]
    if on:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(on)} not ported yet (ROADMAP queue 1, item 4); "
            "the port runs dense decoder-only configs"
        )


# =============================================================================
# init
# =============================================================================
class Block(ParamModule):
    """One transformer block: ``norm1``, ``mixer``, and (with a dense FFN)
    ``norm2`` and ``ffn``."""

    def __init__(self, gen, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: Optional[torch.device] = None) -> None:
        dev = gen.device if gen is not None else device
        super().__init__({"norm1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev)})
        self.mixer = attn.Attention(gen, cfg, dtype=dtype, device=device)
        if cfg.d_ff:
            self.register_parameter("norm2", nn.Parameter(
                torch.zeros((cfg.d_model,), dtype=dtype, device=dev), requires_grad=False))
            self.ffn = MLP(gen, cfg.d_model, cfg.d_ff, cfg.mlp_variant, dtype=dtype,
                           device=device)


def _layer_plan(cfg: ModelConfig) -> dict:
    """How the depth dimension is organized (must match init & apply): the
    JAX package's plan without the hybrid groups, which are not ported."""
    return {"prefix": cfg.first_dense_layers, "tail": cfg.num_layers - cfg.first_dense_layers}


class LM(ParamModule):
    """The dense decoder-only LM.  ``gen`` draws every weight in a fixed
    order (the JAX package draws from split keys, so the two packages give
    different weights from one seed); with ``gen=None`` the weights are left
    uninitialised on ``device`` for loading."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None, *,
                 device: Optional[torch.device] = None) -> None:
        check_supported(cfg)
        dtype = torch_dtype(cfg.param_dtype)
        dev = gen.device if gen is not None else device
        plan = _layer_plan(cfg)
        tensors = {
            "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), fan_in=cfg.d_model,
                                dtype=dtype, device=dev),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        }
        if not cfg.tie_embeddings:
            tensors["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype=dtype,
                                            device=dev)
        super().__init__(tensors)
        self.cfg = cfg
        self.prefix = nn.ModuleList(
            Block(gen, cfg, dtype=dtype, device=dev) for _ in range(plan["prefix"]))
        self.tail = nn.ModuleList(
            Block(gen, cfg, dtype=dtype, device=dev) for _ in range(plan["tail"]))

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
                 is_global=True) -> torch.Tensor:
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    x = x + attn.attention(bp["mixer"], h, positions, cfg, is_global=is_global)
    if "ffn" in bp:
        h = rms_norm(x, bp["norm2"], cfg.norm_eps)
        x = x + mlp_apply(bp["ffn"], h, cfg.mlp_variant)
    return x


def _tokens(params: LM, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.device).long()


def _embed_inputs(params: LM, cfg: ModelConfig, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Token embedding.  Returns (x, positions)."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = F.embedding(_tokens(params, batch["tokens"]), params["embed"]).to(cdt)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return x, positions


def _layers(params: LM, cfg: ModelConfig):
    """(block, is_global) over the whole stack, prefix then tail."""
    blocks = [*params["prefix"], *params["tail"]]
    return [(bp, cfg.is_global_layer(i)) for i, bp in enumerate(blocks)]


def forward(params: LM, batch: dict,
            cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (x before the final norm (B,S,D),
    logits, aux_loss).  While a gradient is recorded, each tail block is
    recomputed in the backward (``jax.checkpoint`` of the JAX tail scan)."""
    check_supported(cfg)
    x, positions = _embed_inputs(params, cfg, batch)
    n_prefix = len(params["prefix"])
    remat = torch.is_grad_enabled() and any(p.requires_grad for p in params.parameters())
    for i, (bp, is_global) in enumerate(_layers(params, cfg)):
        if remat and i >= n_prefix:
            x = checkpoint(_block_apply, bp, x, positions, cfg, is_global=is_global,
                           use_reentrant=False)
        else:
            x = _block_apply(bp, x, positions, cfg, is_global=is_global)
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = hidden @ params.head()
    return x, logits, torch.zeros((), dtype=torch.float32, device=x.device)


def train_loss(params: LM, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Next-token loss plus the aux loss (zero for the dense configs; the
    MTP branch belongs to an unported family and raises in
    ``check_supported``).  Returns (total, metrics)."""
    _, logits, aux = forward(params, batch, cfg)
    loss = next_token_loss(logits, _tokens(params, batch["tokens"]))
    total = loss + aux
    return total, {"lm_loss": loss, "aux_loss": aux, "total_loss": total}


# =============================================================================
# serving: cache init / prefill / decode
# =============================================================================
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: Optional[torch.device] = None) -> dict:
    """Decode state organized like the layer plan: ``t`` (the next
    position, a Python int) and one cache dict per layer of ``prefix`` and
    ``tail``.  As in the JAX package, the tail keeps full-length caches when
    any of its layers is global, and ring buffers only when all are local."""
    check_supported(cfg)
    dtype = torch_dtype(cfg.compute_dtype)
    plan = _layer_plan(cfg)
    cache: dict[str, Any] = {"t": 0}
    if plan["prefix"]:
        cache["prefix"] = [
            attn.init_kv_cache(
                cfg, batch, max_len,
                window_cache=bool(cfg.sliding_window) and not cfg.is_global_layer(i),
                dtype=dtype, device=device)
            for i in range(plan["prefix"])
        ]
    if plan["tail"]:
        window_all = bool(cfg.sliding_window) and all(
            not cfg.is_global_layer(plan["prefix"] + i) for i in range(plan["tail"])
        )
        cache["tail"] = [
            attn.init_kv_cache(cfg, batch, max_len, window_cache=window_all, dtype=dtype,
                               device=device)
            for _ in range(plan["tail"])
        ]
    return cache


def _block_decode(bp, x: torch.Tensor, lcache: dict, t: int, cfg: ModelConfig, *,
                  is_global=True) -> torch.Tensor:
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    y, _ = attn.attention_decode(bp["mixer"], h, lcache, t, cfg, is_global=is_global)
    x = x + y
    if "ffn" in bp:
        h = rms_norm(x, bp["norm2"], cfg.norm_eps)
        x = x + mlp_apply(bp["ffn"], h, cfg.mlp_variant)
    return x


def decode_step(params: LM, cache: dict, tokens_new,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One decode step for the whole stack.  tokens_new (B, 1).  Updates
    ``cache`` in place and returns (logits (B, 1, V), cache)."""
    check_supported(cfg)
    cdt = torch_dtype(cfg.compute_dtype)
    t = cache["t"]
    x = params["embed"][_tokens(params, tokens_new)].to(cdt)
    layer_caches = [*cache.get("prefix", []), *cache.get("tail", [])]
    for (bp, is_global), lc in zip(_layers(params, cfg), layer_caches):
        x = _block_decode(bp, x, lc, t, cfg, is_global=is_global)
    cache["t"] = t + 1
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return hidden @ params.head(), cache


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
