"""Uniform model API over the two assemblies: the decoder-only ``lm.LM``
(the dense, MLA + MoE, SSM, hybrid and vision-prefix configs) and the
encoder/decoder ``encdec.EncDec`` (whisper), as the JAX package's
``models/api.py``.

Everything downstream (steps, the drivers, tests) talks to these functions;
the family dispatch (``cfg.encoder_decoder``) lives here and nowhere else.
Each one that allocates takes ``device=`` (default ``"cuda"``, resolved by
``device.resolve_device``: no card, no silent CPU).
"""

from __future__ import annotations

from typing import Union

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype

__all__ = [
    "Model",
    "init_params",
    "train_loss",
    "forward_logits",
    "init_cache",
    "decode_step",
    "encode_memory",
    "attach_memory",
    "make_dummy_batch",
]

Model = Union[lm.LM, encdec.EncDec]


def init_params(seed: int, cfg: ModelConfig, *, max_decode_len: int = 4096,
                device: str | torch.device = "cuda") -> Model:
    """Weights drawn from ``seed`` on ``device`` (a generator on that
    device: the same seed gives other weights on another device type, and
    other weights than the JAX package's).  ``max_decode_len`` sizes an
    encoder/decoder's learned decoder positions."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.encoder_decoder:
        return encdec.init_params(gen, cfg, max_pos=max_decode_len)
    return lm.init_params(gen, cfg)


def train_loss(params: Model, batch: dict, cfg: ModelConfig):
    """(total loss, metrics) of one batch: next-token loss plus aux."""
    if cfg.encoder_decoder:
        return encdec.train_loss(params, batch, cfg)
    return lm.train_loss(params, batch, cfg)


def forward_logits(params: Model, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence logits (the prefill-throughput path); with a vision
    prefix, the patches' positions come first."""
    if cfg.encoder_decoder:
        memory = encdec.encode(params, batch["frames"], cfg)
        return encdec.decode_full(params, memory, batch["tokens"], cfg)
    _, logits, _ = lm.forward(params, batch, cfg)
    return logits


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: str | torch.device = "cuda") -> dict:
    if cfg.encoder_decoder:
        return encdec.init_cache(cfg, batch, max_len, device=resolve_device(device))
    return lm.init_cache(cfg, batch, max_len, device=resolve_device(device))


def decode_step(params: Model, cache: dict, tokens_new, cfg: ModelConfig):
    if cfg.encoder_decoder:
        return encdec.decode_step(params, cache, tokens_new, cfg)
    return lm.decode_step(params, cache, tokens_new, cfg)


def encode_memory(params: encdec.EncDec, frames, cfg: ModelConfig) -> torch.Tensor:
    """Enc-dec only: run the encoder over (stub) frame embeddings."""
    return encdec.encode(params, frames, cfg)


def attach_memory(cache: dict, memory: torch.Tensor, params: encdec.EncDec,
                  cfg: ModelConfig) -> dict:
    """Enc-dec only: precompute cross-attention K/V into the decode cache."""
    return encdec.precompute_cross(params, memory, cfg, cache)


def make_dummy_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
                     device: str | torch.device = "cuda") -> dict:
    """Concrete (allocated) batch for smoke tests and examples: ``tokens``,
    and an encoder/decoder's ``frames`` (B, encoder_seq, D) or a vision
    prefix's ``patch_embeds`` (B, num_patches, vision_dim), standard normal
    in the compute dtype, all drawn from one generator seeded ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev,
                           dtype=torch.int32)
    out = {"tokens": tokens}
    cdt = torch_dtype(cfg.compute_dtype)
    normal = lambda shape: torch.randn(shape, generator=gen, device=dev).to(cdt)  # noqa: E731
    if cfg.encoder_decoder:
        out["frames"] = normal((batch, cfg.encoder_seq, cfg.d_model))
    if cfg.vision_prefix:
        out["patch_embeds"] = normal((batch, cfg.num_patches, cfg.vision_dim))
    return out
