"""Uniform model API: the decoder-only half of the JAX package's
``models/api.py``, for the dense, MLA + MoE, SSM (mamba2) and hybrid
(zamba2) configs.

Everything downstream (steps, the serving driver, tests) talks to these
functions.  Each one that allocates takes ``device=`` (default ``"cuda"``,
resolved by ``device.resolve_device``: no card, no silent CPU).
The encoder/decoder assembly is not ported yet (ROADMAP queue 1, item 4):
its entry points raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

__all__ = [
    "init_params",
    "train_loss",
    "forward_logits",
    "init_cache",
    "decode_step",
    "encode_memory",
    "attach_memory",
    "make_dummy_batch",
]


def init_params(seed: int, cfg: ModelConfig, *, max_decode_len: int = 4096,
                device: str | torch.device = "cuda") -> lm.LM:
    """Weights drawn from ``seed`` on ``device`` (a generator on that
    device: the same seed gives other weights on another device type, and
    other weights than the JAX package's)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return lm.init_params(gen, cfg)


def train_loss(params: lm.LM, batch: dict, cfg: ModelConfig):
    """(total loss, metrics) of one batch: next-token loss plus aux."""
    return lm.train_loss(params, batch, cfg)


def forward_logits(params: lm.LM, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence logits (the prefill-throughput path)."""
    _, logits, _ = lm.forward(params, batch, cfg)
    return logits


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: str | torch.device = "cuda") -> dict:
    return lm.init_cache(cfg, batch, max_len, device=resolve_device(device))


def decode_step(params: lm.LM, cache: dict, tokens_new, cfg: ModelConfig):
    return lm.decode_step(params, cache, tokens_new, cfg)


def encode_memory(params, frames, cfg: ModelConfig):
    """Enc-dec only: run the encoder over (stub) frame embeddings."""
    raise NotImplementedError(
        "the encoder/decoder assembly is not ported yet (ROADMAP queue 1, item 4)"
    )


def attach_memory(cache: dict, memory, params, cfg: ModelConfig) -> dict:
    """Enc-dec only: precompute cross-attention K/V into the decode cache."""
    raise NotImplementedError(
        "the encoder/decoder assembly is not ported yet (ROADMAP queue 1, item 4)"
    )


def make_dummy_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
                     device: str | torch.device = "cuda") -> dict:
    """Concrete (allocated) token batch for smoke tests and examples."""
    lm.check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev,
                           dtype=torch.int32)
    return {"tokens": tokens}
