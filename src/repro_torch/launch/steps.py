"""Step functions: the units the serving drivers execute.

  * serve_step — one decode token against a KV cache (updated in place)
  * prefill_step — full-sequence logits (the prefill-throughput unit)

The JAX package's ``TrainState`` and ``make_train_step`` wait for the
optimizer's port (ROADMAP §2.3).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import api
from repro_torch.models.config import ModelConfig

__all__ = ["make_serve_step", "make_prefill_step"]


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params, cache, tokens_new):
        logits, cache = api.decode_step(params, cache, tokens_new, cfg)
        last = logits[..., -1, :] if logits.ndim == 3 else logits
        return torch.argmax(last, dim=-1).to(torch.int32), cache

    return serve_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch):
        return api.forward_logits(params, batch, cfg)

    return prefill_step
