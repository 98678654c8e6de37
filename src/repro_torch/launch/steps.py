"""Step functions: the units the drivers execute.

  * train_step — fwd + bwd + optimizer update
  * serve_step — one decode token against a KV/state cache (updated in place)
  * prefill_step — full-sequence logits (the prefill-throughput unit)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.monitoring import span
from repro_torch.models import api
from repro_torch.models.api import Model
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import Optimizer

__all__ = ["TrainState", "greedy", "loss_and_grads", "make_prefill_step", "make_serve_step",
           "make_train_step", "train_state_placements"]


@dataclasses.dataclass
class TrainState:
    """The model (an ``LM`` or an ``EncDec``, its weights made trainable),
    the optimizer state over its named parameters, and the step count (an
    int32 0-d tensor)."""

    params: Model
    opt: Any
    step: torch.Tensor

    def __post_init__(self) -> None:
        self.params.requires_grad_(True)

    @staticmethod
    def create(params: Model, optimizer: Optimizer) -> "TrainState":
        return TrainState(params, optimizer.init(dict(params.named_parameters())),
                          torch.zeros((), dtype=torch.int32, device=params.device))


def loss_and_grads(params: Model, batch: dict, cfg: ModelConfig) -> tuple[dict, dict]:
    """(metrics, gradients by parameter name) of ``api.train_loss`` on one
    batch: fwd + bwd, no update.  On a mesh each gradient is redistributed
    to its parameter's placements (the data-parallel reduction: a partial
    sum becomes an all-reduce or a reduce-scatter) and the metrics are
    replicated DTensors."""
    named = dict(params.named_parameters())
    loss, metrics = api.train_loss(params, batch, cfg)
    grads = torch.autograd.grad(loss, list(named.values()))
    grads = [_placed_like(g, p) for g, p in zip(grads, named.values())]
    return {k: v.detach() for k, v in metrics.items()}, dict(zip(named, grads))


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def train_state_placements(state: "TrainState", mesh) -> dict:
    """DTensor placements of every leaf of ``state`` on ``mesh``: the
    parameters by ``sharding.param_specs``, the moments by
    ``sharding.opt_state_specs`` (float32 moments; ``count`` and ``step``
    stay plain, the same on every rank).  Restoring a checkpoint takes this
    dict as ``placements=``."""
    from repro_torch.models import sharding

    specs = sharding.param_specs(state.params, state.params.cfg, mesh)
    opt = sharding.opt_state_specs(state.opt, specs, mesh)
    if any(isinstance(x, dict) for x in state.opt["m"].values()):
        raise NotImplementedError("int8 moments on a mesh: the sharded driver keeps "
                                  "float32 moments, as the JAX driver does")
    pl = lambda tree: {n: sharding.placements(s, mesh) for n, s in tree.items()}  # noqa: E731
    return {"mesh": mesh, "params": pl(specs), "m": pl(opt["m"]), "v": pl(opt["v"])}


def make_train_step(
    cfg: ModelConfig, optimizer: Optimizer, *, num_microbatches: int = 1
) -> Callable:
    """fwd+bwd+update.  ``num_microbatches`` > 1 accumulates float32
    gradients over batch slices and takes their mean, as the JAX step's
    ``lax.scan`` does (activation memory 1/µ of the full batch, the same
    math; a batch's ``frames`` or ``patch_embeds`` are sliced with its
    tokens); the metrics are the last slice's.  Every config family trains.

    The step consumes its state, as the JAX driver's donated state is
    consumed: the optimizer writes the new weights into ``state.params`` and
    the new float32 moments into ``state.opt`` in place (one copy of each,
    not two), and the returned state holds the same model and optimizer
    state.  A caller that needs the state from before a step rebuilds it.
    Each step is a root span ``step.train``, its update ``step.optimizer``."""

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        with span("step.train"):
            if num_microbatches == 1:
                metrics, grads = loss_and_grads(state.params, batch, cfg)
            else:
                mb = {k: _microbatches(x, num_microbatches) for k, x in batch.items()}
                grads = {n: torch.zeros_like(p, dtype=torch.float32,
                                             memory_format=torch.contiguous_format)
                         for n, p in state.params.named_parameters()}
                for i in range(num_microbatches):
                    metrics, g = loss_and_grads(state.params,
                                                {k: x[i] for k, x in mb.items()}, cfg)
                    for n, gi in g.items():
                        grads[n] += gi.float()
                grads = {n: a / num_microbatches for n, a in grads.items()}

            with span("step.optimizer"):
                _, opt = optimizer.update(grads, state.opt,
                                          dict(state.params.named_parameters()))
            return TrainState(state.params, opt, state.step + 1), metrics

    return train_step


def _microbatches(x, n: int):
    """``x``'s rows in ``n`` equal slices, slice i rows [i·B/n, (i+1)·B/n)
    as the JAX step's reshape takes them.  A DTensor is sliced on each
    rank's own rows (slice i: rows [i·b/n, (i+1)·b/n) of the rank's b), so
    no slice moves between ranks: the slices hold other rows than JAX's,
    the mean of their gradients is the same (every slice is as large), and
    the metrics, the last slice's, are another slice's."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        local = x.to_local()
        return [DTensor.from_local(part, x.device_mesh, x.placements, run_check=False)
                for part in local.reshape(n, -1, *local.shape[1:])]
    return torch.as_tensor(x).reshape(n, -1, *x.shape[1:])


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One greedy decode step: (the next tokens, int32 (B,), the cache
    updated in place).  On a mesh the tokens are a DTensor on the batch
    placement (``greedy``)."""
    def serve_step(params, cache, tokens_new):
        logits, cache = api.decode_step(params, cache, tokens_new, cfg)
        last = logits[..., -1, :] if logits.ndim == 3 else logits
        return greedy(last), cache

    return serve_step


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The argmax over the last dim of ``logits`` as int32, ties to the
    lowest index (``torch.argmax`` on one device).  A DTensor whose vocab
    is split over ``model`` is not gathered: each rank takes its own
    (max, index) pair and the pairs are joined over the ranks, the first
    rank holding the max winning."""
    from repro_torch.models.pspec import is_dtensor, local_call, seq_placements, shard_of

    if not is_dtensor(logits):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    last = logits.ndim - 1
    vocab = shard_of(logits, last)
    return local_call(lambda x: _greedy_local(x, vocab), (logits,),
                      (seq_placements(logits, {0: 0, last: last}),),
                      seq_placements(logits, {0: 0}))


def _greedy_local(logits: torch.Tensor, vocab) -> torch.Tensor:
    idx = torch.argmax(logits, dim=-1)
    if vocab is None:
        return idx.to(torch.int32)
    from repro_torch.models.pspec import gather_over

    group, index, _ = vocab
    best = torch.gather(logits, -1, idx[..., None])[..., 0]
    idx = idx + index * logits.shape[-1]
    vals = gather_over(best[None], 0, group)       # (ranks, B): each rank's max
    idxs = gather_over(idx[None], 0, group)
    return torch.gather(idxs, 0, torch.argmax(vals, dim=0)[None])[0].to(torch.int32)


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """Full-sequence logits of ``batch``: its ``tokens``, and its ``frames``
    (encoder/decoder) or ``patch_embeds`` (vision prefix) if given; each
    call a root span ``step.prefill``."""
    def prefill_step(params, batch):
        with span("step.prefill"):
            return api.forward_logits(params, batch, cfg)

    return prefill_step
