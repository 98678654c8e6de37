"""Batched serving driver: online feature retrieval -> prefill -> decode.

The request path exercises the paper's low-latency plane end to end:
  1. each request names a document/session (entity id);
  2. the ONLINE store serves the session's latest context feature (its most
     recent token chunk — the "session state" pattern) via the CUDA lookup
     kernel (the plain lookup on a CPU store);
  3. the model prefills the retrieved context by stepping decode over it,
     then decodes new tokens greedily.

Offline/online skew shows up here as a wrong prompt: the served context must
equal the offline store's latest record for the session.

    python -m repro_torch.launch.serve --arch gemma3-1b   # reduced config, on the card

``main`` runs the reduced config of ``--arch`` on the card, as the JAX
package's ``main`` does; ``serve`` takes any config (a full one, or a
float32 one with converted weights) and a device.  An encoder/decoder
(whisper) first encodes zero frames (B, encoder_seq, D), as the JAX driver
does, and attaches the memory's cross K/V to the decode cache; a
vision-prefix config (pixtral) serves text-only, as there.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.featurestore import FeatureStore
from repro_torch.data.loader import HOUR, TokenFeatureSet
from repro_torch.data.sources import TokenEventSource
from repro_torch.device import resolve_device
from repro_torch.models import api

__all__ = ["build_serving_plane", "main", "serve"]


def build_serving_plane(cfg, *, seed: int = 0, device: str | torch.device = "cuda"):
    """The token feature plane the requests read: 64 documents of 32-token
    chunks, three hourly jobs materialized into both stores."""
    src = TokenEventSource(
        "token_stream", seed=seed, vocab_size=cfg.vocab_size,
        num_docs=64, chunk_len=32, chunks_per_bucket=128,
    )
    fs = FeatureStore("lm-serving-plane", device=device)
    fs.register_source(src)
    spec = fs.create_feature_set(TokenFeatureSet(src))
    fs.tick(now=3 * HOUR)
    return fs, spec, src


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg, *, requests: int = 8, new_tokens: int = 16, seed: int = 0,
          device: str | torch.device = "cuda", params=None, plane=None,
          keep_logits: bool = False) -> dict:
    """One batch of ``requests`` sessions through the request path.
    ``params`` defaults to weights drawn from ``seed`` on ``device``;
    ``plane`` to ``build_serving_plane(cfg, seed=seed, device=device)``.
    With ``keep_logits`` the result holds the stepped prefill's logits at
    every prompt position (B, S, V)."""
    dev = resolve_device(device)
    fs, spec, src = plane if plane is not None else build_serving_plane(
        cfg, seed=seed, device=dev)

    # -- request batch: sessions ask for continuations -----------------------
    rng = np.random.default_rng(seed)
    doc_ids = rng.integers(0, src.num_docs, requests).astype(np.int64)

    t0 = time.perf_counter()
    ctx_vals, found = fs.get_online_features(spec.name, spec.version, [doc_ids])
    lookup_ms = (time.perf_counter() - t0) * 1e3
    prompts = np.clip(ctx_vals.astype(np.int64), 0, cfg.vocab_size - 1)
    prompts = np.where(found[:, None], prompts, 1)  # cold sessions: BOS-ish

    max_len = prompts.shape[1] + new_tokens
    if params is None:
        params = api.init_params(seed, cfg, max_decode_len=max_len, device=dev)
    cache = api.init_cache(cfg, requests, max_len, device=dev)
    encode_ms = None
    if cfg.encoder_decoder:
        t0 = time.perf_counter()
        frames = torch.zeros((requests, cfg.encoder_seq, cfg.d_model), device=dev)
        memory = api.encode_memory(params, frames, cfg)
        cache = api.attach_memory(cache, memory, params, cfg)
        _sync(dev)
        encode_ms = (time.perf_counter() - t0) * 1e3

    # prefill by stepping the prompt (reference path), then decode new tokens
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    prompt_logits = []
    t1 = time.perf_counter()
    for i in range(prompts.shape[1]):
        logits, cache = api.decode_step(params, cache, toks[:, i : i + 1], cfg)
        if keep_logits:
            prompt_logits.append(logits[:, 0])
    _sync(dev)
    prefill_ms = (time.perf_counter() - t1) * 1e3
    generated = []
    cur = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
    for _ in range(new_tokens):
        generated.append(cur[:, 0].cpu().numpy())
        logits, cache = api.decode_step(params, cache, cur, cfg)
        cur = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
    _sync(dev)
    decode_ms = (time.perf_counter() - t1) * 1e3

    out = {
        "requests": requests,
        "context_hits": int(found.sum()),
        "online_lookup_ms": lookup_ms,
        "encode_ms": encode_ms,  # the encoder and the cross K/V (enc-dec only)
        "prefill_ms": prefill_ms,
        "decode_ms_total": decode_ms,  # stepped prefill + decode, as in the JAX driver
        "tokens_generated": int(new_tokens * requests),
        "generated": np.stack(generated, axis=1),
        "doc_ids": doc_ids,
        "contexts": ctx_vals,
        "found": found,
        "prompts": prompts,
    }
    if keep_logits:
        out["prompt_logits"] = torch.stack(prompt_logits, dim=1)
    print(
        f"[serve] {requests} reqs, {out['context_hits']} warm sessions, "
        f"lookup {lookup_ms:.2f}ms, {out['tokens_generated']} tokens in "
        f"{decode_ms:.0f}ms"
    )
    return out


def main(argv=None, *, device: str | torch.device = "cuda") -> dict:
    """The JAX driver's flags and defaults: the reduced config of ``--arch``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="gemma3-1b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=True)
    return serve(cfg, requests=args.requests, new_tokens=args.new_tokens, seed=args.seed,
                 device=device)


if __name__ == "__main__":
    main()
