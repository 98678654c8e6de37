"""Store-fed prefill: the online store feeds each request's context.

Set-up materializes one hour of session events (``generate.session_events``)
into the program's ``FeatureStore`` (online store only, one scheduled job),
loads the configuration's weights (``weights.py``) into the port's ``LM``,
draws the window's requests from the seed, and serves ``warmup_batches``
batches of the window's shape.  The window is a closed loop of batches of
``batch`` requests: each batch GETs its sessions' latest chunks
(``FeatureStore.get_online_features``: the serving front, the online store,
the lookup kernel), builds each prompt as that 32-token context (BOS for a
cold session, as ``launch/serve.py`` does) followed by its request tokens,
runs ``make_prefill_step`` over the batch, takes the greedy token at every
position, and brings the last position's to the host: the request's first
token.  The next batch starts when it is there.

What the timed path produced is checked after the window: every GET's
contexts against the latest-wins record of the events (exact), and the
served tokens of a seeded sample of the completed requests against the
plain float32 reference (``configs/<reference>.py``): how far each served
token's reference logit lies below the reference's best, the widest and the
mean gap (the cell's limits file names the one compared).
"""

from __future__ import annotations

import contextlib
import gc
import math
import time

import numpy as np
import torch

from fsbench import generate, spec, trace, weights

__all__ = ["SessionPrefill", "run"]

FEATURE_SET = "session_context"


def _identity(df, ctx):
    return df


def latest_by_session(events: dict, sessions: int) -> tuple[np.ndarray, np.ndarray]:
    """(found (sessions,), tokens (sessions, L)) of the latest-wins record
    of each session: the greatest timestamp, the first drawn among equal
    ones (all rows share one creation time, one job)."""
    sid, ts = events["session_id"], events["ts"]
    order = np.lexsort((np.arange(len(sid)), -ts, sid))
    first = order[np.r_[True, sid[order][1:] != sid[order][:-1]]]
    found = np.zeros(sessions, bool)
    vals = np.zeros((sessions, events["tokens"].shape[1]), np.float32)
    found[sid[first]] = True
    vals[sid[first]] = events["tokens"][first]
    return found, vals


class SessionPrefill:
    def __init__(self, cell, seed: int, device) -> None:
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        self.c, self.t = cell.config, cell.traffic
        self.plane, self.rq = self.t["plane"], self.t["requests"]
        self.vocab = self.c["vocab_size"]
        self.batches: list = []
        self.trace = None

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core.assets import (Entity, Feature, FeatureSetSpec,
                                             MaterializationSettings)
        from repro_torch.core.dsl import UDFTransform
        from repro_torch.core.featurestore import FeatureStore
        from repro_torch.launch.steps import make_prefill_step
        from repro_torch.models import lm

        plane, dev = self.plane, self.dev
        t0 = time.perf_counter()
        self.events = generate.session_events(plane, self.vocab, self.seed, dev)
        src = generate.EventSource("session_events", self.events, "session_id")
        width = plane["chunk_tokens"]
        fset = FeatureSetSpec(
            name=FEATURE_SET, version=1, entity=Entity("session", ("session_id",)),
            features=tuple(Feature(f"tok_{j}", "float32") for j in range(width)),
            source_name=src.name, transform=UDFTransform(_identity, name="identity"),
            timestamp_col="ts",
            materialization=MaterializationSettings(
                offline_enabled=False, online_enabled=True,
                schedule_interval=plane["hour_ms"]))
        self.fs = FeatureStore("fsbench-sessions", device=dev,
                               online_partitions=plane["online_partitions"],
                               merge_engine=plane["merge_engine"])
        self.fs.register_source(src)
        self.fs.create_feature_set(fset)
        self.fs.tick(now=plane["hour_ms"])
        self.stages = {"plane_s": time.perf_counter() - t0}
        t0 = time.perf_counter()

        cfg = spec.model_config(self.c)
        self.model = lm.LM(cfg, None, device=dev)
        weights.load(self.model, self.c, self.seed, dev)
        self.prefill = make_prefill_step(cfg)
        self.stages["weights_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        b, r, pool = self.rq["batch"], self.rq["request_tokens"], self.rq["pool_batches"]
        self.ids = generate.session_ids(plane["sessions"], self.rq["session_zipf_s"],
                                        (pool, b), self.seed)
        self.req_tokens = generate.zipf_tokens(generate.generator(self.seed, 3, device=dev),
                                               (pool, b, r), self.vocab,
                                               plane["token_zipf_s"], dev)
        spans = trace.Spans()
        with torch.no_grad():
            for i in range(self.rq["warmup_batches"]):
                self._batch(pool - 1 - i, spans)
                self.stages.setdefault("warmup_first_s", time.perf_counter() - t0)
        self.stages["warmup_s"] = time.perf_counter() - t0

    # -- the timed path -------------------------------------------------------
    def _batch(self, slot: int, spans: trace.Spans):
        ids = self.ids[slot]
        with spans("get"):
            vals, found = self.fs.get_online_features(FEATURE_SET, 1, [ids])
        with spans("build"):
            ctx = np.clip(vals.astype(np.int64), 0, self.vocab - 1)
            ctx[~found] = self.c["bos_token_id"]
            tokens = torch.cat([torch.from_numpy(ctx).to(self.dev), self.req_tokens[slot]], 1)
        with spans("forward"):
            served = torch.argmax(self.prefill(self.model, {"tokens": tokens}), -1)
        with spans("first_token"):
            served[:, -1].cpu()
        return ids, vals, found, tokens, served

    def serve(self, seconds: float, traced: bool = False) -> dict:
        """The closed loop for ``seconds``: the last batch started before
        they ran out ends the window."""
        spans = trace.Spans(traced)
        usable = self.rq["pool_batches"] - self.rq["warmup_batches"]
        done = []
        with torch.no_grad(), trace.profiler(traced) as prof:
            mark = (torch.profiler.record_function(trace.WINDOW) if traced
                    else contextlib.nullcontext())
            with mark:
                start = time.perf_counter()
                while time.perf_counter() - start < seconds:
                    t0 = time.perf_counter()
                    out = self._batch(len(done) % usable, spans)
                    done.append((time.perf_counter() - t0, *out))
                window_s = time.perf_counter() - start
        if traced:
            self.trace = trace.reduce(prof)
        self.batches = done
        self.spans = spans.seconds
        b, s = done[0][4].shape
        lat = np.repeat([d[0] for d in done], b)
        return {"window_s": window_s, "batches": len(done), "attempted": len(lat),
                "prompt_tokens": len(lat) * s, "batch": b, "seq": s,
                "prefill_tokens_per_s": len(lat) * s / window_s,
                "ttft_p95_ms": float(np.percentile(lat, 95)) * 1e3}

    def release(self) -> None:
        """Frees the program's state before the reference runs."""
        self.fs = self.model = self.prefill = self.req_tokens = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- checks -----------------------------------------------------------
    def context_mismatches(self) -> int:
        """Requests whose GET disagrees with the latest-wins record."""
        found, vals = latest_by_session(self.events, self.plane["sessions"])
        bad = 0
        for _, ids, got, hit, _, _ in self.batches:
            wrong = (hit != found[ids]) | (hit & (got != vals[ids]).any(1))
            bad += int(wrong.sum())
        return bad

    def sample(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(prompts, served tokens) of a seeded sample of the completed
        requests, ``sample_positions`` positions in all."""
        b, s = self.batches[0][4].shape
        n = min(math.ceil(self.t["check"]["sample_positions"] / s), b * len(self.batches))
        rng = np.random.default_rng(generate.derived_seed(self.seed, 4))
        pick = np.sort(rng.choice(b * len(self.batches), n, replace=False))
        tokens = torch.stack([self.batches[i // b][4][i % b] for i in pick])
        served = torch.stack([self.batches[i // b][5][i % b] for i in pick])
        return tokens, served

    def logit_gaps(self, control: bool = False) -> tuple[dict, dict | None]:
        """The served tokens' gaps to the reference's best; with ``control``
        also those of the control in the program's place: the tokens the
        fp8 reference puts first at the same positions."""
        ref = spec.reference(self.c)
        tokens, served = self.sample()
        layer = lambda g: weights.draw(self.c, self.seed, g, self.dev)  # noqa: E731
        logits = ref.forward(self.c, tokens, layer)
        gaps = {"positions": int(served.numel()), **_gap_stats(ref.served_gap(logits, served))}
        if not control:
            return gaps, None
        low = ref.forward(self.c, tokens, layer, fp8=True).argmax(-1)
        return gaps, {"positions": int(low.numel()), **_gap_stats(ref.served_gap(logits, low))}


def _gap_stats(gap: torch.Tensor) -> dict:
    """The widest gap, the mean gap and the share of positions whose
    served token is not the reference's argmax."""
    return {"logit_gap": float(gap.max()), "mean_gap": float(gap.mean()),
            "not_argmax": float((gap > 0).float().mean())}


def run(cell, seed: int, seconds: float, traced: bool, device, control: bool = False) -> dict:
    """One run: set-up, the window, then the checks with the program freed.
    Returns what the harness reports; with ``control`` also the checks of
    the control in the program's place (``control_checks``)."""
    job = SessionPrefill(cell, seed, device)
    job.setup()
    setup_done = time.perf_counter()
    result = job.serve(seconds=seconds, traced=traced)
    peak = torch.cuda.max_memory_allocated(job.dev) if job.dev.type == "cuda" else 0
    job.release()
    t0 = time.perf_counter()
    mismatches = {"context_mismatches": job.context_mismatches()}
    gaps, low = job.logit_gaps(control)
    job.stages["check_s"] = time.perf_counter() - t0
    return {"job": job, "setup_done": setup_done, "result": result, "memory_peak": peak,
            "checks": {**mismatches, **gaps},
            "control_checks": low and {**mismatches, **low},
            "trace": job.trace, "spans": job.spans, "stages": job.stages}
