"""Store-fed training: the offline store is the data plane.

Set-up materializes ``hours`` hours of document chunks
(``generate.doc_events``) through the program's ``FeatureStore`` (the
token feature set of ``data/loader.py``, both stores, one scheduled job an
hour), builds the port's ``FeatureStoreLoader`` over it with its clock at
the last hour, loads the configuration's weights (``weights.py``) into the
port's ``LM``, and builds one ``TrainState`` and ``make_train_step`` with
the training entry point's optimizer (``launch/train.py``
``train_optimizer``: AdamW, float32 moments, warm-up and cosine, decay
0.01, clip 1.0).  It then drives
that state through its first ``checked_steps`` steps through the window's
own call and feed, reading what the check compares: each step's loss, the
first gradient as the optimizer got it (its first moment / (1 - b1) after
one step) and each weight's change after the last of them.  The window
hands on the same state: each step is a point-in-time batch
(``FeatureStoreLoader.sample_batch`` at the clock), its upload, forward,
backward and AdamW, ended by reading the loss on the host.

The check: every step's batch, the set-up's and the window's, against the
point-in-time batch the plain reference draws from the events (exact, and
no token past the clock), and the checked steps against the reference's
training steps (``configs/<reference>.py`` ``train``) by the worst of the
loss, the leaves' gradient norms and the leaves' change norms.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from fsbench import generate, spec, trace, weights

__all__ = ["PitTrain", "reference_batch", "run"]

def reference_batch(events: dict, clock: int, seed: int, step: int, batch: int,
                    seq: int) -> tuple[np.ndarray, np.ndarray]:
    """The point-in-time batch of ``step`` at ``clock``: (tokens (B, S)
    int32, each row's newest chunk time).  Chunks up to the clock, one per
    (document, time) (the first drawn: the offline store's full-key
    dedup); rows draw documents with replacement from a generator of
    (seed, step, rank 0), each row the document's newest ceil(S/L) chunks
    in time order, left-padded with 0."""
    doc, ts, tok = events["doc_id"], events["ts"], events["tokens"]
    order = np.lexsort((np.arange(len(doc)), ts, doc))
    first = np.r_[True, (doc[order][1:] != doc[order][:-1]) | (ts[order][1:] != ts[order][:-1])]
    order = order[first]
    order = order[ts[order] <= clock]
    docs = np.unique(doc[order])
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 0]))
    chosen = rng.choice(docs, size=batch, replace=True)
    width = tok.shape[1]
    n_chunks = -(-seq // width)
    out = np.zeros((batch, n_chunks * width), np.int64)
    newest = np.zeros(batch, np.int64)
    for i, d in enumerate(chosen):
        rows = order[doc[order] == d][-n_chunks:]
        flat = tok[rows].astype(np.int64).reshape(-1)
        out[i, out.shape[1] - len(flat):] = flat
        newest[i] = ts[rows].max()
    return out[:, :seq].astype(np.int32), newest


class PitTrain:
    def __init__(self, cell, seed: int, device) -> None:
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        self.c, self.t = cell.config, cell.traffic
        self.plane, self.st = self.t["plane"], self.t["steps"]
        self.fed: list = []              # (step, tokens, newest chunk time) of every step
        self.trace = None

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core.featurestore import FeatureStore
        from repro_torch.data.loader import FeatureStoreLoader, TokenFeatureSet
        from repro_torch.launch.steps import TrainState, make_train_step
        from repro_torch.launch.train import train_optimizer
        from repro_torch.models import lm

        plane, st, dev = self.plane, self.st, self.dev
        t0 = time.perf_counter()
        self.events = generate.doc_events(plane, self.c["vocab_size"], self.seed, dev)
        src = generate.EventSource("token_stream", self.events, "doc_id")
        fs = FeatureStore("fsbench-data-plane", device=dev)
        fs.register_source(src)
        fset = fs.create_feature_set(TokenFeatureSet(src))
        self.loader_seed = generate.derived_seed(self.seed, 5)
        self.loader = FeatureStoreLoader(store=fs, spec=fset, seq_len=st["seq"],
                                         batch_size=st["batch"], chunk_len=src.chunk_len,
                                         seed=self.loader_seed)
        self.loader.advance(plane["hours"] * plane["hour_ms"])
        self.stages = {"plane_s": time.perf_counter() - t0}
        t0 = time.perf_counter()

        cfg = spec.model_config(self.c)
        model = lm.LM(cfg, None, device=dev)
        weights.load(model, self.c, self.seed, dev)
        optimizer = train_optimizer(st["lr"], st["total_steps"])
        self.state = TrainState.create(model, optimizer)
        self.step_fn = make_train_step(cfg, optimizer)
        self.stages["weights_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # the checked steps: the window's own call and feed
        named = dict(self.state.params.named_parameters())
        start = {n: p.detach().to("cpu", copy=True) for n, p in named.items()}
        spans, self.losses = trace.Spans(), []
        for step in range(st["checked_steps"]):
            self.losses.append(self._step(step, spans))
            if step == 0:
                self.grad_norms = {n: float(m.norm() / (1 - st["b1"]))
                                   for n, m in self.state.opt["m"].items()}
            self.stages.setdefault("first_step_s", time.perf_counter() - t0)
        with torch.no_grad():
            self.change_norms = {n: float((p.float() - start[n].to(dev).float()).norm())
                                 for n, p in named.items()}
        del start
        self.next_step = st["checked_steps"]
        self.stages["checked_steps_s"] = time.perf_counter() - t0

    # -- the timed path -------------------------------------------------------
    def _step(self, step: int, spans: trace.Spans) -> float:
        with spans("batch"):
            batch = self.loader.sample_batch(step)
            tokens = torch.as_tensor(batch["tokens"], device=self.dev)
        with spans("step"):
            self.state, metrics = self.step_fn(self.state, {"tokens": tokens})
        with spans("sync"):
            loss = float(metrics["total_loss"])
        self.fed.append((step, batch["tokens"], batch["__max_event_ts__"]))
        return loss

    def serve(self, seconds: float, traced: bool = False) -> dict:
        spans = trace.Spans(traced)
        steps = 0
        with trace.profiler(traced) as prof:
            mark = (torch.profiler.record_function(trace.WINDOW) if traced
                    else contextlib.nullcontext())
            with mark:
                start = time.perf_counter()
                while time.perf_counter() - start < seconds:
                    self._step(self.next_step, spans)
                    self.next_step += 1
                    steps += 1
                window_s = time.perf_counter() - start
        if traced:
            self.trace = trace.reduce(prof)
        self.spans = spans.seconds
        b, s = self.st["batch"], self.st["seq"]
        return {"window_s": window_s, "steps": steps, "batch": b, "seq": s,
                "attempted": steps, "train_tokens_per_s": steps * b * s / window_s}

    def release(self) -> None:
        self.state = self.step_fn = self.loader = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- checks -----------------------------------------------------------
    def pit_mismatches(self) -> int:
        """Steps whose batch differs from the reference's point-in-time
        batch, or holds a chunk from after the clock."""
        clock = self.plane["hours"] * self.plane["hour_ms"]
        bad = 0
        for step, tokens, newest in self.fed:
            want, want_newest = reference_batch(self.events, clock, self.loader_seed, step,
                                                self.st["batch"], self.st["seq"])
            bad += int(not (np.array_equal(tokens, want) and np.array_equal(newest, want_newest)
                            and (newest <= clock).all()))
        return bad

    def reference_gaps(self, control: bool = False) -> tuple[dict, dict | None]:
        """The checked steps against the reference's: the worst relative
        gap of the losses, and of the leaves' gradient and change norms
        (each against the larger of its leaf's reference norm and the
        median leaf's).  Leaves whose reference gradient is under a
        thousandth of the median leaf's move by round-off alone under
        AdamW and are left out of the change.  With ``control`` also the
        gaps of the control in the program's place: the fp8 reference's
        steps on the same batches."""
        ref = spec.reference(self.c)
        batches = [torch.as_tensor(tokens, device=self.dev).long()
                   for step, tokens, _ in self.fed[: self.st["checked_steps"]]]
        layer = lambda g: weights.draw(self.c, self.seed, g, self.dev)  # noqa: E731
        opt = {k: self.st[k] for k in ("lr", "warmup_steps", "total_steps", "b1", "b2", "eps",
                                       "weight_decay", "clip")}
        r = ref.train(self.c, batches, layer, opt)
        got = gaps({"loss": self.losses, "grad_norms": self.grad_norms,
                    "change_norms": self.change_norms}, r)
        if not control:
            return got, None
        return got, gaps(ref.train(self.c, batches, layer, opt, fp8=True), r)


def gaps(got: dict, want: dict) -> dict:
    """The worst relative gaps of ``got``'s losses, gradient norms and
    change norms to ``want``'s (the reference's)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
    g_ref = want["grad_norms"]
    g_med = float(np.median(list(g_ref.values())))
    grad = max(abs(got["grad_norms"][n] - g) / max(g, g_med) for n, g in g_ref.items())
    moved = [n for n, g in g_ref.items() if g >= 1e-3 * g_med]
    c_ref = want["change_norms"]
    c_med = float(np.median([c_ref[n] for n in moved]))
    change = max(abs(got["change_norms"][n] - c_ref[n]) / max(c_ref[n], c_med)
                 for n in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "left_out": len(g_ref) - len(moved)}


def run(cell, seed: int, seconds: float, traced: bool, device, control: bool = False) -> dict:
    """One run: set-up with the checked steps, the window, then the checks
    with the program freed; with ``control`` also the control's checks."""
    job = PitTrain(cell, seed, device)
    job.setup()
    setup_done = time.perf_counter()
    result = job.serve(seconds, traced=traced)
    peak = torch.cuda.max_memory_allocated(job.dev) if job.dev.type == "cuda" else 0
    job.release()
    t0 = time.perf_counter()
    mismatches = {"pit_mismatches": job.pit_mismatches()}
    got, low = job.reference_gaps(control)
    job.stages["check_s"] = time.perf_counter() - t0
    return {"job": job, "setup_done": setup_done, "result": result, "memory_peak": peak,
            "checks": {**mismatches, **got}, "control_checks": low and {**mismatches, **low},
            "trace": job.trace, "spans": job.spans, "stages": job.stages}
