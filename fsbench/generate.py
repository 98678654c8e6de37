"""Traffic from the seed: the copies this benchmark keeps of the program's
event generator (``data/sources.py`` ``TokenEventSource``: chunks of
Zipf-distributed token ids, one document or session id and one timestamp
each, uniform over the ids and over the hour) and of the Zipf draw of
``benchmarks/bench_serving.py`` (inverse CDF over ranks 1..n).

Token ids are drawn on the device, in bulk, by inverse CDF of a Zipf law
truncated to the vocabulary (the original takes ``rng.zipf(s) % vocab`` on
the host, row by row of buckets, which costs seconds at 2^20 chunks).  The
same seed gives the same traffic on one device type; the CPU's generator
gives other draws than the card's.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["EventSource", "derived_seed", "doc_events", "session_events", "session_ids",
           "zipf_cdf", "zipf_tokens"]


def derived_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of the run, from ``--seed``."""
    ss = np.random.SeedSequence([seed % (1 << 64), *stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, *stream: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derived_seed(seed, *stream))


def zipf_cdf(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return np.cumsum(w) / w.sum()


def zipf_tokens(gen: torch.Generator, shape, vocab: int, s: float,
                device) -> torch.Tensor:
    """int64 token ids in [1, vocab): rank r has weight r^-s."""
    cdf = torch.as_tensor(zipf_cdf(vocab - 1, s), device=device)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp_(max=vocab - 2) + 1


def session_events(plane: dict, vocab: int, seed: int, device) -> dict:
    """One hour of ``events`` chunks over ``sessions`` ids: numpy
    ``session_id`` (int64), ``ts`` (int64 ms in [0, hour)), ``tokens``
    (events, chunk_tokens) float32, as the store's float32 features."""
    gen = generator(seed, 1, device=device)
    n, ids = plane["events"], plane["sessions"]
    sid = torch.randint(0, ids, (n,), generator=gen, device=device)
    ts = torch.randint(0, plane["hour_ms"], (n,), generator=gen, device=device)
    tok = zipf_tokens(gen, (n, plane["chunk_tokens"]), vocab, plane["token_zipf_s"], device)
    return {"session_id": sid.cpu().numpy(), "ts": ts.cpu().numpy(),
            "tokens": tok.to(torch.float32).cpu().numpy()}


def session_ids(sessions: int, s: float, shape, seed: int) -> np.ndarray:
    """Zipf(s) popularity over ``sessions`` ids; rank r is id
    (r · 0x9E3779B1) mod sessions (a power of two: a bijection), so the hot
    sessions spread over the store's partitions."""
    if sessions & (sessions - 1):
        raise ValueError(f"{sessions} sessions: the rank-to-id map needs a power of two")
    rng = np.random.default_rng(derived_seed(seed, 2))
    rank = np.searchsorted(zipf_cdf(sessions, s), rng.random(shape)).astype(np.int64)
    return (rank * 0x9E3779B1) % sessions


def doc_events(plane: dict, vocab: int, seed: int, device) -> dict:
    """``hours`` hours of ``chunks_per_hour`` chunks each over ``docs``
    documents: numpy ``doc_id``, ``ts`` (uniform over each hour) and
    ``tokens`` (chunks, chunk_tokens) float32."""
    gen = generator(seed, 6, device=device)
    hours, per = plane["hours"], plane["chunks_per_hour"]
    n = hours * per
    doc = torch.randint(0, plane["docs"], (n,), generator=gen, device=device)
    hour = torch.arange(hours, device=device).repeat_interleave(per) * plane["hour_ms"]
    ts = hour + torch.randint(0, plane["hour_ms"], (n,), generator=gen, device=device)
    tok = zipf_tokens(gen, (n, plane["chunk_tokens"]), vocab, plane["token_zipf_s"], device)
    return {"doc_id": doc.cpu().numpy(), "ts": ts.cpu().numpy(),
            "tokens": tok.to(torch.float32).cpu().numpy()}


class EventSource:
    """Drawn events as a source of the program's store: the rows in
    [start, end), ordered by timestamp, ties in the order drawn, with the
    key column ``key``, ``ts`` and one ``tok_<j>`` column a token."""

    def __init__(self, name: str, events: dict, key: str) -> None:
        self.name, self.events, self.key = name, events, key
        self.chunk_len = events["tokens"].shape[1]

    def read(self, start_ts: int, end_ts: int):
        from repro_torch.core.table import Table

        ev = self.events
        keep = np.nonzero((ev["ts"] >= max(start_ts, 0)) & (ev["ts"] < end_ts))[0]
        keep = keep[np.argsort(ev["ts"][keep], kind="stable")]
        cols = {self.key: ev[self.key][keep], "ts": ev["ts"][keep]}
        tok = ev["tokens"][keep]
        cols.update((f"tok_{j}", np.ascontiguousarray(tok[:, j])) for j in range(tok.shape[1]))
        return Table(cols)
