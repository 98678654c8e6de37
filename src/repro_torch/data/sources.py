"""Source systems (paper Fig. 2 'data sources').

Deterministic synthetic event streams: every read of the same window returns
identical rows (a property the materialization retry/consistency story
relies on, and that real sources provide via snapshot isolation).  Events are
generated per (entity, time-bucket) from a counter-based RNG, so reads are
O(window) regardless of history length and reproducible across processes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.table import Table

__all__ = ["SyntheticEventSource", "TokenEventSource"]


def _bucket_rng(seed: int, bucket: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, bucket]))


@dataclasses.dataclass
class SyntheticEventSource:
    """Numeric business events: (entity_id, ts, amount, quantity)."""

    name: str
    seed: int = 0
    num_entities: int = 100
    events_per_bucket: int = 50
    bucket_ms: int = 3_600_000  # one hour of simulated time
    #: late-arrival modelling: events land up to this many ms after their
    #: nominal bucket (exercises §4.4 delay handling).
    max_jitter_ms: int = 0

    def read(self, start_ts: int, end_ts: int) -> Table:
        start_ts = max(start_ts, 0)  # the event timeline starts at 0
        if end_ts <= start_ts:
            return Table(
                {
                    "entity_id": np.zeros(0, np.int64),
                    "ts": np.zeros(0, np.int64),
                    "amount": np.zeros(0, np.float32),
                    "quantity": np.zeros(0, np.float32),
                }
            )
        b0 = start_ts // self.bucket_ms
        b1 = (end_ts - 1) // self.bucket_ms
        ids, ts, amount, qty = [], [], [], []
        for b in range(b0, b1 + 1):
            rng = _bucket_rng(self.seed, b)
            n = self.events_per_bucket
            e = rng.integers(0, self.num_entities, n)
            t = b * self.bucket_ms + rng.integers(0, self.bucket_ms, n)
            if self.max_jitter_ms:
                t = t + rng.integers(0, self.max_jitter_ms, n)
            a = rng.gamma(2.0, 50.0, n).astype(np.float32)
            q = rng.integers(1, 10, n).astype(np.float32)
            ids.append(e)
            ts.append(t)
            amount.append(a)
            qty.append(q)
        tab = Table(
            {
                "entity_id": np.concatenate(ids).astype(np.int64),
                "ts": np.concatenate(ts).astype(np.int64),
                "amount": np.concatenate(amount),
                "quantity": np.concatenate(qty),
            }
        )
        m = (tab["ts"] >= start_ts) & (tab["ts"] < end_ts)
        out = tab.filter(m)
        return out.take(np.argsort(out["ts"], kind="stable"))


@dataclasses.dataclass
class TokenEventSource:
    """Token-sequence events for the LM data pipeline: each event is one
    document chunk (entity = document id) carrying ``chunk_len`` token ids.

    This is how the feature store becomes the training data plane: chunks are
    materialized like any feature, then PIT-retrieved as training batches
    (launch/train.py), guaranteeing the model never reads tokens "from the
    future" of its data-availability clock.
    """

    name: str
    seed: int = 0
    vocab_size: int = 32_000
    num_docs: int = 512
    chunk_len: int = 128
    chunks_per_bucket: int = 64
    bucket_ms: int = 3_600_000

    def read(self, start_ts: int, end_ts: int) -> Table:
        start_ts = max(start_ts, 0)  # the event timeline starts at 0
        end_ts = max(end_ts, 1)
        cols: dict[str, list[np.ndarray]] = {"doc_id": [], "ts": []}
        tok_cols: list[np.ndarray] = []
        b0 = start_ts // self.bucket_ms
        b1 = max(b0, (end_ts - 1) // self.bucket_ms)
        for b in range(b0, b1 + 1):
            rng = _bucket_rng(self.seed, b)
            n = self.chunks_per_bucket
            cols["doc_id"].append(rng.integers(0, self.num_docs, n).astype(np.int64))
            cols["ts"].append(
                (b * self.bucket_ms + rng.integers(0, self.bucket_ms, n)).astype(
                    np.int64
                )
            )
            # Zipfian-ish token stream, reproducible per bucket.
            toks = (
                rng.zipf(1.3, size=(n, self.chunk_len)).astype(np.int64)
                % self.vocab_size
            )
            tok_cols.append(toks)
        table_cols: dict[str, np.ndarray] = {
            "doc_id": np.concatenate(cols["doc_id"]),
            "ts": np.concatenate(cols["ts"]),
        }
        toks = np.concatenate(tok_cols, axis=0)
        for j in range(self.chunk_len):
            table_cols[f"tok_{j}"] = toks[:, j].astype(np.float32)
        tab = Table(table_cols)
        m = (tab["ts"] >= start_ts) & (tab["ts"] < end_ts)
        out = tab.filter(m)
        return out.take(np.argsort(out["ts"], kind="stable"))
