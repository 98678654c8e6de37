"""Feature-store-backed LM training data pipeline.

The feature store IS the data plane (DESIGN.md §3): token-chunk events are
materialized into the offline store like any feature set, and training
batches are produced by point-in-time retrieval at the run's data clock —
the model can never read tokens from the future of its observation time
(the §4.4 leakage guarantee applied to pretraining data), which the
integration tests assert as a property.

Determinism & distribution:
  * batch content is a pure function of (seed, step) — restart-stable;
  * data-parallel ranks read disjoint document slices (doc_id % world == rank),
    the same contract a multi-host input pipeline needs;
  * the loader cursor (clock) checkpoints alongside the train state.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.assets import Entity, Feature, FeatureSetSpec, MaterializationSettings
from repro_torch.core.dsl import UDFTransform
from repro_torch.core.featurestore import FeatureStore
from repro_torch.core.offline_store import EVENT_TS
from repro_torch.core.table import Table
from repro_torch.data.sources import TokenEventSource

__all__ = ["TokenFeatureSet", "FeatureStoreLoader"]

HOUR = 3_600_000


def TokenFeatureSet(source: TokenEventSource, *, version: int = 1) -> FeatureSetSpec:
    """Feature set materializing raw token chunks (identity transform)."""
    features = tuple(
        Feature(f"tok_{j}", "float32") for j in range(source.chunk_len)
    )

    def identity(df: Table, ctx: dict) -> Table:
        return df.rename({"doc_id": "doc_id"})

    return FeatureSetSpec(
        name="token_chunks",
        version=version,
        entity=Entity("document", ("doc_id",)),
        features=features,
        source_name=source.name,
        transform=UDFTransform(identity, name="identity_chunks"),
        timestamp_col="ts",
        source_lookback=0,
        materialization=MaterializationSettings(
            offline_enabled=True,
            online_enabled=True,
            schedule_interval=HOUR,
        ),
    )


@dataclasses.dataclass
class FeatureStoreLoader:
    store: FeatureStore
    spec: FeatureSetSpec
    seq_len: int
    batch_size: int
    chunk_len: int
    seed: int = 0
    rank: int = 0
    world: int = 1
    clock: int = 0  # data-availability clock (ms); checkpointed

    def advance(self, to: int) -> None:
        """Materialize everything due before ``to`` and move the clock."""
        self.clock = max(self.clock, to)
        self.store.tick(now=self.clock)

    # -- batch construction ------------------------------------------------
    def _history(self) -> Table:
        return self.store.offline.read(self.spec.name, self.spec.version)

    def sample_batch(self, step: int) -> dict:
        """(seed, step)-deterministic batch, PIT-correct at the clock."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.rank])
        )
        hist = self._history()
        if len(hist) == 0:
            raise RuntimeError("no materialized token chunks; call advance()")
        ts0 = self.clock
        eligible = hist.filter(
            (hist[EVENT_TS] <= ts0 - self.spec.expected_delay)
            & (hist["doc_id"] % self.world == self.rank)
        )
        if len(eligible) == 0:
            raise RuntimeError(f"rank {self.rank} has no eligible chunks")
        # newest-last ordering per doc
        eligible = eligible.take(
            np.lexsort((eligible[EVENT_TS], eligible["doc_id"]))
        )
        docs = np.unique(eligible["doc_id"])
        chosen = rng.choice(docs, size=self.batch_size, replace=True)

        n_chunks = -(-self.seq_len // self.chunk_len)
        tok_cols = [f"tok_{j}" for j in range(self.chunk_len)]
        toks = np.stack([eligible[c] for c in tok_cols], axis=1).astype(np.int64)

        batch = np.zeros((self.batch_size, n_chunks * self.chunk_len), np.int64)
        max_ev = np.zeros(self.batch_size, np.int64)
        doc_rows: dict[int, np.ndarray] = {}
        doc_ids_col = eligible["doc_id"]
        for i, d in enumerate(chosen):
            rows = doc_rows.get(int(d))
            if rows is None:
                rows = np.nonzero(doc_ids_col == d)[0]
                doc_rows[int(d)] = rows
            take = rows[-n_chunks:]
            seq = toks[take].reshape(-1)
            batch[i, -len(seq):] = seq  # left-pad with 0 when history is short
            max_ev[i] = eligible[EVENT_TS][take].max()
        return {
            "tokens": batch[:, : self.seq_len].astype(np.int32),
            "__max_event_ts__": max_ev,  # leakage-property hook (tests)
            "__observation_ts__": np.full(self.batch_size, ts0, np.int64),
        }

    # -- checkpoint integration ------------------------------------------------
    def state_dict(self) -> dict:
        return {"clock": self.clock, "seed": self.seed}

    def load_state_dict(self, d: dict) -> None:
        self.clock = int(d["clock"])
        self.seed = int(d["seed"])
