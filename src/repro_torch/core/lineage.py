"""Feature–model lineage subsystem (paper §4.6).

Challenges named by the paper, and how this module answers them:
  * scalability — a model may use hundreds+ of features: adjacency is kept
    as indexed sets both ways, so queries are O(degree), and registration is
    batched;
  * cross-region lineage — models deploy to any region while the feature
    store lives in one: edges carry the consuming deployment's region, and
    ``global_view`` aggregates across regions.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable

__all__ = ["LineageGraph", "ModelNode"]


@dataclasses.dataclass(frozen=True)
class ModelNode:
    name: str
    version: int
    region: str


class LineageGraph:
    def __init__(self) -> None:
        # feature ref = "<feature_set>:v<version>:<feature>"
        self._models_of_feature: dict[str, set[ModelNode]] = defaultdict(set)
        self._features_of_model: dict[ModelNode, set[str]] = defaultdict(set)

    def register_model(self, model: ModelNode, feature_refs: Iterable[str]) -> None:
        refs = set(feature_refs)
        self._features_of_model[model] |= refs
        for r in refs:
            self._models_of_feature[r].add(model)

    def features_of_model(self, model: ModelNode) -> set[str]:
        return set(self._features_of_model.get(model, set()))

    def models_of_feature(self, feature_ref: str) -> set[ModelNode]:
        return set(self._models_of_feature.get(feature_ref, set()))

    def models_by_region(self, feature_ref: str) -> dict[str, int]:
        out: dict[str, int] = defaultdict(int)
        for m in self._models_of_feature.get(feature_ref, set()):
            out[m.region] += 1
        return dict(out)

    def impact_of_feature_set(self, name: str, version: int) -> set[ModelNode]:
        """Every model touching any feature of the given feature-set version —
        the blast-radius query behind safe archival."""
        prefix = f"{name}:v{version}:"
        out: set[ModelNode] = set()
        for ref, models in self._models_of_feature.items():
            if ref.startswith(prefix):
                out |= models
        return out

    def global_view(self) -> dict:
        regions: dict[str, int] = defaultdict(int)
        for m in self._features_of_model:
            regions[m.region] += 1
        return {
            "num_models": len(self._features_of_model),
            "num_features": len(self._models_of_feature),
            "num_edges": sum(
                len(v) for v in self._features_of_model.values()
            ),
            "models_per_region": dict(regions),
        }
