"""Asset metadata management, versioning, and hub-and-spoke sharing
(paper §4.1, §4.1.1, §4.1.2, §3.2).

* Versioning contract: IMMUTABLE properties (schema, source binding,
  transformation code — ``FeatureSetSpec.immutable_fingerprint()``) may only
  change via a new version; MUTABLE properties (description, tags,
  materialization policy) update in place.
* Hub-and-spoke: the feature store (hub) owns assets; consuming ML
  workspaces (spokes) attach to hubs — possibly across subscriptions and
  regions — instead of peer-to-peer workspace pairing.
* Cross-region access control: an asset is readable from another region iff
  the hub grants access (our implemented mechanism, matching the paper's
  current choice) — geo-replication is the alternative mechanism handled by
  regions.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.assets import Entity, FeatureSetSpec

__all__ = ["AssetRegistry", "Workspace", "RegistryError"]


class RegistryError(RuntimeError):
    pass


@dataclasses.dataclass
class Workspace:
    """A consuming ML workspace (spoke)."""

    name: str
    subscription: str
    region: str


class AssetRegistry:
    """The metadata store of one feature store (hub)."""

    def __init__(self, store_name: str, region: str, subscription: str):
        self.store_name = store_name
        self.region = region
        self.subscription = subscription
        self._entities: dict[str, Entity] = {}
        self._feature_sets: dict[tuple[str, int], FeatureSetSpec] = {}
        self._archived: set[tuple[str, int]] = set()
        self._spokes: dict[str, Workspace] = {}
        # cross-region ACL: workspace name -> set of asset names (or "*")
        self._grants: dict[str, set[str]] = {}

    # -- entities -------------------------------------------------------------
    def create_entity(self, entity: Entity) -> Entity:
        if entity.name in self._entities:
            existing = self._entities[entity.name]
            if existing.join_keys != entity.join_keys:
                raise RegistryError(
                    f"entity {entity.name!r} exists with different join keys "
                    f"{existing.join_keys}; entities are created once and "
                    f"reused (§2.2)"
                )
            return existing
        self._entities[entity.name] = entity
        return entity

    def get_entity(self, name: str) -> Entity:
        return self._entities[name]

    # -- feature sets -----------------------------------------------------------
    def create_feature_set(self, spec: FeatureSetSpec) -> FeatureSetSpec:
        key = spec.key
        if key in self._feature_sets:
            existing = self._feature_sets[key]
            if existing.immutable_fingerprint() != spec.immutable_fingerprint():
                raise RegistryError(
                    f"{spec.name}:v{spec.version} exists with different "
                    f"immutable properties; increment the version instead (§4.1)"
                )
            raise RegistryError(f"{spec.name}:v{spec.version} already exists")
        if spec.entity.name not in self._entities:
            self.create_entity(spec.entity)
        self._feature_sets[key] = spec
        return spec

    def update_mutable(
        self,
        name: str,
        version: int,
        *,
        description: Optional[str] = None,
        tags: Optional[tuple[str, ...]] = None,
        materialization=None,
    ) -> FeatureSetSpec:
        spec = self.get_feature_set(name, version)
        if description is not None:
            spec.description = description
        if tags is not None:
            spec.tags = tags
        if materialization is not None:
            spec.materialization = materialization
        return spec

    def next_version(self, name: str) -> int:
        versions = [v for (n, v) in self._feature_sets if n == name]
        return max(versions, default=0) + 1

    def get_feature_set(self, name: str, version: int) -> FeatureSetSpec:
        key = (name, version)
        if key in self._archived:
            raise RegistryError(f"{name}:v{version} is archived")
        if key not in self._feature_sets:
            raise RegistryError(f"unknown feature set {name}:v{version}")
        return self._feature_sets[key]

    def latest_version(self, name: str) -> FeatureSetSpec:
        versions = [
            v
            for (n, v) in self._feature_sets
            if n == name and (n, v) not in self._archived
        ]
        if not versions:
            raise RegistryError(f"unknown feature set {name}")
        return self._feature_sets[(name, max(versions))]

    def archive(self, name: str, version: int) -> None:
        if (name, version) not in self._feature_sets:
            raise RegistryError(f"unknown feature set {name}:v{version}")
        self._archived.add((name, version))

    # -- search & discovery (§1: search and reuse) -------------------------------
    def search(
        self, text: str = "", *, tag: Optional[str] = None
    ) -> list[FeatureSetSpec]:
        out = []
        for key, spec in sorted(self._feature_sets.items()):
            if key in self._archived:
                continue
            blob = " ".join(
                [
                    spec.name,
                    spec.description,
                    *(f.name for f in spec.features),
                    *(f.description for f in spec.features),
                ]
            ).lower()
            if text.lower() in blob and (tag is None or tag in spec.tags):
                out.append(spec)
        return out

    def list_feature_sets(self) -> list[tuple[str, int]]:
        return sorted(k for k in self._feature_sets if k not in self._archived)

    # -- hub-and-spoke sharing (§4.1.1) --------------------------------------------
    def attach_workspace(self, ws: Workspace) -> None:
        self._spokes[ws.name] = ws

    def grant_access(self, workspace: str, asset: str = "*") -> None:
        self._grants.setdefault(workspace, set()).add(asset)

    def resolve_for_workspace(
        self, ws_name: str, name: str, version: int
    ) -> tuple[FeatureSetSpec, str]:
        """Spoke-side resolution.  Returns (spec, access_mode) where mode is
        'local' (same region) or 'cross-region' (ACL-gated, §4.1.2)."""
        if ws_name not in self._spokes:
            raise RegistryError(
                f"workspace {ws_name!r} is not attached to hub "
                f"{self.store_name!r} (hub-and-spoke required, §4.1.1)"
            )
        ws = self._spokes[ws_name]
        spec = self.get_feature_set(name, version)
        if ws.region == self.region:
            return spec, "local"
        grants = self._grants.get(ws_name, set())
        if "*" in grants or name in grants:
            return spec, "cross-region"
        raise RegistryError(
            f"workspace {ws_name!r} in region {ws.region!r} has no "
            f"cross-region grant for asset {name!r} (§4.1.2)"
        )
