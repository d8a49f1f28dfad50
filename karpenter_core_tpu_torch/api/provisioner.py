"""Provisioner: the declarative node-pool spec (provisioner.go:32-136,
limits.go): labels, taints, requirements, capacity limits, weight, the
expiry TTL and consolidation."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_core_tpu_torch.kube.objects import (
    NodeSelectorRequirement,
    ObjectMeta,
    ResourceList,
    Taint,
)


@dataclass
class Limits:
    """Capacity bounds for a provisioner (limits.go)."""

    resources: ResourceList = field(default_factory=dict)


@dataclass
class Consolidation:
    """provisioner.go:83: whether the provisioner's nodes may be
    consolidated."""

    enabled: Optional[bool] = None


@dataclass
class ProvisionerSpec:
    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    requirements: List[NodeSelectorRequirement] = field(default_factory=list)
    limits: Optional[Limits] = None
    weight: Optional[int] = None
    ttl_seconds_until_expired: Optional[int] = None
    consolidation: Optional[Consolidation] = None


@dataclass
class Provisioner:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ProvisionerSpec = field(default_factory=ProvisionerSpec)

    def __post_init__(self):
        self.metadata.namespace = ""  # cluster-scoped

    @property
    def name(self) -> str:
        return self.metadata.name

    def consolidation_enabled(self) -> bool:
        return bool(self.spec.consolidation and self.spec.consolidation.enabled)


def order_by_weight(provisioners: List[Provisioner]) -> List[Provisioner]:
    """Descending weight; missing weight is 0 (provisioner.go:132-136)."""
    return sorted(provisioners, key=lambda p: -(p.spec.weight or 0))
