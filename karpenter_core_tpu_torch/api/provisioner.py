"""Provisioner: the declarative node-pool spec (provisioner.go:32-136,
limits.go, provisioner_status.go): labels, annotations, taints,
requirements, kubelet configuration, the provider reference, capacity
limits, weight, the empty and expiry TTLs and consolidation, with the
status resources the launch path's limits check reads."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_core_tpu_torch.kube.objects import (
    Condition,
    NodeSelectorRequirement,
    ObjectMeta,
    ResourceList,
    Taint,
)


@dataclass
class KubeletConfiguration:
    """The kubelet settings a machine carries (machine.go:46-115)."""

    cluster_dns: List[str] = field(default_factory=list)
    container_runtime: Optional[str] = None
    max_pods: Optional[int] = None
    pods_per_core: Optional[int] = None
    system_reserved: ResourceList = field(default_factory=dict)
    kube_reserved: ResourceList = field(default_factory=dict)
    eviction_hard: Dict[str, str] = field(default_factory=dict)
    eviction_soft: Dict[str, str] = field(default_factory=dict)
    eviction_soft_grace_period: Dict[str, str] = field(default_factory=dict)
    image_gc_high_threshold_percent: Optional[int] = None
    image_gc_low_threshold_percent: Optional[int] = None


@dataclass
class ProviderRef:
    kind: str = ""
    name: str = ""
    api_version: str = ""


@dataclass
class Limits:
    """Capacity bounds for a provisioner (limits.go)."""

    resources: ResourceList = field(default_factory=dict)

    def exceeded_by(self, used: ResourceList) -> Optional[str]:
        """An error if `used` exceeds any limit (limits.go ExceededBy)."""
        for name, limit in self.resources.items():
            if used.get(name, 0.0) > limit:
                return (
                    f"{name} resource usage of {used.get(name, 0.0):g} exceeds limit of {limit:g}"
                )
        return None


@dataclass
class Consolidation:
    """provisioner.go:83: whether the provisioner's nodes may be
    consolidated."""

    enabled: Optional[bool] = None


@dataclass
class ProvisionerSpec:
    annotations: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    requirements: List[NodeSelectorRequirement] = field(default_factory=list)
    kubelet_configuration: Optional[KubeletConfiguration] = None
    provider: Optional[dict] = None
    provider_ref: Optional[ProviderRef] = None
    limits: Optional[Limits] = None
    weight: Optional[int] = None
    ttl_seconds_after_empty: Optional[int] = None
    ttl_seconds_until_expired: Optional[int] = None
    consolidation: Optional[Consolidation] = None


@dataclass
class ProvisionerStatus:
    last_scale_time: Optional[float] = None
    conditions: List[Condition] = field(default_factory=list)
    resources: ResourceList = field(default_factory=dict)


@dataclass
class Provisioner:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ProvisionerSpec = field(default_factory=ProvisionerSpec)
    status: ProvisionerStatus = field(default_factory=ProvisionerStatus)

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
