"""Cloud-provider value types (pkg/cloudprovider/types.go:72-145):
InstanceType with requirements, offerings, capacity and overhead."""
from __future__ import annotations

from dataclasses import dataclass, field

from karpenter_core_tpu_torch.kube.objects import ResourceList
from karpenter_core_tpu_torch.scheduling.requirements import Requirements
from karpenter_core_tpu_torch.utils import resources as resources_util


@dataclass(frozen=True)
class Offering:
    """types.go:106-113."""

    capacity_type: str
    zone: str
    price: float
    available: bool = True


class Offerings(list):
    """types.go:119-145."""

    def available(self) -> "Offerings":
        return Offerings(o for o in self if o.available)

    def get(self, capacity_type: str, zone: str):
        """The offering of a capacity type in a zone, or None
        (types.go:127-133)."""
        for o in self:
            if o.capacity_type == capacity_type and o.zone == zone:
                return o
        return None


@dataclass
class InstanceTypeOverhead:
    """types.go:91-103."""

    kube_reserved: ResourceList = field(default_factory=dict)
    system_reserved: ResourceList = field(default_factory=dict)
    eviction_threshold: ResourceList = field(default_factory=dict)

    def total(self) -> ResourceList:
        return resources_util.merge(
            self.kube_reserved, self.system_reserved, self.eviction_threshold
        )


@dataclass
class InstanceType:
    """types.go:72-89."""

    name: str
    requirements: Requirements = field(default_factory=Requirements)
    offerings: Offerings = field(default_factory=Offerings)
    capacity: ResourceList = field(default_factory=dict)
    overhead: InstanceTypeOverhead = field(default_factory=InstanceTypeOverhead)

    def allocatable(self) -> ResourceList:
        return resources_util.subtract(self.capacity, self.overhead.total())
