"""Cloud-provider value types (pkg/cloudprovider/types.go:72-175):
InstanceType with requirements, offerings, capacity and overhead, and the
typed errors of the create path."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

from karpenter_core_tpu_torch.api.labels import LABEL_CAPACITY_TYPE
from karpenter_core_tpu_torch.kube.objects import LABEL_TOPOLOGY_ZONE, ResourceList
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

    def requirements(self, reqs: Requirements) -> "Offerings":
        """The offerings whose zone and capacity type the requirements
        allow (types.go:133-138)."""
        return Offerings(
            o for o in self
            if (LABEL_TOPOLOGY_ZONE not in reqs
                or reqs.get_requirement(LABEL_TOPOLOGY_ZONE).has(o.zone))
            and (LABEL_CAPACITY_TYPE not in reqs
                 or reqs.get_requirement(LABEL_CAPACITY_TYPE).has(o.capacity_type))
        )

    def cheapest(self) -> Offering:
        return min(self, key=lambda o: o.price)


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


class MachineNotFoundError(Exception):
    """types.go:148-175."""


class CloudProviderError(RuntimeError):
    """The base of the typed create-path failures."""


class InsufficientCapacityError(CloudProviderError):
    """The provider could not launch the offering (an insufficient-capacity
    error); carries the exhausted offering's key."""

    def __init__(self, message: str = "insufficient capacity",
                 instance_type: str = "", zone: str = "", capacity_type: str = ""):
        super().__init__(message)
        self.instance_type = instance_type
        self.zone = zone
        self.capacity_type = capacity_type

    def offering_key(self) -> Tuple[str, str, str]:
        return (self.instance_type, self.zone, self.capacity_type)


class IncompatibleRequirementsError(CloudProviderError):
    """No instance type satisfies the machine's requirements: a defect of
    the request, which a retry cannot fix."""


def offering_pool_matches(pool: Tuple[str, str, str], instance_type: str,
                          zone: str, capacity_type: str) -> bool:
    """Match an (instance type, zone, capacity type) pool key, an empty
    component matching anything."""
    pool_it, pool_zone, pool_ct = pool
    return ((not pool_it or pool_it == instance_type)
            and (not pool_zone or pool_zone == zone)
            and (not pool_ct or pool_ct == capacity_type))
