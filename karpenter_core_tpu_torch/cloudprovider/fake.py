"""The reference's fake cloud provider, reduced to what the solve and the
consolidation search read: the instance-type universe generators
(fake/instancetype.go:48-167) and FakeCloudProvider.get_instance_types
(fake/cloudprovider.go:41-160 without machine creation)."""
from __future__ import annotations

from typing import List, Optional

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.cloudprovider.types import (
    InstanceType,
    InstanceTypeOverhead,
    Offering,
    Offerings,
)
from karpenter_core_tpu_torch.kube.objects import (
    LABEL_ARCH_STABLE,
    LABEL_INSTANCE_TYPE_STABLE,
    LABEL_OS_STABLE,
    LABEL_TOPOLOGY_ZONE,
    ResourceList,
)
from karpenter_core_tpu_torch.scheduling.requirement import (
    OP_DOES_NOT_EXIST,
    OP_IN,
    Requirement,
)
from karpenter_core_tpu_torch.scheduling.requirements import Requirements

GI = 2**30

LABEL_INSTANCE_SIZE = "size"
EXOTIC_INSTANCE_LABEL_KEY = "special"
INTEGER_INSTANCE_LABEL_KEY = "integer"

api_labels.register_well_known_labels(
    LABEL_INSTANCE_SIZE, EXOTIC_INSTANCE_LABEL_KEY, INTEGER_INSTANCE_LABEL_KEY
)


def price_from_resources(resources: ResourceList) -> float:
    """fake/instancetype.go:175-187 (without the GPU vendor resources)."""
    price = 0.0
    for name, value in resources.items():
        if name == "cpu":
            price += 0.1 * value
        elif name == "memory":
            price += 0.1 * value / 1e9
    return price


def new_instance_type(
    name: str,
    resources: Optional[ResourceList] = None,
    offerings: Optional[List[Offering]] = None,
    architecture: str = "",
    operating_systems: Optional[List[str]] = None,
) -> InstanceType:
    """fake/instancetype.go:48-107: defaulted 4cpu/4Gi/5pods, five offerings
    over three zones, well-known plus fake-specific requirements."""
    resources = dict(resources or {})
    resources.setdefault("cpu", 4.0)
    resources.setdefault("memory", 4.0 * GI)
    if not resources.get("pods"):
        resources["pods"] = 5.0
    if offerings is None:
        price = price_from_resources(resources)
        offerings = [
            Offering("spot", "test-zone-1", price),
            Offering("spot", "test-zone-2", price),
            Offering("on-demand", "test-zone-1", price),
            Offering("on-demand", "test-zone-2", price),
            Offering("on-demand", "test-zone-3", price),
        ]
    offerings = Offerings(offerings)
    architecture = architecture or "amd64"
    operating_systems = operating_systems or ["linux", "windows", "darwin"]

    available = offerings.available()
    requirements = Requirements(
        [
            Requirement(LABEL_INSTANCE_TYPE_STABLE, OP_IN, [name]),
            Requirement(LABEL_ARCH_STABLE, OP_IN, [architecture]),
            Requirement(LABEL_OS_STABLE, OP_IN, operating_systems),
            Requirement(LABEL_TOPOLOGY_ZONE, OP_IN, sorted({o.zone for o in available})),
            Requirement(
                api_labels.LABEL_CAPACITY_TYPE,
                OP_IN,
                sorted({o.capacity_type for o in available}),
            ),
            Requirement(INTEGER_INSTANCE_LABEL_KEY, OP_IN, [str(int(resources["cpu"]))]),
        ]
    )
    if resources["cpu"] > 4 and resources["memory"] > 8 * GI:
        requirements.add(Requirement(LABEL_INSTANCE_SIZE, OP_IN, ["large"]))
        requirements.add(Requirement(EXOTIC_INSTANCE_LABEL_KEY, OP_IN, ["optional"]))
    else:
        requirements.add(Requirement(LABEL_INSTANCE_SIZE, OP_IN, ["small"]))
        requirements.add(Requirement(EXOTIC_INSTANCE_LABEL_KEY, OP_DOES_NOT_EXIST))

    return InstanceType(
        name=name,
        requirements=requirements,
        offerings=offerings,
        capacity=resources,
        overhead=InstanceTypeOverhead(
            kube_reserved={"cpu": 0.1, "memory": 10 * 2**20}
        ),
    )


def instance_types(total: int) -> List[InstanceType]:
    """Incrementing ladder: (i+1) cpu, 2(i+1)Gi, 10(i+1) pods
    (fake/instancetype.go:151-167)."""
    return [
        new_instance_type(
            f"fake-it-{i}",
            resources={
                "cpu": float(i + 1),
                "memory": float((i + 1) * 2 * GI),
                "pods": float((i + 1) * 10),
            },
        )
        for i in range(total)
    ]


class FakeCloudProvider:
    """Serves one instance-type universe to every provisioner; the ladder
    of five types when none is given."""

    def __init__(self, instance_types: Optional[List[InstanceType]] = None):
        self.instance_types: List[InstanceType] = list(instance_types or [])

    def get_instance_types(self, provisioner=None) -> List[InstanceType]:
        return self.instance_types if self.instance_types else instance_types(5)

    def name(self) -> str:
        return "fake"
