"""The reference's fake cloud provider: the instance-type universe
generators (fake/instancetype.go:48-167) and FakeCloudProvider
(fake/cloudprovider.go:41-160), which serves one universe to every
provisioner, launches machines (the cheapest compatible type, its first
offering with capacity), records create calls, caps them, fails the next
create on demand, exhausts offering pools and reports drift by a toggle.
Launched machines are named fake-machine-N from a process-wide counter,
as in the reference."""
from __future__ import annotations

import copy
import itertools
import threading
from typing import Dict, List, Optional

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.api.machine import Machine, MachineStatus
from karpenter_core_tpu_torch.cloudprovider.types import (
    IncompatibleRequirementsError,
    InstanceType,
    InstanceTypeOverhead,
    InsufficientCapacityError,
    MachineNotFoundError,
    Offering,
    Offerings,
    offering_pool_matches,
)
from karpenter_core_tpu_torch.kube.objects import (
    LABEL_ARCH_STABLE,
    LABEL_INSTANCE_TYPE_STABLE,
    LABEL_OS_STABLE,
    LABEL_TOPOLOGY_ZONE,
    ObjectMeta,
    ResourceList,
)
from karpenter_core_tpu_torch.scheduling.requirement import (
    OP_DOES_NOT_EXIST,
    OP_IN,
    Requirement,
)
from karpenter_core_tpu_torch.scheduling.requirements import Requirements
from karpenter_core_tpu_torch.utils import resources as resources_util

GI = 2**30

LABEL_INSTANCE_SIZE = "size"
EXOTIC_INSTANCE_LABEL_KEY = "special"
INTEGER_INSTANCE_LABEL_KEY = "integer"

api_labels.register_well_known_labels(
    LABEL_INSTANCE_SIZE, EXOTIC_INSTANCE_LABEL_KEY, INTEGER_INSTANCE_LABEL_KEY
)

_name_counter = itertools.count(1)


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
    """fake/cloudprovider.go:41-160: one instance-type universe for every
    provisioner (the ladder of five types when none is given)."""

    def __init__(self, instance_types: Optional[List[InstanceType]] = None):
        self.instance_types: List[InstanceType] = list(instance_types or [])
        self._mu = threading.RLock()
        self.create_calls: List[Machine] = []
        self.allowed_create_calls: int = 2**31
        self.created_machines: Dict[str, Machine] = {}
        self.drifted: bool = False
        self.next_create_err: Optional[Exception] = None
        # offering pools (instance type, zone, capacity type) that fail
        # create with InsufficientCapacityError; an empty component
        # matches anything
        self.insufficient_capacity: set = set()

    def reset(self) -> None:
        with self._mu:
            self.create_calls = []
            self.created_machines = {}
            self.allowed_create_calls = 2**31
            self.next_create_err = None
            self.insufficient_capacity = set()

    def create(self, machine: Machine) -> Machine:
        """Launch the cheapest instance type compatible with the machine's
        requirements that fits its requests, in its first compatible
        offering with capacity."""
        with self._mu:
            if self.next_create_err is not None:
                err, self.next_create_err = self.next_create_err, None
                raise err
            self.create_calls.append(machine)
            if len(self.create_calls) > self.allowed_create_calls:
                raise InsufficientCapacityError(
                    "erroring as number of AllowedCreateCalls has been exceeded"
                )

            reqs = Requirements.from_node_selector_requirements(*machine.spec.requirements)
            candidates = [
                it for it in self.get_instance_types()
                if reqs.compatible(it.requirements) is None
                and len(it.offerings.requirements(reqs).available()) > 0
                and resources_util.fits(machine.spec.resources.requests, it.allocatable())
            ]
            if not candidates:
                raise IncompatibleRequirementsError("no compatible instance types for machine")
            candidates.sort(
                key=lambda it: it.offerings.available().requirements(reqs).cheapest().price
            )
            instance_type = candidates[0]

            labels = {
                key: requirement.values_list()[0]
                for key, requirement in instance_type.requirements.items()
                if requirement.operator() == OP_IN
            }
            # the first compatible offering with capacity; an exhausted pool
            # is skipped, and only when every compatible one is exhausted
            # does create fail
            exhausted = []
            for o in instance_type.offerings.available():
                offer_reqs = Requirements([
                    Requirement(LABEL_TOPOLOGY_ZONE, OP_IN, [o.zone]),
                    Requirement(api_labels.LABEL_CAPACITY_TYPE, OP_IN, [o.capacity_type]),
                ])
                if reqs.compatible(offer_reqs) is None:
                    if self._exhausted(instance_type.name, o):
                        exhausted.append(o)
                        continue
                    labels[LABEL_TOPOLOGY_ZONE] = o.zone
                    labels[api_labels.LABEL_CAPACITY_TYPE] = o.capacity_type
                    break
            else:
                if exhausted:
                    if len(exhausted) == 1:
                        o = exhausted[0]
                        raise InsufficientCapacityError(
                            f"insufficient capacity for {instance_type.name} "
                            f"in {o.zone}/{o.capacity_type}",
                            instance_type=instance_type.name, zone=o.zone,
                            capacity_type=o.capacity_type,
                        )
                    raise InsufficientCapacityError(
                        f"insufficient capacity for {instance_type.name} "
                        f"(all compatible offerings exhausted)",
                        instance_type=instance_type.name,
                    )

            name = f"fake-machine-{next(_name_counter)}"
            created = Machine(
                metadata=ObjectMeta(name=name, labels=labels),
                spec=copy.deepcopy(machine.spec),
                status=MachineStatus(
                    provider_id=f"fake:///{name}",
                    capacity={k: v for k, v in instance_type.capacity.items() if v},
                    allocatable={k: v for k, v in instance_type.allocatable().items() if v},
                ),
            )
            self.created_machines[machine.name] = created
            return created

    def _exhausted(self, instance_type: str, offering: Offering) -> bool:
        return any(
            offering_pool_matches(pool, instance_type, offering.zone, offering.capacity_type)
            for pool in self.insufficient_capacity
        )

    def get(self, machine_name: str, provisioner_name: str = "") -> Machine:
        with self._mu:
            if machine_name in self.created_machines:
                return copy.deepcopy(self.created_machines[machine_name])
            raise MachineNotFoundError(f"machine {machine_name} not found")

    def delete(self, machine: Machine) -> None:
        with self._mu:
            if machine.name in self.created_machines:
                del self.created_machines[machine.name]
                return
            raise MachineNotFoundError(f"machine {machine.name} not found")

    def get_instance_types(self, provisioner=None) -> List[InstanceType]:
        return self.instance_types if self.instance_types else instance_types(5)

    def is_machine_drifted(self, machine: Machine) -> bool:
        return self.drifted

    def name(self) -> str:
        return "fake"
