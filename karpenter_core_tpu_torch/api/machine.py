"""Machine: the launch-intent record for one node (machine.go:23-42,
machine_status.go).

The spec snapshots the scheduling decision (requirements, requested
resources, taints, startup taints); the status carries the provider id,
capacity and allocatable once the cloud provider launched it, and the
MachineLaunched / MachineRegistered / MachineInitialized conditions the
machine controller manages.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

from karpenter_core_tpu_torch.api.provisioner import KubeletConfiguration, ProviderRef
from karpenter_core_tpu_torch.kube.objects import (
    Condition,
    NodeSelectorRequirement,
    ObjectMeta,
    ResourceList,
    Taint,
)

CONDITION_MACHINE_LAUNCHED = "MachineLaunched"
CONDITION_MACHINE_REGISTERED = "MachineRegistered"
CONDITION_MACHINE_INITIALIZED = "MachineInitialized"
CONDITION_READY = "Ready"


@dataclass
class MachineResourceRequirements:
    requests: ResourceList = field(default_factory=dict)


@dataclass
class MachineSpec:
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    requirements: List[NodeSelectorRequirement] = field(default_factory=list)
    resources: MachineResourceRequirements = field(default_factory=MachineResourceRequirements)
    kubelet: Optional[KubeletConfiguration] = None
    machine_template_ref: Optional[ProviderRef] = None


@dataclass
class MachineStatus:
    provider_id: str = ""
    capacity: ResourceList = field(default_factory=dict)
    allocatable: ResourceList = field(default_factory=dict)
    conditions: List[Condition] = field(default_factory=list)


@dataclass
class Machine:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: MachineSpec = field(default_factory=MachineSpec)
    status: MachineStatus = field(default_factory=MachineStatus)

    def __post_init__(self):
        self.metadata.namespace = ""  # cluster-scoped

    @property
    def name(self) -> str:
        return self.metadata.name

    def get_condition(self, ctype: str) -> Optional[Condition]:
        for c in self.status.conditions:
            if c.type == ctype:
                return c
        return None

    def set_condition(self, ctype: str, status: str, reason: str = "",
                      message: str = "") -> None:
        """Set a condition; its transition time moves only when the status
        changes (wall clock, as the apiserver stamps it)."""
        cond = self.get_condition(ctype)
        if cond is None:
            cond = Condition(type=ctype)
            self.status.conditions.append(cond)
        if cond.status != status:
            cond.last_transition_time = time.time()
        cond.status = status
        cond.reason = reason
        cond.message = message

    def condition_true(self, ctype: str) -> bool:
        cond = self.get_condition(ctype)
        return cond is not None and cond.status == "True"
