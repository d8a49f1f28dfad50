"""Per-Provisioner launch template (machinetemplate.go:32-100): the labels,
annotations, taints and requirements every machine of the provisioner
starts from, and the Node and Machine objects a launch makes of it."""
from __future__ import annotations

import itertools
import json
from typing import List

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.api.machine import (
    Machine,
    MachineResourceRequirements,
    MachineSpec,
)
from karpenter_core_tpu_torch.kube.objects import (
    LABEL_INSTANCE_TYPE_STABLE,
    Node,
    ObjectMeta,
)
from karpenter_core_tpu_torch.scheduling.requirement import OP_IN, Requirement
from karpenter_core_tpu_torch.scheduling.requirements import Requirements

# the machine name sequence (<provisioner>-00001, ...), process-wide
_node_id = itertools.count(1)


def next_node_id() -> int:
    return next(_node_id)


class MachineTemplate:
    def __init__(self, provisioner):
        labels = dict(provisioner.spec.labels)
        labels[api_labels.PROVISIONER_NAME_LABEL_KEY] = provisioner.name
        requirements = Requirements()
        requirements.add(
            *Requirements.from_node_selector_requirements(
                *provisioner.spec.requirements
            ).values()
        )
        requirements.add(*Requirements.from_labels(labels).values())
        self.provisioner_name = provisioner.name
        self.provider = provisioner.spec.provider
        self.provider_ref = provisioner.spec.provider_ref
        self.kubelet = provisioner.spec.kubelet_configuration
        self.annotations = dict(provisioner.spec.annotations)
        self.labels = labels
        self.taints: List = list(provisioner.spec.taints)
        self.startup_taints: List = list(provisioner.spec.startup_taints)
        self.requirements = requirements
        self.requests = {}
        self.instance_type_options: List = []

    def to_node(self) -> Node:
        """machinetemplate.go:64-77: the node, with the termination
        finalizer, its taints and startup taints."""
        node = Node(
            metadata=ObjectMeta(
                labels={**self.labels, **self.requirements.labels()},
                annotations=dict(self.annotations),
                finalizers=[api_labels.TERMINATION_FINALIZER],
            )
        )
        node.spec.taints = list(self.taints) + list(self.startup_taints)
        return node

    def to_machine(self) -> Machine:
        """machinetemplate.go:79-100: the Machine record, its instance-type
        requirement narrowed to the launch's options; an inline provider
        config rides the compatibility annotation."""
        self.requirements.add(
            Requirement(LABEL_INSTANCE_TYPE_STABLE, OP_IN,
                        [it.name for it in self.instance_type_options])
        )
        annotations = dict(self.annotations)
        if self.provider is not None:
            annotations[api_labels.PROVIDER_COMPATIBILITY_ANNOTATION_KEY] = json.dumps(
                self.provider, sort_keys=True
            )
        return Machine(
            metadata=ObjectMeta(
                name=f"{self.provisioner_name}-{next(_node_id):05d}",
                annotations=annotations,
                labels=dict(self.labels),
            ),
            spec=MachineSpec(
                taints=list(self.taints),
                startup_taints=list(self.startup_taints),
                requirements=[r.to_node_selector_requirement()
                              for r in self.requirements.values()],
                resources=MachineResourceRequirements(requests=dict(self.requests)),
                kubelet=self.kubelet,
                machine_template_ref=self.provider_ref,
            ),
        )
