"""In-flight scheduling machines: the constraint accumulators of the host
scheduler (machine.go, existingnode.go, machinetemplate.go).

A SchedulingMachine collects pods and narrows its instance-type options
through the compatible, fits and has-an-offering filter (machine.go:137-159),
the expression the device solver's feasibility program evaluates densely
(ops/feasibility.py). Provisioning's failure explanation probes each
template with the same filter.
"""
from __future__ import annotations

from typing import List, Optional

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.cloudprovider.types import InstanceType
from karpenter_core_tpu_torch.kube.objects import (
    LABEL_HOSTNAME,
    LABEL_TOPOLOGY_ZONE,
    ResourceList,
)
from karpenter_core_tpu_torch.scheduling import taints as taints_mod
from karpenter_core_tpu_torch.scheduling.hostportusage import HostPortUsage
from karpenter_core_tpu_torch.scheduling.machinetemplate import (  # noqa: F401
    MachineTemplate,
    next_node_id,
)
from karpenter_core_tpu_torch.scheduling.requirement import OP_IN, Requirement
from karpenter_core_tpu_torch.scheduling.requirements import Requirements
from karpenter_core_tpu_torch.utils import resources as resources_util


class SchedulingMachine:
    """A node this solve provisions (machine.go:31-115)."""

    def __init__(self, template: MachineTemplate, topology,
                 daemon_resources: ResourceList, instance_types: List[InstanceType]):
        hostname = f"hostname-placeholder-{next_node_id():04d}"
        topology.register(LABEL_HOSTNAME, hostname)
        self.template = template
        self.provisioner_name = template.provisioner_name
        self.labels = template.labels
        self.annotations = template.annotations
        self.taints = template.taints
        self.startup_taints = template.startup_taints
        self.kubelet = template.kubelet
        self.provider = template.provider
        self.provider_ref = template.provider_ref
        self.requirements = Requirements(template.requirements.values())
        self.requirements.add(Requirement(LABEL_HOSTNAME, OP_IN, [hostname]))
        self.instance_type_options = list(instance_types)
        self.requests: ResourceList = dict(daemon_resources)
        self.pods: List = []
        self.topology = topology
        self.hostport_usage = HostPortUsage()

    def add(self, pod) -> Optional[str]:
        """Commit the pod, or return why it does not fit (machine.go:62-107)."""
        err = taints_mod.tolerates(self.taints, pod)
        if err:
            return err
        err = self.hostport_usage.validate(pod)
        if err:
            return err

        machine_requirements = Requirements(self.requirements.values())
        pod_requirements = Requirements.from_pod(pod)
        err = machine_requirements.compatible(pod_requirements)
        if err:
            return f"incompatible requirements, {err}"
        machine_requirements.add(*pod_requirements.values())

        topology_requirements, err = self.topology.add_requirements(
            pod_requirements, machine_requirements, pod)
        if err:
            return err
        err = machine_requirements.compatible(topology_requirements)
        if err:
            return err
        machine_requirements.add(*topology_requirements.values())

        requests = resources_util.merge(self.requests, resources_util.requests_for_pods(pod))
        instance_types = filter_instance_types_by_requirements(
            self.instance_type_options, machine_requirements, requests)
        if not instance_types:
            return (
                f"no instance type satisfied resources "
                f"{resources_util.to_string(resources_util.requests_for_pods(pod))} "
                f"and requirements {machine_requirements!r}"
            )

        self.pods.append(pod)
        self.instance_type_options = instance_types
        self.requests = requests
        self.requirements = machine_requirements
        self.topology.record(pod, machine_requirements)
        self.hostport_usage.add(pod)
        return None

    def finalize_scheduling(self) -> None:
        """Drop the placeholder hostname requirement (machine.go:109-115)."""
        self.requirements.pop(LABEL_HOSTNAME, None)

    def __repr__(self) -> str:
        names = ", ".join(it.name for it in self.instance_type_options[:5])
        extra = len(self.instance_type_options) - 5
        if extra > 0:
            names += f" and {extra} other(s)"
        return (
            f"machine with {len(self.pods)} pods requesting "
            f"{resources_util.to_string(self.requests)} from types {names}"
        )


class ExistingNode:
    """A real or in-flight node the solve may place pods on
    (existingnode.go:28-115)."""

    def __init__(self, state_node, topology, daemon_resources: ResourceList):
        remaining_daemon = resources_util.subtract(
            daemon_resources, state_node.total_daemonset_requests())
        remaining_daemon = {k: max(v, 0.0) for k, v in remaining_daemon.items()}
        self.state_node = state_node
        # the node's own pods do not change during a solve (add() records
        # this solve's pods in self.requests), so its available resources
        # are read once
        self._available = state_node.available()
        self.pods: List = []
        self.topology = topology
        self.requests: ResourceList = remaining_daemon
        self.requirements = Requirements.from_labels(state_node.labels())
        self.requirements.add(Requirement(LABEL_HOSTNAME, OP_IN, [state_node.hostname()]))
        topology.register(LABEL_HOSTNAME, state_node.hostname())

    def name(self) -> str:
        return self.state_node.name()

    def add(self, pod) -> Optional[str]:
        """existingnode.go:62-115."""
        err = taints_mod.tolerates(self.state_node.taints(), pod)
        if err:
            return err
        err = self.state_node.hostport_usage.validate(pod)
        if err:
            return err
        mounted = self.state_node.volume_usage.validate(pod)
        if mounted.exceeds(self.state_node.volume_limits):
            return "would exceed node volume limits"

        requests = resources_util.merge(self.requests, resources_util.requests_for_pods(pod))
        if not resources_util.fits(requests, self._available):
            return "exceeds node resources"

        node_requirements = Requirements(self.requirements.values())
        pod_requirements = Requirements.from_pod(pod)
        err = node_requirements.compatible(pod_requirements)
        if err:
            return err
        node_requirements.add(*pod_requirements.values())

        topology_requirements, err = self.topology.add_requirements(
            pod_requirements, node_requirements, pod)
        if err:
            return err
        err = node_requirements.compatible(topology_requirements)
        if err:
            return err
        node_requirements.add(*topology_requirements.values())

        self.pods.append(pod)
        self.requests = requests
        self.requirements = node_requirements
        self.topology.record(pod, node_requirements)
        self.state_node.hostport_usage.add(pod)
        self.state_node.volume_usage.add(pod)
        return None


def filter_instance_types_by_requirements(instance_types: List[InstanceType],
                                          requirements: Requirements,
                                          requests: ResourceList) -> List[InstanceType]:
    """compatible, fits and has an offering (machine.go:137-159)."""
    return [it for it in instance_types
            if _compatible(it, requirements) and _fits(it, requests)
            and _has_offering(it, requirements)]


def _compatible(instance_type: InstanceType, requirements: Requirements) -> bool:
    return instance_type.requirements.intersects(requirements) is None


def _fits(instance_type: InstanceType, requests: ResourceList) -> bool:
    return resources_util.fits(requests, instance_type.allocatable())


def _has_offering(instance_type: InstanceType, requirements: Requirements) -> bool:
    for offering in instance_type.offerings.available():
        if ((LABEL_TOPOLOGY_ZONE not in requirements
             or requirements.get_requirement(LABEL_TOPOLOGY_ZONE).has(offering.zone))
                and (api_labels.LABEL_CAPACITY_TYPE not in requirements
                     or requirements.get_requirement(api_labels.LABEL_CAPACITY_TYPE).has(
                         offering.capacity_type))):
            return True
    return False
