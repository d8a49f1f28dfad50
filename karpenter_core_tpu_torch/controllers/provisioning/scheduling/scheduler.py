"""The host scheduler: the greedy first-fit solve with its progress queue
and relaxation (scheduler.go:42-312).

It is the semantic oracle of the device solver (solver/torch_solver.py):
the dense feasibility and pack programs on the card must place pods as
this per-pod loop does, within the equivalence bar of the differential
tests. GreedySolver serves it behind the Solver interface, as the host
fallback of solver/fallback.ResilientSolver.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.api.provisioner import Provisioner, order_by_weight
from karpenter_core_tpu_torch.cloudprovider.types import InstanceType
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.machine import (
    ExistingNode,
    MachineTemplate,
    SchedulingMachine,
    filter_instance_types_by_requirements,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.preferences import (
    Preferences,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.queue import Queue
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (  # noqa: F401
    Topology,
    build_domains,
)
from karpenter_core_tpu_torch.kube.objects import ResourceList
from karpenter_core_tpu_torch.obs.tracer import TRACER
from karpenter_core_tpu_torch.scheduling import taints as taints_mod
from karpenter_core_tpu_torch.scheduling.requirements import Requirements
from karpenter_core_tpu_torch.state.node import resolve_volume_limits
from karpenter_core_tpu_torch.utils import resources as resources_util

__all__ = [
    "SchedulerOptions", "SchedulingResult", "Scheduler", "build_scheduler",
    "build_domains", "subtract_max", "filter_by_remaining_resources",
    "filter_instance_types_by_requirements",
]


@dataclass
class SchedulerOptions:
    simulation_mode: bool = False


@dataclass
class SchedulingResult:
    new_machines: List[SchedulingMachine] = field(default_factory=list)
    existing_nodes: List[ExistingNode] = field(default_factory=list)
    errors: Dict[str, str] = field(default_factory=dict)  # pod uid -> last error
    failed_pods: List = field(default_factory=list)

    def pod_count_new(self) -> int:
        return sum(len(m.pods) for m in self.new_machines)

    def pod_count_existing(self) -> int:
        return sum(len(n.pods) for n in self.existing_nodes)


class Scheduler:
    """scheduler.go:79-133."""

    def __init__(self, kube_client, machine_templates: List[MachineTemplate],
                 provisioners: List[Provisioner], cluster, state_nodes: List,
                 topology: Topology, instance_types: Dict[str, List[InstanceType]],
                 daemonset_pods: List, recorder=None,
                 opts: Optional[SchedulerOptions] = None):
        # a provisioner's PreferNoSchedule taint enables the extra
        # relaxation (scheduler.go:48-56)
        tolerate_prefer_no_schedule = any(
            taint.effect == "PreferNoSchedule"
            for prov in provisioners for taint in prov.spec.taints
        )
        self.kube_client = kube_client
        self.machine_templates = machine_templates
        self.topology = topology
        self.cluster = cluster
        self.instance_types = instance_types
        self.daemon_overhead = _get_daemon_overhead(machine_templates, daemonset_pods)
        self.recorder = recorder
        self.opts = opts or SchedulerOptions()
        self.preferences = Preferences(tolerate_prefer_no_schedule)
        self.remaining_resources: Dict[str, ResourceList] = {
            p.name: dict(p.spec.limits.resources)
            for p in provisioners if p.spec.limits is not None
        }
        self.new_machines: List[SchedulingMachine] = []
        self.existing_nodes: List[ExistingNode] = []
        self._calculate_existing_machines(state_nodes, daemonset_pods)

    def solve(self, pods: List) -> SchedulingResult:
        """The loop (scheduler.go:96-133): pop a pod, try the existing
        nodes, then the open machines (fewest pods first), then open a
        machine from the first compatible template by weight; on failure
        relax the pod and push it back."""
        with TRACER.span("scheduler.solve", pods=len(pods)) as sp:
            result = self._solve_traced(pods)
            sp.set(machines=len(result.new_machines), failed=len(result.failed_pods))
            return result

    def _solve_traced(self, pods: List) -> SchedulingResult:
        errors: Dict[str, str] = {}
        q = Queue(pods)
        while True:
            pod = q.pop()
            if pod is None:
                break
            err = self._add(pod)
            if err is None:
                errors.pop(pod.metadata.uid, None)
                continue
            errors[pod.metadata.uid] = err
            relaxed = self.preferences.relax(pod)
            q.push(pod, relaxed)
            if relaxed:
                self.topology.update(pod)

        for machine in self.new_machines:
            machine.finalize_scheduling()

        failed = q.list()
        result = SchedulingResult(
            new_machines=self.new_machines,
            existing_nodes=self.existing_nodes,
            errors={p.metadata.uid: errors.get(p.metadata.uid, "") for p in failed},
            failed_pods=failed,
        )
        if not self.opts.simulation_mode:
            self._record_results(result)
        return result

    def _add(self, pod) -> Optional[str]:
        """scheduler.go:177-222."""
        for node in self.existing_nodes:
            if node.add(pod) is None:
                return None

        # the open machine with the fewest pods first (scheduler.go:186-193)
        self.new_machines.sort(key=lambda m: len(m.pods))
        for machine in self.new_machines:
            if machine.add(pod) is None:
                return None

        errs: List[str] = []
        for template in self.machine_templates:
            instance_types = self.instance_types.get(template.provisioner_name, [])
            remaining = self.remaining_resources.get(template.provisioner_name)
            if remaining is not None:
                instance_types = filter_by_remaining_resources(instance_types, remaining)
                if not instance_types:
                    errs.append(
                        f"all available instance types exceed limits for provisioner "
                        f'"{template.provisioner_name}"'
                    )
                    continue
            machine = SchedulingMachine(
                template, self.topology, self.daemon_overhead.get(id(template), {}),
                instance_types,
            )
            err = machine.add(pod)
            if err is not None:
                errs.append(f'incompatible with provisioner "{template.provisioner_name}", {err}')
                continue
            self.new_machines.append(machine)
            if remaining is not None:
                # pessimistic max-capacity subtraction (scheduler.go:276-293)
                self.remaining_resources[template.provisioner_name] = subtract_max(
                    remaining, machine.instance_type_options)
            return None
        return "; ".join(errs) if errs else "no machine templates configured"

    def _calculate_existing_machines(self, state_nodes: List, daemonset_pods: List) -> None:
        """scheduler.go:224-251."""
        for state_node in state_nodes:
            if not state_node.owned():
                continue
            daemons = [
                p for p in daemonset_pods
                if taints_mod.tolerates(state_node.taints(), p) is None
                and Requirements.from_labels(state_node.labels()).compatible(
                    Requirements.from_pod(p)) is None
            ]
            # claims resolve to their drivers through the kube client
            # (volumeusage.go:133-200); a state node built outside the
            # cluster cache may not carry one yet
            if state_node.volume_usage.kube_client is None:
                state_node.volume_usage.kube_client = self.kube_client
            self.existing_nodes.append(ExistingNode(
                state_node, self.topology,
                resources_util.requests_for_pods(*daemons) if daemons else {"pods": 0.0},
            ))
            provisioner_name = state_node.labels().get(
                api_labels.PROVISIONER_NAME_LABEL_KEY, "")
            if provisioner_name in self.remaining_resources:
                self.remaining_resources[provisioner_name] = resources_util.subtract(
                    self.remaining_resources[provisioner_name], state_node.capacity())

    def _record_results(self, result: SchedulingResult) -> None:
        """scheduler.go:135-175: the failure events and the nominations."""
        if self.recorder is None:
            return
        for pod in result.failed_pods:
            self.recorder.pod_failed_to_schedule(pod, result.errors.get(pod.metadata.uid, ""))
        for node in self.existing_nodes:
            if node.pods and self.cluster is not None:
                self.cluster.nominate_node_for_pod(node.name())
            for pod in node.pods:
                self.recorder.nominate_pod(pod, node.name())


def build_scheduler(kube_client, cluster, provisioners: List[Provisioner],
                    instance_types: Dict[str, List[InstanceType]], pods: List,
                    state_nodes: Optional[List] = None,
                    daemonset_pods: Optional[List] = None,
                    opts: Optional[SchedulerOptions] = None,
                    recorder=None) -> Scheduler:
    """A Scheduler wired as the provisioner wires it (provisioner.go:198-264):
    templates by weight, the topology-domain universe from the provisioners'
    and instance types' requirements, the topology seeded with the batch."""
    provisioners = [p for p in order_by_weight(provisioners)
                    if p.metadata.deletion_timestamp is None]
    templates = [MachineTemplate(p) for p in provisioners]
    # CSI attach limits: state nodes that did not come through the cluster's
    # informers (direct use, tests) resolve theirs from the CSINode objects,
    # only for the owned nodes the scheduler packs
    resolve_volume_limits([n for n in (state_nodes or []) if n.owned()], kube_client)
    domains = build_domains(provisioners, instance_types)
    topology = Topology(kube_client, cluster, domains, pods)
    return Scheduler(kube_client, templates, provisioners, cluster, state_nodes or [],
                     topology, instance_types, daemonset_pods or [],
                     recorder=recorder, opts=opts)


def _get_daemon_overhead(templates: List[MachineTemplate],
                         daemonset_pods: List) -> Dict[int, ResourceList]:
    """The daemons' resource overhead per template (scheduler.go:253-270)."""
    overhead: Dict[int, ResourceList] = {}
    for template in templates:
        daemons = [
            p for p in daemonset_pods
            if taints_mod.tolerates(template.taints, p) is None
            and template.requirements.compatible(Requirements.from_pod(p)) is None
        ]
        overhead[id(template)] = (
            resources_util.requests_for_pods(*daemons) if daemons else {"pods": 0.0})
    return overhead


def subtract_max(remaining: ResourceList, instance_types: List[InstanceType]) -> ResourceList:
    """Subtract the largest capacity among the machine's remaining options,
    pessimistically (scheduler.go:276-293)."""
    if not instance_types:
        return remaining
    max_caps = resources_util.max_resources(*[it.capacity for it in instance_types])
    return {k: v - max_caps.get(k, 0.0) for k, v in remaining.items()}


def filter_by_remaining_resources(instance_types: List[InstanceType],
                                  remaining: ResourceList) -> List[InstanceType]:
    """The types whose capacity stays within the provisioner's limits
    (scheduler.go:296-312)."""
    return [it for it in instance_types
            if all(it.capacity.get(name, 0.0) <= quantity
                   for name, quantity in remaining.items())]
