"""Object builders for tests and smoke runs (the analog of pkg/test), and
a synchronous control loop over the lifecycle controllers. The suite
environment with the Expect* helpers is testing/expectations.Env.

Importing the package loads no module that allocates a lock (the
controllers load when a ControlLoop is made), so that the race watchers
of testing/lockwatch.py and testing/racewatch.py can be armed before any
lock of the port exists."""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from karpenter_core_tpu_torch.api.machine import (
    CONDITION_MACHINE_INITIALIZED,
    CONDITION_MACHINE_LAUNCHED,
    CONDITION_MACHINE_REGISTERED,
    Machine,
    MachineSpec,
    MachineStatus,
)
from karpenter_core_tpu_torch.api.provisioner import (
    Consolidation,
    Limits,
    Provisioner,
    ProvisionerSpec,
)
from karpenter_core_tpu_torch.kube.objects import (
    LABEL_TOPOLOGY_ZONE,
    Affinity,
    Condition,
    Container,
    ContainerPort,
    CSINode,
    CSINodeDriver,
    CSIPersistentVolumeSource,
    DaemonSet,
    LabelSelector,
    Node,
    NodeAffinity,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    ObjectMeta,
    OwnerReference,
    PersistentVolume,
    PersistentVolumeClaim,
    PersistentVolumeClaimSpec,
    PersistentVolumeClaimVolumeSource,
    PersistentVolumeSpec,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodDisruptionBudget,
    PodDisruptionBudgetSpec,
    PodDisruptionBudgetStatus,
    PodSpec,
    ResourceRequirements,
    StorageClass,
    Taint,
    Toleration,
    TopologySelectorLabelRequirement,
    TopologySelectorTerm,
    TopologySpreadConstraint,
    Volume,
    WeightedPodAffinityTerm,
)
from karpenter_core_tpu_torch.utils.resources import parse_resource_list

_counter = itertools.count(1)


class FakeClock:
    """A steppable clock for the TTL-driven controllers. `sleep` blocks
    while another thread advances the clock past the deadline, and jumps
    to the deadline itself once the clock has stood still for `grace`
    real seconds (no stepping thread), so a TTL wait never deadlocks."""

    def __init__(self, t: float = 1_700_000_000.0, grace: float = 0.05):
        self._t = t
        self._grace = grace
        self._cond = threading.Condition()

    @property
    def t(self) -> float:
        return self._t

    def __call__(self) -> float:
        with self._cond:
            return self._t

    def advance(self, seconds: float) -> None:
        with self._cond:
            self._t += seconds
            self._cond.notify_all()

    def sleep(self, seconds: float) -> None:
        with self._cond:
            deadline = self._t + seconds
            while self._t < deadline:
                last = self._t
                self._cond.wait(timeout=self._grace)
                if self._t == last:
                    self._t = deadline
                    self._cond.notify_all()


def unique_name(prefix: str = "obj") -> str:
    return f"{prefix}-{next(_counter)}"


def make_pod(
    name: Optional[str] = None,
    namespace: str = "default",
    labels: Optional[Dict[str, str]] = None,
    annotations: Optional[Dict[str, str]] = None,
    requests: Optional[Dict[str, object]] = None,
    limits: Optional[Dict[str, object]] = None,
    node_selector: Optional[Dict[str, str]] = None,
    node_name: str = "",
    tolerations: Optional[List[Toleration]] = None,
    topology_spread: Optional[List[TopologySpreadConstraint]] = None,
    pod_affinity_required: Optional[List[PodAffinityTerm]] = None,
    pod_affinity_preferred: Optional[List[WeightedPodAffinityTerm]] = None,
    pod_anti_affinity_required: Optional[List[PodAffinityTerm]] = None,
    pod_anti_affinity_preferred: Optional[List[WeightedPodAffinityTerm]] = None,
    node_affinity_required: Optional[List[NodeSelectorTerm]] = None,
    node_affinity_preferred=None,
    host_ports: Optional[List[int]] = None,
    owner_kind: str = "",
    phase: str = "Pending",
    unschedulable: bool = True,
    init_requests: Optional[Dict[str, object]] = None,
    init_limits: Optional[Dict[str, object]] = None,
    uid: Optional[str] = None,
    creation_timestamp: Optional[float] = None,
) -> Pod:
    """A pending pod, marked with the PodScheduled Unschedulable condition,
    by default; a pod bound to a node takes `node_name`, and a running one
    also phase="Running". Requests default from limits per resource, as
    the apiserver's admission defaulting does. `uid` and
    `creation_timestamp` pin the first-fit-decreasing tie-breakers."""

    def _requests(reqs, lims):
        out = dict(parse_resource_list(lims or {}))
        out.update(parse_resource_list(reqs or {}))
        return out

    containers = [
        Container(
            resources=ResourceRequirements(
                requests=_requests(requests, limits),
                limits=parse_resource_list(limits or {}),
            ),
            ports=[ContainerPort(host_port=p) for p in (host_ports or [])],
        )
    ]
    init_containers = []
    if init_requests or init_limits:
        init_containers = [
            Container(
                resources=ResourceRequirements(
                    requests=_requests(init_requests, init_limits),
                    limits=parse_resource_list(init_limits or {}),
                )
            )
        ]
    affinity = None
    if any([pod_affinity_required, pod_affinity_preferred,
            pod_anti_affinity_required, pod_anti_affinity_preferred,
            node_affinity_required, node_affinity_preferred]):
        affinity = Affinity(
            node_affinity=NodeAffinity(
                required=list(node_affinity_required or []),
                preferred=list(node_affinity_preferred or []),
            )
            if (node_affinity_required or node_affinity_preferred)
            else None,
            pod_affinity=PodAffinity(
                required=list(pod_affinity_required or []),
                preferred=list(pod_affinity_preferred or []),
            )
            if (pod_affinity_required or pod_affinity_preferred)
            else None,
            pod_anti_affinity=PodAntiAffinity(
                required=list(pod_anti_affinity_required or []),
                preferred=list(pod_anti_affinity_preferred or []),
            )
            if (pod_anti_affinity_required or pod_anti_affinity_preferred)
            else None,
        )
    meta = ObjectMeta(
        name=name or unique_name("pod"),
        namespace=namespace,
        labels=dict(labels or {}),
        annotations=dict(annotations or {}),
    )
    if uid is not None:
        meta.uid = uid
    if creation_timestamp is not None:
        meta.creation_timestamp = creation_timestamp
    if owner_kind:
        meta.owner_references.append(OwnerReference(kind=owner_kind, name="owner"))
    pod = Pod(
        metadata=meta,
        spec=PodSpec(
            node_name=node_name,
            node_selector=dict(node_selector or {}),
            affinity=affinity,
            tolerations=list(tolerations or []),
            containers=containers,
            init_containers=init_containers,
            topology_spread_constraints=list(topology_spread or []),
        ),
    )
    pod.status.phase = phase
    if unschedulable and not node_name:
        pod.status.conditions.append(
            Condition(type="PodScheduled", status="False", reason="Unschedulable")
        )
    return pod


def make_provisioner(
    name: Optional[str] = None,
    requirements: Optional[List[NodeSelectorRequirement]] = None,
    labels: Optional[Dict[str, str]] = None,
    annotations: Optional[Dict[str, str]] = None,
    taints: Optional[List[Taint]] = None,
    startup_taints: Optional[List[Taint]] = None,
    limits: Optional[Dict[str, object]] = None,
    weight: Optional[int] = None,
    ttl_seconds_after_empty: Optional[int] = None,
    ttl_seconds_until_expired: Optional[int] = None,
    consolidation_enabled: Optional[bool] = None,
) -> Provisioner:
    """A provisioner; like the reference's test builder it carries an
    inline provider config when it names no provider reference."""
    spec = ProvisionerSpec(
        requirements=list(requirements or []),
        labels=dict(labels or {}),
        annotations=dict(annotations or {}),
        taints=list(taints or []),
        startup_taints=list(startup_taints or []),
        weight=weight,
        ttl_seconds_after_empty=ttl_seconds_after_empty,
        ttl_seconds_until_expired=ttl_seconds_until_expired,
    )
    if limits is not None:
        spec.limits = Limits(resources=parse_resource_list(limits))
    if consolidation_enabled is not None:
        spec.consolidation = Consolidation(enabled=consolidation_enabled)
    spec.provider = {"fake": True}
    return Provisioner(
        metadata=ObjectMeta(name=name or unique_name("provisioner")), spec=spec
    )


def make_node(
    name: Optional[str] = None,
    labels: Optional[Dict[str, str]] = None,
    capacity: Optional[Dict[str, object]] = None,
    allocatable: Optional[Dict[str, object]] = None,
    taints: Optional[List[Taint]] = None,
    provider_id: str = "",
    ready: bool = True,
) -> Node:
    node = Node(metadata=ObjectMeta(name=name or unique_name("node"),
                                    labels=dict(labels or {})))
    node.spec.taints = list(taints or [])
    node.spec.provider_id = provider_id or f"fake:///{node.metadata.name}"
    node.status.capacity = parse_resource_list(capacity or {})
    node.status.allocatable = parse_resource_list(allocatable or capacity or {})
    node.status.conditions.append(Condition(type="Ready", status="True" if ready else "False"))
    return node


def make_machine(
    name: Optional[str] = None,
    provider_id: str = "",
    labels: Optional[Dict[str, str]] = None,
    requirements: Optional[List[NodeSelectorRequirement]] = None,
    capacity: Optional[Dict[str, object]] = None,
    allocatable: Optional[Dict[str, object]] = None,
    launched: bool = False,
    registered: bool = False,
    initialized: bool = False,
) -> Machine:
    """A Machine record, with lifecycle conditions optionally set (the
    reference's test.Machine)."""
    machine = Machine(
        metadata=ObjectMeta(name=name or unique_name("machine"), labels=dict(labels or {})),
        spec=MachineSpec(requirements=list(requirements or [])),
        status=MachineStatus(
            provider_id=provider_id,
            capacity=parse_resource_list(capacity or {}),
            allocatable=parse_resource_list(
                (capacity if allocatable is None else allocatable) or {}),
        ),
    )
    if launched:
        machine.set_condition(CONDITION_MACHINE_LAUNCHED, "True")
    if registered:
        machine.set_condition(CONDITION_MACHINE_REGISTERED, "True")
    if initialized:
        machine.set_condition(CONDITION_MACHINE_INITIALIZED, "True")
    return machine


def make_storage_class(name: str, provisioner: str = "",
                       zones: Optional[List[str]] = None) -> StorageClass:
    sc = StorageClass(metadata=ObjectMeta(name=name), provisioner=provisioner)
    if zones:
        sc.allowed_topologies = [TopologySelectorTerm(match_label_expressions=[
            TopologySelectorLabelRequirement(key=LABEL_TOPOLOGY_ZONE, values=list(zones))
        ])]
    return sc


def make_pvc(name: str, namespace: str = "default", storage_class: Optional[str] = None,
             volume_name: str = "") -> PersistentVolumeClaim:
    return PersistentVolumeClaim(
        metadata=ObjectMeta(name=name, namespace=namespace),
        spec=PersistentVolumeClaimSpec(storage_class_name=storage_class,
                                       volume_name=volume_name),
    )


def make_pv(name: str, driver: str = "", zones: Optional[List[str]] = None,
            storage_class: str = "") -> PersistentVolume:
    """A persistent volume; driver="" models a non-CSI one (NFS, say)."""
    spec = PersistentVolumeSpec(storage_class_name=storage_class)
    if driver:
        spec.csi = CSIPersistentVolumeSource(driver=driver)
    if zones:
        spec.node_affinity_required = [NodeSelectorTerm(match_expressions=[
            NodeSelectorRequirement(LABEL_TOPOLOGY_ZONE, "In", list(zones))
        ])]
    return PersistentVolume(metadata=ObjectMeta(name=name), spec=spec)


def make_csinode(node_name: str, driver: str, allocatable: Optional[int] = None) -> CSINode:
    """A CSINode carrying one driver's attach limit."""
    return CSINode(metadata=ObjectMeta(name=node_name),
                   drivers=[CSINodeDriver(name=driver, allocatable_count=allocatable)])


def pvc_volume(claim_name: str) -> Volume:
    return Volume(name=claim_name, persistent_volume_claim=PersistentVolumeClaimVolumeSource(
        claim_name=claim_name))


def make_pdb(name: str, match_labels: Dict[str, str], disruptions_allowed: int = 0,
             namespace: str = "default") -> PodDisruptionBudget:
    """A PodDisruptionBudget over the pods matching `match_labels`, with
    `disruptions_allowed` left."""
    return PodDisruptionBudget(
        metadata=ObjectMeta(name=name, namespace=namespace),
        spec=PodDisruptionBudgetSpec(selector=LabelSelector(match_labels=dict(match_labels))),
        status=PodDisruptionBudgetStatus(disruptions_allowed=disruptions_allowed),
    )


def make_daemonset(name: Optional[str] = None, namespace: str = "default",
                   requests: Optional[Dict[str, object]] = None,
                   tolerations: Optional[List[Toleration]] = None,
                   limits: Optional[Dict[str, object]] = None,
                   node_selector: Optional[Dict[str, str]] = None,
                   node_affinity_required: Optional[List[NodeSelectorTerm]] = None,
                   init_requests: Optional[Dict[str, object]] = None,
                   init_limits: Optional[Dict[str, object]] = None) -> DaemonSet:
    """A DaemonSet whose pod template is make_pod's with these options."""
    template = make_pod(requests=requests, limits=limits, node_selector=node_selector,
                        tolerations=tolerations,
                        node_affinity_required=node_affinity_required,
                        init_requests=init_requests, init_limits=init_limits,
                        unschedulable=False).spec
    return DaemonSet(metadata=ObjectMeta(name=name or unique_name("ds"), namespace=namespace),
                     pod_template_spec=template)


def subset_planes(snap, K: int, seed: int = 0):
    """K replan subset planes over an encoded snapshot (count_rows [K, I]
    int32, exist_open [K, E] bool): each subset activates a random ~60% of
    the items at their full replica counts and closes 0-2 existing slots;
    with K > 1 the last subset activates nothing (a zero row, as a pad
    rung)."""
    rng = np.random.default_rng(seed)
    E = snap.exist_used.shape[0]
    I = len(snap.item_counts)
    count_rows = np.zeros((K, snap.item_pad), np.int32)
    exist_open = np.ones((K, E), bool)
    n_nodes = len(snap.state_nodes)
    for r in range(K - 1 if K > 1 else K):
        count_rows[r, :I] = snap.item_counts * (rng.random(I) < 0.6)
        if n_nodes:
            exist_open[r, rng.choice(n_nodes, size=min(n_nodes, r % 3), replace=False)] = False
    return count_rows, exist_open


class ControlLoop:
    """A synchronous control loop over one kube client, fed by watches where
    the operator relists (operator.Operator is the port's entry point). It
    wires an informer-fed Cluster (one watch per kind: Node, Machine, Pod,
    Provisioner), a ProvisioningController with `solver`, the machine,
    node and termination controllers, the Terminator with its
    EvictionQueue, and the DeprovisioningController. step() runs them in
    the order of the operator's step, without the provisioning reconcile
    and the counter."""

    KINDS = ("Node", "Machine", "Pod", "Provisioner")

    def __init__(self, kube_client, cloud_provider, solver, clock=None,
                 validation_ttl: float = 15.0):
        from karpenter_core_tpu_torch.controllers.deprovisioning.controller import (
            DeprovisioningController,
        )
        from karpenter_core_tpu_torch.controllers.machine.controller import MachineController
        from karpenter_core_tpu_torch.controllers.machine.terminator import (
            EvictionQueue,
            Terminator,
        )
        from karpenter_core_tpu_torch.controllers.node.controller import NodeController
        from karpenter_core_tpu_torch.controllers.provisioning.provisioner import (
            ProvisioningController,
        )
        from karpenter_core_tpu_torch.controllers.termination.controller import (
            TerminationController,
        )
        from karpenter_core_tpu_torch.state import informer
        from karpenter_core_tpu_torch.state.cluster import Cluster

        clock = clock if clock is not None else time.time
        self._drain = informer.drain
        self.kube_client = kube_client
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.cluster = Cluster(kube_client, cloud_provider, clock=clock)
        handlers = {
            "Node": informer.NodeInformer(self.cluster),
            "Machine": informer.MachineInformer(self.cluster),
            "Pod": informer.PodInformer(self.cluster),
            "Provisioner": informer.ProvisionerInformer(self.cluster),
        }
        self.watches = [(kube_client.watch(kind), handlers[kind]) for kind in self.KINDS]
        self.eviction_queue = EvictionQueue(kube_client)
        self.terminator = Terminator(kube_client, cloud_provider, self.eviction_queue,
                                     clock=clock)
        self.provisioning = ProvisioningController(kube_client, cloud_provider,
                                                   self.cluster, solver=solver, clock=clock)
        self.machine_controller = MachineController(kube_client, cloud_provider,
                                                    self.cluster, self.terminator,
                                                    clock=clock)
        self.node_controller = NodeController(kube_client, cloud_provider, self.cluster,
                                              clock=clock)
        self.termination_controller = TerminationController(kube_client, self.terminator,
                                                            self.cluster)
        self.deprovisioning = DeprovisioningController(
            kube_client, self.cluster, self.provisioning, cloud_provider, clock=clock,
            validation_ttl=validation_ttl)

    def sync(self) -> int:
        """Hand every waiting watch event to its informer, kind by kind in
        KINDS order; returns how many there were."""
        return sum(self._drain(q, handler) for q, handler in self.watches)

    def step(self) -> None:
        """One pass over the controllers, in the order of the reference's
        Operator.step: machines, then each node's node and termination
        controllers, machines again, and the eviction queue. The caller
        runs the deprovisioning chain (self.deprovisioning.reconcile())."""
        self.sync()
        for machine in self.kube_client.list("Machine"):
            self.machine_controller.reconcile(machine)
        for node in self.kube_client.list("Node"):
            self.node_controller.reconcile(node)
            self.termination_controller.reconcile(node)
        self.sync()
        for machine in self.kube_client.list("Machine"):
            self.machine_controller.reconcile(machine)
        self.eviction_queue.drain()
