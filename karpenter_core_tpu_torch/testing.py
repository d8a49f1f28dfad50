"""Object builders for tests and smoke runs (the analog of pkg/test)."""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional

from karpenter_core_tpu_torch.api.provisioner import (
    Limits,
    Provisioner,
    ProvisionerSpec,
)
from karpenter_core_tpu_torch.kube.objects import (
    Affinity,
    Condition,
    Container,
    ContainerPort,
    Node,
    NodeAffinity,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodSpec,
    ResourceRequirements,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)
from karpenter_core_tpu_torch.utils.resources import parse_resource_list

_counter = itertools.count(1)


def unique_name(prefix: str = "obj") -> str:
    return f"{prefix}-{next(_counter)}"


def make_pod(
    name: Optional[str] = None,
    namespace: str = "default",
    labels: Optional[Dict[str, str]] = None,
    requests: Optional[Dict[str, object]] = None,
    limits: Optional[Dict[str, object]] = None,
    node_selector: Optional[Dict[str, str]] = None,
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
    init_requests: Optional[Dict[str, object]] = None,
    uid: Optional[str] = None,
    creation_timestamp: Optional[float] = None,
) -> Pod:
    """A pending pod. Requests default from limits per resource, as the
    apiserver's admission defaulting does. `uid` and `creation_timestamp`
    pin the first-fit-decreasing tie-breakers."""

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
    if init_requests:
        init_containers = [
            Container(
                resources=ResourceRequirements(
                    requests=parse_resource_list(init_requests)
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
            node_selector=dict(node_selector or {}),
            affinity=affinity,
            tolerations=list(tolerations or []),
            containers=containers,
            init_containers=init_containers,
            topology_spread_constraints=list(topology_spread or []),
        ),
    )
    pod.status.conditions.append(
        Condition(type="PodScheduled", status="False", reason="Unschedulable")
    )
    return pod


def make_provisioner(
    name: Optional[str] = None,
    requirements: Optional[List[NodeSelectorRequirement]] = None,
    labels: Optional[Dict[str, str]] = None,
    taints: Optional[List[Taint]] = None,
    startup_taints: Optional[List[Taint]] = None,
    limits: Optional[Dict[str, object]] = None,
    weight: Optional[int] = None,
) -> Provisioner:
    spec = ProvisionerSpec(
        requirements=list(requirements or []),
        labels=dict(labels or {}),
        taints=list(taints or []),
        startup_taints=list(startup_taints or []),
        weight=weight,
    )
    if limits is not None:
        spec.limits = Limits(resources=parse_resource_list(limits))
    return Provisioner(
        metadata=ObjectMeta(name=name or unique_name("provisioner")), spec=spec
    )


def make_node(
    name: Optional[str] = None,
    labels: Optional[Dict[str, str]] = None,
    capacity: Optional[Dict[str, object]] = None,
    allocatable: Optional[Dict[str, object]] = None,
    taints: Optional[List[Taint]] = None,
) -> Node:
    node = Node(metadata=ObjectMeta(name=name or unique_name("node"),
                                    labels=dict(labels or {})))
    node.spec.taints = list(taints or [])
    node.spec.provider_id = f"fake:///{node.metadata.name}"
    node.status.capacity = parse_resource_list(capacity or {})
    node.status.allocatable = parse_resource_list(allocatable or capacity or {})
    node.status.conditions.append(Condition(type="Ready", status="True"))
    return node
