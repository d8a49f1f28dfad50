"""k8s-lite object model: the subset of objects a provisioning solve and
the node lifecycle read (pods, nodes, and the storage, policy and
namespace kinds they resolve through a kube client).

Quantities are plain floats in a ``dict[str, float]`` ResourceList (cpu in
cores, memory in bytes, counts for pods and extended resources), parsed from
k8s quantity strings by ``utils.resources.parse_quantity``.

``ObjectMeta.uid`` and ``creation_timestamp`` default to a process counter
and the wall clock; both break first-fit-decreasing ties, so a caller that
needs a reproducible order sets them explicitly.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ResourceList = Dict[str, float]

_uid_counter = itertools.count(1)


def _new_uid() -> str:
    return f"uid-{next(_uid_counter)}"


# ---------------------------------------------------------------------------
# metadata


@dataclass
class OwnerReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False
    block_owner_deletion: bool = False


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    uid: str = field(default_factory=_new_uid)
    creation_timestamp: float = field(default_factory=time.time)
    deletion_timestamp: Optional[float] = None
    # deletion waits until every finalizer is removed (kube/client.py)
    finalizers: List[str] = field(default_factory=list)
    owner_references: List[OwnerReference] = field(default_factory=list)
    resource_version: int = 0


class NamespacedName(tuple):
    """Hashable (namespace, name) object key."""

    def __new__(cls, namespace: str, name: str):
        return super().__new__(cls, (namespace, name))

    @property
    def namespace(self) -> str:
        return self[0]

    @property
    def name(self) -> str:
        return self[1]

    def __str__(self) -> str:
        return f"{self[0]}/{self[1]}"


def object_key(obj) -> NamespacedName:
    return NamespacedName(obj.metadata.namespace, obj.metadata.name)


# ---------------------------------------------------------------------------
# selectors / affinity


@dataclass
class NodeSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: List[str] = field(default_factory=list)

    def __deepcopy__(self, memo):
        # the values are strings: a new list is a deep copy, and a Machine's
        # instance-type requirement lists hundreds of them
        out = NodeSelectorRequirement(self.key, self.operator, list(self.values))
        memo[id(self)] = out
        return out


@dataclass
class NodeSelectorTerm:
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)


@dataclass
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


# the k8s wire names of the affinity term lists (kube/serialization.py);
# NodeAffinity's required list also wraps in a NodeSelector on the wire
_AFFINITY_WIRE = {
    "required": "requiredDuringSchedulingIgnoredDuringExecution",
    "preferred": "preferredDuringSchedulingIgnoredDuringExecution",
}


@dataclass
class NodeAffinity:
    # required terms are ORed; expressions within a term are ANDed
    required: List[NodeSelectorTerm] = field(default_factory=list)
    preferred: List[PreferredSchedulingTerm] = field(default_factory=list)

    _WIRE_OVERRIDES = _AFFINITY_WIRE
    _WIRE_WRAP = {"required": "nodeSelectorTerms"}


@dataclass
class LabelSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist
    values: List[str] = field(default_factory=list)


@dataclass
class LabelSelector:
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[LabelSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        """metav1.LabelSelectorAsSelector: every label and expression holds."""
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        for expr in self.match_expressions:
            val = labels.get(expr.key)
            if expr.operator == "In":
                if val is None or val not in expr.values:
                    return False
            elif expr.operator == "NotIn":
                if val is not None and val in expr.values:
                    return False
            elif expr.operator == "Exists":
                if expr.key not in labels:
                    return False
            elif expr.operator == "DoesNotExist":
                if expr.key in labels:
                    return False
            else:
                return False
        return True


@dataclass
class PodAffinityTerm:
    topology_key: str
    label_selector: Optional[LabelSelector] = None
    namespaces: List[str] = field(default_factory=list)
    namespace_selector: Optional[LabelSelector] = None


@dataclass
class WeightedPodAffinityTerm:
    weight: int
    pod_affinity_term: PodAffinityTerm = None


@dataclass
class PodAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)

    _WIRE_OVERRIDES = _AFFINITY_WIRE


@dataclass
class PodAntiAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)

    _WIRE_OVERRIDES = _AFFINITY_WIRE


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


@dataclass
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str  # DoNotSchedule | ScheduleAnyway
    label_selector: Optional[LabelSelector] = None


# ---------------------------------------------------------------------------
# taints / tolerations


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"

    def match_taint(self, other: "Taint") -> bool:
        """v1.Taint.MatchTaint: the same key and effect (value ignored)."""
        return self.key == other.key and self.effect == other.effect


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: Optional[int] = None

    def tolerates_taint(self, taint: Taint) -> bool:
        """v1.Toleration.ToleratesTaint."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator in ("", "Equal"):
            return self.value == taint.value
        if self.operator == "Exists":
            return self.value == ""
        return False


# ---------------------------------------------------------------------------
# pods


@dataclass
class ContainerPort:
    container_port: int = 0
    host_port: int = 0
    host_ip: str = ""
    protocol: str = "TCP"


@dataclass
class ResourceRequirements:
    requests: ResourceList = field(default_factory=dict)
    limits: ResourceList = field(default_factory=dict)


@dataclass
class Container:
    name: str = "container"
    image: str = ""
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    ports: List[ContainerPort] = field(default_factory=list)


@dataclass
class PersistentVolumeClaimVolumeSource:
    claim_name: str = ""


@dataclass
class EphemeralVolumeSource:
    """A generic ephemeral volume: its claim template's storage class."""

    storage_class_name: Optional[str] = None


@dataclass
class Volume:
    name: str = ""
    persistent_volume_claim: Optional[PersistentVolumeClaimVolumeSource] = None
    ephemeral: Optional[EphemeralVolumeSource] = None


@dataclass
class PodSpec:
    node_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    topology_spread_constraints: List[TopologySpreadConstraint] = field(
        default_factory=list
    )
    volumes: List[Volume] = field(default_factory=list)
    priority: Optional[int] = None
    # system-cluster-critical and system-node-critical pods drain last
    priority_class_name: str = ""
    # carried for the wire format (kube/serialization.py): a flight record
    # holds them as the reference package writes them
    scheduler_name: str = "default-scheduler"
    termination_grace_period_seconds: Optional[int] = None


@dataclass
class Condition:
    type: str = ""
    status: str = ""  # True | False | Unknown
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


@dataclass
class PodStatus:
    phase: str = "Pending"
    conditions: List[Condition] = field(default_factory=list)
    start_time: Optional[float] = None


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)


# ---------------------------------------------------------------------------
# nodes


@dataclass
class NodeSpec:
    provider_id: str = ""
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False


@dataclass
class NodeStatus:
    capacity: ResourceList = field(default_factory=dict)
    allocatable: ResourceList = field(default_factory=dict)
    conditions: List[Condition] = field(default_factory=list)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    def __post_init__(self):
        self.metadata.namespace = ""  # nodes are cluster-scoped

    @property
    def name(self) -> str:
        return self.metadata.name

    def ready(self) -> bool:
        """The kubelet's Ready condition is True."""
        for c in self.status.conditions:
            if c.type == "Ready":
                return c.status == "True"
        return False


# ---------------------------------------------------------------------------
# storage


@dataclass
class PersistentVolumeClaimSpec:
    storage_class_name: Optional[str] = None
    volume_name: str = ""


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeClaimSpec = field(default_factory=PersistentVolumeClaimSpec)


@dataclass
class CSIPersistentVolumeSource:
    driver: str = ""


@dataclass
class PersistentVolumeSpec:
    csi: Optional[CSIPersistentVolumeSource] = None
    node_affinity_required: List[NodeSelectorTerm] = field(default_factory=list)
    storage_class_name: str = ""


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeSpec = field(default_factory=PersistentVolumeSpec)

    def __post_init__(self):
        self.metadata.namespace = ""


@dataclass
class TopologySelectorLabelRequirement:
    key: str = ""
    values: List[str] = field(default_factory=list)


@dataclass
class TopologySelectorTerm:
    match_label_expressions: List[TopologySelectorLabelRequirement] = field(
        default_factory=list
    )


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    allowed_topologies: List[TopologySelectorTerm] = field(default_factory=list)

    def __post_init__(self):
        self.metadata.namespace = ""


@dataclass
class CSINodeDriver:
    name: str = ""
    allocatable_count: Optional[int] = None


@dataclass
class CSINode:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    drivers: List[CSINodeDriver] = field(default_factory=list)

    def __post_init__(self):
        self.metadata.namespace = ""


# ---------------------------------------------------------------------------
# policy and workloads


@dataclass
class PodDisruptionBudgetSpec:
    selector: Optional[LabelSelector] = None
    min_available: Optional[object] = None  # an int or a percent string "50%"
    max_unavailable: Optional[object] = None


@dataclass
class PodDisruptionBudgetStatus:
    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0


@dataclass
class PodDisruptionBudget:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodDisruptionBudgetSpec = field(default_factory=PodDisruptionBudgetSpec)
    status: PodDisruptionBudgetStatus = field(default_factory=PodDisruptionBudgetStatus)


@dataclass
class DaemonSet:
    """A DaemonSet reduced to its pod template: the scheduler counts the
    template's requests as per-node daemon overhead."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    pod_template_spec: Optional[PodSpec] = None


@dataclass
class ObjectReference:
    """core/v1 ObjectReference (an Event's involvedObject)."""

    kind: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""


@dataclass
class Event:
    """core/v1 Event: what the event recorder posts through the client, so
    that an object's events can be listed beside it."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    involved_object: ObjectReference = field(default_factory=ObjectReference)
    reason: str = ""
    message: str = ""
    type: str = "Normal"  # Normal | Warning
    count: int = 1
    first_timestamp: Optional[float] = None
    last_timestamp: Optional[float] = None
    reporting_component: str = "karpenter"


@dataclass
class Namespace:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)

    def __post_init__(self):
        self.metadata.namespace = ""


@dataclass
class ConfigMap:
    """core/v1 ConfigMap: the process entry reads its settings from the
    karpenter-global-settings one."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)


@dataclass
class Secret:
    """An opaque Secret (base64-encoded values in `data`): the admission
    webhook's serving certificate."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)
    type: str = "Opaque"


@dataclass
class LeaseSpec:
    """coordination.k8s.io/v1 LeaseSpec: the leader-election record
    (operator.go:108-110, the "leases" resource lock)."""

    holder_identity: str = ""
    lease_duration_seconds: int = 15
    acquire_time: Optional[float] = None
    renew_time: Optional[float] = None
    lease_transitions: int = 0


@dataclass
class Lease:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LeaseSpec = field(default_factory=LeaseSpec)


# Well-known label constants (k8s.io/api/core/v1 well_known_labels.go)
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_TOPOLOGY_ZONE = "topology.kubernetes.io/zone"
LABEL_TOPOLOGY_REGION = "topology.kubernetes.io/region"
LABEL_INSTANCE_TYPE_STABLE = "node.kubernetes.io/instance-type"
LABEL_ARCH_STABLE = "kubernetes.io/arch"
LABEL_OS_STABLE = "kubernetes.io/os"
LABEL_FAILURE_DOMAIN_BETA_ZONE = "failure-domain.beta.kubernetes.io/zone"
LABEL_FAILURE_DOMAIN_BETA_REGION = "failure-domain.beta.kubernetes.io/region"
LABEL_INSTANCE_TYPE_BETA = "beta.kubernetes.io/instance-type"

TAINT_NODE_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_NODE_UNREACHABLE = "node.kubernetes.io/unreachable"
TAINT_NODE_UNSCHEDULABLE = "node.kubernetes.io/unschedulable"
