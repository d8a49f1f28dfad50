"""Deprovisioning core: Command/CandidateNode types, candidate scanning,
scheduling simulation, eviction-cost model, price filters, PDB limits.

The port of pkg/controllers/deprovisioning/{types,helpers,pdblimits}.go.
The simulation is the exact path: one TorchSolver.solve (with its
relaxation rounds) over the pending pods and the candidates' pods, with
the candidates taken out of the cluster.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.api.provisioner import Provisioner
from karpenter_core_tpu_torch.cloudprovider.types import InstanceType, Offering
from karpenter_core_tpu_torch.kube.objects import (
    LABEL_INSTANCE_TYPE_STABLE,
    LABEL_TOPOLOGY_ZONE,
    Node,
    Pod,
)
from karpenter_core_tpu_torch.scheduling.requirements import Requirements
from karpenter_core_tpu_torch.solver.torch_solver import SolvedMachine, SolveResult
from karpenter_core_tpu_torch.utils import podutils

ACTION_DELETE = "delete"
ACTION_REPLACE = "replace"
ACTION_RETRY = "retry"
ACTION_DO_NOTHING = "do-nothing"

POD_DELETION_COST_ANNOTATION = "controller.kubernetes.io/pod-deletion-cost"


class CandidateNodeDeletingError(Exception):
    pass


@dataclass
class CandidateNode:
    """types.go:118-126."""

    node: Node
    state_node: object
    instance_type: InstanceType
    capacity_type: str
    zone: str
    provisioner: Provisioner
    pods: List[Pod]
    disruption_cost: float

    @property
    def name(self) -> str:
        return self.node.metadata.name


@dataclass
class Command:
    """types.go:63-67."""

    nodes_to_remove: List[Node] = field(default_factory=list)
    action: str = ACTION_DO_NOTHING
    replacement_machines: List[SolvedMachine] = field(default_factory=list)
    # provenance: True when a DELETE was issued straight from the batched
    # ladder screen (no exact confirming solve); a validation rejection of
    # such a command flips the next ladder to exact per-rung confirmation
    from_screen: bool = False

    def __str__(self) -> str:
        names = [n.metadata.name for n in self.nodes_to_remove]
        if self.action == ACTION_REPLACE:
            return f"{self.action}, terminating {names} and launching replacement"
        return f"{self.action}, terminating {names}"


# ---------------------------------------------------------------------------
# eviction cost model (helpers.go:115-155)


def pod_eviction_cost(pod: Pod) -> float:
    cost = 1.0
    raw = pod.metadata.annotations.get(POD_DELETION_COST_ANNOTATION)
    if raw is not None:
        try:
            cost += float(raw) / (2.0**27)
        except ValueError:
            pass
    if pod.spec.priority is not None:
        cost += float(pod.spec.priority) / (2.0**25)
    return clamp(-10.0, cost, 10.0)


def disruption_cost(pods: List[Pod]) -> float:
    return sum(pod_eviction_cost(p) for p in pods)


def clamp(lo: float, v: float, hi: float) -> float:
    return max(lo, min(v, hi))


def lifetime_remaining(candidate: CandidateNode, clock=None) -> float:
    """helpers.go:308-318: fraction of expiry TTL left scales disruption
    cost toward 0 for nearly-expired nodes.

    clock resolves at call time (None -> time.time), so a clock the caller
    installs later reaches this comparison against the node's wall-clock
    creation_timestamp."""
    if candidate.provisioner.spec.ttl_seconds_until_expired is None:
        return 1.0
    if clock is None:
        clock = time.time
    total = float(candidate.provisioner.spec.ttl_seconds_until_expired)
    age = clock() - candidate.node.metadata.creation_timestamp
    return clamp(0.0, (total - age) / total, 1.0)


# ---------------------------------------------------------------------------
# price filters (helpers.go:138-147,281-304)


def worst_launch_price(offerings: List[Offering], reqs: Requirements) -> float:
    """Max price the launch could resolve to: spot offerings if spot allowed,
    else on-demand."""
    ct_req = reqs.get_requirement(api_labels.LABEL_CAPACITY_TYPE)
    zone_req = reqs.get_requirement(LABEL_TOPOLOGY_ZONE)
    if ct_req.has(api_labels.CAPACITY_TYPE_SPOT):
        spot = [
            o
            for o in offerings
            if o.capacity_type == api_labels.CAPACITY_TYPE_SPOT and zone_req.has(o.zone)
        ]
        if spot:
            return max(o.price for o in spot)
    if ct_req.has(api_labels.CAPACITY_TYPE_ON_DEMAND):
        od = [
            o
            for o in offerings
            if o.capacity_type == api_labels.CAPACITY_TYPE_ON_DEMAND and zone_req.has(o.zone)
        ]
        if od:
            return max(o.price for o in od)
    return math.inf


def filter_by_price(
    options: List[InstanceType], reqs: Requirements, price: float
) -> List[InstanceType]:
    return [
        it for it in options if worst_launch_price(it.offerings.available(), reqs) < price
    ]


def instance_types_are_subset(lhs: List[InstanceType], rhs: List[InstanceType]) -> bool:
    rhs_names = {it.name for it in rhs}
    return all(it.name in rhs_names for it in lhs)


def node_prices(candidates: List[CandidateNode]) -> float:
    """Sum of the candidates' current offering prices (consolidation.go
    getNodePrices)."""
    total = 0.0
    for c in candidates:
        offering = c.instance_type.offerings.get(c.capacity_type, c.zone)
        if offering is None:
            raise ValueError(
                f"unable to determine offering for {c.instance_type.name}/{c.capacity_type}/{c.zone}"
            )
        total += offering.price
    return total


def candidate_price(candidate: CandidateNode) -> Optional[float]:
    """One candidate's current offering price, or None when its offering
    cannot be determined (a 'priceless' node — its zone/capacity-type
    labels name an offering the cloud provider no longer lists). The
    ranking objective treats None as a zero-savings contribution; the
    exact REPLACE path still refuses to price such a subset
    (node_prices raises -> do-nothing, the reference's err branch)."""
    offering = candidate.instance_type.offerings.get(
        candidate.capacity_type, candidate.zone
    )
    return None if offering is None else offering.price


def replacement_price_floor(
    instance_types: Dict[str, List[InstanceType]]
) -> float:
    """The cheapest price ANY replacement launch could possibly resolve to:
    min over the live instance-type universe of worst_launch_price under
    unconstrained requirements. An optimistic lower bound on a REPLACE
    subset's replacement cost, used only to RANK subsets by savings
    (deprovisioning.replan objective) — the exact confirming solve still
    applies filter_by_price's strictly-cheaper rule before anything
    executes, so an over-optimistic rank costs one extra confirmation,
    never a wrong command."""
    floor = math.inf
    empty = Requirements()
    for its in instance_types.values():
        for it in its:
            price = worst_launch_price(it.offerings.available(), empty)
            floor = min(floor, price)
    return 0.0 if floor is math.inf else floor


# ---------------------------------------------------------------------------
# PDB limits (pdblimits.go:34-76)


class PDBLimits:
    def __init__(self, kube_client):
        self.kube_client = kube_client
        self.pdbs = kube_client.list("PodDisruptionBudget")

    def can_evict_pods(self, pods: List[Pod]) -> Tuple[str, bool]:
        """(blocking pdb name, ok)."""
        for pdb in self.pdbs:
            if pdb.spec.selector is None:
                continue
            for pod in pods:
                if pdb.metadata.namespace != pod.metadata.namespace:
                    continue
                if pdb.spec.selector.matches(pod.metadata.labels):
                    if pdb.status.disruptions_allowed <= 0:
                        return f"{pdb.metadata.namespace}/{pdb.metadata.name}", False
        return "", True


def pods_prevent_eviction(pods: List[Pod]) -> Tuple[str, bool]:
    """helpers.go PodsPreventEviction: do-not-evict blocks (reason, blocked)."""
    for pod in pods:
        if podutils.is_terminating(pod) or podutils.is_terminal(pod) or podutils.is_owned_by_node(pod):
            continue
        if podutils.has_do_not_evict(pod):
            return (
                f"pod {pod.metadata.namespace}/{pod.metadata.name} has do-not-evict annotation",
                True,
            )
    return "", False


def can_be_terminated(candidate: CandidateNode, pdbs: PDBLimits) -> Tuple[str, bool]:
    """helpers.go canBeTerminated."""
    if candidate.node.metadata.deletion_timestamp is not None:
        return "in the process of deletion", False
    pdb, ok = pdbs.can_evict_pods(candidate.pods)
    if not ok:
        return f"pdb {pdb} prevents pod evictions", False
    reason, blocked = pods_prevent_eviction(candidate.pods)
    if blocked:
        return reason, False
    return "", True


# ---------------------------------------------------------------------------
# candidate scan (helpers.go:161-238)


def candidate_nodes(
    cluster,
    kube_client,
    cloud_provider,
    should_deprovision: Callable[[object, Provisioner, List[Pod]], bool],
    clock=None,
) -> List[CandidateNode]:
    # clock resolves late (see lifetime_remaining): a default bound at
    # import would pin whatever time.time was at import forever
    if clock is None:
        clock = time.time
    provisioners: Dict[str, Provisioner] = {
        p.name: p for p in kube_client.list("Provisioner")
    }
    instance_types_by_prov: Dict[str, Dict[str, InstanceType]] = {
        name: {it.name: it for it in cloud_provider.get_instance_types(p)}
        for name, p in provisioners.items()
    }

    candidates: List[CandidateNode] = []

    # ONE pass over the pod store instead of a per-candidate filtered list:
    # the naive form is O(nodes x pods) with a lambda per pair — at 1k
    # nodes / 10k pods that is 10M calls per deprovisioning scan.
    # Shared references (copy_objects=False): this path only READS pods —
    # simulate paths shallow-clone (clone_for_simulation) before clearing
    # node_name and the solvers deep-copy a pod before relaxing it — and at
    # 10k pods the per-scan clone dominated the whole replan's host time
    pods_by_node: Dict[str, List[Pod]] = {}
    for p in kube_client.list("Pod", copy_objects=False):
        if p.spec.node_name and not podutils.is_terminal(p):
            pods_by_node.setdefault(p.spec.node_name, []).append(p)

    def visit(state_node) -> bool:
        labels = state_node.labels()
        prov_name = labels.get(api_labels.PROVISIONER_NAME_LABEL_KEY)
        provisioner = provisioners.get(prov_name)
        it_map = instance_types_by_prov.get(prov_name)
        if state_node.is_marked_for_deletion():
            return True
        if provisioner is None or it_map is None:
            return True
        instance_type = it_map.get(labels.get(LABEL_INSTANCE_TYPE_STABLE, ""))
        if instance_type is None:
            return True
        capacity_type = labels.get(api_labels.LABEL_CAPACITY_TYPE)
        zone = labels.get(LABEL_TOPOLOGY_ZONE)
        if not capacity_type or not zone:
            return True
        if not state_node.initialized():
            return True
        if state_node.nominated():
            return True
        if state_node.node is None:
            return True
        pods = pods_by_node.get(state_node.name(), [])
        if not should_deprovision(state_node, provisioner, pods):
            return True
        candidate = CandidateNode(
            node=state_node.node,
            state_node=state_node,
            instance_type=instance_type,
            capacity_type=capacity_type,
            zone=zone,
            provisioner=provisioner,
            pods=pods,
            disruption_cost=disruption_cost(pods),
        )
        candidate.disruption_cost *= lifetime_remaining(candidate, clock)
        candidates.append(candidate)
        return True

    cluster.for_each_node(visit)
    return candidates


# ---------------------------------------------------------------------------
# scheduling simulation (helpers.go:41-105)


def simulate_scheduling(
    kube_client,
    cluster,
    provisioning,
    candidates: List[CandidateNode],
) -> Tuple[List[SolvedMachine], bool]:
    """Re-enter the solver in simulation mode over (pending + evicted) pods
    with the candidates removed from the snapshot. Returns (new machines,
    all_pods_scheduled)."""
    return _simulate_scheduling_traced(kube_client, cluster, provisioning, candidates)


def _simulate_scheduling_traced(
    kube_client,
    cluster,
    provisioning,
    candidates: List[CandidateNode],
) -> Tuple[List[SolvedMachine], bool]:
    candidate_names = {c.name for c in candidates}
    state_nodes = []
    deleting_nodes = []
    for node in cluster.nodes():
        if node.is_marked_for_deletion():
            deleting_nodes.append(node)
        elif node.name() not in candidate_names:
            state_nodes.append(node)
    if any(n.name() in candidate_names for n in deleting_nodes):
        raise CandidateNodeDeletingError()

    pods = provisioning.get_pending_pods()
    for candidate in candidates:
        pods.extend(
            p for p in candidate.pods if not podutils.is_owned_by_daemonset(p)
        )
    for node in deleting_nodes:
        pods.extend(
            p
            for p in kube_client.list(
                "Pod",
                node_name=node.name(),
                copy_objects=False,  # cloned for mutation two lines down
            )
            if not podutils.is_terminal(p) and not podutils.is_owned_by_daemonset(p)
        )
    pods = [podutils.clone_for_simulation(p) for p in pods]

    provisioners = [
        p for p in kube_client.list("Provisioner") if p.metadata.deletion_timestamp is None
    ]
    if not provisioners:
        return [], not pods
    instance_types = {
        p.name: provisioning.cloud_provider.get_instance_types(p) for p in provisioners
    }
    result: SolveResult = provisioning.solver.solve(
        pods,
        provisioners,
        instance_types,
        daemonset_pods=provisioning.get_daemonset_pods(),
        state_nodes=state_nodes,
        kube_client=kube_client,
        cluster=cluster,
    )
    scheduled = result.pod_count_new() + result.pod_count_existing()
    # in-flight (uninitialized) existing nodes taking pods -> not conclusive
    for state_node, placed in result.existing_assignments:
        if placed and not state_node.initialized():
            return result.new_machines, False
    return result.new_machines, scheduled == len(pods)
