"""Topology groups: spread, pod affinity and pod anti-affinity.

The port of karpenter_core_tpu/controllers/provisioning/scheduling/
topology.py (topology.go, topologygroup.go, topologynodefilter.go), as far
as the device solver needs it: the groups a batch forms, hashed for sharing
across pods, with their owners, selectors, node filters and registered
domains, and their counts seeded from the cluster: scheduled pods listed
through a kube client (countDomains, topology.go:231-276), the inverse
anti-affinity of bound pods (topology.go:183-196) and namespace selectors
resolved through the client (topology.go:327-347). Placement-time
evaluation (the skew rule, affinity seeding, the anti-affinity zero-count
rule, Record) runs on the device (ops/topology.py);
ops/topology.encode_topology lowers these groups to its tensors.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from karpenter_core_tpu_torch.kube.objects import LABEL_HOSTNAME
from karpenter_core_tpu_torch.scheduling.requirements import Requirements
from karpenter_core_tpu_torch.utils import podutils

MAX_SKEW_UNBOUNDED = 2**31 - 1

TOPOLOGY_TYPE_SPREAD = "topology spread"
TOPOLOGY_TYPE_POD_AFFINITY = "pod affinity"
TOPOLOGY_TYPE_POD_ANTI_AFFINITY = "pod anti-affinity"


def build_domains(provisioners, instance_types) -> Dict[str, set]:
    """Topology-domain universe: provisioner ∩ instance-type requirement
    values per key (provisioner.go:227-243; the reference's
    scheduler.build_domains)."""
    domains: Dict[str, set] = {}
    for provisioner in provisioners:
        prov_reqs = Requirements.from_node_selector_requirements(
            *provisioner.spec.requirements
        )
        for instance_type in instance_types.get(provisioner.name, []):
            requirements = Requirements(prov_reqs.values())
            requirements.add(*instance_type.requirements.values())
            for key, requirement in requirements.items():
                domains.setdefault(key, set()).update(requirement.values_list())
        for key, requirement in prov_reqs.items():
            if requirement.operator() == "In":
                domains.setdefault(key, set()).update(requirement.values_list())
    return domains


def _selector_canonical(selector) -> Tuple:
    if selector is None:
        return ("nil",)
    return (
        tuple(sorted(selector.match_labels.items())),
        tuple(sorted(
            (e.key, e.operator, tuple(sorted(e.values)))
            for e in selector.match_expressions
        )),
    )


def _selector_matches(selector, labels: Dict[str, str]) -> bool:
    """metav1.LabelSelectorAsSelector semantics: nil matches nothing, empty
    matches everything."""
    if selector is None:
        return False
    return selector.matches(labels)


class TopologyNodeFilter:
    """OR-of-terms node filter of a spread constraint
    (topologynodefilter.go:15-56)."""

    def __init__(self, terms: List[Requirements]):
        self.terms = terms

    @classmethod
    def for_pod(cls, pod) -> "TopologyNodeFilter":
        node_selector_reqs = Requirements.from_labels(pod.spec.node_selector)
        affinity = pod.spec.affinity
        if (affinity is None or affinity.node_affinity is None
                or not affinity.node_affinity.required):
            return cls([node_selector_reqs])
        terms = []
        for term in affinity.node_affinity.required:
            reqs = Requirements(node_selector_reqs.values())
            reqs.add(*Requirements.from_node_selector_requirements(
                *term.match_expressions).values())
            terms.append(reqs)
        return cls(terms)

    @classmethod
    def empty(cls) -> "TopologyNodeFilter":
        return cls([])

    def matches_requirements(self, requirements: Requirements) -> bool:
        if not self.terms:
            return True
        return any(requirements.compatible(term) is None for term in self.terms)

    def matches_labels(self, labels: Dict[str, str]) -> bool:
        return self.matches_requirements(Requirements.from_labels(labels))

    def canonical(self) -> Tuple:
        return tuple(sorted(
            tuple(sorted(
                (r.key, r.complement, tuple(sorted(r.values)), r.greater_than,
                 r.less_than)
                for r in term.values()
            ))
            for term in self.terms
        ))


class TopologyGroup:
    """topologygroup.go:51-85."""

    def __init__(self, topology_type: str, key: str, pod, namespaces: Set[str],
                 selector, max_skew: int, domains: Optional[Set[str]]):
        self.type = topology_type
        self.key = key
        self.namespaces = set(namespaces)
        self.selector = selector
        self.max_skew = max_skew
        self.domains: Dict[str, int] = {d: 0 for d in (domains or set())}
        self.owners: Set[str] = set()  # uids of the pods carrying this rule
        if topology_type == TOPOLOGY_TYPE_SPREAD and pod is not None:
            self.node_filter = TopologyNodeFilter.for_pod(pod)
        else:
            self.node_filter = TopologyNodeFilter.empty()

    def record(self, *domains: str) -> None:
        for domain in domains:
            self.domains[domain] = self.domains.get(domain, 0) + 1

    def add_owner(self, uid: str) -> None:
        self.owners.add(uid)

    def remove_owner(self, uid: str) -> None:
        self.owners.discard(uid)

    def is_owned_by(self, uid: str) -> bool:
        return uid in self.owners

    def hash_key(self) -> Tuple:
        """Identity for sharing across pods (topologygroup.go:137-153)."""
        return (
            self.key,
            self.type,
            tuple(sorted(self.namespaces)),
            _selector_canonical(self.selector),
            self.max_skew,
            self.node_filter.canonical(),
        )

    def _selects(self, pod) -> bool:
        return pod.metadata.namespace in self.namespaces and _selector_matches(
            self.selector, pod.metadata.labels
        )


class Topology:
    """topology.go:37-80."""

    def __init__(self, kube_client, cluster, domains: Dict[str, Set[str]], pods: List,
                 update_pods: Optional[List] = None):
        """kube_client and cluster may be None (nothing to seed from).
        update_pods: the subset of `pods` to register groups and ownership
        for; the encoder passes one representative per pod-spec
        equivalence class (membership is a pure function of spec, labels
        and namespace). `pods` always defines the excluded set."""
        self.kube_client = kube_client
        self.cluster = cluster
        self.domains = domains
        self.topologies: Dict[Tuple, TopologyGroup] = {}
        self.inverse_topologies: Dict[Tuple, TopologyGroup] = {}
        # the batch's own pods are placed by this solve, so they never
        # count as cluster pods (topology.go:56-58)
        self.excluded_pods: Set[str] = {p.metadata.uid for p in pods}
        self._update_inverse_affinities()
        for pod in pods if update_pods is None else update_pods:
            self.update(pod)

    def update(self, pod) -> None:
        """Derive the pod's topology groups (topology.go:86-117); a new
        group's counts are seeded from the cluster."""
        for tg in self.topologies.values():
            tg.remove_owner(pod.metadata.uid)
        if podutils.has_pod_anti_affinity(pod):
            self._update_inverse_anti_affinity(pod, None)
        for tg in self._new_for_topologies(pod) + self._new_for_affinities(pod):
            key = tg.hash_key()
            existing = self.topologies.get(key)
            if existing is None:
                self._count_domains(tg)
                self.topologies[key] = tg
            else:
                tg = existing
            tg.add_owner(pod.metadata.uid)

    def _update_inverse_affinities(self) -> None:
        """Inverse anti-affinity of the pods bound in the cluster
        (topology.go:183-196)."""
        if self.cluster is None:
            return

        def visit(pod, node) -> bool:
            if pod.metadata.uid not in self.excluded_pods:
                self._update_inverse_anti_affinity(pod, node.metadata.labels)
            return True

        self.cluster.for_pods_with_anti_affinity(visit)

    def _update_inverse_anti_affinity(self, pod, node_labels: Optional[Dict[str, str]]) -> None:
        """topology.go:200-227: an inverse group tracks where a pod with
        anti-affinity landed (its node's domain, for a bound pod), so later
        matching pods avoid those domains."""
        for term in pod.spec.affinity.pod_anti_affinity.required:
            namespaces = self._build_namespace_list(
                pod.metadata.namespace, term.namespaces, term.namespace_selector
            )
            tg = TopologyGroup(
                TOPOLOGY_TYPE_POD_ANTI_AFFINITY, term.topology_key, pod,
                namespaces, term.label_selector, MAX_SKEW_UNBOUNDED,
                self.domains.get(term.topology_key, set()),
            )
            key = tg.hash_key()
            existing = self.inverse_topologies.get(key)
            if existing is None:
                self.inverse_topologies[key] = tg
            else:
                tg = existing
            if node_labels and tg.key in node_labels:
                tg.record(node_labels[tg.key])
            tg.add_owner(pod.metadata.uid)

    def _count_domains(self, tg: TopologyGroup) -> None:
        """Seed a group's domain counts from the scheduled cluster pods it
        selects (topology.go:231-276): pending, terminal, terminating and
        batch pods do not count, nor a pod whose node is unknown, has no
        domain for the key (the hostname key falls back to the node's
        name) or fails the group's node filter."""
        if self.kube_client is None:
            return
        pods: List = []
        for ns in tg.namespaces:
            pods.extend(self.kube_client.list("Pod", namespace=ns, selector=tg.selector))
        for pod in pods:
            if (not podutils.is_scheduled(pod) or podutils.is_terminal(pod)
                    or podutils.is_terminating(pod)):
                continue
            if pod.metadata.uid in self.excluded_pods:
                continue
            node = self.kube_client.get("Node", "", pod.spec.node_name)
            if node is None:
                continue
            domain = node.metadata.labels.get(tg.key)
            if domain is None and tg.key == LABEL_HOSTNAME:
                domain = node.metadata.name
            if domain is None:
                continue
            if not tg.node_filter.matches_labels(node.metadata.labels):
                continue
            tg.record(domain)

    def _new_for_topologies(self, pod) -> List[TopologyGroup]:
        return [
            TopologyGroup(
                TOPOLOGY_TYPE_SPREAD, cs.topology_key, pod,
                {pod.metadata.namespace}, cs.label_selector, cs.max_skew,
                self.domains.get(cs.topology_key, set()),
            )
            for cs in pod.spec.topology_spread_constraints
        ]

    def _new_for_affinities(self, pod) -> List[TopologyGroup]:
        """Required and preferred terms both become groups
        (topology.go:283-322)."""
        affinity = pod.spec.affinity
        if affinity is None:
            return []
        terms = []
        if affinity.pod_affinity is not None:
            terms += [(TOPOLOGY_TYPE_POD_AFFINITY, t)
                      for t in affinity.pod_affinity.required]
            terms += [(TOPOLOGY_TYPE_POD_AFFINITY, t.pod_affinity_term)
                      for t in affinity.pod_affinity.preferred]
        if affinity.pod_anti_affinity is not None:
            terms += [(TOPOLOGY_TYPE_POD_ANTI_AFFINITY, t)
                      for t in affinity.pod_anti_affinity.required]
            terms += [(TOPOLOGY_TYPE_POD_ANTI_AFFINITY, t.pod_affinity_term)
                      for t in affinity.pod_anti_affinity.preferred]
        return [
            TopologyGroup(
                topology_type, term.topology_key, pod,
                self._build_namespace_list(
                    pod.metadata.namespace, term.namespaces,
                    term.namespace_selector,
                ),
                term.label_selector, MAX_SKEW_UNBOUNDED,
                self.domains.get(term.topology_key, set()),
            )
            for topology_type, term in terms
        ]

    def _build_namespace_list(self, namespace: str, namespaces: List[str],
                              selector) -> Set[str]:
        """topology.go:327-347: the listed namespaces plus those a
        namespace selector matches through the kube client."""
        if not namespaces and selector is None:
            return {namespace}
        if selector is None:
            return set(namespaces)
        selected = set(namespaces)
        if self.kube_client is not None:
            for ns in self.kube_client.list("Namespace", selector=selector):
                selected.add(ns.metadata.name)
        return selected
