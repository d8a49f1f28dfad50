"""Topology groups: spread, pod affinity and pod anti-affinity.

The port of karpenter_core_tpu/controllers/provisioning/scheduling/
topology.py (topology.go, topologygroup.go, topologynodefilter.go), as far
as the device solver needs it: the groups a batch forms, hashed for sharing
across pods, with their owners, selectors, node filters and registered
domains. Placement-time evaluation (the skew rule, affinity seeding, the
anti-affinity zero-count rule, Record) runs on the device
(ops/topology.py); ops/topology.encode_topology lowers these groups to its
tensors.

Seeding from pods already in the cluster (countDomains,
topology.go:231-276; inverse anti-affinity of running pods,
topology.go:183-196) and namespace selectors resolved through the
apiserver need a kube client, which the port does not have yet: the solver
refuses a kube client or cluster (ROADMAP Queue A), and a selector's listed
namespaces stand alone, as in the reference without a client.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

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
    """topology.go:37-80, for a batch with no cluster pods to seed from."""

    def __init__(self, domains: Dict[str, Set[str]], pods: List,
                 update_pods: Optional[List] = None):
        """update_pods: the subset of `pods` to register groups and
        ownership for; the encoder passes one representative per pod-spec
        equivalence class (membership is a pure function of spec, labels
        and namespace)."""
        self.domains = domains
        self.topologies: Dict[Tuple, TopologyGroup] = {}
        self.inverse_topologies: Dict[Tuple, TopologyGroup] = {}
        for pod in pods if update_pods is None else update_pods:
            self.update(pod)

    def update(self, pod) -> None:
        """Derive the pod's topology groups (topology.go:86-117)."""
        for tg in self.topologies.values():
            tg.remove_owner(pod.metadata.uid)
        if podutils.has_pod_anti_affinity(pod):
            self._update_inverse_anti_affinity(pod)
        for tg in self._new_for_topologies(pod) + self._new_for_affinities(pod):
            key = tg.hash_key()
            existing = self.topologies.get(key)
            if existing is None:
                self.topologies[key] = tg
            else:
                tg = existing
            tg.add_owner(pod.metadata.uid)

    def _update_inverse_anti_affinity(self, pod) -> None:
        """topology.go:200-227: an inverse group tracks where a pod with
        anti-affinity lands, so later matching pods avoid those domains."""
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
            tg.add_owner(pod.metadata.uid)

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

    @staticmethod
    def _build_namespace_list(namespace: str, namespaces: List[str],
                              selector) -> Set[str]:
        """topology.go:327-347 without a kube client: a namespace selector
        adds no namespaces beyond the listed ones."""
        if not namespaces and selector is None:
            return {namespace}
        return set(namespaces)
