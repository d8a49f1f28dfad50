"""Topology groups: spread, pod affinity and pod anti-affinity.

The port of karpenter_core_tpu/controllers/provisioning/scheduling/
topology.py (topology.go, topologygroup.go, topologynodefilter.go): the
groups a batch forms, hashed for sharing across pods, with their owners,
selectors, node filters and registered domains, and their counts seeded
from the cluster: scheduled pods listed through a kube client
(countDomains, topology.go:231-276), the inverse anti-affinity of bound
pods (topology.go:183-196) and namespace selectors resolved through the
client (topology.go:327-347). ops/topology.encode_topology lowers these
groups to the device solver's tensors, and the placement-time evaluation
runs on the device there (ops/topology.py). The host scheduler
(scheduler.py) evaluates the same rules here: the skew rule, affinity
seeding and the anti-affinity zero-count rule (TopologyGroup.get),
AddRequirements, Record and Register.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from karpenter_core_tpu_torch.kube.objects import LABEL_HOSTNAME
from karpenter_core_tpu_torch.scheduling.requirement import (
    OP_DOES_NOT_EXIST,
    OP_IN,
    Requirement,
)
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


class TopologyError:
    """An unsatisfiable topology constraint (topology.go:149-167), in the
    reference's words. The message is built when it is read: the scheduler
    reads it only for a new machine that refuses the pod, and formatting a
    hostname group's counts costs far more than the check itself."""

    __slots__ = ("type", "key", "counts", "pod_domains", "node_domains")

    def __init__(self, tg: "TopologyGroup", pod_domains: Requirement,
                 node_domains: Requirement):
        self.type, self.key = tg.type, tg.key
        self.counts = dict(tg.domains)
        self.pod_domains, self.node_domains = repr(pod_domains), repr(node_domains)

    def __str__(self) -> str:
        return (f"unsatisfiable topology constraint for {self.type}, key={self.key} "
                f"(counts = {self.counts}, podDomains = {self.pod_domains}, "
                f"nodeDomains = {self.node_domains})")

    def __format__(self, spec: str) -> str:
        return format(str(self), spec)


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

    # -- next-domain selection (topologygroup.go:82-98,155-243) -----------

    def get(self, pod, pod_domains: Requirement, node_domains: Requirement) -> Requirement:
        if self.type == TOPOLOGY_TYPE_SPREAD:
            return self._next_domain_spread(pod, pod_domains, node_domains)
        if self.type == TOPOLOGY_TYPE_POD_AFFINITY:
            return self._next_domain_affinity(pod, pod_domains, node_domains)
        return self._next_domain_anti_affinity(pod_domains)

    def record(self, *domains: str) -> None:
        for domain in domains:
            self.domains[domain] = self.domains.get(domain, 0) + 1

    def counts(self, pod, requirements: Requirements) -> bool:
        """Whether the pod's placement under `requirements` counts for this
        group (topologygroup.go:101-103)."""
        return self._selects(pod) and self.node_filter.matches_requirements(requirements)

    def register(self, *domains: str) -> None:
        for domain in domains:
            self.domains.setdefault(domain, 0)

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

    def _viable(self, domains: Requirement) -> List[str]:
        """The group's domains that `domains` allows, in sorted order (the
        order the reference's loops visit them). A finite requirement (a
        node's one hostname) is walked over its own values, not over every
        domain of the group."""
        if not domains.complement:
            return sorted(d for d in domains.values if d in self.domains and domains.has(d))
        return [d for d in sorted(self.domains) if domains.has(d)]

    def _next_domain_spread(self, pod, pod_domains: Requirement,
                            node_domains: Requirement) -> Requirement:
        """kube-scheduler skew rule: count + self - min <= maxSkew, the
        min-count domain wins (topologygroup.go:155-182)."""
        min_count = self._domain_min_count(pod_domains)
        self_selecting = self._selects(pod)
        best_domain = None
        best_count = MAX_SKEW_UNBOUNDED
        for domain in self._viable(node_domains):
            count = self.domains[domain]
            if self_selecting:
                count += 1
            if count - min_count <= self.max_skew and count < best_count:
                best_domain = domain
                best_count = count
        if best_domain is None:
            return Requirement(pod_domains.key, OP_DOES_NOT_EXIST)
        return Requirement(pod_domains.key, OP_IN, [best_domain])

    def _domain_min_count(self, domains: Requirement) -> int:
        """The minimum over the domains the pod can select; the hostname
        key's is always 0 (topologygroup.go:185-199)."""
        if self.key == LABEL_HOSTNAME:
            return 0
        counts = [self.domains[d] for d in self._viable(domains)]
        return min(counts) if counts else MAX_SKEW_UNBOUNDED

    def _next_domain_affinity(self, pod, pod_domains: Requirement,
                              node_domains: Requirement) -> Requirement:
        """The domains holding matching pods; a self-selecting pod may seed
        the first viable domain (topologygroup.go:202-233)."""
        options = Requirement(pod_domains.key, OP_DOES_NOT_EXIST)
        viable = self._viable(pod_domains)
        options.insert(*(d for d in viable if self.domains[d] > 0))
        if options.len() == 0 and self._selects(pod):
            options.insert(*self._viable(pod_domains.intersection(node_domains))[:1])
            options.insert(*viable[:1])
        return options

    def _next_domain_anti_affinity(self, domains: Requirement) -> Requirement:
        """Only zero-count domains stay viable (topologygroup.go:235-243)."""
        options = Requirement(domains.key, OP_DOES_NOT_EXIST)
        options.insert(*(d for d in self._viable(domains) if self.domains[d] == 0))
        return options

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

    def record(self, pod, requirements: Requirements) -> None:
        """Commit a placement into the domain counts (topology.go:120-143)."""
        for tg in self.topologies.values():
            if tg.counts(pod, requirements):
                domains = requirements.get_requirement(tg.key)
                if tg.type == TOPOLOGY_TYPE_POD_ANTI_AFFINITY:
                    tg.record(*domains.values_list())
                elif domains.len() == 1:
                    tg.record(domains.values_list()[0])
        for tg in self.inverse_topologies.values():
            if tg.is_owned_by(pod.metadata.uid):
                tg.record(*requirements.get_requirement(tg.key).values_list())

    def add_requirements(self, pod_requirements: Requirements,
                         node_requirements: Requirements, pod
                         ) -> Tuple[Optional[Requirements], Optional[TopologyError]]:
        """Tighten the node's requirements to the viable domains
        (topology.go:149-167). Returns (requirements, error); str(error) is
        the reference's message."""
        requirements = Requirements(node_requirements.values())
        for tg in self._get_matching_topologies(pod, node_requirements):
            pod_domains = pod_requirements.get_requirement(tg.key)
            node_domains = node_requirements.get_requirement(tg.key)
            domains = tg.get(pod, pod_domains, node_domains)
            if domains.len() == 0:
                return None, TopologyError(tg, pod_domains, node_domains)
            requirements.add(domains)
        return requirements, None

    def register(self, topology_key: str, domain: str) -> None:
        """Register a new domain, such as a machine's hostname
        (topology.go:170-180)."""
        for tg in self.topologies.values():
            if tg.key == topology_key:
                tg.register(domain)
        for tg in self.inverse_topologies.values():
            if tg.key == topology_key:
                tg.register(domain)

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

    def _get_matching_topologies(self, pod, requirements: Requirements) -> List[TopologyGroup]:
        """The groups that control the pod's scheduling, and the inverse
        groups the pod counts against (topology.go:351-364)."""
        matching = [tg for tg in self.topologies.values()
                    if tg.is_owned_by(pod.metadata.uid)]
        matching += [tg for tg in self.inverse_topologies.values()
                     if tg.counts(pod, requirements)]
        return matching
