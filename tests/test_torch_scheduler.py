"""The port's host scheduler and GreedySolver against the reference's, on
the CPU.

Every case is built twice, once with each package's builders, with pod
names, uids and creation timestamps pinned (they break FFD ties). The two
packages' schedulers and GreedySolvers must agree byte for byte under the
reference's canonical placement serializer; the port's GreedySolver and
the port's TorchSolver(device="cpu") are held to the equivalence bar of
tests/test_differential_fuzz.py (every constraint holds, the device fails
no more pods than the host and opens at most one machine more).
"""
import itertools
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

from karpenter_core_tpu.obs import flightrec as jrec

from karpenter_core_tpu_torch.obs import flightrec as trec
from karpenter_core_tpu_torch.scheduling import taints as ttaints
from karpenter_core_tpu_torch.scheduling.requirements import Requirements as TRequirements
from karpenter_core_tpu_torch.solver import torch_solver as tsolver
from karpenter_core_tpu_torch.utils import resources as tresources

from tests.test_torch_cuda import FAMILIES, _mods, workload

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
CT = "karpenter.sh/capacity-type"
PROV = "karpenter.sh/provisioner-name"
ZONES = ["test-zone-1", "test-zone-2", "test-zone-3"]


@pytest.fixture(autouse=True)
def _pin_node_ids(monkeypatch):
    """A new machine's placeholder hostname comes from a process-wide
    counter in each package, and a topology error quotes the hostnames it
    counts: both counters start at 1 in each test."""
    from karpenter_core_tpu.scheduling import machinetemplate as jtemplate
    from karpenter_core_tpu_torch.scheduling import machinetemplate as ttemplate

    for mod in (jtemplate, ttemplate):
        monkeypatch.setattr(mod, "_node_id", itertools.count(1))


class Builder:
    """One package's builders, modules and a pod counter (pinned names,
    uids and creation timestamps)."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.m = _mods(pkg)
        if pkg == "jax":
            from karpenter_core_tpu.controllers.provisioning.scheduling import (
                preferences,
                scheduler,
                topology,
            )
            from karpenter_core_tpu.scheduling import requirement, requirements
            from karpenter_core_tpu.solver.tpu_solver import GreedySolver

            self.rec = jrec
        else:
            from karpenter_core_tpu_torch.controllers.provisioning.scheduling import (
                preferences,
                scheduler,
                topology,
            )
            from karpenter_core_tpu_torch.scheduling import requirement, requirements
            from karpenter_core_tpu_torch.solver.torch_solver import GreedySolver

            self.rec = trec
        self.scheduler, self.topology, self.preferences = scheduler, topology, preferences
        self.requirement, self.requirements = requirement, requirements
        self.GreedySolver = GreedySolver
        self.o = self.m.o
        self.fake = self.m.fake
        self.n = 0

    def pod(self, **kw):
        self.n += 1
        p = self.m.t.make_pod(name=f"pod-{self.n:03d}", **kw)
        p.metadata.uid = f"uid-{self.n:05d}"
        p.metadata.creation_timestamp = 1000.0 + (self.n * 37) % 11
        return p

    def provisioner(self, **kw):
        kw.setdefault("name", "default")  # not a process-wide counter's name
        return self.m.t.make_provisioner(**kw)

    def node(self, name, labels, capacity):
        return self.m.node(self.m.t.make_node(name=name, labels=labels, capacity=capacity))

    def solve(self, pods, provisioners=None, instance_types=None, state_nodes=None):
        provisioners = provisioners or [self.provisioner()]
        its = instance_types if instance_types is not None else self.fake.instance_types(10)
        it_map = {p.name: its for p in provisioners}
        s = self.scheduler.build_scheduler(
            self.m.client(), None, provisioners, it_map, pods, state_nodes=state_nodes,
            opts=self.scheduler.SchedulerOptions(simulation_mode=True))
        return s.solve(pods)


def _placements(b, result) -> str:
    """A SchedulingResult through the package's canonical placements, plus
    each machine's requirements and option names and the failure causes."""
    view = SimpleNamespace(
        new_machines=result.new_machines,
        existing_assignments=[(n.state_node, n.pods) for n in result.existing_nodes if n.pods],
        failed_pods=result.failed_pods,
    )
    extra = sorted(
        (sorted(p.metadata.name for p in m.pods), repr(m.requirements),
         [it.name for it in m.instance_type_options])
        for m in result.new_machines
    )
    return b.rec.placements_json(b.rec.canonical_placements(view)) + repr(extra) + repr(
        sorted(result.errors.items()))


# -- the 20 cases of tests/test_scheduler.py, with the reference's assertions --


def case_single_pod_single_node(b):
    result = b.solve([b.pod(requests={"cpu": "1"})])
    assert len(result.new_machines) == 1
    assert result.pod_count_new() == 1
    assert not result.failed_pods
    return result


def case_bin_packs_multiple_pods_one_node(b):
    pods = [b.pod(requests={"cpu": "1"}) for _ in range(10)]
    result = b.solve(pods, instance_types=b.fake.instance_types(20))
    assert not result.failed_pods
    assert len(result.new_machines) == 1
    machine = result.new_machines[0]
    assert len(machine.pods) == 10
    for it in machine.instance_type_options:
        assert it.allocatable()["cpu"] >= 10
    return result


def case_huge_pod_fails(b):
    result = b.solve([b.pod(requests={"cpu": "1000"})])
    assert len(result.failed_pods) == 1
    assert not result.new_machines
    return result


def case_instance_type_narrowing_by_node_selector(b):
    result = b.solve([b.pod(node_selector={"node.kubernetes.io/instance-type": "fake-it-3"})])
    assert not result.failed_pods
    assert [it.name for it in result.new_machines[0].instance_type_options] == ["fake-it-3"]
    return result


def case_taints_block_untolerating_pods(b):
    o = b.o
    prov = b.provisioner(taints=[o.Taint("team", "infra", "NoSchedule")])
    result = b.solve([b.pod()], provisioners=[prov])
    assert len(result.failed_pods) == 1
    ok = b.solve([b.pod(tolerations=[o.Toleration(key="team", operator="Exists")])],
                 provisioners=[b.provisioner(taints=[o.Taint("team", "infra", "NoSchedule")])])
    assert not ok.failed_pods
    return ok


def case_provisioner_requirements_constrain_pods(b):
    o = b.o
    prov = b.provisioner(requirements=[o.NodeSelectorRequirement(ZONE, "In", ["test-zone-1"])])
    ok = b.solve([b.pod(node_selector={ZONE: "test-zone-1"})], provisioners=[prov])
    assert not ok.failed_pods
    bad = b.solve([b.pod(node_selector={ZONE: "test-zone-3"})], provisioners=[prov])
    assert len(bad.failed_pods) == 1
    return bad


def case_weighted_provisioner_order(b):
    heavy = b.provisioner(name="heavy", weight=50, labels={"tier": "heavy"})
    light = b.provisioner(name="light", labels={"tier": "light"})
    result = b.solve([b.pod(requests={"cpu": "1"})], provisioners=[light, heavy])
    assert result.new_machines[0].provisioner_name == "heavy"
    return result


def case_provisioner_limits_respected(b):
    prov = b.provisioner(limits={"cpu": "4"})
    its = [b.fake.new_instance_type("only-4cpu", resources={"cpu": 4.0, "pods": 100.0})]
    result = b.solve([b.pod(requests={"cpu": "1"}) for _ in range(8)], provisioners=[prov],
                     instance_types=its)
    assert len(result.new_machines) == 1
    assert result.failed_pods
    return result


def _spread(b, key):
    o = b.o
    return o.TopologySpreadConstraint(
        max_skew=1, topology_key=key, when_unsatisfiable="DoNotSchedule",
        label_selector=o.LabelSelector(match_labels={"app": "web"}))


def case_zonal_topology_spread(b):
    spread = _spread(b, ZONE)
    pods = [b.pod(labels={"app": "web"}, requests={"cpu": "1"}, topology_spread=[spread])
            for _ in range(6)]
    result = b.solve(pods, instance_types=b.fake.instance_types(5))
    assert not result.failed_pods
    zone_counts = {}
    for m in result.new_machines:
        zone_req = m.requirements.get_requirement(ZONE)
        assert zone_req.len() == 1
        zone = zone_req.values_list()[0]
        zone_counts[zone] = zone_counts.get(zone, 0) + len(m.pods)
    assert len(zone_counts) == 3
    assert max(zone_counts.values()) - min(zone_counts.values()) <= 1
    return result


def case_hostname_topology_spread_forces_nodes(b):
    spread = _spread(b, HOST)
    pods = [b.pod(labels={"app": "web"}, requests={"cpu": "1"}, topology_spread=[spread])
            for _ in range(4)]
    result = b.solve(pods, instance_types=b.fake.instance_types(5))
    assert not result.failed_pods
    assert len(result.new_machines) >= 2
    return result


def _term(b, key, app):
    o = b.o
    return o.PodAffinityTerm(topology_key=key,
                             label_selector=o.LabelSelector(match_labels={"app": app}))


def case_pod_anti_affinity_zone_late_committal(b):
    term = _term(b, ZONE, "db")
    pods = [b.pod(labels={"app": "db"}, requests={"cpu": "1"}, pod_anti_affinity_required=[term])
            for _ in range(3)]
    result = b.solve(pods, instance_types=b.fake.instance_types(5))
    assert result.pod_count_new() == 1
    assert len(result.failed_pods) == 2
    return result


def case_pod_anti_affinity_hostname_separates_in_one_batch(b):
    term = _term(b, HOST, "db")
    pods = [b.pod(labels={"app": "db"}, requests={"cpu": "1"}, pod_anti_affinity_required=[term])
            for _ in range(3)]
    result = b.solve(pods, instance_types=b.fake.instance_types(5))
    assert not result.failed_pods
    assert len(result.new_machines) == 3
    assert all(len(m.pods) == 1 for m in result.new_machines)
    return result


def case_pod_affinity_colocates(b):
    term = _term(b, ZONE, "web")
    pods = [b.pod(labels={"app": "web"}, requests={"cpu": "1"}) for _ in range(2)] + [
        b.pod(labels={"app": "web"}, requests={"cpu": "1"}, pod_affinity_required=[term])
        for _ in range(2)]
    result = b.solve(pods, instance_types=b.fake.instance_types(20))
    assert not result.failed_pods
    zones = set()
    for m in result.new_machines:
        if m.pods:
            zones.update(m.requirements.get_requirement(ZONE).values_list())
    assert len(zones) == 1
    return result


def case_relaxation_drops_impossible_preferred_affinity(b):
    o = b.o
    pref = o.PreferredSchedulingTerm(weight=1, preference=o.NodeSelectorTerm(
        [o.NodeSelectorRequirement(ZONE, "In", ["mars-zone"])]))
    result = b.solve([b.pod(requests={"cpu": "1"}, node_affinity_preferred=[pref])])
    assert not result.failed_pods
    return result


def case_relaxation_required_or_terms(b):
    o = b.o
    terms = [o.NodeSelectorTerm([o.NodeSelectorRequirement(ZONE, "In", ["mars-zone"])]),
             o.NodeSelectorTerm([o.NodeSelectorRequirement(ZONE, "In", ["test-zone-1"])])]
    result = b.solve([b.pod(requests={"cpu": "1"}, node_affinity_required=terms)])
    assert not result.failed_pods
    assert result.new_machines[0].requirements.get_requirement(ZONE).values_list() == [
        "test-zone-1"]
    return result


def case_existing_node_reused(b):
    node = b.node("existing-1", {PROV: "default", "karpenter.sh/initialized": "true",
                                 HOST: "existing-1"},
                  {"cpu": "16", "memory": "32Gi", "pods": "100"})
    result = b.solve([b.pod(requests={"cpu": "1"})], state_nodes=[node])
    assert not result.new_machines
    assert result.pod_count_existing() == 1
    return result


def case_existing_node_overflow_opens_new(b):
    node = b.node("small-1", {PROV: "default", "karpenter.sh/initialized": "true"},
                  {"cpu": "2", "pods": "10"})
    result = b.solve([b.pod(requests={"cpu": "1"}) for _ in range(4)], state_nodes=[node])
    assert not result.failed_pods
    assert result.pod_count_existing() == 2
    assert result.pod_count_new() == 2
    return result


def case_capacity_type_requirement_filters_offerings(b):
    result = b.solve([b.pod(node_selector={CT: "spot"})])
    assert not result.failed_pods
    m = result.new_machines[0]
    assert m.requirements.get_requirement(CT).has("spot")
    for it in m.instance_type_options:
        assert any(o.capacity_type == "spot" for o in it.offerings.available())
    return result


def case_progress_queue_terminates_on_unsatisfiable(b):
    result = b.solve([b.pod(requests={"cpu": "1"}), b.pod(requests={"cpu": "999"})])
    assert len(result.failed_pods) == 1
    assert result.pod_count_new() == 1
    return result


def case_is_relaxable_predicate(b):
    """Preferences.is_relaxable agrees with what relax() can drop; returns
    the verdicts (compared across packages)."""
    import copy

    o = b.o
    prefs = b.preferences.Preferences()
    term = _term(b, ZONE, "x")
    cases = [
        b.pod(requests={"cpu": "1"}),
        b.pod(requests={"cpu": "1"}, pod_affinity_preferred=[
            o.WeightedPodAffinityTerm(weight=1, pod_affinity_term=term)]),
        b.pod(requests={"cpu": "1"}, topology_spread=[o.TopologySpreadConstraint(
            max_skew=1, topology_key=HOST, when_unsatisfiable="ScheduleAnyway",
            label_selector=o.LabelSelector(match_labels={"app": "x"}))]),
        b.pod(requests={"cpu": "1"}, pod_affinity_required=[term]),
    ]
    verdicts = []
    for pod in cases:
        probe = copy.deepcopy(pod)
        assert prefs.is_relaxable(pod) == prefs.relax(probe), pod
        verdicts.append(prefs.is_relaxable(pod))
    return verdicts


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduler_case_matches_reference(case):
    fn = CASES[case]
    ref, port = Builder("jax"), Builder("torch")
    want, got = fn(ref), fn(port)
    if isinstance(want, list):
        assert got == want
        return
    assert _placements(port, got) == _placements(ref, want)


def test_scheduler_cases_cover_the_reference_file():
    """One case per test of tests/test_scheduler.py."""
    import ast
    import os

    path = os.path.join(os.path.dirname(__file__), "test_scheduler.py")
    tree = ast.parse(open(path).read())
    names = {n.name[len("test_"):] for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    assert names == set(CASES) and len(names) == 20


# -- the host Topology's methods on seeded inputs --------------------------------


def _topology_pods(b, rng, n):
    o = b.o
    pods = []
    for i in range(n):
        app = f"app-{int(rng.integers(0, 3))}"
        kind = int(rng.integers(0, 5))
        kw = dict(labels={"app": app}, requests={"cpu": "0.5"})
        sel = o.LabelSelector(match_labels={"app": app})
        key = ZONE if rng.random() < 0.5 else HOST
        if kind == 0:
            kw["topology_spread"] = [o.TopologySpreadConstraint(
                max_skew=int(rng.integers(1, 3)), topology_key=key,
                when_unsatisfiable="DoNotSchedule", label_selector=sel)]
        elif kind == 1:
            kw["pod_affinity_required"] = [o.PodAffinityTerm(topology_key=key,
                                                             label_selector=sel)]
        elif kind == 2:
            kw["pod_anti_affinity_required"] = [o.PodAffinityTerm(topology_key=key,
                                                                  label_selector=sel)]
        elif kind == 3:
            kw["node_selector"] = {ZONE: ZONES[int(rng.integers(0, 3))]}
            kw["topology_spread"] = [o.TopologySpreadConstraint(
                max_skew=1, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
                label_selector=sel)]
        pods.append(b.pod(**kw))
    return pods


def _topology_state(topology):
    return sorted(
        (repr(k), tg.type, tg.key, sorted(tg.domains.items()), sorted(tg.owners))
        for groups in (topology.topologies, topology.inverse_topologies)
        for k, tg in groups.items()
    )


@pytest.mark.parametrize("seed", [5, 19, 31])
def test_host_topology_methods_match_reference(seed):
    """add_requirements (TopologyGroup.get: the skew rule, affinity seeding,
    the anti-affinity zero-count rule), record, register, counts and the
    domain min count on seeded pods and node requirements, step by step."""
    sides = []
    for pkg in ("jax", "torch"):
        b = Builder(pkg)
        rng = np.random.default_rng(seed)
        pods = _topology_pods(b, rng, 24)
        domains = {ZONE: set(ZONES), HOST: {f"host-{h}" for h in range(4)}}
        topo = b.topology.Topology(None, None, domains, pods)
        Req, R = b.requirements.Requirements, b.requirement
        trace = []
        for step in range(60):
            pod = pods[int(rng.integers(0, len(pods)))]
            zones = [z for z in ZONES if rng.random() < 0.6] or [ZONES[0]]
            host = f"host-{int(rng.integers(0, 6))}"
            if rng.random() < 0.3:
                topo.register(HOST, host)
            node = Req([R.Requirement(ZONE, R.OP_IN, zones),
                        R.Requirement(HOST, R.OP_IN, [host])])
            pod_reqs = Req.from_pod(pod)
            got, err = topo.add_requirements(pod_reqs, node, pod)
            trace.append((step, pod.metadata.name, repr(got), err if err is None else str(err)))
            for tg in list(topo.topologies.values()) + list(topo.inverse_topologies.values()):
                trace.append((tg.counts(pod, node),
                              tg._domain_min_count(pod_reqs.get_requirement(tg.key))))
            if got is not None and rng.random() < 0.7:
                merged = Req(node.values())
                merged.add(*got.values())
                topo.record(pod, merged)
            trace.append(_topology_state(topo))
        sides.append(trace)
    assert sides[1] == sides[0]


# -- GreedySolver: both packages byte-identical, and against the device ----------


def _greedy(pkg, family):
    pods, provs, its, daemons, nodes, _mn, client, cluster = workload(family, pkg)
    solver = Builder(pkg).GreedySolver()
    res = solver.solve(pods, provs, its, daemons, nodes, kube_client=client, cluster=cluster)
    return res, pods


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_solver_matches_reference(family):
    want, _ = _greedy("jax", family)
    got, _ = _greedy("torch", family)
    assert trec.placements_json(got) == jrec.placements_json(want)
    assert got.errors == want.errors
    assert [repr(m.requirements) for m in got.new_machines] == [
        repr(m.requirements) for m in want.new_machines]


def _fuzz_workload(b, seed):
    """tests/test_differential_fuzz.py's _workload, built with b's
    builders (names, uids and creation timestamps pinned)."""
    o, rng = b.o, np.random.default_rng(seed)
    universe = b.fake.instance_types(8)
    zonal = o.TopologySpreadConstraint(
        max_skew=1, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
        label_selector=o.LabelSelector(match_labels={"app": "spread"}))
    tol = [o.Toleration(key="dedicated", operator="Exists")]
    apps = ["a", "b", "c", "d"]
    pods = [b.pod(requests={"cpu": "0.1"}, node_selector={ZONE: z}) for z in ZONES]
    pods += [b.pod(labels={"app": app}, requests={"cpu": "0.1"}) for app in apps]
    pods.append(b.pod(labels={"app": "spread"}, requests={"cpu": "0.1"},
                      topology_spread=[zonal]))
    pods.append(b.pod(requests={"cpu": "0.1"}, host_ports=[9000]))
    pods.append(b.pod(requests={"cpu": "0.1"}, tolerations=tol))
    while len(pods) < 72:
        kind = int(rng.integers(0, 6))
        cpu = float(rng.choice([0.25, 0.5, 1.0, 2.0]))
        mem = str(int(rng.choice([1, 2, 4]))) + "Gi"
        if kind == 0:
            pods.append(b.pod(requests={"cpu": str(cpu)},
                              node_selector={ZONE: str(rng.choice(ZONES))}))
        elif kind == 1:
            pods.append(b.pod(labels={"app": "spread"}, requests={"cpu": str(cpu)},
                              topology_spread=[zonal]))
        elif kind == 2:
            pods.append(b.pod(requests={"cpu": str(cpu)}, host_ports=[9000]))
        elif kind == 3:
            pods.append(b.pod(requests={"cpu": str(cpu), "memory": mem}, tolerations=tol))
        else:
            pods.append(b.pod(labels={"app": str(rng.choice(apps))},
                              requests={"cpu": str(cpu), "memory": mem}))
    pods = [pods[i] for i in rng.permutation(len(pods))]
    nodes = []
    for e in range(6):
        it = universe[e % len(universe)]
        nodes.append(b.node(f"fuzz-node-{e}", {
            PROV: "default", "karpenter.sh/initialized": "true",
            "node.kubernetes.io/instance-type": it.name, CT: "on-demand",
            ZONE: ZONES[e % 3]}, {k: str(v) for k, v in it.capacity.items()}))
    provisioners = [
        b.provisioner(name="default"),
        b.provisioner(name="tainted", weight=10,
                      taints=[o.Taint(key="dedicated", value="x", effect="NoSchedule")]),
    ]
    return pods, provisioners, {"default": universe, "tainted": universe}, nodes


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_greedy_solver_matches_reference_on_fuzz_seeds(seed):
    out = {}
    for pkg in ("jax", "torch"):
        b = Builder(pkg)
        pods, provs, its, nodes = _fuzz_workload(b, seed)
        out[pkg] = (b, b.GreedySolver().solve(pods, provs, its, state_nodes=nodes))
    (jb, want), (tb, got) = out["jax"], out["torch"]
    assert tb.rec.placements_json(got) == jb.rec.placements_json(want)
    assert got.errors == want.errors


def _check_invariants(res, pods):
    """Every pod accounted once; existing nodes within their resources,
    selectors and taints; machines with an option that fits their
    requests; one port-9000 pod a node; zonal DoNotSchedule spreads of
    app=spread within skew 1 (the fuzz workload's)."""
    placed = Counter(id(p) for m in res.new_machines for p in m.pods)
    placed.update(id(p) for _n, ps in res.existing_assignments for p in ps)
    assert not [c for c in placed.values() if c > 1], "pod placed twice"
    failed = {id(p) for p in res.failed_pods}
    assert failed.isdisjoint(placed)
    assert len(placed) + len(failed) == len(pods)
    for node, ps in res.existing_assignments:
        total = tresources.merge(*[tresources.requests_for_pods(p) for p in ps])
        assert tresources.fits(total, node.available()), node.name()
        node_reqs = TRequirements.from_labels(node.labels())
        for p in ps:
            assert ttaints.tolerates(node.taints(), p) is None
            assert node_reqs.compatible(TRequirements.from_pod(p)) is None
    for m in res.new_machines:
        assert m.instance_type_options, "machine without an instance type"
        need = tresources.requests_for_pods(*m.pods)
        assert any(tresources.fits(need, it.allocatable()) for it in m.instance_type_options)
    groups = [ps for _n, ps in res.existing_assignments] + [m.pods for m in res.new_machines]
    for ps in groups:
        assert sum(1 for p in ps for c in p.spec.containers for port in c.ports
                   if port.host_port) <= 1, "two hostPort pods on one node"
    zone_counts = dict.fromkeys(ZONES, 0)
    for m in res.new_machines:
        n_spread = sum(1 for p in m.pods if p.metadata.labels.get("app") == "spread"
                       and p.spec.topology_spread_constraints)
        if n_spread:
            zs = m.requirements.get_requirement(ZONE).values_list()
            assert len(zs) == 1, "a spread owner's machine pins one zone"
            zone_counts[zs[0]] += n_spread
    for node, ps in res.existing_assignments:
        z = node.labels().get(ZONE)
        if z in zone_counts:
            zone_counts[z] += sum(1 for p in ps if p.metadata.labels.get("app") == "spread"
                                  and p.spec.topology_spread_constraints)
    if sum(zone_counts.values()):
        assert max(zone_counts.values()) - min(zone_counts.values()) <= 1, zone_counts


def _equivalence_bar(device, host, pods):
    _check_invariants(device, pods)
    _check_invariants(host, pods)
    assert len(device.failed_pods) <= len(host.failed_pods)
    assert len(device.new_machines) <= len(host.new_machines) + 1


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_greedy_against_torch_solver_on_fuzz_seeds(seed):
    b = Builder("torch")
    pods, provs, its, nodes = _fuzz_workload(b, seed)
    host = tsolver.GreedySolver().solve(pods, provs, its,
                                        state_nodes=[n.deep_copy() for n in nodes])
    device = tsolver.TorchSolver(max_nodes=96, device="cpu").solve(
        pods, provs, its, state_nodes=[n.deep_copy() for n in nodes])
    _equivalence_bar(device, host, pods)


@pytest.mark.parametrize("family", ["mixed", "bulk", "wide", "refmix", "cluster"])
def test_greedy_against_torch_solver_on_families(family):
    pods, provs, its, daemons, nodes, mn, client, cluster = workload(family, "torch")
    host = tsolver.GreedySolver().solve(pods, provs, its, daemons,
                                        [n.deep_copy() for n in nodes] if nodes else nodes,
                                        kube_client=client, cluster=cluster)
    device = tsolver.TorchSolver(max_nodes=mn, device="cpu").solve(
        pods, provs, its, daemonset_pods=daemons, state_nodes=nodes, kube_client=client,
        cluster=cluster)
    assert len(device.failed_pods) <= len(host.failed_pods)
    assert len(device.new_machines) <= len(host.new_machines) + 1
    for res in (device, host):
        placed = Counter(id(p) for m in res.new_machines for p in m.pods)
        placed.update(id(p) for _n, ps in res.existing_assignments for p in ps)
        assert max(placed.values(), default=1) == 1
        assert len(placed) + len(res.failed_pods) == len(pods)


def test_host_helpers_match_reference():
    """Requirements.copy and keys_set, Requirement.__len__, and resources'
    cmp, is_zero and resource_names, on the same inputs in both packages."""
    from karpenter_core_tpu.utils import resources as jresources

    out = {}
    for pkg, res in (("jax", jresources), ("torch", tresources)):
        b = Builder(pkg)
        R, Req = b.requirement, b.requirements.Requirements
        reqs = Req([R.Requirement(ZONE, R.OP_IN, ZONES[:2]),
                    R.Requirement("rack", "NotIn", ["r1"]), R.Requirement("gen", "Gt", ["3"])])
        copied = reqs.copy()
        copied.add(R.Requirement(ZONE, R.OP_IN, ZONES[1:]))
        with pytest.raises(TypeError):
            len(R.Requirement(ZONE, R.OP_IN, ZONES))
        rng = np.random.default_rng(3)
        lists = [{k: float(rng.integers(0, 3)) for k in ("cpu", "memory", "pods")
                  if rng.random() < 0.7} for _ in range(6)]
        out[pkg] = (repr(reqs), repr(copied), sorted(reqs.keys_set()),
                    type(reqs.keys_set()).__name__,
                    [res.cmp(a, b) for a, b in ((1.0, 2.0), (2.0, 2.0), (3.0, -1.0))],
                    [res.is_zero(rl) for rl in lists], res.resource_names(lists))
    assert out["torch"] == out["jax"]
