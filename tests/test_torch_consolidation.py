"""Consolidation decisions of the PyTorch port against the JAX reference,
on the CPU, on the geometries of tests/test_consolidation_parity.py.

The reference side is a full operator (new_operator with a
TPUSolver(backend="mxu")); the port side is the port's own kube client,
a Cluster fed by the informers through watches, a ProvisioningController
with a TorchSolver(device="cpu"), the fake provider and the consolidation
deprovisioners, all on one pinned FakeClock with validation_ttl = 0. Both
must agree on the candidates and their order, every SubsetScreen of the
multi-node ladder and of the single-node sweep (pods_per_slot included),
and the Command: its action, the nodes it removes and the replacement's
instance-type options. The host modules (candidate_nodes, PDBLimits,
replacement_price_floor, build_union_scenario's planes, Cluster
nomination, deletion marks and the consolidated TTL) are held against the
reference's on the same inputs."""
from types import SimpleNamespace

import numpy as np
import pytest

from karpenter_core_tpu.api import settings as jsettings
from karpenter_core_tpu.cloudprovider import fake as jfake
from karpenter_core_tpu.controllers.deprovisioning import core as jcore
from karpenter_core_tpu.kube import objects as jobj
from karpenter_core_tpu.operator import new_operator
from karpenter_core_tpu.solver import replan as jreplan
from karpenter_core_tpu.solver.tpu_solver import TPUSolver
from karpenter_core_tpu import testing as jt
from karpenter_core_tpu_torch import testing as tt
from karpenter_core_tpu_torch.api import settings as tsettings
from karpenter_core_tpu_torch.cloudprovider import fake as tfake
from karpenter_core_tpu_torch.controllers.deprovisioning import consolidation as tcons
from karpenter_core_tpu_torch.controllers.deprovisioning import core as tcore
from karpenter_core_tpu_torch.controllers.provisioning.provisioner import (
    ProvisioningController,
)
from karpenter_core_tpu_torch.kube import objects as tobj
from karpenter_core_tpu_torch.kube.client import InMemoryKubeClient
from karpenter_core_tpu_torch.solver import replan as treplan
from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver
from karpenter_core_tpu_torch.state import informer
from karpenter_core_tpu_torch.state.cluster import Cluster

PROV = "karpenter.sh/provisioner-name"
INIT = "karpenter.sh/initialized"
CT = "karpenter.sh/capacity-type"
ZONE = "topology.kubernetes.io/zone"
ITYPE = "node.kubernetes.io/instance-type"
T0 = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _reset_settings():
    yield
    jsettings.set_current(jsettings.Settings())
    tsettings.set_current(tsettings.Settings())


@pytest.fixture(autouse=True)
def _slots_and_screens(monkeypatch):
    """Every batched screen of a pass fetches its per-slot counts, in both
    packages, so the captured SubsetScreens carry pods_per_slot."""
    for mod in (jreplan, treplan):
        real = mod.batched_subset_screen

        def forced(*a, _real=real, **kw):
            kw["want_slots"] = True
            return _real(*a, **kw)

        monkeypatch.setattr(mod, "batched_subset_screen", forced)
    tcons.reset_fallbacks()
    yield
    assert tcons.FALLBACKS == {"multi": 0, "single": 0}


class PortEnv:
    """The port's side: client, informer-fed Cluster, the provisioning
    controller and the consolidation deprovisioners on one clock."""

    def __init__(self, max_nodes=64, types=10):
        self.clock = tt.FakeClock(T0)
        self.client = InMemoryKubeClient()
        self.cluster = Cluster(self.client, clock=self.clock)
        self.queues = [
            (self.client.watch("Node"), informer.NodeInformer(self.cluster)),
            (self.client.watch("Pod"), informer.PodInformer(self.cluster)),
            (self.client.watch("Provisioner"), informer.ProvisionerInformer(self.cluster)),
        ]
        self.cp = tfake.FakeCloudProvider(tfake.instance_types(types))
        self.provisioning = ProvisioningController(
            self.client, self.cp, self.cluster,
            solver=TorchSolver(max_nodes=max_nodes, device="cpu"), clock=self.clock)
        args = (self.client, self.cluster, self.provisioning, self.cp, None)
        self.multi = tcons.MultiNodeConsolidation(*args, clock=self.clock, validation_ttl=0.0)
        self.single = tcons.SingleNodeConsolidation(*args, clock=self.clock,
                                                    validation_ttl=0.0)
        self.m = SimpleNamespace(t=tt, o=tobj, core=tcore, replan=treplan,
                                 settings=tsettings)

    def sync(self):
        for q, inf in self.queues:
            informer.drain(q, inf)


class RefEnv:
    """The reference's side: a full operator."""

    def __init__(self, max_nodes=64, types=10):
        self.clock = jt.FakeClock(T0)
        self.cp = jfake.FakeCloudProvider(jfake.instance_types(types))
        self.op = new_operator(self.cp, settings=jsettings.Settings(),
                               solver=TPUSolver(max_nodes=max_nodes, backend="mxu"),
                               clock=self.clock)
        for d in self.op.deprovisioning.deprovisioners:
            d.validation_ttl = 0.0
        self.client, self.cluster = self.op.kube_client, self.op.cluster
        self.provisioning = self.op.provisioning
        self.multi = _dep(self.op, "MultiNodeConsolidation")
        self.single = _dep(self.op, "SingleNodeConsolidation")
        self.m = SimpleNamespace(t=jt, o=jobj, core=jcore, replan=jreplan,
                                 settings=jsettings)

    def sync(self):
        self.op.sync_state()


def _dep(op, name):
    return next(d for d in op.deprovisioning.deprovisioners if type(d).__name__ == name)


def add_keeper(env, cpu="40", pods="200"):
    t = env.m.t
    env.client.create(t.make_provisioner(name="static"))
    env.client.create(t.make_node(
        name="keeper", labels={PROV: "static", INIT: "true"},
        capacity={"cpu": cpu, "memory": "80Gi", "pods": pods}))


def add_node(env, name, it_name="fake-it-9", cpu="10", ct="on-demand", pods=1,
             zone="test-zone-1", pod_requests=None, pod_labels=None):
    t = env.m.t
    node = t.make_node(
        name=name,
        labels={PROV: "default", INIT: "true", ITYPE: it_name, CT: ct, ZONE: zone},
        capacity={"cpu": cpu, "memory": "20Gi", "pods": "100"},
    )
    node.metadata.creation_timestamp = env.clock()
    env.client.create(node)
    for j in range(pods):
        pod = t.make_pod(name=f"{name}-p{j}", requests=pod_requests or {"cpu": "0.1"},
                         node_name=name, unschedulable=False, labels=pod_labels)
        pod.metadata.uid = f"uid-{name}-{j}"
        pod.metadata.creation_timestamp = 1000.0 + j
        pod.status.phase = "Running"
        env.client.create(pod)


def add_pdb(env, labels, name="guard"):
    if isinstance(env, PortEnv):
        pdb = tt.make_pdb(name, labels, disruptions_allowed=0)
    else:
        pdb = jobj.PodDisruptionBudget(
            spec=jobj.PodDisruptionBudgetSpec(
                selector=jobj.LabelSelector(match_labels=dict(labels))),
            status=jobj.PodDisruptionBudgetStatus(disruptions_allowed=0))
        pdb.metadata.name, pdb.metadata.namespace = name, "default"
    env.client.create(pdb)


def default_provisioner(env):
    env.client.create(env.m.t.make_provisioner(name="default", consolidation_enabled=True))


def scan(env, dep):
    return env.m.core.candidate_nodes(env.cluster, env.client, env.cp,
                                      dep.should_deprovision, env.clock)


def _screen_tuple(s):
    return (s.subset, s.all_scheduled, s.n_new_machines, s.conclusive, s.price,
            s.disruption, s.savings, s.priceless)


def _command_tuple(cmd):
    repl = [[it.name for it in m.instance_type_options] for m in cmd.replacement_machines]
    return (cmd.action, [n.metadata.name for n in cmd.nodes_to_remove], repl,
            cmd.from_screen)


def run_pass(env, kind):
    """One deprovisioner's compute_command over the raw candidates, with
    its screens captured; returns (sorted candidate names, screens, cmd)."""
    dep = env.multi if kind == "multi" else env.single
    captured = []
    dep._record_pass = lambda cands, screens, cmd, scenario=None: captured.append(screens)
    raw = scan(env, dep)
    order = [c.name for c in dep.sort_and_filter_candidates(raw)]
    cmd = dep.compute_command(raw)
    return order, captured, cmd


def assert_same_decisions(ref, port, kinds=("multi", "single")):
    """Both packages decide alike; returns the port's (order, screens, cmd)
    per kind."""
    out = {}
    for kind in kinds:
        r_order, r_screens, r_cmd = run_pass(ref, kind)
        p_order, p_screens, p_cmd = run_pass(port, kind)
        assert p_order == r_order, kind
        assert len(p_screens) == len(r_screens), kind
        for rs, ps in zip(r_screens, p_screens):
            assert [_screen_tuple(s) for s in ps] == [_screen_tuple(s) for s in rs], kind
            for a, b in zip(rs, ps):
                assert b.pods_per_slot is not None
                assert np.array_equal(a.pods_per_slot, b.pods_per_slot), (kind, a.subset)
        assert _command_tuple(p_cmd) == _command_tuple(r_cmd), kind
        out[kind] = (p_order, p_screens, p_cmd)
    return out


def both(build, **kw):
    envs = []
    for env in (RefEnv(**kw), PortEnv(**kw)):
        build(env)
        env.sync()
        envs.append(env)
    return envs


# -- geometries of test_consolidation_parity.py ----------------------------


def test_delete_geometry_matches_reference():
    def build(env):
        default_provisioner(env)
        add_keeper(env)
        for i in range(6):
            add_node(env, f"lite-{i}")

    ref, port = both(build)
    out = assert_same_decisions(ref, port)
    order, screens, cmd = out["multi"]
    assert len(order) == 6 and cmd.action == "delete" and len(cmd.nodes_to_remove) == 6
    assert port.multi.validate_command(cmd, scan(port, port.multi))
    assert out["single"][2].action == "delete"


def test_replace_geometry_matches_reference():
    def build(env):
        default_provisioner(env)
        add_node(env, "big-1", it_name="fake-it-9", cpu="10")
        add_node(env, "big-2", it_name="fake-it-4", cpu="5")

    ref, port = both(build)
    out = assert_same_decisions(ref, port)
    cmd = out["multi"][2]
    assert cmd.action == "replace" and not cmd.from_screen
    names = {it.name for it in cmd.replacement_machines[0].instance_type_options}
    assert "fake-it-9" not in names


def test_empty_subset_rides_along_matches_reference():
    def build(env):
        default_provisioner(env)
        for i in range(3):
            add_node(env, f"loaded-{i}", pods=30, pod_requests={"cpu": "0.3"})
        add_node(env, "empty-a", pods=0)
        add_node(env, "empty-b", pods=0)

    ref, port = both(build)
    out = assert_same_decisions(ref, port)
    order, screens, _cmd = out["multi"]
    empty = tuple(i for i, name in enumerate(order) if name.startswith("empty"))
    assert len(empty) == 2
    assert empty in [s.subset for s in screens[0]]


def test_pdb_blocked_candidates_match_reference():
    def build(env):
        default_provisioner(env)
        add_keeper(env)
        for i in range(4):
            add_node(env, f"lite-{i}", pod_labels={"app": "guarded"} if i == 0 else None)
        add_pdb(env, {"app": "guarded"})

    ref, port = both(build)
    out = assert_same_decisions(ref, port)
    order, _screens, cmd = out["multi"]
    assert "lite-0" not in order
    assert "lite-0" not in {n.metadata.name for n in cmd.nodes_to_remove}


def test_priceless_node_matches_reference():
    def build(env):
        default_provisioner(env)
        add_keeper(env)
        for i in range(3):
            add_node(env, f"lite-{i}")
        add_node(env, "priceless", zone="test-zone-9")

    ref, port = both(build)
    out = assert_same_decisions(ref, port)
    assert out["multi"][2].action == "delete"
    assert any(s.priceless for s in out["multi"][1][0])


def test_single_node_ranked_sweep_matches_reference():
    def build(env):
        default_provisioner(env)
        add_keeper(env)
        for i in range(5):
            add_node(env, f"lite-{i}", it_name=f"fake-it-{5 + i}")

    ref, port = both(build)
    out = assert_same_decisions(ref, port, kinds=("single",))
    order, screens, cmd = out["single"]
    assert len(screens[0]) == len(order) == 5
    assert all(len(s.subset) == 1 for s in screens[0])
    assert cmd.action == "delete" and len(cmd.nodes_to_remove) == 1


def test_disruption_budget_matches_reference():
    def build(env):
        env.m.settings.set_current(env.m.settings.Settings(consolidation_disruption_budget=2))
        default_provisioner(env)
        add_keeper(env)
        for i in range(6):
            add_node(env, f"lite-{i}")

    ref, port = both(build)
    out = assert_same_decisions(ref, port, kinds=("multi",))
    cmd = out["multi"][2]
    assert cmd.action == "delete" and len(cmd.nodes_to_remove) == 2


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_seeded_fuzz_matches_reference(seed):
    def build(env):
        rng = np.random.RandomState(seed)
        default_provisioner(env)
        if rng.rand() < 0.7:
            add_keeper(env)
        for i in range(int(rng.randint(4, 8))):
            add_node(env, f"fuzz-{i}", it_name=f"fake-it-{int(rng.randint(3, 10))}",
                     pods=int(rng.randint(0, 3)),
                     pod_requests={"cpu": str(round(float(rng.uniform(0.1, 0.4)), 2))})

    ref, port = both(build)
    assert_same_decisions(ref, port)


# -- host modules ------------------------------------------------------------


def _pdb_world(env):
    default_provisioner(env)
    add_keeper(env)
    for i in range(4):
        add_node(env, f"lite-{i}", pods=2,
                 pod_labels={"app": "guarded"} if i == 0 else {"app": f"web-{i}"})
    add_pdb(env, {"app": "guarded"})
    dne = env.m.t.make_pod(name="pinned", requests={"cpu": "0.1"}, node_name="lite-2",
                           unschedulable=False)
    dne.metadata.annotations["karpenter.sh/do-not-evict"] = "true"
    dne.metadata.uid = "uid-pinned"
    dne.metadata.creation_timestamp = 1000.0
    dne.status.phase = "Running"
    env.client.create(dne)
    pending = env.m.t.make_pod(name="pending-a", requests={"cpu": "2"})
    pending.metadata.uid = "uid-pending-a"
    pending.metadata.creation_timestamp = 1000.0
    env.client.create(pending)


def test_candidates_pdb_limits_and_union_planes_match_reference():
    ref, port = both(_pdb_world)
    r_c, p_c = scan(ref, ref.multi), scan(port, port.multi)
    assert [(c.name, c.disruption_cost, c.capacity_type, c.zone, len(c.pods))
            for c in p_c] == [(c.name, c.disruption_cost, c.capacity_type, c.zone,
                               len(c.pods)) for c in r_c]
    r_pdb, p_pdb = jcore.PDBLimits(ref.client), tcore.PDBLimits(port.client)
    for rc, pc in zip(r_c, p_c):
        assert tcore.can_be_terminated(pc, p_pdb) == jcore.can_be_terminated(rc, r_pdb)
        assert tcore.candidate_price(pc) == jcore.candidate_price(rc)
    assert [c.name for c in port.multi.sort_and_filter_candidates(p_c)] == [
        c.name for c in ref.multi.sort_and_filter_candidates(r_c)]
    types_r = {"default": ref.cp.get_instance_types(None)}
    types_p = {"default": port.cp.get_instance_types(None)}
    assert tcore.replacement_price_floor(types_p) == jcore.replacement_price_floor(types_r)
    r_sc = jreplan.build_union_scenario(ref.client, ref.cluster, ref.provisioning, r_c,
                                        max_nodes=64)
    p_sc = treplan.build_union_scenario(port.client, port.cluster, port.provisioning, p_c,
                                        max_nodes=64)
    for name in ("cand_slot", "uninitialized", "counts_base", "counts_per_cand"):
        assert np.array_equal(getattr(p_sc, name), getattr(r_sc, name)), name
    assert p_sc.item_pad == r_sc.item_pad and p_sc.prices == r_sc.prices
    assert p_sc.replacement_floor == r_sc.replacement_floor
    assert sorted(p_sc.cand_of_pod.items()) == sorted(r_sc.cand_of_pod.items())
    subsets = [(0,), (1, 2), tuple(range(len(p_c)))]
    for a, b in zip(r_sc.subset_rows(subsets), p_sc.subset_rows(subsets)):
        assert np.array_equal(a, b)
    # the union scenario never mutated the live pods it read
    assert all(p.spec.node_name for c in p_c for p in c.pods)


def test_pending_and_daemonset_readers_match_reference():
    def build(env):
        t, o = env.m.t, env.m.o

        def pend(name, **kw):
            p = t.make_pod(name=name, requests={"cpu": "1"}, **kw)
            p.metadata.uid = f"uid-{name}"
            p.metadata.creation_timestamp = 1000.0
            return p

        default_provisioner(env)
        env.client.create(pend("plain"))
        env.client.create(pend("bound", node_name="somewhere", unschedulable=False))
        env.client.create(pend("not-failed", unschedulable=False))
        # opted out of provisioned nodes, a restricted label, a missing
        # claim, a claim of a missing class: all left out
        env.client.create(pend("opted-out", node_affinity_required=[o.NodeSelectorTerm(
            [o.NodeSelectorRequirement(PROV, "DoesNotExist", [])])]))
        env.client.create(pend("restricted", node_affinity_required=[o.NodeSelectorTerm(
            [o.NodeSelectorRequirement("kubernetes.io/custom", "In", ["x"])])]))
        missing = pend("no-claim")
        missing.spec.volumes.append(t.pvc_volume("missing"))
        env.client.create(missing)
        env.client.create(t.make_pvc("ghost-class", storage_class="ghost"))
        ghost = pend("ghost-class")
        ghost.spec.volumes.append(t.pvc_volume("ghost-class"))
        env.client.create(ghost)
        env.client.create(t.make_storage_class("ebs"))
        env.client.create(t.make_pvc("good", storage_class="ebs"))
        good = pend("good-claim")
        good.spec.volumes.append(t.pvc_volume("good"))
        env.client.create(good)
        env.client.create(t.make_daemonset(name="ds", requests={"cpu": "0.5"}))

    ref, port = both(build)
    names = [p.metadata.name for p in port.provisioning.get_pending_pods()]
    assert names == [p.metadata.name for p in ref.provisioning.get_pending_pods()]
    assert names == ["plain", "good-claim"]
    r_ds, p_ds = ref.provisioning.get_daemonset_pods(), port.provisioning.get_daemonset_pods()
    assert [(p.metadata.name, p.spec.containers[0].resources.requests) for p in p_ds] == [
        (p.metadata.name, p.spec.containers[0].resources.requests) for p in r_ds]
    assert len(p_ds) == 1


def test_cluster_nomination_marks_and_consolidated_ttl_match_reference():
    def build(env):
        default_provisioner(env)
        for i in range(2):
            add_node(env, f"n-{i}", pods=0)

    ref, port = both(build)
    for env in (ref, port):
        env.m.settings.set_current(env.m.settings.Settings(batch_max_duration=7.0))
    states = []
    for env in (ref, port):
        c = env.cluster
        seen = []
        c.nominate_node_for_pod("n-0")
        by_name = {n.name(): n for n in c.nodes()}
        seen.append((by_name["n-0"].nominated(), by_name["n-1"].nominated()))
        env.clock.advance(13.0)
        seen.append(c.node_for("n-0").nominated())
        env.clock.advance(2.0)
        seen.append(c.node_for("n-0").nominated())
        rev = c.revision()
        c.mark_for_deletion("n-1", "ghost")
        seen.append((c.node_for("n-1").is_marked_for_deletion(), c.revision() - rev))
        names = [n.name for n in env.m.core.candidate_nodes(
            c, env.client, env.cp, env.multi.should_deprovision, env.clock)]
        seen.append(names)
        c.unmark_for_deletion("n-1")
        seen.append(c.node_for("n-1").is_marked_for_deletion())
        c.set_consolidated(True)
        seen.append(c.consolidated())
        env.clock.advance(c.CONSOLIDATED_TTL + 1)
        seen.append(c.consolidated())
        c.set_consolidated(True)
        env.client.delete("Node", "", "n-0")
        env.sync()
        seen.append(c.consolidated())
        states.append(seen)
    assert states[0] == states[1]
    assert states[1][0] == (True, False) and states[1][1] is True and states[1][2] is False
