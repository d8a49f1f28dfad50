"""The node lifecycle modules of the PyTorch port against the JAX
reference, each alone, on the CPU: the kube client's finalizer-aware
delete, finalize, apply, update_status, compare_and_update and evict with
the watch events each emits; the fake provider's create; StateNode over a
node, a Machine or both; Cluster.update_machine / delete_machine with the
change feed; the machine, node and termination controllers step by step;
Terminator.drain's order; and solves after a replacement Machine joins
the cluster (device_args equal, placements byte-identical, and an
incremental solve refreshed exactly across the join).

Launched machines are named fake-machine-N from each package's own
counter; those names are compared as "fake-machine-*"."""
import copy
import re
from types import SimpleNamespace

import pytest

from karpenter_core_tpu.obs.flightrec import canonical_placements, placements_json
from karpenter_core_tpu.solver import encode as jencode
from karpenter_core_tpu.solver import tpu_solver as jsolver
from karpenter_core_tpu_torch.solver import encode as tencode
from karpenter_core_tpu_torch.solver import torch_solver as tsolver

from tests.test_torch_solver import _assert_tree_equal

PROV = "karpenter.sh/provisioner-name"
INIT = "karpenter.sh/initialized"
CT = "karpenter.sh/capacity-type"
ZONE = "topology.kubernetes.io/zone"
ITYPE = "node.kubernetes.io/instance-type"
FINALIZER = "karpenter.sh/termination"
T0 = 1_700_000_000.0


def _lm(pkg):
    """The modules of one package the lifecycle tests drive."""
    if pkg == "jax":
        from karpenter_core_tpu import testing as t
        from karpenter_core_tpu.api import machine, settings
        from karpenter_core_tpu.cloudprovider import fake, types
        from karpenter_core_tpu.controllers.machine import controller as mc
        from karpenter_core_tpu.controllers.machine import terminator
        from karpenter_core_tpu.controllers.node import controller as nc
        from karpenter_core_tpu.controllers.termination import controller as tc
        from karpenter_core_tpu.kube import client, objects
        from karpenter_core_tpu.state import cluster, informer, node
    else:
        from karpenter_core_tpu_torch import testing as t
        from karpenter_core_tpu_torch.api import machine, settings
        from karpenter_core_tpu_torch.cloudprovider import fake, types
        from karpenter_core_tpu_torch.controllers.machine import controller as mc
        from karpenter_core_tpu_torch.controllers.machine import terminator
        from karpenter_core_tpu_torch.controllers.node import controller as nc
        from karpenter_core_tpu_torch.controllers.termination import controller as tc
        from karpenter_core_tpu_torch.kube import client, objects
        from karpenter_core_tpu_torch.state import cluster, informer, node
    return SimpleNamespace(pkg=pkg, t=t, machine=machine, settings=settings, fake=fake,
                           types=types, mc=mc, terminator=terminator, nc=nc, tc=tc,
                           client=client, o=objects, cluster=cluster, informer=informer,
                           node=node)


def both(fn):
    """fn(m) for the reference and the port; equal results, the port's
    returned."""
    ref, port = fn(_lm("jax")), fn(_lm("torch"))
    assert port == ref
    return port


@pytest.fixture(autouse=True)
def _reset_settings():
    yield
    for pkg in ("jax", "torch"):
        m = _lm(pkg)
        m.settings.set_current(m.settings.Settings())


def _canon(value):
    return re.sub(r"fake-machine-\d+", "fake-machine-*", str(value))


def _events(q):
    out = []
    while not q.empty():
        ev, obj = q.get_nowait()
        out.append((ev, _canon(obj.metadata.name), obj.metadata.resource_version,
                    obj.metadata.deletion_timestamp is not None,
                    list(obj.metadata.finalizers)))
    return out


def _node(m, name, cpu="4", labels=None, ready=True, **kw):
    lab = {PROV: "default", INIT: "true", ITYPE: "fake-it-3", CT: "on-demand",
           ZONE: "test-zone-1"}
    lab.update(labels or {})
    node = m.t.make_node(name=name, labels=lab, capacity={"cpu": cpu, "memory": "8Gi",
                                                          "pods": "40"}, ready=ready, **kw)
    node.metadata.uid = f"uid-node-{name}"
    node.metadata.creation_timestamp = T0 - 100
    return node


def _pod(m, name, node_name="", phase="Running", **kw):
    p = m.t.make_pod(name=name, node_name=node_name, unschedulable=not node_name, **kw)
    p.metadata.uid = f"uid-{name}"
    p.metadata.creation_timestamp = 1000.0
    p.status.phase = phase
    return p


def _err(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class is what is compared
        return type(e).__name__
    return None


# -- the kube client -----------------------------------------------------------

def test_client_finalizer_delete_and_finalize_match_reference():
    def run(m):
        c = m.client.InMemoryKubeClient()
        q = c.watch("Node", backlog=False)
        node = _node(m, "n-1")
        node.metadata.finalizers = [FINALIZER]
        c.create(node)
        c.create(_node(m, "n-2"))
        c.delete("Node", "", "n-1")
        c.delete("Node", "", "n-1")  # still terminating: no second event
        terminating = c.get("Node", "", "n-1")
        c.delete("Node", "", "n-2")  # no finalizer: gone at once
        terminating.metadata.finalizers = []
        c.finalize(terminating)
        gone = c.get("Node", "", "n-1") is None
        return [_events(q), gone, terminating.metadata.deletion_timestamp is not None,
                _err(lambda: c.delete("Node", "", "n-1")),
                _err(lambda: c.finalize(terminating))]

    out = both(run)
    assert [e[0] for e in out[0]] == ["ADDED", "ADDED", "MODIFIED", "DELETED", "DELETED"]
    assert out[1:] == [True, True, "NotFoundError", "NotFoundError"]


def test_client_finalize_without_deletion_keeps_the_object():
    def run(m):
        c = m.client.InMemoryKubeClient()
        q = c.watch("Node", backlog=False)
        node = _node(m, "n-1")
        node.metadata.finalizers = [FINALIZER, "other"]
        c.create(node)
        node.metadata.finalizers = ["other"]
        c.finalize(node)
        kept = c.get("Node", "", "n-1")
        return [_events(q), kept.metadata.finalizers, node.metadata.resource_version]

    out = both(run)
    assert out[1] == ["other"]


def test_client_apply_update_status_and_conflict_match_reference():
    def run(m):
        c = m.client.InMemoryKubeClient()
        q = c.watch("Machine", backlog=False)
        machine = m.t.make_machine(name="m-1", capacity={"cpu": "2"})
        applied = c.apply(machine)  # create
        machine.metadata.labels["a"] = "b"
        machine.status.provider_id = "fake:///m-1"
        c.apply(machine)  # update: the status is the stored one
        after_update = c.get("Machine", "", "m-1")
        machine.spec.taints = [m.o.Taint(key="ignored")]
        c.update_status(machine)  # the status alone
        after_status = c.get("Machine", "", "m-1")
        stale = applied.metadata.resource_version
        conflict = _err(lambda: c.compare_and_update(machine, stale))
        ok = c.compare_and_update(after_status, after_status.metadata.resource_version)
        missing = _err(lambda: c.update_status(m.t.make_machine(name="ghost")))
        return [_events(q), after_update.metadata.labels, after_update.status.provider_id,
                after_status.status.provider_id, len(after_status.spec.taints),
                conflict, ok.metadata.resource_version, missing,
                machine.metadata.resource_version]

    out = both(run)
    assert out[2:] == ["", "fake:///m-1", 0, "ConflictError", 4, "NotFoundError", 3]


def test_client_evict_under_budgets_matches_reference():
    def run(m):
        c = m.client.InMemoryKubeClient()
        q = c.watch("Pod", backlog=False)
        for i, app in enumerate(["guarded", "guarded", "open", "twice"]):
            c.create(_pod(m, f"p-{i}", node_name="n", labels={"app": app, "x": "y"}))
        for name, labels, allowed in (("guard", {"app": "guarded"}, 1),
                                      ("t-1", {"app": "twice"}, 5),
                                      ("t-2", {"x": "y", "app": "twice"}, 5)):
            pdb = m.o.PodDisruptionBudget(
                spec=m.o.PodDisruptionBudgetSpec(
                    selector=m.o.LabelSelector(match_labels=labels)),
                status=m.o.PodDisruptionBudgetStatus(disruptions_allowed=allowed))
            pdb.metadata.name, pdb.metadata.namespace = name, "default"
            c.create(pdb)
        results = [_err(lambda n=n: c.evict("default", n))
                   for n in ("p-0", "p-1", "p-2", "p-3", "gone")]
        left = [p.metadata.name for p in c.list("Pod")]
        by_node = [p.metadata.name for p in c.list("Pod", copy_objects=False)
                   if p.spec.node_name == "n"]
        budget = c.get("PodDisruptionBudget", "default", "guard").status.disruptions_allowed
        return [results, left, by_node, budget, _events(q)]

    out = both(run)
    assert out[0] == [None, "EvictionBlockedError", None, "EvictionBlockedError", None]
    assert out[1] == ["p-1", "p-3"] and out[3] == 0


def test_pods_by_node_index_matches_a_filter():
    """The port's index of pods by node gives what a filter over every pod
    gives, in creation order, through binds, rebinds and deletes."""
    m = _lm("torch")
    c = m.client.InMemoryKubeClient()
    for i in range(12):
        c.create(_pod(m, f"p-{i}", node_name=f"n-{i % 3}" if i % 4 else ""))
    moved = c.get("Pod", "default", "p-5")
    moved.spec.node_name = "n-0"
    c.update(moved)
    c.delete("Pod", "default", "p-2")
    c.create(_pod(m, "p-2", node_name="n-2"))
    bound = c.get("Pod", "default", "p-0")
    bound.spec.node_name = "n-1"
    c.update_status(bound)  # a status write leaves the binding as stored
    for node in ("n-0", "n-1", "n-2", "n-9", ""):
        want = [p.metadata.name for p in c.list(
            "Pod", field_filter=lambda p, n=node: p.spec.node_name == n)]
        if node:
            got = [p.metadata.name for p in c.list("Pod", node_name=node)]
            assert got == want, node
    assert [p.metadata.name for p in c.list("Pod", node_name="n-2")] == ["p-11", "p-2"]


# -- the fake cloud provider -----------------------------------------------------

CREATE_CASES = {
    "cheapest": [],
    "types": [(ITYPE, "In", ["fake-it-2", "fake-it-4"])],
    "spot_zone_2": [(CT, "In", ["spot"]), (ZONE, "In", ["test-zone-2"])],
    "zone_3_on_demand": [(ZONE, "In", ["test-zone-3"])],
    "incompatible": [(ITYPE, "In", ["no-such-type"])],
}


@pytest.mark.parametrize("case", sorted(CREATE_CASES))
def test_fake_create_matches_reference(case):
    def run(m):
        cp = m.fake.FakeCloudProvider(m.fake.instance_types(6))
        reqs = [m.o.NodeSelectorRequirement(k, op, v) for k, op, v in CREATE_CASES[case]]
        machine = m.t.make_machine(name="req", requirements=reqs)
        machine.spec.resources.requests = {"cpu": 1.5}
        try:
            created = cp.create(machine)
        except Exception as e:  # noqa: BLE001
            return [type(e).__name__, len(cp.create_calls)]
        got = cp.get("req")
        return [_canon(created.metadata.name), created.metadata.labels,
                _canon(created.status.provider_id), created.status.capacity,
                created.status.allocatable, _canon(got.metadata.name),
                _err(lambda: cp.get("other")), _err(lambda: cp.delete(got)),
                _err(lambda: cp.delete(machine)), len(cp.create_calls)]

    both(run)


def test_fake_create_limits_errors_and_exhausted_pools_match_reference():
    def run(m):
        cp = m.fake.FakeCloudProvider(m.fake.instance_types(3))
        out = []

        def create(name, *reqs):
            machine = m.t.make_machine(name=name, requirements=[
                m.o.NodeSelectorRequirement(k, op, v) for k, op, v in reqs])
            try:
                c = cp.create(machine)
                out.append((c.metadata.labels[ITYPE], c.metadata.labels[ZONE],
                            c.metadata.labels[CT]))
            except Exception as e:  # noqa: BLE001
                out.append((type(e).__name__, getattr(e, "instance_type", None),
                            getattr(e, "zone", None), getattr(e, "capacity_type", None)))

        cp.insufficient_capacity = {("fake-it-0", "test-zone-1", "spot")}
        create("a")  # falls through to the next offering of fake-it-0
        create("b", (ZONE, "In", ["test-zone-1"]), (CT, "In", ["spot"]))
        cp.insufficient_capacity = {("fake-it-0", "", "")}
        create("c", (ITYPE, "In", ["fake-it-0"]))  # every pool: type-level
        cp.insufficient_capacity = set()
        cp.next_create_err = RuntimeError("boom")
        create("d")
        create("e")  # the error was used up
        cp.allowed_create_calls = len(cp.create_calls)
        create("f")
        cp.reset()
        create("g")
        cp.drifted = True
        out.append(cp.is_machine_drifted(m.t.make_machine(name="g")))
        out.append(len(cp.create_calls))
        return out

    out = both(run)
    assert out[1][0] == "InsufficientCapacityError" and out[2][1] == "fake-it-0"
    assert out[3][0] == "RuntimeError" and out[5][0] == "InsufficientCapacityError"


# -- StateNode over a node, a Machine, or both ---------------------------------------

def _view(sn):
    return [_canon(sn.name()), _canon(sn.provider_id()), sorted(sn.labels().items()),
            sorted(sn.annotations().items()), sorted((t.key, t.value, t.effect)
                                                     for t in sn.taints()),
            sn.capacity(), sn.allocatable(), sn.initialized(), sn.owned(),
            sn.is_marked_for_deletion(), _canon(sn.hostname()), sn.available()]


def _machine(m, name="repl-1", initialized=False, registered=False, it="fake-it-4",
             zone="test-zone-2", startup=False, taints=True):
    cap = {"cpu": "5", "memory": "10Gi", "pods": "50"}
    machine = m.t.make_machine(
        name=name, provider_id=f"fake:///{name}",
        labels={PROV: "default", ITYPE: it, ZONE: zone, CT: "on-demand"},
        capacity=cap, allocatable={"cpu": "4.9", "memory": "9Gi", "pods": "50"},
        launched=True, registered=registered, initialized=initialized)
    machine.metadata.annotations["note"] = "machine"
    if taints:
        machine.spec.taints = [m.o.Taint(key="dedicated", value="x")]
    if startup:
        machine.spec.startup_taints = [m.o.Taint(key="startup", effect="NoSchedule")]
    machine.metadata.creation_timestamp = T0 - 50
    return machine


def _registered_node(m, name="repl-1", ready=False, initialized=False, taints=True):
    node = _node(m, name, cpu="0", labels={ITYPE: "fake-it-4", ZONE: "test-zone-2"},
                 ready=ready, provider_id=f"fake:///{name}")
    node.status.capacity = {"cpu": 0.0, "memory": 2.0 ** 33}
    node.status.allocatable = {}
    node.metadata.annotations["note"] = "node"
    node.spec.taints = [m.o.Taint(key="node.kubernetes.io/not-ready", effect="NoSchedule")]
    if taints:
        node.spec.taints.insert(0, m.o.Taint(key="startup", effect="NoSchedule"))
    if not initialized:
        del node.metadata.labels[INIT]
    return node


STATE_CASES = {
    "node_initialized": lambda m, c: c.update_node(_node(m, "n-1")),
    "node_uninitialized_inflight": lambda m, c: c.update_node(
        _registered_node(m, "n-2", ready=True)),
    "machine_only": lambda m, c: c.update_machine(_machine(m, startup=True)),
    "machine_and_node": lambda m, c: (c.update_machine(_machine(m, startup=True)),
                                      c.update_node(_registered_node(m))),
    "machine_and_node_initialized": lambda m, c: (
        c.update_machine(_machine(m, registered=True, initialized=True)),
        c.update_node(_registered_node(m, ready=True, initialized=True))),
    "machine_deleting": lambda m, c: (
        c.update_machine(_deleting(_machine(m))), c.update_node(_registered_node(m))),
}


def _deleting(machine):
    machine.metadata.deletion_timestamp = T0
    return machine


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_state_node_views_match_reference(case):
    def run(m):
        client = m.client.InMemoryKubeClient()
        cp = m.fake.FakeCloudProvider(m.fake.instance_types(6))
        cluster = m.cluster.Cluster(client, cp, clock=m.t.FakeClock(T0))
        STATE_CASES[case](m, cluster)
        cluster.update_pod(_pod(m, "bound", node_name=cluster.nodes()[0].name(),
                                requests={"cpu": "1"}))
        views = [_view(sn) for sn in cluster.nodes()]
        copies = [_view(sn.deep_copy()) for sn in cluster.nodes()]
        return [views, copies, sorted(cluster.node_name_to_provider_id),
                sorted(cluster.machine_name_to_provider_id)]

    both(run)


# -- the Cluster's machines and the change feed ---------------------------------

def test_cluster_machines_and_change_feed_match_reference():
    def run(m):
        client = m.client.InMemoryKubeClient()
        cluster = m.cluster.Cluster(client, m.fake.FakeCloudProvider(), clock=m.t.FakeClock(T0))
        out = []
        cursor = cluster.revision()

        def mark(label):
            nonlocal cursor
            cursor, changed = cluster.changes_since(cursor)
            out.append((label, cursor, sorted(changed) if changed is not None else None,
                        sorted(sn.name() for sn in cluster.nodes()),
                        cluster.consolidated()))

        cluster.update_node(_node(m, "n-1"))
        mark("node")
        cluster.set_consolidated(True)
        cluster.update_machine(m.t.make_machine(name="no-pid"))
        mark("machine without a provider id")
        cluster.update_machine(_machine(m))
        mark("machine joins")
        cluster.update_node(_registered_node(m))
        mark("its node registers")
        cluster.update_pod(_pod(m, "p", node_name="repl-1", requests={"cpu": "1"}))
        mark("a pod binds")
        cluster.mark_for_deletion("repl-1")
        mark("marked")
        cluster.delete_node("repl-1")
        mark("node gone, machine stays")
        found = cluster.node_for("repl-1")
        out.append(found is not None and found.node is None)
        cluster.delete_machine("repl-1")
        mark("machine gone")
        cluster.delete_machine("repl-1")
        mark("unknown machine")
        cluster.update_machine(_machine(m, name="repl-2"))
        cluster.update_node(_registered_node(m, name="repl-2"))
        cluster.delete_machine("repl-2")
        mark("machine gone, node stays")
        out.append(cluster.node_for("repl-2").machine is None)
        return out

    both(run)


def test_machine_informer_feeds_the_cluster_like_the_reference():
    def run(m):
        client = m.client.InMemoryKubeClient()
        cluster = m.cluster.Cluster(client, clock=m.t.FakeClock(T0))
        q = client.watch("Machine")
        inf = m.informer.MachineInformer(cluster)
        client.create(_machine(m))
        client.create(_machine(m, name="repl-2"))
        client.delete("Machine", "", "repl-1")
        while not q.empty():
            inf.handle(*q.get_nowait())
        return [sorted(cluster.machine_name_to_provider_id), cluster.revision()]

    assert both(run)[0] == ["repl-2"]


# -- the machine, node and termination controllers ---------------------------------

def _conditions(machine):
    return sorted((c.type, c.status, c.reason) for c in machine.status.conditions)


def _node_state(node):
    if node is None:
        return None
    return [_canon(node.metadata.name), sorted(node.metadata.labels.items()),
            sorted((t.key, t.value, t.effect) for t in node.spec.taints),
            list(node.metadata.finalizers), node.spec.unschedulable,
            sorted(node.metadata.annotations.items())]


def _lifecycle(m, clock):
    client = m.client.InMemoryKubeClient()
    cp = m.fake.FakeCloudProvider(m.fake.instance_types(6))
    cluster = m.cluster.Cluster(client, cp, clock=clock)
    queue = m.terminator.EvictionQueue(client)
    terminator = m.terminator.Terminator(client, cp, queue, clock=clock)
    ctrl = m.mc.MachineController(client, cp, cluster, terminator, clock=clock)
    return client, cp, cluster, queue, terminator, ctrl


def test_machine_controller_steps_match_reference():
    def run(m):
        clock = m.t.FakeClock(T0)
        client, cp, cluster, queue, terminator, ctrl = _lifecycle(m, clock)
        client.create(m.t.make_provisioner(name="default"))
        machine = m.t.make_machine(name="launch-me", labels={PROV: "default"}, requirements=[
            m.o.NodeSelectorRequirement(ITYPE, "In", ["fake-it-2"])])
        machine.spec.startup_taints = [m.o.Taint(key="startup", effect="NoSchedule")]
        machine.spec.taints = [m.o.Taint(key="dedicated", value="x")]
        machine.metadata.creation_timestamp = T0
        client.create(machine)
        out = []

        def reconcile(label):
            cur = client.get("Machine", "", "launch-me")
            if cur is None:
                out.append((label, None))
                return
            requeue = ctrl.reconcile(cur)
            cur = client.get("Machine", "", "launch-me")
            nodes = client.list("Node")
            out.append((label, requeue, None if cur is None else _conditions(cur),
                        None if cur is None else _canon(cur.status.provider_id),
                        [_node_state(n) for n in nodes],
                        sorted(_canon(sn.name()) for sn in cluster.nodes())))

        reconcile("launch, no node yet")
        launched = client.get("Machine", "", "launch-me")
        node = m.o.Node()
        node.metadata.name = "registered"
        node.metadata.uid = "uid-registered"
        node.spec.provider_id = launched.status.provider_id
        node.status.conditions = [m.o.Condition(type="Ready", status="False")]
        client.create(node)
        reconcile("registration")
        node = client.get("Node", "", "registered")
        node.status.conditions = [m.o.Condition(type="Ready", status="True")]
        client.update_status(node)
        reconcile("ready, startup taints remain")
        node = client.get("Node", "", "registered")
        node.spec.taints = [t for t in node.spec.taints if t.key != "startup"]
        client.update(node)
        reconcile("extended resources unregistered")
        node = client.get("Node", "", "registered")
        node.status.allocatable = dict(launched.status.allocatable)
        client.update_status(node)
        reconcile("initialized")
        reconcile("steady")
        # finalize: the node holds an evictable pod; the machine carries the
        # finalizer, so its deletion drains first
        client.create(_pod(m, "work", node_name="registered", requests={"cpu": "0.5"}))
        cur = client.get("Machine", "", "launch-me")
        cur.metadata.finalizers = [FINALIZER]
        client.update(cur)
        client.delete("Machine", "", "launch-me")
        reconcile("finalize drains")
        queue.drain()
        reconcile("finalize terminates")
        out.append(sorted(p.metadata.name for p in client.list("Pod")))
        return out

    out = both(run)
    assert out[4][2][0] == ("MachineInitialized", "True", "")
    assert out[-2][1] is None and out[-1] == []


def test_machine_liveness_deletes_an_unregistered_machine():
    def run(m):
        m.settings.set_current(m.settings.Settings(ttl_after_not_registered=60.0))
        clock = m.t.FakeClock(T0)
        client, cp, cluster, _q, _t, ctrl = _lifecycle(m, clock)
        machine = m.t.make_machine(name="never", labels={PROV: "default"})
        machine.metadata.creation_timestamp = T0
        client.create(machine)
        first = ctrl.reconcile(client.get("Machine", "", "never"))
        clock.advance(61)
        second = ctrl.reconcile(client.get("Machine", "", "never"))
        return [first, second, client.get("Machine", "", "never") is None]

    assert both(run) == [60.0, None, True]


def test_node_controller_emptiness_finalizer_and_drift_match_reference():
    def run(m):
        clock = m.t.FakeClock(T0)
        client = m.client.InMemoryKubeClient()
        cp = m.fake.FakeCloudProvider(m.fake.instance_types(6))
        cluster = m.cluster.Cluster(client, cp, clock=clock)
        ctrl = m.nc.NodeController(client, cp, cluster, clock=clock)
        client.create(m.t.make_provisioner(name="default", ttl_seconds_after_empty=30))
        client.create(_node(m, "n-1"))
        client.create(_node(m, "raw", ready=True, labels={INIT: "false"}))
        client.create(_node(m, "foreign", labels={PROV: ""}))
        out = []

        def reconcile(label):
            results = [ctrl.reconcile(n) for n in client.list("Node")]
            out.append((label, results, [_node_state(n) for n in client.list("Node")]))

        reconcile("empty: stamped, finalizer added, raw initialized")
        clock.advance(5)
        reconcile("unchanged")
        client.create(_pod(m, "busy", node_name="n-1"))
        client.create(_pod(m, "done", node_name="raw", phase="Succeeded"))
        reconcile("a pod arrives: the stamp goes")
        m.settings.set_current(m.settings.Settings(drift_enabled=True))
        reconcile("drift on, nothing drifted")
        cp.drifted = True
        reconcile("drifted")
        return out

    out = both(run)
    assert out[0][2][1][5] == [("karpenter.sh/emptiness-timestamp", str(T0))]


def test_termination_controller_and_drain_order_match_reference():
    """Terminator.drain: daemonset and node-owned pods stay, a terminal pod
    is skipped, critical pods go only after the rest, a PDB-blocked
    eviction stays queued until its budget allows it, and a do-not-evict
    pod blocks the drain."""
    def run(m):
        clock = m.t.FakeClock(T0)
        client, cp, cluster, queue, terminator, _ctrl = _lifecycle(m, clock)
        term = m.tc.TerminationController(client, terminator, cluster)
        node = _node(m, "n-1")
        node.metadata.finalizers = [FINALIZER]
        client.create(node)
        cluster.update_node(node)
        pods = [
            _pod(m, "daemon", node_name="n-1", owner_kind="DaemonSet"),
            _pod(m, "mirror", node_name="n-1", owner_kind="Node"),
            _pod(m, "finished", node_name="n-1", phase="Succeeded"),
            _pod(m, "critical", node_name="n-1"),
            _pod(m, "web-1", node_name="n-1", labels={"app": "web"}),
            _pod(m, "web-2", node_name="n-1", labels={"app": "web"}),
            _pod(m, "guarded", node_name="n-1", labels={"app": "guarded"}),
        ]
        pods[3].spec.priority_class_name = "system-node-critical"
        for p in pods:
            client.create(p)
        pdb = m.o.PodDisruptionBudget(
            spec=m.o.PodDisruptionBudgetSpec(
                selector=m.o.LabelSelector(match_labels={"app": "guarded"})),
            status=m.o.PodDisruptionBudgetStatus(disruptions_allowed=0))
        pdb.metadata.name, pdb.metadata.namespace = "guard", "default"
        client.create(pdb)
        client.delete("Node", "", "n-1")
        out = []
        for i in range(5):
            current = client.get("Node", "", "n-1")
            requeue = None if current is None else term.reconcile(current)
            queue.drain()
            out.append((requeue, sorted(p.metadata.name for p in client.list("Pod")),
                        _node_state(client.get("Node", "", "n-1")),
                        cluster.node_for("n-1") is not None))
            if i == 1:
                budget = client.get("PodDisruptionBudget", "default", "guard")
                budget.status.disruptions_allowed = 1
                client.update(budget)
        # a do-not-evict pod blocks at once
        blocked = _node(m, "n-2")
        client.create(blocked)
        pin = _pod(m, "pinned", node_name="n-2")
        pin.metadata.annotations["karpenter.sh/do-not-evict"] = "true"
        client.create(pin)
        out.append(_err(lambda: terminator.drain(client.get("Node", "", "n-2"))))
        return out

    out = both(run)
    assert out[0][1] == ["critical", "daemon", "finished", "guarded", "mirror"]
    assert out[2][1] == ["critical", "daemon", "finished", "mirror"]
    assert out[-2][2] is None and out[-1] == "NodeDrainError"


# -- solves after a replacement Machine joins -----------------------------------

def _joined_world(m, variant):
    """A cluster of three initialized nodes with bound pods, a replacement
    that has joined as `variant`, and pending pods."""
    clock = m.t.FakeClock(T0)
    client = m.client.InMemoryKubeClient()
    cp = m.fake.FakeCloudProvider(m.fake.instance_types(6))
    cluster = m.cluster.Cluster(client, cp, clock=clock)
    for e in range(3):
        node = _node(m, f"n-{e}", cpu="3", labels={ZONE: f"test-zone-{1 + e % 3}"})
        client.create(node)
        cluster.update_node(node)
        pod = _pod(m, f"bound-{e}", node_name=node.metadata.name, requests={"cpu": "1"})
        client.create(pod)
        cluster.update_pod(pod)
    if variant in ("machine", "machine_and_node", "initialized"):
        cluster.update_machine(_machine(m, registered=variant != "machine",
                                        initialized=variant == "initialized", taints=False))
    if variant in ("machine_and_node", "initialized", "node_inflight"):
        node = _registered_node(m, ready=variant != "machine_and_node",
                                initialized=variant == "initialized", taints=False)
        if variant == "initialized":
            node.status.capacity = {"cpu": 5.0, "memory": 10 * 2.0 ** 30, "pods": 50.0}
            node.status.allocatable = {"cpu": 4.9, "memory": 9 * 2.0 ** 30, "pods": 50.0}
        cluster.update_node(node)
    pods = [_pod(m, f"pend-{i}", phase="Pending",
                 requests={"cpu": str(0.5 + 0.25 * (i % 3))}) for i in range(9)]
    provs = [m.t.make_provisioner(name="default")]
    return pods, provs, {"default": cp.get_instance_types(None)}, client, cluster


@pytest.mark.parametrize("variant", ["machine", "machine_and_node", "initialized",
                                     "node_inflight"])
def test_solve_after_a_replacement_joins_matches_reference(variant):
    j = _joined_world(_lm("jax"), variant)
    t = _joined_world(_lm("torch"), variant)
    js = jencode.encode_snapshot(j[0], j[1], j[2], None, j[4].nodes(), kube_client=j[3],
                                 cluster=j[4], max_nodes=64)
    ts = tencode.encode_snapshot(t[0], t[1], t[2], None, t[4].nodes(), t[3], t[4],
                                 max_nodes=64)
    assert len(ts.state_nodes) == 4
    _assert_tree_equal(dict(zip(jsolver.RUN_ARG_NAMES, jsolver.device_args(js, j[1]))),
                       dict(zip(tsolver.RUN_ARG_NAMES, tsolver.device_args(ts, t[1]))))
    want = jsolver.TPUSolver(max_nodes=64, backend="mxu", incremental="off").solve(
        copy.deepcopy(j[0]), j[1], j[2], state_nodes=j[4].nodes(), kube_client=j[3],
        cluster=j[4])
    got = tsolver.TorchSolver(max_nodes=64, device="cpu", incremental="off").solve(
        copy.deepcopy(t[0]), t[1], t[2], state_nodes=t[4].nodes(), kube_client=t[3],
        cluster=t[4])
    assert placements_json(canonical_placements(got)) == placements_json(
        canonical_placements(want))
    assert got.pod_count_existing() == want.pod_count_existing() > 0
    if variant != "none":
        assert any(sn.provider_id() == "fake:///repl-1" and placed
                   for sn, placed in got.existing_assignments), "the replacement took no pod"


def test_incremental_solves_across_a_machine_joining_match_reference():
    """A replacement Machine joins between two incremental solves, its Node
    registers and initializes, then it goes: at every solve the port's
    incremental solver places exactly as its full solver and as the
    reference's incremental solver, and its prescreen modes are the
    reference's."""
    out = {}
    for pkg in ("jax", "torch"):
        m = _lm(pkg)
        pods, provs, its, client, cluster = _joined_world(m, "none")
        if pkg == "jax":
            solvers = [jsolver.TPUSolver(max_nodes=64, backend="mxu", incremental="on")]
        else:
            solvers = [tsolver.TorchSolver(max_nodes=64, device="cpu"),
                       tsolver.TorchSolver(max_nodes=64, device="cpu", incremental="off")]
        placements, modes = [], []

        def solve(batch):
            row = []
            for k, solver in enumerate(solvers):
                res = solver.solve(copy.deepcopy(batch), provs, its,
                                   state_nodes=cluster.nodes(), kube_client=client,
                                   cluster=cluster if k == 0 else None)
                row.append(placements_json(canonical_placements(res)))
            placements.append(row)
            modes.append(solvers[0].last_prescreen_mode)

        solve(pods[:5])
        cluster.update_machine(_machine(m, taints=False))
        solve(pods[3:])
        cluster.update_node(_registered_node(m, ready=True, taints=False))
        solve(pods)
        cluster.update_machine(_machine(m, registered=True, initialized=True, taints=False))
        solve(pods[:6])
        cluster.delete_node("repl-1")
        cluster.delete_machine("repl-1")
        solve(pods[2:])
        out[pkg] = (placements, modes)
    (j_place, j_modes), (t_place, t_modes) = out["jax"], out["torch"]
    for k, (jrow, trow) in enumerate(zip(j_place, t_place)):
        assert trow[0] == trow[1], f"incremental and full differ at solve {k}"
        assert trow[0] == jrow[0], f"the port and the reference differ at solve {k}"
    assert t_modes == j_modes
    assert t_modes[0] == "full", t_modes
    assert "refresh" in t_modes, t_modes
