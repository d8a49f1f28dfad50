"""The deprovisioning chain of the PyTorch port against the JAX reference,
on the CPU, on the cases of tests/test_deprovisioning.py and
tests/test_expiration_drift_suite.py.

The reference side is a full operator (new_operator with a
TPUSolver(backend="mxu")), stepped without its provisioning reconcile;
the port side is testing.ControlLoop with a TorchSolver(device="cpu").
Both build the same world (names, uids and creation times pinned) on a
FakeClock with validation_ttl = 0. Each reconcile of the chain must pick
the same deprovisioner and the same Command (action, removed nodes, the
replacements' instance-type options and requirements); after the same
steps the nodes, machines, pods, cordons, deletion marks and the
consolidated bit must agree. Launched machines are named fake-machine-N
from each package's own counter, so a replacement is compared by what it
is (instance type, zone, capacity type), not by its name."""
import time

import pytest

from karpenter_core_tpu import testing as jt
from karpenter_core_tpu.api import settings as jsettings
from karpenter_core_tpu.cloudprovider import fake as jfake
from karpenter_core_tpu.cloudprovider.types import Offering as JOffering
from karpenter_core_tpu.kube import objects as jobj
from karpenter_core_tpu.operator import new_operator
from karpenter_core_tpu.solver.tpu_solver import TPUSolver
from karpenter_core_tpu_torch import testing as tt
from karpenter_core_tpu_torch.api import settings as tsettings
from karpenter_core_tpu_torch.cloudprovider import fake as tfake
from karpenter_core_tpu_torch.cloudprovider.types import Offering as TOffering
from karpenter_core_tpu_torch.controllers.deprovisioning import consolidation as tcons
from karpenter_core_tpu_torch.kube.client import InMemoryKubeClient
from karpenter_core_tpu_torch.kube import objects as tobj
from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

PROV = "karpenter.sh/provisioner-name"
INIT = "karpenter.sh/initialized"
CT = "karpenter.sh/capacity-type"
ZONE = "topology.kubernetes.io/zone"
ITYPE = "node.kubernetes.io/instance-type"
DRIFT_KEY = "karpenter.sh/voluntary-disruption"
T0 = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _reset_settings():
    yield
    jsettings.set_current(jsettings.Settings())
    tsettings.set_current(tsettings.Settings())


@pytest.fixture(autouse=True)
def _no_fallbacks():
    tcons.reset_fallbacks()
    yield
    assert tcons.FALLBACKS == {"multi": 0, "single": 0}


def _requirements_key(reqs):
    return sorted((k, r.operator(), r.values_list(), r.greater_than, r.less_than)
                  for k, r in reqs.items())


def command_key(deprovisioner, cmd):
    repl = [([it.name for it in m.instance_type_options], _requirements_key(m.requirements))
            for m in cmd.replacement_machines]
    return (str(deprovisioner), cmd.action, [n.metadata.name for n in cmd.nodes_to_remove],
            repl)


def _canon(name):
    return "<launched>" if name.startswith("fake-machine-") else name


class _Env:
    """What both sides share: the builders over the package's own modules,
    the trace of every reconcile's Command, and the state readers."""

    def _capture(self, ctrl):
        real = ctrl.execute_command

        def execute(dep, cmd):
            self.commands.append(command_key(dep, cmd))
            return real(dep, cmd)

        ctrl.execute_command = execute

    def reconcile(self):
        self.commands.clear()
        acted = self.deprovisioning.reconcile()
        return acted, list(self.commands)

    def settings(self, **kw):
        self.m.settings.set_current(self.m.settings.Settings(**kw))

    def state(self, consolidated=True):
        """The nodes, machines and pods of the store, the cordons, the
        deletion marks and (read where both sides last touched the cluster
        alike: the reference's sync relists every object, which clears the
        bit, where a watch delivers only changes) the consolidated bit."""
        nodes = sorted(
            (_canon(n.metadata.name), n.metadata.labels.get(ITYPE), n.metadata.labels.get(ZONE),
             n.metadata.labels.get(CT), n.spec.unschedulable,
             n.metadata.deletion_timestamp is not None, n.metadata.labels.get(INIT))
            for n in self.client.list("Node"))
        machines = sorted(
            (m.metadata.labels.get(ITYPE), m.metadata.labels.get(ZONE), m.metadata.labels.get(CT),
             tuple(sorted((c.type, c.status) for c in m.status.conditions)))
            for m in self.client.list("Machine"))
        pods = sorted((p.metadata.name, _canon(p.spec.node_name))
                      for p in self.client.list("Pod"))
        marks = sorted((_canon(n.name()), n.is_marked_for_deletion(), n.initialized())
                       for n in self.cluster.nodes())
        out = {"nodes": nodes, "machines": machines, "pods": pods, "marks": marks}
        if consolidated:
            out["consolidated"] = self.cluster.consolidated()
        return out

    # -- the world --------------------------------------------------------------

    def provisioner(self, name="default", **kw):
        self.client.create(self.m.t.make_provisioner(name=name, **kw))

    def add_node(self, name, it_name="fake-it-9", cpu="10", ct="on-demand", pods=1,
                 pod_labels=None, pod_annotations=None, initialized=True, annotations=None,
                 created_at=None, zone="test-zone-1", pod_requests=None, pod_owner_kind="",
                 prov="default"):
        t = self.m.t
        labels = {PROV: prov, INIT: "true", ITYPE: it_name, CT: ct, ZONE: zone}
        if not initialized:
            del labels[INIT]
        node = t.make_node(name=name, labels=labels,
                           capacity={"cpu": cpu, "memory": "20Gi", "pods": "100"})
        node.metadata.annotations.update(annotations or {})
        node.metadata.creation_timestamp = created_at if created_at is not None else self.clock()
        node.metadata.uid = f"uid-node-{name}"
        self.client.create(node)
        for i in range(pods):
            pod = t.make_pod(name=f"{name}-p{i}", requests=pod_requests or {"cpu": "1"},
                             node_name=name, unschedulable=False, labels=pod_labels,
                             owner_kind=pod_owner_kind)
            pod.metadata.annotations.update(pod_annotations or {})
            pod.metadata.uid = f"uid-{name}-{i}"
            pod.metadata.creation_timestamp = 1000.0 + i
            pod.status.phase = "Running"
            self.client.create(pod)

    def add_daemon_pod(self, node_name):
        pod = self.m.t.make_pod(name=f"{node_name}-daemon", requests={"cpu": "0.1"},
                                node_name=node_name, unschedulable=False,
                                owner_kind="DaemonSet")
        pod.metadata.uid = f"uid-{node_name}-daemon"
        pod.metadata.creation_timestamp = 1000.0
        pod.status.phase = "Running"
        self.client.create(pod)

    def add_pdb(self, labels, name="guard"):
        o = self.m.o
        pdb = o.PodDisruptionBudget(
            spec=o.PodDisruptionBudgetSpec(selector=o.LabelSelector(match_labels=dict(labels))),
            status=o.PodDisruptionBudgetStatus(disruptions_allowed=0))
        pdb.metadata.name, pdb.metadata.namespace = name, "default"
        self.client.create(pdb)

    def keeper(self):
        """A node of a second provisioner without consolidation: room for
        displaced pods that is never a candidate."""
        t = self.m.t
        self.provisioner(name="static")
        node = t.make_node(name="keeper", labels={PROV: "static", INIT: "true"},
                           capacity={"cpu": "10", "memory": "20Gi", "pods": "100"})
        node.metadata.uid = "uid-node-keeper"
        node.metadata.creation_timestamp = self.clock()
        self.client.create(node)

    def custom_replacement_universe(self):
        """expiration_test.go:198-225: the node's own type has no available
        offering; the only buyable type holds one 2-cpu pod."""
        f, offering = self.m.fake, self.m.offering
        current = f.new_instance_type("current-on-demand", offerings=[
            offering("on-demand", "test-zone-1a", 0.5, available=False)])
        replacement = f.new_instance_type("replacement-on-demand", resources={"cpu": 3.0},
                                          offerings=[offering("on-demand", "test-zone-1a", 0.3)])
        self.cp.instance_types = [current, replacement]
        return current.name


class RefEnv(_Env):
    def __init__(self, max_nodes=64, clock=None, readiness_wait=None):
        self.m = _mods(jt, jobj, jsettings, jfake, JOffering)
        self.clock = clock if clock is not None else jt.FakeClock(T0)
        self.cp = jfake.FakeCloudProvider(jfake.instance_types(10))
        self.op = new_operator(self.cp, settings=jsettings.Settings(),
                               solver=TPUSolver(max_nodes=max_nodes, backend="mxu"),
                               clock=self.clock)
        self.deprovisioning = self.op.deprovisioning
        for d in self.deprovisioning.deprovisioners:
            d.validation_ttl = 0.0
        if readiness_wait is not None:
            self.deprovisioning.readiness_wait = readiness_wait
            self.deprovisioning.readiness_poll = readiness_wait / 5
        self.client, self.cluster = self.op.kube_client, self.op.cluster
        self.commands = []
        self._capture(self.deprovisioning)

    def sync(self):
        self.op.sync_state()

    def step(self):
        self.op.step(provision=False)


class PortEnv(_Env):
    def __init__(self, max_nodes=64, clock=None, readiness_wait=None):
        self.m = _mods(tt, tobj, tsettings, tfake, TOffering)
        self.clock = clock if clock is not None else tt.FakeClock(T0)
        self.cp = tfake.FakeCloudProvider(tfake.instance_types(10))
        self.client = InMemoryKubeClient()
        self.loop = tt.ControlLoop(self.client, self.cp,
                                   TorchSolver(max_nodes=max_nodes, device="cpu"),
                                   clock=self.clock, validation_ttl=0.0)
        self.deprovisioning = self.loop.deprovisioning
        if readiness_wait is not None:
            self.deprovisioning.readiness_wait = readiness_wait
            self.deprovisioning.readiness_poll = readiness_wait / 5
        self.cluster = self.loop.cluster
        self.commands = []
        self._capture(self.deprovisioning)

    def sync(self):
        self.loop.sync()

    def step(self):
        self.loop.step()


def _mods(t, o, settings, fake, offering):
    from types import SimpleNamespace

    return SimpleNamespace(t=t, o=o, settings=settings, fake=fake, offering=offering)


def run_both(script, **kw):
    """Run `script(env)` on both sides; it returns its observations
    (reconcile results, states). They must be equal; returns the port's."""
    out = []
    for env in (RefEnv(**kw), PortEnv(**kw)):
        out.append(script(env))
    assert out[1] == out[0]
    return out[1]


def _names(env):
    return {n.metadata.name for n in env.client.list("Node")}


def _cordoned(env, name):
    node = env.client.get("Node", "", name)
    return node is not None and node.spec.unschedulable


# -- the cases: (setup, clock advance before the reconcile, steps after) ------
# Each builds the world, syncs, optionally advances the clock, runs one
# reconcile and then `steps` lifecycle steps; `check` holds the port's own
# observations to what the reference's suite asserts.

def _gating_uninitialized(env):
    env.provisioner(consolidation_enabled=True)
    env.add_node("raw", initialized=False, pods=0)


def _gating_no_provisioner_label(env):
    env.provisioner(consolidation_enabled=True)
    node = env.m.t.make_node(name="foreign", capacity={"cpu": "4", "pods": "10"})
    node.metadata.uid = "uid-node-foreign"
    node.metadata.creation_timestamp = env.clock()
    env.client.create(node)


def _gating_do_not_consolidate(env):
    env.provisioner(consolidation_enabled=True)
    env.add_node("anno", pods=0,
                 annotations={"karpenter.sh/do-not-consolidate": "true"})


def _consolidation_disabled(env):
    env.provisioner()
    env.add_node("idle", pods=0)


def _empty_nodes(env):
    env.provisioner(consolidation_enabled=True)
    env.add_node("empty-1", pods=0)
    env.add_node("empty-2", pods=0)


def _daemonset_only(env):
    env.provisioner(consolidation_enabled=True)
    env.add_node("daemons-only", pods=0)
    env.add_daemon_pod("daemons-only")


def _expiration_unexpired(env):
    env.provisioner(ttl_seconds_until_expired=3600)
    env.add_node("young", pods=1, pod_labels={"app": "x"})


def _expiration_oldest_first(env):
    env.provisioner(ttl_seconds_until_expired=3600)
    env.add_node("older", pods=1, created_at=env.clock() - 8000)
    env.add_node("newer", pods=1, created_at=env.clock() - 7000)


def _drift_gate_off(env):
    env.settings(drift_enabled=False)
    env.provisioner()
    env.add_node("drifted", pods=0, annotations={DRIFT_KEY: "drifted"})


def _drift_delete(env):
    env.settings(drift_enabled=True)
    env.provisioner()
    env.add_node("drifted", pods=0, annotations={DRIFT_KEY: "drifted"})


def _pdb_blocks(env):
    env.provisioner(consolidation_enabled=True)
    env.add_node("guarded", pods=1, pod_labels={"app": "guarded"})
    env.add_pdb({"app": "guarded"})


def _do_not_evict(env):
    env.provisioner(consolidation_enabled=True)
    env.add_node("pinned", pods=1, pod_annotations={"karpenter.sh/do-not-evict": "true"})


def _spot_to_spot(env):
    env.provisioner(consolidation_enabled=True)
    env.add_node("spot-big", ct="spot", pods=1)


def _multi_merges(env):
    env.provisioner(consolidation_enabled=True)
    env.add_node("big-1", it_name="fake-it-9", cpu="10", pods=1)
    env.add_node("big-2", it_name="fake-it-4", cpu="5", pods=1)


def _single_deletes(env):
    env.provisioner(consolidation_enabled=True)
    env.keeper()
    env.add_node("redundant", it_name="fake-it-4", cpu="5", pods=1)


def _launch_failure(env):
    env.provisioner(ttl_seconds_until_expired=3600)
    env.add_node("expired", pods=1, created_at=env.clock() - 8000)
    env.cp.next_create_err = RuntimeError("no capacity")


# expiration_test.go and drift_test.go (nodes own their pods through a
# ReplicaSet, as those suites' pods do)
RS = dict(pod_owner_kind="ReplicaSet")
DRIFTED = {DRIFT_KEY: "drifted"}


def _exp_no_ttl(env):
    env.provisioner()
    env.add_node("ageless", pods=0, **RS)


def _exp_delete(env):
    env.provisioner(ttl_seconds_until_expired=60)
    env.add_node("expired", pods=0, **RS)


def _exp_one_at_a_time(env):
    env.provisioner(ttl_seconds_until_expired=100)
    env.provisioner(name="slow-expiry", ttl_seconds_until_expired=500)
    env.add_node("to-expire", pods=0, **RS)
    env.add_node("not-to-expire", pods=0, prov="slow-expiry", **RS)


def _exp_replace(env):
    env.provisioner(ttl_seconds_until_expired=30)
    env.add_node("replaced", pods=1, **RS)


def _exp_partial_failure(env):
    current = env.custom_replacement_universe()
    env.cp.allowed_create_calls = 2
    env.provisioner(ttl_seconds_until_expired=30)
    env.add_node("kept", it_name=current, cpu="7", zone="test-zone-1a", pods=3,
                 pod_requests={"cpu": "2"}, **RS)


def _exp_multiple(env):
    current = env.custom_replacement_universe()
    env.provisioner(ttl_seconds_until_expired=200)
    env.add_node("fan-out", it_name=current, cpu="8", zone="test-zone-1a", pods=3,
                 pod_requests={"cpu": "2"}, **RS)


def _drift_gate_disabled(env):
    env.settings(drift_enabled=False)
    env.provisioner()
    env.add_node("gated", pods=0, annotations=dict(DRIFTED), **RS)


def _drift_wrong_value(env):
    env.settings(drift_enabled=True)
    env.provisioner()
    env.add_node("mislabeled", pods=0, annotations={DRIFT_KEY: "wrong-value"}, **RS)


def _drift_unannotated(env):
    env.settings(drift_enabled=True)
    env.provisioner()
    env.add_node("undrifted", pods=0, **RS)


def _drift_delete_suite(env):
    env.settings(drift_enabled=True)
    env.provisioner()
    env.add_node("drifted", pods=0, annotations=dict(DRIFTED), **RS)


def _drift_replace(env):
    env.settings(drift_enabled=True)
    env.provisioner()
    env.add_node("drift-replace", pods=1, annotations=dict(DRIFTED), **RS)


def _drift_multiple(env):
    env.settings(drift_enabled=True)
    current = env.custom_replacement_universe()
    env.provisioner()
    env.add_node("drift-fan-out", it_name=current, cpu="8", zone="test-zone-1a", pods=3,
                 pod_requests={"cpu": "2"}, annotations=dict(DRIFTED), **RS)


def _drift_one_at_a_time(env):
    env.settings(drift_enabled=True)
    env.provisioner()
    env.add_node("drift-1", pods=0, annotations=dict(DRIFTED), **RS)
    env.add_node("drift-2", pods=0, annotations=dict(DRIFTED), **RS)


def _gone(*names):
    return lambda env, acted: acted and not (_names(env) & set(names))


def _kept(*names):
    return lambda env, acted: not acted and set(names) <= _names(env)


def _n_creates(n, *gone):
    return lambda env, acted: (acted and len(env.cp.create_calls) == n
                               and not (_names(env) & set(gone)))


CASES = {
    # tests/test_deprovisioning.py
    "uninitialized_not_candidate": (_gating_uninitialized, 0, 0, _kept("raw")),
    "no_provisioner_label": (_gating_no_provisioner_label, 0, 0, _kept("foreign")),
    "do_not_consolidate": (_gating_do_not_consolidate, 0, 0, _kept("anno")),
    "consolidation_disabled": (_consolidation_disabled, 0, 0, _kept("idle")),
    "empty_node_consolidation": (_empty_nodes, 0, 1, _gone("empty-1", "empty-2")),
    "daemonset_pods_emptiness": (_daemonset_only, 0, 1, _gone("daemons-only")),
    "expiration_ignores_unexpired": (_expiration_unexpired, 0, 0, _kept("young")),
    "expiration_oldest_first": (_expiration_oldest_first, 0, 1,
                                lambda env, acted: acted and _names(env) == {"newer"}),
    "drift_requires_gate": (_drift_gate_off, 0, 0, _kept("drifted")),
    "drift_deletes_when_enabled": (_drift_delete, 0, 1, _gone("drifted")),
    "pdb_blocks": (_pdb_blocks, 0, 0, _kept("guarded")),
    "do_not_evict_blocks": (_do_not_evict, 0, 0, _kept("pinned")),
    "spot_to_spot_forbidden": (_spot_to_spot, 0, 0, _kept("spot-big")),
    "multi_node_merges": (_multi_merges, 0, 3,
                          lambda env, acted: acted and len(_names(env)) == 1
                          and not (_names(env) & {"big-1", "big-2"})),
    "single_node_deletes": (_single_deletes, 0, 1,
                            lambda env, acted: acted and _names(env) == {"keeper"}),
    "launch_failure_rolls_back_cordon": (
        _launch_failure, 0, 0,
        lambda env, acted: acted and "expired" in _names(env)
        and not _cordoned(env, "expired")),
    # tests/test_expiration_drift_suite.py
    "exp_ignores_without_ttl": (_exp_no_ttl, 600, 0, _kept("ageless")),
    "exp_deletes_expired": (_exp_delete, 600, 1, _n_creates(0, "expired")),
    "exp_one_at_a_time_most_expired_first": (
        _exp_one_at_a_time, 600, 1,
        lambda env, acted: acted and not env.cp.create_calls
        and "to-expire" not in _names(env) and "not-to-expire" in _names(env)),
    "exp_replaces": (_exp_replace, 600, 3, _n_creates(1, "replaced")),
    "exp_partial_failure_uncordons": (
        _exp_partial_failure, 600, 0,
        lambda env, acted: len(env.cp.create_calls) == 3 and "kept" in _names(env)
        and not _cordoned(env, "kept")),
    "exp_replaces_with_multiple": (_exp_multiple, 600, 3, _n_creates(3, "fan-out")),
    "drift_ignored_gate_disabled": (_drift_gate_disabled, 600, 0, _kept("gated")),
    "drift_ignores_wrong_value": (_drift_wrong_value, 600, 0, _kept("mislabeled")),
    "drift_ignores_unannotated": (_drift_unannotated, 600, 0, _kept("undrifted")),
    "drift_deletes": (_drift_delete_suite, 600, 1, _n_creates(0, "drifted")),
    "drift_replaces": (_drift_replace, 600, 3, _n_creates(1, "drift-replace")),
    "drift_replaces_with_multiple": (_drift_multiple, 600, 3, _n_creates(3, "drift-fan-out")),
    "drift_one_at_a_time": (
        _drift_one_at_a_time, 600, 1,
        lambda env, acted: acted and not env.cp.create_calls
        and len(_names(env) & {"drift-1", "drift-2"}) == 1),
}


def _drained(check, *names):
    """The check, and no pod is left on the removed nodes: they carried the
    termination finalizer, so their deletion drained them."""
    return lambda env, acted: check(env, acted) and not any(
        p.spec.node_name in names for p in env.client.list("Pod"))


# the same cases with one lifecycle step before the reconcile: the node
# controller gives every node the termination finalizer, so the deletion
# goes through the termination controller's cordon, drain (evictions) and
# termination
DRAINED = {
    "empty_node_consolidation": ("empty-1", "empty-2"),
    "expiration_oldest_first": ("older",),
    "multi_node_merges": ("big-1", "big-2"),
    "single_node_deletes": ("redundant",),
    "exp_replaces": ("replaced",),
    "exp_replaces_with_multiple": ("fan-out",),
    "drift_replaces": ("drift-replace",),
}


def _mark_ready(env):
    """Play the kubelet: every launched node reports Ready with its
    machine's capacity, so that the machine controller initializes it."""
    for node in env.client.list("Node"):
        if node.metadata.name.startswith("fake-machine-") and not node.ready():
            machine = env.client.get("Machine", "", node.metadata.name)
            node.status.capacity = dict(machine.status.capacity)
            node.status.allocatable = dict(machine.status.allocatable)
            node.status.conditions = [env.m.o.Condition(type="Ready", status="True")]
            env.client.update_status(node)


@pytest.mark.parametrize("case", list(CASES) + [f"{c}/drained" for c in DRAINED])
def test_chain_matches_reference(case):
    base, _, drained = case.partition("/")
    setup, advance, steps, check = CASES[base]
    if drained:
        # a drain takes one step more: evictions at the end of one, the
        # termination in the next
        check, steps = _drained(check, *DRAINED[base]), steps + 1

    def script(env):
        setup(env)
        env.sync()
        if drained:
            env.step()
        env.clock.advance(advance)
        obs = [env.reconcile(), env.state()]
        for _ in range(steps):
            env.step()
            _mark_ready(env)
        env.sync()
        obs.append(env.state(consolidated=False))
        acted = obs[0][0]
        assert check(env, acted), (case, obs)
        return obs

    run_both(script)


def test_node_controller_annotates_drift_and_drift_replaces_after_it():
    """The node controller annotates a node the provider reports drifted
    (node/drift.go); the Drift deprovisioner then acts on it, and the
    replacement's machine is registered and initialized by the steps."""
    def script(env):
        env.settings(drift_enabled=True)
        env.provisioner()
        env.add_node("n-1", pods=1, **RS)
        env.sync()
        env.step()
        env.sync()
        obs = [env.state(consolidated=False)]
        env.cp.drifted = True
        env.step()
        env.sync()
        annotated = env.client.get("Node", "", "n-1").metadata.annotations.get(DRIFT_KEY)
        obs.append(annotated)
        env.cp.drifted = False
        obs.append(env.reconcile())
        for _ in range(3):
            env.step()
            _mark_ready(env)
        env.sync()
        obs.append(env.state(consolidated=False))
        return obs

    obs = run_both(script)
    assert obs[1] == "drifted"
    assert obs[2][1][0][:2] == ("drift", "replace")
    assert [m[3] for m in obs[3]["machines"]] == [(
        ("MachineInitialized", "True"), ("MachineLaunched", "True"),
        ("MachineRegistered", "True"), ("Ready", "True"))]


def test_expiration_then_consolidation_sequence_matches_reference():
    """Several passes: expiration replaces the oldest node, a step runs the
    replacement through registration and initialization, then
    consolidation acts on what is left; every pass and the final cluster
    agree."""
    def script(env):
        env.provisioner(ttl_seconds_until_expired=3600, consolidation_enabled=True)
        env.add_node("old", pods=2, created_at=env.clock() - 8000, pod_requests={"cpu": "3"},
                     **RS)
        env.add_node("lite-1", it_name="fake-it-9", pods=1, pod_requests={"cpu": "0.5"}, **RS)
        env.add_node("lite-2", it_name="fake-it-8", pods=1, pod_requests={"cpu": "0.5"}, **RS)
        env.sync()
        obs = []
        for _ in range(3):
            obs.append(env.reconcile())
            for _ in range(3):
                env.step()
                _mark_ready(env)
            env.sync()
            obs.append(env.state(consolidated=False))
        return obs

    obs = run_both(script)
    assert obs[0][1][0][0] == "expiration"
    assert any(o[0] for o in obs[2::2])


def test_readiness_timeout_rolls_back_on_wall_clock():
    """On time.time the replace waits for its replacement to initialize;
    none does within readiness_wait, so the cordon and the deletion mark
    are rolled back and the node stays (controller.go:246-251)."""
    def script(env):
        env.provisioner(ttl_seconds_until_expired=3600)
        env.add_node("expired", pods=1, created_at=time.time() - 8000)
        env.sync()
        acted, cmds = env.reconcile()
        env.sync()
        node = env.client.get("Node", "", "expired")
        return [acted, cmds, node is not None, node.spec.unschedulable,
                env.cluster.node_for("expired").is_marked_for_deletion(),
                len(env.cp.create_calls)]

    obs = run_both(script, clock=time.time, readiness_wait=0.05)
    assert obs[0] and obs[1][0][:2] == ("expiration", "replace")
    assert obs[2:] == [True, False, False, 1]
