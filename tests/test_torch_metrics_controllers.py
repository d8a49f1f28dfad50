"""The port's metrics controllers and cloud-provider decorator against the
JAX reference's, on the CPU: the node, pod and provisioner gauges of the
same inputs, the same op.step() sequence through testing/expectations.Env
in both packages, the decorated provider's label sets, and the operator
wiring (the metrics controllers in step(), a decorated provider per
controller, the registry series of the provisioning loop)."""
import threading
from types import SimpleNamespace

import pytest

from karpenter_core_tpu.metrics import registry as jreg
from karpenter_core_tpu_torch.metrics import registry as treg


def _mods(pkg):
    if pkg == "jax":
        from karpenter_core_tpu import testing as t
        from karpenter_core_tpu.api.labels import (
            LABEL_NODE_INITIALIZED,
            PROVISIONER_NAME_LABEL_KEY,
        )
        from karpenter_core_tpu.cloudprovider import fake
        from karpenter_core_tpu.cloudprovider import metrics as cpm
        from karpenter_core_tpu.controllers.metrics import controllers as mc
        from karpenter_core_tpu.controllers.provisioning import provisioner as prov
        from karpenter_core_tpu.kube import objects as o
        from karpenter_core_tpu.kube.client import InMemoryKubeClient
        from karpenter_core_tpu.solver.tpu_solver import TPUSolver
        from karpenter_core_tpu.state.node import StateNode
        from karpenter_core_tpu.testing.expectations import Env

        solver = lambda: TPUSolver(max_nodes=64, backend="mxu", incremental="off")  # noqa: E731
        reg = jreg
    else:
        from karpenter_core_tpu_torch import testing as t
        from karpenter_core_tpu_torch.api.labels import (
            LABEL_NODE_INITIALIZED,
            PROVISIONER_NAME_LABEL_KEY,
        )
        from karpenter_core_tpu_torch.cloudprovider import fake
        from karpenter_core_tpu_torch.cloudprovider import metrics as cpm
        from karpenter_core_tpu_torch.controllers.metrics import controllers as mc
        from karpenter_core_tpu_torch.controllers.provisioning import provisioner as prov
        from karpenter_core_tpu_torch.kube import objects as o
        from karpenter_core_tpu_torch.kube.client import InMemoryKubeClient
        from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver
        from karpenter_core_tpu_torch.state.node import StateNode
        from karpenter_core_tpu_torch.testing.expectations import Env

        solver = lambda: TorchSolver(max_nodes=64, device="cpu", incremental="off")  # noqa: E731
        reg = treg
    return SimpleNamespace(t=t, o=o, fake=fake, cpm=cpm, mc=mc, prov=prov,
                           client=InMemoryKubeClient, StateNode=StateNode, Env=Env,
                           solver=solver, reg=reg,
                           INIT=LABEL_NODE_INITIALIZED, PROV=PROVISIONER_NAME_LABEL_KEY)


def both(script):
    return script(_mods("jax")), script(_mods("torch"))


class _FakeCluster:
    def __init__(self, state_nodes):
        self._nodes = list(state_nodes)

    def nodes(self):
        return list(self._nodes)


def _state_node(m, name, cpu="4", labels=None):
    node = m.t.make_node(name=name, labels={m.PROV: "default", m.INIT: "true",
                                            **(labels or {})},
                         capacity={"cpu": cpu, "memory": "8Gi", "pods": "20"})
    return m.StateNode(node=node)


def _series(gauge, mask=()):
    """A gauge's series as sorted (labels, value) pairs, `mask` labels
    replaced by "*"."""
    out = []
    for lv, v in gauge.values.items():
        labels = tuple((k, "*" if k in mask else val) for k, val in lv)
        out.append((labels, v))
    return sorted(out)


def _node_gauges(ctrl, mask=()):
    return {g.name: _series(g, mask) for g in (
        ctrl.allocatable, ctrl.pod_requests, ctrl.pod_limits, ctrl.daemon_requests,
        ctrl.daemon_limits, ctrl.overhead)}


# -- the controllers on the same inputs --------------------------------------------


def _node_scrape(m):
    """Node gauges of state nodes with bound pods (requests, limits and a
    daemonset pod), then a node gone: its series drop on the next scrape."""
    sn = _state_node(m, "n1", labels={"topology.kubernetes.io/zone": "z1",
                                      "node.kubernetes.io/instance-type": "it-1"})
    pod = m.t.make_pod(name="p1", requests={"cpu": "1", "memory": "1Gi"},
                       limits={"cpu": "2", "memory": "2Gi"})
    pod.spec.node_name = "n1"
    sn.update_for_pod(pod)
    ds = m.t.make_pod(name="ds", requests={"cpu": "0.5"}, limits={"cpu": "1"})
    ds.metadata.owner_references = [m.o.OwnerReference(kind="DaemonSet", name="ds")]
    ds.spec.node_name = "n1"
    sn.update_for_pod(ds)
    cluster = _FakeCluster([sn, _state_node(m, "n2", cpu="8")])
    ctrl = m.mc.NodeMetricsController(cluster)
    ctrl.reconcile()
    first = _node_gauges(ctrl)
    cluster._nodes = [sn]
    ctrl.reconcile()
    return first, _node_gauges(ctrl), ctrl.reconcile()


def _pod_scrape(m):
    clock = {"t": 1000.0}
    ctrl = m.mc.PodMetricsController(m.client(), clock=lambda: clock["t"])
    ctrl.state.clear()
    base = ctrl.startup.snapshot()
    out = []
    pod = m.t.make_pod(name="a")
    pod.metadata.uid = "uid-a"
    pod.metadata.creation_timestamp = 990.0
    ctrl.reconcile(pod)
    out.append(_series(ctrl.state))
    pod.status.phase, pod.spec.node_name = "Running", "n1"
    ctrl.reconcile(pod)
    ctrl.reconcile(pod)  # observed once
    out.append(_series(ctrl.state))
    skew = m.t.make_pod(name="future")
    skew.metadata.uid = "uid-future"
    skew.metadata.creation_timestamp = 2000.0
    skew.status.phase = "Running"
    unset = m.t.make_pod(name="unset")
    unset.metadata.uid = "uid-unset"
    unset.metadata.creation_timestamp = 0.0
    unset.status.phase = "Running"
    ctrl.reconcile(skew)
    ctrl.reconcile(unset)
    out.append((ctrl.startup.count_since(base), ctrl.startup.snapshot()[2] - base[2]))
    ctrl.reconcile(pod, deleted=True)
    out.append((_series(ctrl.state), pod.metadata.uid in ctrl._started))
    return out


def _provisioner_scrape(m):
    ctrl = m.mc.ProvisionerMetricsController(m.client())
    for g in (ctrl.limit, ctrl.usage, ctrl.usage_pct):
        g.clear()
    keep = m.t.make_provisioner(name="keep", limits={"cpu": "100"})
    keep.status.resources = {"cpu": 10.0, "memory": 4.0}
    gone = m.t.make_provisioner(name="gone", limits={"cpu": "50"})
    gone.status.resources = {"cpu": 5.0}
    ctrl.reconcile(keep)
    ctrl.reconcile(gone)
    out = [[_series(g) for g in (ctrl.limit, ctrl.usage, ctrl.usage_pct)]]
    keep.status.resources = {"cpu": 3.0}
    ctrl.reconcile(keep)
    ctrl.prune({"keep"})
    out.append([_series(g) for g in (ctrl.limit, ctrl.usage, ctrl.usage_pct)])
    ctrl.reconcile(keep, deleted=True)
    out.append([_series(g) for g in (ctrl.limit, ctrl.usage, ctrl.usage_pct)])
    return out


def _decorator(m):
    cp = m.fake.FakeCloudProvider(m.fake.instance_types(3))
    base = {tuple(sorted(lv)): c for lv, c in m.cpm.METHOD_DURATION.counts.items()}
    a = m.cpm.decorate(cp, "provisioning")
    b = m.cpm.decorate(a, "machine")
    out = [a is m.cpm.decorate(a, "provisioning"), b._inner is cp, a.name() == cp.name()]
    its = a.get_instance_types(None)
    b.get_instance_types(None)
    out.append(len(its))
    try:
        b.get("missing")
    except Exception as e:  # noqa: BLE001 — timed all the same
        out.append(type(e).__name__)
    counts = {tuple(sorted(lv)): c - base.get(tuple(sorted(lv)), 0)
              for lv, c in m.cpm.METHOD_DURATION.counts.items()}
    out.append(sorted((k, v) for k, v in counts.items() if v))
    out.append(m.cpm.METHOD_DURATION.name)
    return out


CASES = {f.__name__.strip("_"): f for f in (
    _node_scrape, _pod_scrape, _provisioner_scrape, _decorator)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_metrics_controllers_match_reference(case):
    """Each controller on the same inputs in both packages: equal gauge
    series, startup observations and decorator label sets."""
    ref, port = both(CASES[case])
    assert port == ref


def test_node_scrape_never_observes_an_empty_window():
    """A concurrent exposition always sees a stable node's series while the
    node metrics rebuild (build, then swap)."""
    m = _mods("torch")
    ctrl = m.mc.NodeMetricsController(_FakeCluster([_state_node(m, "stable")]))
    ctrl.reconcile()
    stop, holes = threading.Event(), []

    def scraper():
        while not stop.is_set():
            if 'node_name="stable"' not in treg.REGISTRY.expose():
                holes.append(1)
                return

    t = threading.Thread(target=scraper)
    t.start()
    try:
        for _ in range(100):
            ctrl.reconcile()
    finally:
        stop.set()
        t.join()
    assert not holes


# -- the operator: the same op.step() sequence in both packages ------------------------


def _env_run(m):
    """testing/expectations.Env: a provisioner with limits, pods, one
    step, the kubelet, a second step, a provisioner deleted, a third step;
    the gauges after each step (launched node names masked: each package
    counts its own), the pod gauges from the pods' events, and the label
    sets of the decorated provider's timings."""
    base = {lv: c for lv, c in m.cpm.METHOD_DURATION.counts.items()}
    env = m.Env(universe=m.fake.instance_types(10), solver=m.solver())
    op = env.op
    for g in (op.provisioner_metrics.limit, op.provisioner_metrics.usage,
              op.provisioner_metrics.usage_pct, op.pod_metrics.state):
        g.clear()
    env.expect_applied(m.t.make_provisioner(name="default", limits={"cpu": "1000"}))
    env.expect_applied(m.t.make_provisioner(name="extra", limits={"cpu": "10"}))
    for i in range(8):
        pod = m.t.make_pod(name=f"p-{i}", requests={"cpu": str(1 + i % 3)},
                           limits={"cpu": "4"})
        pod.metadata.uid, pod.metadata.creation_timestamp = f"uid-p-{i}", 1000.0 + i
        env.expect_applied(pod)
    out = []

    def snap():
        out.append({
            "nodes": _node_gauges(op.node_metrics, mask=("node_name",)),
            "provisioners": [_series(g) for g in (op.provisioner_metrics.limit,
                                                  op.provisioner_metrics.usage,
                                                  op.provisioner_metrics.usage_pct)],
        })

    op.step()
    snap()
    for node in env.kube.list("Node"):  # the kubelet
        machine = env.kube.get("Machine", "", node.metadata.name)
        if machine is not None:
            node.status.capacity = dict(machine.status.capacity)
            node.status.allocatable = dict(machine.status.allocatable)
            env.kube.update_status(node)
    op.step()
    snap()
    env.kube.delete("Provisioner", "", "extra")
    op.step()
    snap()
    for pod in env.kube.list("Pod"):
        op.pod_metrics.reconcile(pod)
    out.append(_series(op.pod_metrics.state, mask=("node",)))
    labels = sorted(tuple(sorted(lv)) for lv, c in m.cpm.METHOD_DURATION.counts.items()
                    if c != base.get(lv, 0))
    out.append(labels)
    return out


def test_operator_metrics_after_the_same_steps_match_reference():
    """The node, pod and provisioner gauge series after the same op.step()
    sequence, and the decorated provider's (controller, method, provider)
    label sets, are equal in both packages."""
    ref, port = both(_env_run)
    assert port == ref
    nodes = port[2]["nodes"]["karpenter_nodes_allocatable"]
    assert nodes and any(dict(lv)["provisioner"] == "default" for lv, _ in nodes)
    assert (("controller", "provisioning"), ("method", "GetInstanceTypes"),
            ("provider", "fake")) in port[-1]


def test_new_operator_decorates_the_provider_per_controller():
    from karpenter_core_tpu_torch.cloudprovider.metrics import DecoratedCloudProvider
    from karpenter_core_tpu_torch.cloudprovider import fake
    from karpenter_core_tpu_torch.operator import new_operator
    from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

    cp = fake.FakeCloudProvider(fake.instance_types(3))
    op = new_operator(cp, solver=TorchSolver(max_nodes=8, device="cpu"))
    assert op.cloud_provider is cp
    wrapped = {"provisioning": op.provisioning.cloud_provider,
               "machine": op.machine_controller.cloud_provider,
               "node": op.node_controller.cloud_provider,
               "deprovisioning": op.deprovisioning.cloud_provider,
               "inflightchecks": op.inflight_checks.cloud_provider}
    for controller, provider in wrapped.items():
        assert isinstance(provider, DecoratedCloudProvider)
        assert provider._controller == controller and provider._inner is cp
    assert op.cluster.cloud_provider._controller == "node"
    assert op.terminator.cloud_provider._controller == "machine"


def test_provisioning_series_after_a_step():
    """One step over pending pods: nodes created, the pending gauge, one
    admission-to-bind observation per decided pod (tenant-labelled for a
    tenant's pod), and a clean exposition."""
    from karpenter_core_tpu_torch import testing as t
    from karpenter_core_tpu_torch.api.labels import TENANT_LABEL_KEY
    from karpenter_core_tpu_torch.cloudprovider import fake
    from karpenter_core_tpu_torch.controllers.provisioning import provisioner as prov
    from karpenter_core_tpu_torch.operator import new_operator
    from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

    prov.reset_counts()
    clock = t.FakeClock(1_700_000_100.0)
    op = new_operator(fake.FakeCloudProvider(fake.instance_types(6)),
                      solver=TorchSolver(max_nodes=32, device="cpu"), clock=clock)
    op.kube_client.create(t.make_provisioner(name="default"))
    for i in range(6):
        pod = t.make_pod(name=f"p-{i}", requests={"cpu": "1"},
                         labels={TENANT_LABEL_KEY: "team-a"} if i < 2 else None)
        pod.metadata.creation_timestamp = 1_700_000_000.0
        op.kube_client.create(pod)
    launched = op.step()["launched"]
    assert launched and prov.NODES_CREATED.get({"reason": "provisioning"}) == launched
    assert prov.PENDING_PODS.get() == 6.0
    assert prov.ADMISSION_TO_BIND.count_since(labels={"tenant": "team-a"}) == 2
    assert prov.ADMISSION_TO_BIND.count_since() == 4
    assert prov.ADMISSION_TO_BIND.snapshot()[2] == pytest.approx(4 * 100.0)
    text = treg.REGISTRY.expose()
    assert "karpenter_admission_to_bind_seconds_count 4" in text
    assert 'karpenter_nodes_created{reason="provisioning"}' in text
    for line in text.splitlines():
        assert line.startswith("# HELP ") or line.startswith("# TYPE ") or \
            len(line.rsplit(" ", 1)) == 2
    prov.reset_counts()
    assert prov.NODES_CREATED.get({"reason": "provisioning"}) == 0
    assert prov.PENDING_PODS.get() == 0.0
