"""The specs of tests/test_provisioning_suite.py (the reference's
provisioning suite_test.go: daemonset overhead, annotation and label
propagation, the machine request's content, storage zones) through the
port's testing.expectations.Env, each against the reference's Env on the
same inputs.

Each spec runs on both packages: the reference's Env with
TPUSolver(backend="mxu", incremental="off") and the port's with
TorchSolver(device="cpu", incremental="off"). A spec makes the suite's
assertions and returns what it saw (the instance type chosen, the node's
labels and annotations, the create call's requirements and requests,
bindings); both packages must see the same.
"""
from types import SimpleNamespace

import pytest

from karpenter_core_tpu.api import settings as jsettings
from karpenter_core_tpu_torch.api import settings as tsettings
from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

ZONE = "topology.kubernetes.io/zone"
ITYPE = "node.kubernetes.io/instance-type"
PROV = "karpenter.sh/provisioner-name"
DO_NOT_CONSOLIDATE = "karpenter.sh/do-not-consolidate"
PROVIDER_COMPAT = "compatibility.karpenter.sh/provider"


@pytest.fixture(autouse=True)
def _reset_settings():
    yield
    jsettings.set_current(jsettings.Settings())
    tsettings.set_current(tsettings.Settings())


def _env(pkg):
    if pkg == "jax":
        from karpenter_core_tpu import testing as t
        from karpenter_core_tpu.cloudprovider import fake
        from karpenter_core_tpu.kube import objects as o
        from karpenter_core_tpu.solver.tpu_solver import TPUSolver
        from karpenter_core_tpu.testing.expectations import Env

        solver = TPUSolver(max_nodes=64, backend="mxu", incremental="off")
    else:
        from karpenter_core_tpu_torch import testing as t
        from karpenter_core_tpu_torch.cloudprovider import fake
        from karpenter_core_tpu_torch.kube import objects as o
        from karpenter_core_tpu_torch.testing.expectations import Env

        solver = TorchSolver(max_nodes=64, device="cpu", incremental="off")
    env = Env(universe=fake.instance_types(10), solver=solver)
    return env, SimpleNamespace(t=t, o=o)


def _req(m, key, op, *values):
    return m.o.NodeSelectorRequirement(key=key, operator=op, values=list(values))


def _pod(m, name, **kw):
    pod = m.t.make_pod(name=name, **kw)
    pod.metadata.uid = f"uid-{name}"
    pod.metadata.creation_timestamp = 1000.0
    return pod


def _chosen_cpu(env, pod):
    node = env.expect_scheduled(pod)
    name = node.metadata.labels[ITYPE]
    return next(it.capacity["cpu"] for it in env.universe if it.name == name)


def _call(env):
    call = env.cloud_provider.create_calls[0]
    return (sorted((r.key, r.operator, sorted(r.values)) for r in call.spec.requirements),
            sorted(call.spec.resources.requests.items()),
            sorted(call.metadata.annotations.items()))


def ignores_deleting_provisioners(env, m):
    """suite_test.go:111-121."""
    prov = m.t.make_provisioner(name="default")
    env.expect_applied(prov)
    prov.metadata.deletion_timestamp = env.clock()
    env.kube.update(prov)
    pod = _pod(m, "p")
    env.expect_provisioned(pod)
    env.expect_not_scheduled(pod)
    assert not env.cloud_provider.create_calls
    return None


def daemonset_overhead_counted(env, m):
    """suite_test.go:370-387."""
    env.expect_applied(m.t.make_provisioner(name="default"),
                       m.t.make_daemonset(name="ds", requests={"cpu": "1"}))
    pod = _pod(m, "p", requests={"cpu": "1"})
    env.expect_provisioned(pod)
    assert _chosen_cpu(env, pod) == 3
    return _chosen_cpu(env, pod), _call(env)


def daemonset_without_matching_toleration_ignored(env, m):
    """suite_test.go:493-512."""
    env.expect_applied(
        m.t.make_provisioner(name="default",
                             taints=[m.o.Taint(key="foo", value="bar", effect="NoSchedule")]),
        m.t.make_daemonset(name="ds", requests={"cpu": "1"}))
    pod = _pod(m, "p", requests={"cpu": "1"}, tolerations=[m.o.Toleration(operator="Exists")])
    env.expect_provisioned(pod)
    assert _chosen_cpu(env, pod) == 2
    return _chosen_cpu(env, pod), _call(env)


def daemonset_with_incompatible_selector_ignored(env, m):
    """suite_test.go:513-530."""
    env.expect_applied(m.t.make_provisioner(name="default"),
                       m.t.make_daemonset(name="ds", requests={"cpu": "1"},
                                          node_selector={"node": "invalid"}))
    pod = _pod(m, "p", requests={"cpu": "1"})
    env.expect_provisioned(pod)
    assert _chosen_cpu(env, pod) == 2
    return _chosen_cpu(env, pod), _call(env)


def daemonset_with_notin_unspecified_key_counted(env, m):
    """suite_test.go:531-551."""
    env.expect_applied(
        m.t.make_provisioner(name="default"),
        m.t.make_daemonset(name="ds", requests={"cpu": "1"}, node_affinity_required=[
            m.o.NodeSelectorTerm(match_expressions=[_req(m, "foo", "NotIn", "bar")])]))
    pod = _pod(m, "p", requests={"cpu": "1"}, node_affinity_required=[
        m.o.NodeSelectorTerm(match_expressions=[_req(m, ZONE, "In", "test-zone-2")])])
    env.expect_provisioned(pod)
    assert _chosen_cpu(env, pod) == 3
    return _chosen_cpu(env, pod), _call(env)


def daemonset_with_matching_toleration_counted(env, m):
    """suite_test.go:493-512, the daemonset tolerating the taint."""
    env.expect_applied(
        m.t.make_provisioner(name="default",
                             taints=[m.o.Taint(key="foo", value="bar", effect="NoSchedule")]),
        m.t.make_daemonset(name="ds", requests={"cpu": "1"},
                           tolerations=[m.o.Toleration(operator="Exists")]))
    pod = _pod(m, "p", requests={"cpu": "1"}, tolerations=[m.o.Toleration(operator="Exists")])
    env.expect_provisioned(pod)
    assert _chosen_cpu(env, pod) == 3
    return _chosen_cpu(env, pod), _call(env)


def provisioner_annotations_propagate_to_nodes(env, m):
    """suite_test.go:552-563."""
    env.expect_applied(m.t.make_provisioner(name="default",
                                            annotations={DO_NOT_CONSOLIDATE: "true"}))
    pod = _pod(m, "p", requests={"cpu": "1"})
    env.expect_provisioned(pod)
    node = env.expect_scheduled(pod)
    assert node.metadata.annotations.get(DO_NOT_CONSOLIDATE) == "true"
    return sorted(node.metadata.annotations.items())


def provisioner_requirement_labels_propagate(env, m):
    """suite_test.go:564-605."""
    env.expect_applied(m.t.make_provisioner(
        name="default", labels={"test-key-1": "test-value-1"},
        requirements=[_req(m, "test-key-2", "In", "test-value-2"),
                      _req(m, "test-key-3", "NotIn", "test-value-3"),
                      _req(m, "test-key-4", "Lt", "4"),
                      _req(m, "test-key-5", "Gt", "5"),
                      _req(m, "test-key-6", "Exists"),
                      _req(m, "test-key-7", "DoesNotExist")]))
    pod = _pod(m, "p", requests={"cpu": "1"})
    env.expect_provisioned(pod)
    labels = env.expect_scheduled(pod).metadata.labels
    assert labels.get("test-key-1") == "test-value-1"
    assert labels.get("test-key-2") == "test-value-2"
    assert labels.get("test-key-3") != "test-value-3"
    assert "test-key-6" in labels
    assert "test-key-7" not in labels
    # the Lt and Gt bounds do not reach the solved machine's requirements on
    # either package's device solver, so the labels drawn for test-key-4 and
    # test-key-5 may break them (ROADMAP Queue C); the values an Exists,
    # NotIn or bounded requirement takes are drawn at random by both
    # packages: compare which keys carry a value
    fixed = {k: labels[k] for k in ("test-key-1", "test-key-2", PROV, ZONE, ITYPE)}
    return sorted(fixed.items()), sorted(k for k in labels if k.startswith("test-key"))


def machine_request_carries_requirements_and_provider(env, m):
    """suite_test.go:648-712, 819-859."""
    env.expect_applied(m.t.make_provisioner(
        name="default", requirements=[_req(m, ZONE, "In", "test-zone-2")]))
    pod = _pod(m, "p", requests={"cpu": "1"})
    env.expect_provisioned(pod)
    env.expect_scheduled(pod)
    call = env.cloud_provider.create_calls[0]
    reqs = {r.key: r for r in call.spec.requirements}
    assert reqs[ZONE].values == ["test-zone-2"]
    assert PROV in reqs
    assert PROVIDER_COMPAT in call.metadata.annotations
    return _call(env)


def machine_request_includes_daemon_overhead_requests(env, m):
    """suite_test.go:860-918."""
    env.expect_applied(m.t.make_provisioner(name="default"),
                       m.t.make_daemonset(name="ds", requests={"cpu": "1", "memory": "1Gi"}))
    pod = _pod(m, "p", requests={"cpu": "1", "memory": "1Gi"})
    env.expect_provisioned(pod)
    env.expect_scheduled(pod)
    call = env.cloud_provider.create_calls[0]
    assert call.spec.resources.requests.get("cpu", 0.0) >= 2.0
    assert call.spec.resources.requests.get("memory", 0.0) >= 2 * 2**30
    return _call(env)


def schedules_to_storage_class_zones(env, m):
    """suite_test.go:974-998."""
    env.expect_applied(m.t.make_provisioner(name="default"),
                       m.t.make_storage_class("zonal-sc", "fake.csi", zones=["test-zone-3"]),
                       m.t.make_pvc("zonal-claim", storage_class="zonal-sc"))
    pod = _pod(m, "p", requests={"cpu": "1"})
    pod.spec.volumes.append(m.t.pvc_volume("zonal-claim"))
    env.expect_provisioned(pod)
    node = env.expect_scheduled(pod)
    assert node.metadata.labels[ZONE] == "test-zone-3"
    incompatible = _pod(m, "incompatible", requests={"cpu": "1"},
                        node_selector={ZONE: "test-zone-1"})
    incompatible.spec.volumes.append(m.t.pvc_volume("zonal-claim"))
    env.expect_provisioned(incompatible)
    env.expect_not_scheduled(incompatible)
    return node.metadata.labels[ZONE], node.metadata.labels[ITYPE], _call(env)


def schedules_to_bound_volume_zones(env, m):
    """suite_test.go:999-1010."""
    env.expect_applied(m.t.make_provisioner(name="default"),
                       m.t.make_pv("bound-pv", zones=["test-zone-2"]),
                       m.t.make_pvc("bound-claim", volume_name="bound-pv"))
    pod = _pod(m, "p", requests={"cpu": "1"})
    pod.spec.volumes.append(m.t.pvc_volume("bound-claim"))
    env.expect_provisioned(pod)
    node = env.expect_scheduled(pod)
    assert node.metadata.labels[ZONE] == "test-zone-2"
    return node.metadata.labels[ZONE], _call(env)


SPECS = [
    ignores_deleting_provisioners,
    daemonset_overhead_counted,
    daemonset_without_matching_toleration_ignored,
    daemonset_with_incompatible_selector_ignored,
    daemonset_with_notin_unspecified_key_counted,
    daemonset_with_matching_toleration_counted,
    provisioner_annotations_propagate_to_nodes,
    provisioner_requirement_labels_propagate,
    machine_request_carries_requirements_and_provider,
    machine_request_includes_daemon_overhead_requests,
    schedules_to_storage_class_zones,
    schedules_to_bound_volume_zones,
]


@pytest.mark.parametrize("spec", SPECS, ids=[s.__name__ for s in SPECS])
def test_provisioning_spec_matches_reference(spec):
    ref = spec(*_env("jax"))
    port = spec(*_env("torch"))
    assert port == ref
