"""The suite environment and the Expect* helpers of
pkg/test/expectations/expectations.go, over the port's operator.

`Env` is the suite-level environment (environment.go:69-118): an operator
from new_operator over an in-memory client, with a fake cloud provider and
a steppable clock. The helpers raise AssertionError with the diagnostic
shape of the reference's matchers, so that a suite reads as the
reference's does. The solver is the caller's (a TorchSolver(device="cpu")
in the tests); without one new_operator builds one on the card.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from karpenter_core_tpu_torch.api.settings import Settings
from karpenter_core_tpu_torch.cloudprovider import fake
from karpenter_core_tpu_torch.kube.objects import LABEL_HOSTNAME
from karpenter_core_tpu_torch.operator import new_operator
from karpenter_core_tpu_torch.testing import FakeClock
from karpenter_core_tpu_torch.utils import podutils


class Env:
    """An operator, a fake cloud provider over `universe` and a FakeClock,
    with the Expect* helpers as methods."""

    def __init__(self, universe=None, settings: Optional[Settings] = None, solver=None):
        self.clock = FakeClock()
        self.universe = universe if universe is not None else fake.default_universe()
        self.cloud_provider = fake.FakeCloudProvider(self.universe)
        self.op = new_operator(self.cloud_provider, settings=settings or Settings(),
                               solver=solver, clock=self.clock)

    @property
    def kube(self):
        return self.op.kube_client

    @property
    def cluster(self):
        return self.op.cluster

    @property
    def provisioning(self):
        return self.op.provisioning

    # -- object lifecycle (expectations.go:58-213) -------------------------------

    def expect_applied(self, *objects):
        """Create or update each object, its status included
        (ExpectApplied, expectations.go:110-143)."""
        for obj in objects:
            kind = type(obj).__name__
            current = self.kube.get(kind, obj.metadata.namespace, obj.metadata.name)
            if current is None:
                self.kube.create(obj)
            else:
                obj.metadata.resource_version = current.metadata.resource_version
                self.kube.update(obj)
                if hasattr(obj, "status"):
                    self.kube.update_status(obj)
        return objects[0] if len(objects) == 1 else objects

    def expect_exists(self, obj_or_kind, name: str = None, namespace: str = ""):
        """ExpectExists (expectations.go:58-66)."""
        if name is None:
            kind = type(obj_or_kind).__name__
            namespace = obj_or_kind.metadata.namespace
            name = obj_or_kind.metadata.name
        else:
            kind = obj_or_kind
        got = self.kube.get(kind, namespace, name)
        assert got is not None, f"expected {kind} {namespace}/{name} to exist"
        return got

    def expect_not_found(self, *objects):
        """ExpectNotFound (expectations.go:84-96)."""
        for obj in objects:
            kind = type(obj).__name__
            ns = obj.metadata.namespace
            got = self.kube.get(kind, ns, obj.metadata.name)
            assert got is None, (f"expected {kind} {ns}/{obj.metadata.name} to be deleted, "
                                 f"but it still exists")

    def expect_deleted(self, *objects):
        """Delete each object, its finalizers cleared, and assert it gone
        (ExpectDeleted, expectations.go:145-152). A Node's Machine record
        goes with it: the reference's suites expect all of a deleted
        node's capacity gone."""
        for obj in objects:
            kind = type(obj).__name__
            obj.metadata.finalizers = []
            try:
                self.kube.update(obj)
            except Exception:  # noqa: BLE001 — not stored yet
                pass
            self.kube.delete(kind, obj.metadata.namespace, obj.metadata.name)
            if kind == "Node":
                machine = self.kube.get("Machine", "", obj.metadata.name)
                if machine is not None:
                    machine.metadata.finalizers = []
                    self.kube.update(machine)
                    self.kube.delete("Machine", "", machine.metadata.name)
        self.expect_not_found(*objects)

    def expect_finalizers_removed(self, *objects):
        """ExpectFinalizersRemoved (expectations.go:203-213)."""
        for obj in objects:
            live = self.kube.get(type(obj).__name__, obj.metadata.namespace,
                                 obj.metadata.name)
            if live is not None:
                live.metadata.finalizers = []
                self.kube.update(live)

    # -- the scheduling cycle (expectations.go:216-257) ---------------------------

    def expect_provisioned(self, *pods) -> Dict[str, Optional[object]]:
        """Apply the pods, schedule and launch once, and bind each scheduled
        pod to its node (ExpectProvisioned, expectations.go:216-227).
        Returns {pod name: Node or None}."""
        bindings = self.expect_provisioned_no_binding(*pods)
        for pod in pods:
            node = bindings.get(pod.metadata.name)
            if node is not None:
                self.expect_manual_binding(pod, node)
        return bindings

    def expect_provisioned_no_binding(self, *pods) -> Dict[str, Optional[object]]:
        """Schedule and launch, no binding (ExpectProvisionedNoBinding,
        expectations.go:233-257)."""
        self.expect_applied(*pods)
        self.op.sync_state()
        result = self.provisioning.schedule()
        bindings: Dict[str, Optional[object]] = {p.metadata.name: None for p in pods}
        if result is None:
            return bindings
        names = self.provisioning.launch_machines(result.new_machines)
        for machine, node_name in zip(result.new_machines, names):
            if not node_name:
                continue
            node = self.kube.get("Node", "", node_name)
            for pod in machine.pods:
                bindings[pod.metadata.name] = node
        for state_node, assigned in result.existing_assignments:
            node = state_node.node
            if node is None and state_node.machine is not None:
                node = self.kube.get("Node", "", state_node.name())
            for pod in assigned:
                bindings[pod.metadata.name] = node
        return bindings

    def expect_scheduled(self, pod):
        """ExpectScheduled (expectations.go:98-102): the pod is bound; its
        node."""
        live = self.expect_exists(pod)
        assert live.spec.node_name, (
            f"expected {live.metadata.namespace}/{live.metadata.name} to be scheduled")
        return self.expect_exists("Node", live.spec.node_name)

    def expect_not_scheduled(self, pod):
        """ExpectNotScheduled (expectations.go:104-108)."""
        live = self.expect_exists(pod)
        assert not live.spec.node_name, (
            f"expected {live.metadata.namespace}/{live.metadata.name} "
            f"to not be scheduled (bound to {live.spec.node_name})")
        return live

    def expect_manual_binding(self, pod, node):
        """Bind the pod to the node and tell the Cluster
        (ExpectManualBinding, expectations.go:314-334)."""
        live = self.kube.get("Pod", pod.metadata.namespace, pod.metadata.name) or pod
        live.spec.node_name = node.metadata.name
        live.status.conditions = [c for c in live.status.conditions
                                  if c.type != "PodScheduled"]
        try:
            self.kube.update(live)
        except Exception:  # noqa: BLE001 — not stored yet
            self.kube.create(live)
        pod.spec.node_name = node.metadata.name
        self.cluster.update_pod(live)

    # -- controller drives ------------------------------------------------------

    def expect_reconcile_succeeded(self, reconciler, obj):
        """ExpectReconcileSucceeded (expectations.go:260-264)."""
        try:
            return reconciler.reconcile(obj)
        except Exception as exc:
            raise AssertionError(f"expected reconcile of {type(obj).__name__} "
                                 f"{obj.metadata.name} to succeed: {exc}") from exc

    def expect_reconcile_failed(self, reconciler, obj):
        """ExpectReconcileFailed (expectations.go:266-269)."""
        try:
            reconciler.reconcile(obj)
        except Exception:  # noqa: BLE001 — the expected outcome
            return
        raise AssertionError(
            f"expected reconcile of {type(obj).__name__} {obj.metadata.name} to fail")

    # -- topology (expectations.go:336-361) --------------------------------------

    def expect_skew(self, namespace: str, constraint) -> Dict[str, int]:
        """Bound, non-terminal pods matching the constraint's selector per
        domain of its key (ExpectSkew)."""
        nodes = {n.metadata.name: n for n in self.kube.list("Node")}
        skew: Dict[str, int] = {}
        for pod in self.kube.list("Pod"):
            if namespace and pod.metadata.namespace != namespace:
                continue
            if podutils.is_terminal(pod):
                continue
            if (constraint.label_selector is not None
                    and not constraint.label_selector.matches(pod.metadata.labels)):
                continue
            node = nodes.get(pod.spec.node_name)
            if node is None:
                continue
            if constraint.topology_key == LABEL_HOSTNAME:
                domain = node.metadata.name
            else:
                domain = node.metadata.labels.get(constraint.topology_key)
            if domain is not None:
                skew[domain] = skew.get(domain, 0) + 1
        return skew

    # -- the rest -----------------------------------------------------------------

    @staticmethod
    def expect_resources(expected: dict, real: dict):
        """ExpectResources (expectations.go:363-371)."""
        for key, value in expected.items():
            assert key in real, f"expected resource {key} missing (have {sorted(real)})"
            assert abs(real[key] - float(value)) < 1e-9, (
                f"resource {key}: expected {value}, got {real[key]}")

    def expect_status_condition(self, obj, cond_type: str):
        """ExpectStatusConditionExists (expectations.go:271-278)."""
        for cond in obj.status.conditions:
            if cond.type == cond_type:
                return cond
        raise AssertionError(f"expected condition {cond_type} on {obj.metadata.name} "
                             f"(have {[c.type for c in obj.status.conditions]})")

    def expect_owner_reference(self, obj, owner):
        """ExpectOwnerReferenceExists (expectations.go:280-287)."""
        for ref in obj.metadata.owner_references:
            if ref.kind == type(owner).__name__ and ref.name == owner.metadata.name:
                return ref
        raise AssertionError(f"expected {obj.metadata.name} to be owned by "
                             f"{owner.metadata.name}")

    def expect_cleaned_up(self):
        """Delete every object, finalizers cleared (ExpectCleanedUp,
        expectations.go:174-201)."""
        for kind in ("Pod", "Node", "Machine", "Provisioner", "PersistentVolumeClaim",
                     "PersistentVolume", "DaemonSet", "PodDisruptionBudget"):
            for obj in self.kube.list(kind):
                obj.metadata.finalizers = []
                for write in (lambda: self.kube.update(obj),
                              lambda: self.kube.delete(kind, obj.metadata.namespace,
                                                       obj.metadata.name)):
                    try:
                        write()
                    except Exception:  # noqa: BLE001 — gone meanwhile
                        pass

    def drop_machine(self, node):
        """Delete the Machine record behind a launched node, leaving a bare
        Node (the reference's machine-less suite specs), and relist."""
        machine = self.kube.get("Machine", "", node.metadata.name)
        if machine is not None:
            machine.metadata.finalizers = []
            self.kube.update(machine)
            self.kube.delete("Machine", "", machine.metadata.name)
        self.op.sync_state()

    def bound_pods(self, node) -> List:
        return self.kube.list("Pod", node_name=node.metadata.name)
