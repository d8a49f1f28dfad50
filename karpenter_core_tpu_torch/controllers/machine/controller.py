"""The machine lifecycle controller: launch, registration, initialization
and liveness, and the drain-then-delete finalizer
(machine/{controller,launch,registration,initialization,liveness}.go).

Launch creates the instance of a machine without a provider id;
registration finds the machine's node by provider id and gives it the
machine's labels, taints, startup taints (once) and the termination
finalizer; initialization marks the machine initialized (and the node
labelled so) once the node is ready, its startup taints are gone and its
extended resources are registered; liveness deletes a machine whose node
has not registered within Settings.ttl_after_not_registered. Status
writes go through the status subresource.
"""
from __future__ import annotations

import copy
import time
from typing import Optional

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.api.machine import (
    CONDITION_MACHINE_INITIALIZED,
    CONDITION_MACHINE_LAUNCHED,
    CONDITION_MACHINE_REGISTERED,
    CONDITION_READY,
)
from karpenter_core_tpu_torch.api.settings import current as current_settings
from karpenter_core_tpu_torch.cloudprovider.types import MachineNotFoundError
from karpenter_core_tpu_torch.controllers.machine.terminator import NodeDrainError, Terminator
from karpenter_core_tpu_torch.kube.client import NotFoundError
from karpenter_core_tpu_torch.metrics.registry import MACHINES_CREATED, MACHINES_TERMINATED
from karpenter_core_tpu_torch.scheduling import taints as taints_mod

class MachineController:
    """machine/controller.go:60-166."""

    def __init__(self, kube_client, cloud_provider, cluster, terminator: Terminator,
                 recorder=None, clock=None):
        self.kube_client = kube_client
        self.cloud_provider = cloud_provider
        self.cluster = cluster
        self.terminator = terminator
        self.recorder = recorder
        self.clock = clock if clock is not None else time.time

    def reconcile(self, machine) -> Optional[float]:
        """One pass; returns a requeue delay in seconds, or None."""
        if machine.metadata.deletion_timestamp is not None:
            return self.finalize(machine)
        requeue = None
        for step in (self.launch, self.registration, self.initialization, self.liveness):
            r = step(machine)
            if r == "deleted":
                return None
            if isinstance(r, (int, float)):
                requeue = min(requeue, r) if requeue is not None else r
        self._sync_ready(machine)
        # metadata and spec ride the plain update; conditions, provider id
        # and capacity live under the status subresource, written on the
        # version apply returned. A machine deleted meanwhile is a no-op.
        try:
            applied = self.kube_client.apply(machine)
            machine.metadata.resource_version = applied.metadata.resource_version
            self.kube_client.update_status(machine)
        except NotFoundError:
            return None
        self.cluster.update_machine(machine)
        return requeue

    # -- the sub-reconcilers ---------------------------------------------------

    def launch(self, machine):
        """launch.go:35-77."""
        if machine.status.provider_id:
            machine.set_condition(CONDITION_MACHINE_LAUNCHED, "True")
            return None
        try:
            created = self.cloud_provider.get(machine.name)
        except MachineNotFoundError:
            try:
                created = self.cloud_provider.create(machine)
                MACHINES_CREATED.inc()
            except Exception as e:  # noqa: BLE001 — recorded on the condition
                machine.set_condition(CONDITION_MACHINE_LAUNCHED, "False", "LaunchFailed",
                                      str(e))
                return 10.0
        machine.status.provider_id = created.status.provider_id
        machine.status.capacity = dict(created.status.capacity)
        machine.status.allocatable = dict(created.status.allocatable)
        machine.metadata.labels.update(created.metadata.labels)
        machine.set_condition(CONDITION_MACHINE_LAUNCHED, "True")
        return None

    def registration(self, machine):
        """registration.go:38-98: sync the node's labels and taints with
        the machine's; the startup taints only at the first registration,
        so that once removed they stay removed."""
        if not machine.status.provider_id:
            return None
        node = self._node_for(machine)
        if node is None:
            machine.set_condition(CONDITION_MACHINE_REGISTERED, "False", "NodeNotFound",
                                  "node has not registered")
            return None
        node.metadata.labels.update(machine.metadata.labels)
        node.metadata.labels[api_labels.MACHINE_NAME_LABEL_KEY] = machine.name
        node.spec.taints = taints_mod.merge(node.spec.taints, machine.spec.taints)
        if not machine.condition_true(CONDITION_MACHINE_REGISTERED):
            node.spec.taints = taints_mod.merge(node.spec.taints, machine.spec.startup_taints)
        if api_labels.TERMINATION_FINALIZER not in node.metadata.finalizers:
            node.metadata.finalizers.append(api_labels.TERMINATION_FINALIZER)
        self.kube_client.apply(node)
        self.cluster.update_node(node)
        machine.set_condition(CONDITION_MACHINE_REGISTERED, "True")
        return None

    def initialization(self, machine):
        """initialization.go:42-90."""
        if not machine.condition_true(CONDITION_MACHINE_REGISTERED):
            return None
        node = self._node_for(machine)
        if node is None:
            return None
        if not node.ready():
            machine.set_condition(CONDITION_MACHINE_INITIALIZED, "False", "NodeNotReady",
                                  "node not ready")
            return None
        startup = {(t.key, t.value, t.effect) for t in machine.spec.startup_taints}
        if any((t.key, t.value, t.effect) in startup for t in node.spec.taints):
            machine.set_condition(CONDITION_MACHINE_INITIALIZED, "False",
                                  "StartupTaintsExist", "startup taints remain")
            return None
        for name, quantity in machine.status.allocatable.items():
            if quantity and not node.status.allocatable.get(name):
                machine.set_condition(CONDITION_MACHINE_INITIALIZED, "False",
                                      "ResourceNotRegistered",
                                      f"extended resource {name} not registered")
                return None
        node.metadata.labels[api_labels.LABEL_NODE_INITIALIZED] = "true"
        self.kube_client.apply(node)
        self.cluster.update_node(node)
        machine.set_condition(CONDITION_MACHINE_INITIALIZED, "True")
        return None

    def liveness(self, machine):
        """liveness.go:33-60: a machine unregistered past the TTL is
        deleted."""
        if machine.condition_true(CONDITION_MACHINE_REGISTERED):
            return None
        ttl = current_settings().ttl_after_not_registered
        if ttl is None:
            return None
        age = self.clock() - machine.metadata.creation_timestamp
        if age < ttl:
            return ttl - age
        try:
            self.kube_client.delete("Machine", "", machine.name)
        except NotFoundError:
            pass  # already gone
        return "deleted"

    def finalize(self, machine):
        """controller.go:122-146: drain the node, delete the instance, drop
        the finalizers."""
        node = self._node_for(machine)
        if node is not None:
            self.terminator.cordon(node)
            try:
                self.terminator.drain(node)
            except NodeDrainError:
                return 1.0
        try:
            self.cloud_provider.delete(machine)
            MACHINES_TERMINATED.inc()
        except MachineNotFoundError:
            pass
        if node is not None and api_labels.TERMINATION_FINALIZER in node.metadata.finalizers:
            node.metadata.finalizers.remove(api_labels.TERMINATION_FINALIZER)
            self.kube_client.finalize(node)
        if api_labels.TERMINATION_FINALIZER in machine.metadata.finalizers:
            machine.metadata.finalizers.remove(api_labels.TERMINATION_FINALIZER)
            self.kube_client.finalize(machine)
        self.cluster.delete_machine(machine.name)
        return None

    # -- helpers ---------------------------------------------------------------

    def _node_for(self, machine):
        """The node with the machine's provider id. A launched node is named
        after its machine, so that name is read first; only when it is not
        the machine's node are all nodes scanned, as the reference always
        does (one scan per machine would make a pass over every machine
        quadratic in the nodes)."""
        provider_id = machine.status.provider_id
        node = self.kube_client.get("Node", "", machine.name)
        if node is not None and node.spec.provider_id == provider_id:
            return node
        for node in self.kube_client.list("Node", copy_objects=False):
            if node.spec.provider_id == provider_id:
                return copy.deepcopy(node)
        return None

    def _sync_ready(self, machine) -> None:
        ready = (machine.condition_true(CONDITION_MACHINE_LAUNCHED)
                 and machine.condition_true(CONDITION_MACHINE_REGISTERED)
                 and machine.condition_true(CONDITION_MACHINE_INITIALIZED))
        machine.set_condition(CONDITION_READY, "True" if ready else "False")
