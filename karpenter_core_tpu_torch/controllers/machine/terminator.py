"""Terminator: cordon, drain and terminate a node, and the eviction queue
(machine/terminator/{terminator,eviction}.go).

Cordon marks the node unschedulable; drain evicts the pods that can be
evicted (daemonset and node-owned pods stay, terminal pods are skipped,
a do-not-evict pod blocks the drain, critical pods go after the rest) and
raises NodeDrainError until the node is empty; terminate deletes the
instance and removes the termination finalizer. The EvictionQueue is
synchronous here: add() queues pods once each, drain() calls the eviction
API for every queued pod until no eviction makes progress, a pod blocked
by its PodDisruptionBudget staying queued for the next drain. The queue's
worker thread belongs to the operator runtime.
"""
from __future__ import annotations

import time
from typing import Dict, List

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.api.machine import Machine
from karpenter_core_tpu_torch.cloudprovider.types import MachineNotFoundError
from karpenter_core_tpu_torch.kube.client import EvictionBlockedError, NotFoundError
from karpenter_core_tpu_torch.kube.objects import (
    TAINT_NODE_UNSCHEDULABLE,
    NamespacedName,
    Taint,
    object_key,
)
from karpenter_core_tpu_torch.utils import podutils

CRITICAL_PRIORITY_CLASSES = ("system-cluster-critical", "system-node-critical")


class NodeDrainError(Exception):
    """The drain is not finished yet; requeue (terminator.go)."""


class EvictionQueue:
    """eviction.go:58-131, run synchronously: pods queue once each, in the
    order they were added."""

    def __init__(self, kube_client):
        self.kube_client = kube_client
        self._queued: Dict[NamespacedName, None] = {}
        self.evicted = 0  # pods evicted

    def add(self, *pods) -> None:
        for pod in pods:
            self._queued.setdefault(object_key(pod), None)

    def __len__(self) -> int:
        return len(self._queued)

    def evict(self, key: NamespacedName) -> bool:
        """One eviction call (eviction.go:87-124): True when the pod is
        evicted or already gone, False when its budget refuses."""
        pod = self.kube_client.get("Pod", key.namespace, key.name)
        if pod is None:
            return True
        try:
            self.kube_client.evict(key.namespace, key.name)
        except EvictionBlockedError:
            return False
        except NotFoundError:
            return True  # deleted meanwhile
        self.evicted += 1
        return True

    def drain(self) -> None:
        """Evict everything queued, repeating while evictions progress."""
        while self._queued:
            progressed = False
            for key in list(self._queued):
                if self.evict(key):
                    del self._queued[key]
                    progressed = True
            if not progressed:
                return


class Terminator:
    """terminator.go:40-155."""

    def __init__(self, kube_client, cloud_provider, eviction_queue: EvictionQueue,
                 clock=None):
        self.kube_client = kube_client
        self.cloud_provider = cloud_provider
        self.eviction_queue = eviction_queue
        self.clock = clock if clock is not None else time.time

    def cordon(self, node) -> None:
        """terminator.go:53-68: mark the node unschedulable."""
        if node.spec.unschedulable:
            return
        node.spec.unschedulable = True
        if not any(t.key == TAINT_NODE_UNSCHEDULABLE for t in node.spec.taints):
            node.spec.taints.append(Taint(key=TAINT_NODE_UNSCHEDULABLE, effect="NoSchedule"))
        self.kube_client.update(node)

    def drain(self, node) -> None:
        """terminator.go:70-155: queue the evictable pods, critical pods
        only once the rest are gone; NodeDrainError until the node is
        empty of them, or at once when a do-not-evict pod blocks it."""
        evictable: List = []
        critical: List = []
        for pod in self.kube_client.list("Pod", node_name=node.metadata.name):
            if podutils.is_owned_by_daemonset(pod) or podutils.is_owned_by_node(pod):
                continue
            if podutils.is_terminal(pod):
                continue
            if podutils.has_do_not_evict(pod) and pod.metadata.deletion_timestamp is None:
                raise NodeDrainError(
                    f"pod {pod.metadata.namespace}/{pod.metadata.name} has do-not-evict "
                    f"annotation")
            if pod.spec.priority_class_name in CRITICAL_PRIORITY_CLASSES:
                critical.append(pod)
            else:
                evictable.append(pod)
        batch = evictable if evictable else critical
        if batch:
            self.eviction_queue.add(*batch)
            raise NodeDrainError(
                f"{len(evictable) + len(critical)} pods are waiting to be evicted")

    def terminate_node(self, node) -> None:
        """terminator.go:102-129: delete the instance, then drop the
        finalizer so that the deletion completes."""
        machine = self.kube_client.get("Machine", "", node.metadata.name)
        if machine is None:
            machine = Machine()
            machine.metadata.name = node.metadata.name
            machine.status.provider_id = node.spec.provider_id
        try:
            self.cloud_provider.delete(machine)
        except MachineNotFoundError:
            pass
        if api_labels.TERMINATION_FINALIZER in node.metadata.finalizers:
            node.metadata.finalizers.remove(api_labels.TERMINATION_FINALIZER)
            self.kube_client.finalize(node)
