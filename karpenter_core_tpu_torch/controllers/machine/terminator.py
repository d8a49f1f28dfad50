"""Terminator: cordon, drain and terminate a node, and the eviction queue
(machine/terminator/{terminator,eviction}.go).

Cordon marks the node unschedulable; drain evicts the pods that can be
evicted (daemonset and node-owned pods stay, terminal pods are skipped,
a do-not-evict pod blocks the drain, critical pods go after the rest) and
raises NodeDrainError until the node is empty; terminate deletes the
instance and removes the termination finalizer. The EvictionQueue queues
each pod once; its worker thread (start/stop, the operator's background
runtime) evicts them as they become due, a pod blocked by its
PodDisruptionBudget coming back after an exponential delay, and drain()
does the same synchronously until no eviction makes progress (the
operator's step()).
"""
from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, List, Optional

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
    """eviction.go:58-131: pods queue once each, in the order they were
    added; the worker takes them from a heap of due times, so that a
    blocked pod's retry waits without a thread of its own. Each add gives
    the key a generation that its heap entries carry, so an entry left
    from before a synchronous drain is skipped and a key has at most one
    live entry. `pdb_checker` (pod -> bool) is an optional extra gate
    before the eviction call."""

    def __init__(self, kube_client, recorder=None, pdb_checker=None):
        self.kube_client = kube_client
        self.recorder = recorder
        self.pdb_checker = pdb_checker
        # the pending keys (the reference's set), each with its generation
        self._set: Dict[NamespacedName, int] = {}
        self._heap: list = []  # (due, seq, key, attempts, generation)
        self._seq = 0
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.evicted = 0  # pods evicted

    def add(self, *pods) -> None:
        with self._cond:
            for pod in pods:
                key = object_key(pod)
                if key not in self._set:
                    self._set[key] = self._seq
                    heapq.heappush(self._heap, (0.0, self._seq, key, 0, self._seq))
                    self._seq += 1
            self._cond.notify()

    def __len__(self) -> int:
        with self._cond:
            return len(self._set)

    def _requeue(self, key: NamespacedName, attempts: int, generation: int) -> None:
        """A blocked eviction comes back after 0.1 s x 2^attempts, at most
        10 s (eviction.go:110-124), unless its key was drained meanwhile."""
        delay = min(0.1 * (2 ** attempts), 10.0)
        with self._cond:
            if self._set.get(key) != generation:
                return
            heapq.heappush(self._heap, (time.monotonic() + delay, self._seq, key,
                                        attempts + 1, generation))
            self._seq += 1
            self._cond.notify()

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="eviction-queue")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _pop_ready(self, timeout: float = 0.1):
        """The earliest due live (key, attempts, generation), waiting up
        to `timeout` for one; None when none is due by then."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while not self._stop.is_set():
                now = time.monotonic()
                while self._heap and self._set.get(self._heap[0][2]) != self._heap[0][4]:
                    heapq.heappop(self._heap)  # drained synchronously meanwhile
                if self._heap and self._heap[0][0] <= now:
                    _, _, key, attempts, generation = heapq.heappop(self._heap)
                    return key, attempts, generation
                wait = (min(self._heap[0][0], deadline) if self._heap else deadline) - now
                if wait <= 0:
                    return None
                self._cond.wait(wait)
            return None

    def _run(self) -> None:
        while not self._stop.is_set():
            item = self._pop_ready()
            if item is None:
                continue
            key, attempts, generation = item
            if self.evict(key):
                with self._cond:
                    if self._set.get(key) == generation:
                        del self._set[key]
            else:
                self._requeue(key, attempts, generation)

    def evict(self, key: NamespacedName) -> bool:
        """One eviction call (eviction.go:87-124): True when the pod is
        evicted or already gone, False when its budget refuses."""
        pod = self.kube_client.get("Pod", key.namespace, key.name)
        if pod is None:
            return True
        if self.pdb_checker is not None and not self.pdb_checker(pod):
            return False
        try:
            self.kube_client.evict(key.namespace, key.name)
        except EvictionBlockedError:
            return False
        except NotFoundError:
            return True  # deleted meanwhile
        self.evicted += 1
        if self.recorder:
            self.recorder.evict_pod(pod)
        return True

    def drain(self) -> None:
        """Evict everything queued, repeating while evictions progress."""
        while True:
            with self._cond:
                pending = list(self._set)
            if not pending:
                return
            progressed = False
            for key in pending:
                if self.evict(key):
                    with self._cond:
                        self._set.pop(key, None)
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
