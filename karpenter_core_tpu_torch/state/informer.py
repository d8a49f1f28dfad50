"""Informers: watch events of the kube client into Cluster calls.

The reference's informer controllers (state/informer/{node,pod,machine,
provisioner}.go), as in its state/informer.py: thin handlers that turn
each ("ADDED" | "MODIFIED" | "DELETED", object) event of a watch into a
Cluster update or delete.
"""
from __future__ import annotations

import queue

from karpenter_core_tpu_torch.kube.objects import NamespacedName


class NodeInformer:
    def __init__(self, cluster):
        self.cluster = cluster

    def handle(self, event: str, node) -> None:
        if event == "DELETED":
            self.cluster.delete_node(node.metadata.name)
        else:
            self.cluster.update_node(node)


class PodInformer:
    def __init__(self, cluster):
        self.cluster = cluster

    def handle(self, event: str, pod) -> None:
        if event == "DELETED":
            self.cluster.delete_pod(NamespacedName(pod.metadata.namespace, pod.metadata.name))
        else:
            self.cluster.update_pod(pod)


class MachineInformer:
    def __init__(self, cluster):
        self.cluster = cluster

    def handle(self, event: str, machine) -> None:
        if event == "DELETED":
            self.cluster.delete_machine(machine.metadata.name)
        else:
            self.cluster.update_machine(machine)


class ProvisionerInformer:
    def __init__(self, cluster):
        self.cluster = cluster

    def handle(self, event: str, provisioner) -> None:
        self.cluster.update_provisioner(provisioner)


def drain(events, informer) -> int:
    """Hand every event waiting on a watch queue to `informer`, in order;
    returns how many there were."""
    n = 0
    while True:
        try:
            event, obj = events.get_nowait()
        except queue.Empty:
            return n
        informer.handle(event, obj)
        n += 1
