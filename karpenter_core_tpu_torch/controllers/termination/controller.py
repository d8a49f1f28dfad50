"""The node termination finalizer (termination/controller.go:50-98): a
deleted Node that carries the termination finalizer is cordoned, drained
(requeued while pods remain), its instance terminated and its finalizer
removed; the Cluster forgets it."""
from __future__ import annotations

from typing import Optional

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.controllers.machine.terminator import NodeDrainError, Terminator

class TerminationController:
    def __init__(self, kube_client, terminator: Terminator, cluster=None):
        self.kube_client = kube_client
        self.terminator = terminator
        self.cluster = cluster

    def reconcile(self, node) -> Optional[float]:
        if node.metadata.deletion_timestamp is None:
            return None
        return self.finalize(node)

    def finalize(self, node) -> Optional[float]:
        """controller.go:64-86; a no-op without the finalizer."""
        if api_labels.TERMINATION_FINALIZER not in node.metadata.finalizers:
            return None
        self.terminator.cordon(node)
        try:
            self.terminator.drain(node)
        except NodeDrainError:
            return 1.0  # requeue while the node drains
        self.terminator.terminate_node(node)
        if self.cluster is not None:
            self.cluster.delete_node(node.metadata.name)
        return None
