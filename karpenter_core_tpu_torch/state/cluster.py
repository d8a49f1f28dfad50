"""Cluster: the in-memory mirror of nodes and pod bindings that a
provisioning solve reads (state/cluster.go:44-532).

The part of the reference's Cluster the solve path needs: nodes keyed by
provider id, pod -> node bindings that keep each node's requests, host
ports and volumes, the index of bound pods with required anti-affinity,
and CSINode attach limits applied on every node update. Machines, the
diff feed, consolidation state and in-flight capacity from the cloud
provider are not here.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from karpenter_core_tpu_torch.kube.objects import NamespacedName, object_key
from karpenter_core_tpu_torch.state.node import StateNode, populate_volume_limits_from
from karpenter_core_tpu_torch.utils import podutils


class Cluster:
    """cluster.go:44-60."""

    def __init__(self, kube_client):
        self.kube_client = kube_client
        self._mu = threading.RLock()
        self.nodes_by_provider_id: Dict[str, StateNode] = {}
        self.node_name_to_provider_id: Dict[str, str] = {}
        self.bindings: Dict[NamespacedName, str] = {}  # pod -> node name
        self.anti_affinity_pods: Dict[NamespacedName, object] = {}

    # -- queries (cluster.go:116-156) ---------------------------------------

    def nodes(self) -> List[StateNode]:
        """A deep-copied snapshot of every node (cluster.go:149-156)."""
        with self._mu:
            return [n.deep_copy() for n in self.nodes_by_provider_id.values()]

    def for_pods_with_anti_affinity(self, fn: Callable[[object, object], bool]) -> None:
        """Visit bound pods with required anti-affinity and their nodes,
        until fn returns False (cluster.go:116-132)."""
        with self._mu:
            pods = list(self.anti_affinity_pods.values())
        for pod in pods:
            node = self.kube_client.get("Node", "", pod.spec.node_name)
            if node is None:
                continue
            if not fn(pod, node):
                return

    def node_for(self, name: str) -> Optional[StateNode]:
        with self._mu:
            pid = self.node_name_to_provider_id.get(name)
            return None if pid is None else self.nodes_by_provider_id.get(pid)

    # -- ingestion (cluster.go:204-267,341-505) -------------------------------

    def update_node(self, node) -> None:
        with self._mu:
            provider_id = node.spec.provider_id or f"node:///{node.metadata.name}"
            existing = self.nodes_by_provider_id.get(provider_id)
            if existing is None:
                existing = StateNode(node)
                # claims resolve to their drivers through the store
                existing.volume_usage.kube_client = self.kube_client
                self.nodes_by_provider_id[provider_id] = existing
            else:
                existing.node = node
            self.node_name_to_provider_id[node.metadata.name] = provider_id
            populate_volume_limits_from(self.kube_client, existing)

    def update_pod(self, pod) -> None:
        """cluster.go:446-505: bindings, per-node usage and the
        anti-affinity index."""
        with self._mu:
            key = object_key(pod)
            if podutils.is_terminal(pod):
                self._unbind(key)
                self.anti_affinity_pods.pop(key, None)
                return
            old_node_name = self.bindings.get(key)
            if pod.spec.node_name:
                if old_node_name and old_node_name != pod.spec.node_name:
                    self._unbind(key)
                self.bindings[key] = pod.spec.node_name
                node = self.node_for(pod.spec.node_name)
                if node is not None:
                    node.update_for_pod(pod)
                if podutils.has_pod_anti_affinity(pod):
                    self.anti_affinity_pods[key] = pod

    def delete_pod(self, key: NamespacedName) -> None:
        with self._mu:
            self._unbind(key)
            self.anti_affinity_pods.pop(key, None)

    def _unbind(self, key: NamespacedName) -> None:
        node_name = self.bindings.pop(key, None)
        if node_name:
            node = self.node_for(node_name)
            if node is not None:
                node.cleanup_for_pod(key)
