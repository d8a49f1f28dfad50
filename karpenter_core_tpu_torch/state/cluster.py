"""Cluster: the in-memory mirror of nodes, machines and pod bindings
that a provisioning solve and the deprovisioners read
(state/cluster.go:44-532).

Nodes and Machine records keyed by provider id (a launched machine is a
state node before its Node registers), pod -> node bindings that keep
each node's requests, host ports and volumes, the index of bound pods with
required anti-affinity, CSINode attach limits applied on every node
update, the in-flight capacity of a node's instance type from the cloud
provider until the node reports its own, the change feed that tells an
incremental solver whether it has seen every mutation since its last
solve (`changes_since`), node nomination, mark-for-deletion, and the
consolidated bit that every mutation clears and that expires after
CONSOLIDATED_TTL on the cluster's clock.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Set, Tuple

from karpenter_core_tpu_torch.kube.objects import (
    LABEL_INSTANCE_TYPE_STABLE,
    NamespacedName,
    object_key,
)
from karpenter_core_tpu_torch.state.node import StateNode, populate_volume_limits_from
from karpenter_core_tpu_torch.utils import podutils


class Cluster:
    """cluster.go:44-60."""

    # change-feed history bound: a consumer further behind than this many
    # mutations gets a full-resync verdict instead of a partial diff
    CHANGE_RING = 8192
    # the consolidated bit's forced re-check interval (cluster.go:277-286)
    CONSOLIDATED_TTL = 5 * 60.0

    def __init__(self, kube_client, cloud_provider=None, clock=None):
        self.kube_client = kube_client
        self.cloud_provider = cloud_provider
        self.clock = clock if clock is not None else time.time
        self._mu = threading.RLock()
        self._consolidated = False
        self._consolidated_at = 0.0
        self.nodes_by_provider_id: Dict[str, StateNode] = {}
        self.node_name_to_provider_id: Dict[str, str] = {}
        self.machine_name_to_provider_id: Dict[str, str] = {}
        self.bindings: Dict[NamespacedName, str] = {}  # pod -> node name
        self.anti_affinity_pods: Dict[NamespacedName, object] = {}
        # the change feed: every mutation bumps the revision and appends
        # (revision, token); the token is the touched node's provider id,
        # or "*" for a change with no single node (a provisioner update, a
        # delete of an unknown name)
        self._revision = 0
        self._changes = deque(maxlen=self.CHANGE_RING)

    # -- change feed ----------------------------------------------------------

    def _record_change(self, token: str) -> None:
        """Append one change to the bounded feed (under self._mu)."""
        self._revision += 1
        self._changes.append((self._revision, token))

    def revision(self) -> int:
        with self._mu:
            return self._revision

    def changes_since(self, cursor: Optional[int]) -> Tuple[int, Optional[Set[str]]]:
        """(new cursor, the tokens changed since `cursor`), or (new cursor,
        None) when the feed cannot prove it holds the whole history: a
        cursor that is None, from the future, or older than the ring
        remembers. Revisions are dense, so a gap is detected, never
        skipped; repeated changes collapse into one token."""
        with self._mu:
            rev = self._revision
            if cursor is None or cursor > rev:
                return rev, None
            if cursor == rev:
                return rev, set()
            oldest = self._changes[0][0] if self._changes else rev + 1
            if cursor + 1 < oldest:
                return rev, None  # history fell off the ring
            changed: Set[str] = set()
            for r, token in reversed(self._changes):
                if r <= cursor:
                    break
                changed.add(token)
            return rev, changed

    # -- queries (cluster.go:116-156) ---------------------------------------

    def nodes(self) -> List[StateNode]:
        """A deep-copied snapshot of every node (cluster.go:149-156)."""
        with self._mu:
            return [n.deep_copy() for n in self.nodes_by_provider_id.values()]

    def for_each_node(self, fn: Callable[[StateNode], bool]) -> None:
        """Visit the live nodes (not copies) until fn returns False."""
        with self._mu:
            nodes = list(self.nodes_by_provider_id.values())
        for node in nodes:
            if not fn(node):
                return

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
        """The state node of a Node or Machine name."""
        with self._mu:
            pid = (self.node_name_to_provider_id.get(name)
                   or self.machine_name_to_provider_id.get(name))
            return None if pid is None else self.nodes_by_provider_id.get(pid)

    # -- nomination and deletion marks (cluster.go:160-202) -----------------

    def nominate_node_for_pod(self, node_name: str) -> None:
        with self._mu:
            node = self.node_for(node_name)
            if node is not None:
                node.nominate()

    def mark_for_deletion(self, *node_names: str) -> None:
        with self._mu:
            for name in node_names:
                node = self.node_for(name)
                if node is not None:
                    node.marked_for_deletion = True
                    self._record_change(node.provider_id() or "*")

    def unmark_for_deletion(self, *node_names: str) -> None:
        with self._mu:
            for name in node_names:
                node = self.node_for(name)
                if node is not None:
                    node.marked_for_deletion = False
                    self._record_change(node.provider_id() or "*")

    # -- the consolidated bit (cluster.go:269-286) ---------------------------

    def set_consolidated(self, consolidated: bool) -> None:
        with self._mu:
            self._consolidated = consolidated
            if consolidated:
                self._consolidated_at = self.clock()

    def consolidated(self) -> bool:
        """True while nothing changed since the last full consolidation
        pass, for at most CONSOLIDATED_TTL."""
        with self._mu:
            if self.clock() - self._consolidated_at > self.CONSOLIDATED_TTL:
                self._consolidated = False
            return self._consolidated

    # -- ingestion (cluster.go:204-267,341-505) -------------------------------

    def update_node(self, node) -> None:
        with self._mu:
            provider_id = node.spec.provider_id or f"node:///{node.metadata.name}"
            existing = self.nodes_by_provider_id.get(provider_id)
            if existing is None:
                existing = StateNode(node, clock=self.clock)
                # claims resolve to their drivers through the store
                existing.volume_usage.kube_client = self.kube_client
                self.nodes_by_provider_id[provider_id] = existing
            else:
                existing.node = node
            self.node_name_to_provider_id[node.metadata.name] = provider_id
            self._populate_inflight(existing)
            populate_volume_limits_from(self.kube_client, existing)
            self._record_change(provider_id)
            self.set_consolidated(False)

    def delete_node(self, name: str) -> None:
        """cluster.go:239-251: a node backed by a Machine record leaves the
        machine's state node behind."""
        with self._mu:
            pid = self.node_name_to_provider_id.pop(name, None)
            if pid is not None:
                state_node = self.nodes_by_provider_id.get(pid)
                if state_node is not None:
                    if state_node.machine is not None:
                        state_node.node = None
                    else:
                        del self.nodes_by_provider_id[pid]
            self._record_change(pid or "*")
            self.set_consolidated(False)

    def update_machine(self, machine) -> None:
        """cluster.go:204-236: a machine is tracked once the cloud provider
        gave it a provider id."""
        with self._mu:
            if not machine.status.provider_id:
                return
            provider_id = machine.status.provider_id
            existing = self.nodes_by_provider_id.get(provider_id)
            if existing is None:
                # as the reference's: this state node's volume usage gets no
                # kube client, also once its Node registers (ROADMAP Queue C)
                existing = StateNode(machine=machine, clock=self.clock)
                self.nodes_by_provider_id[provider_id] = existing
            else:
                existing.machine = machine
            self.machine_name_to_provider_id[machine.name] = provider_id
            self._record_change(provider_id)
            self.set_consolidated(False)

    def delete_machine(self, name: str) -> None:
        """cluster.go:299-317: a machine whose Node lives on leaves the
        node's state node behind."""
        with self._mu:
            pid = self.machine_name_to_provider_id.pop(name, None)
            if pid is not None:
                state_node = self.nodes_by_provider_id.get(pid)
                if state_node is not None:
                    if state_node.node is not None:
                        state_node.machine = None
                    else:
                        del self.nodes_by_provider_id[pid]
            self._record_change(pid or "*")
            self.set_consolidated(False)

    def _populate_inflight(self, state_node: StateNode) -> None:
        """The capacity and allocatable of the node's instance type, which
        stand in for the node's own until it reports them
        (cluster.go:388-428)."""
        if self.cloud_provider is None or state_node.node is None:
            return
        it_name = state_node.labels().get(LABEL_INSTANCE_TYPE_STABLE)
        if not it_name:
            return
        try:
            for it in self.cloud_provider.get_instance_types(None):
                if it.name == it_name:
                    state_node.inflight_capacity = dict(it.capacity)
                    state_node.inflight_allocatable = dict(it.allocatable())
                    break
        except Exception:  # noqa: BLE001 — in-flight capacity is best effort
            pass

    def update_provisioner(self, provisioner) -> None:
        """A provisioner changed (informer/provisioner.go:52): templates,
        not node rows, so the change has no node scope."""
        with self._mu:
            self._record_change("*")
            self.set_consolidated(False)

    def update_pod(self, pod) -> None:
        """cluster.go:446-505: bindings, per-node usage and the
        anti-affinity index."""
        with self._mu:
            key = object_key(pod)
            if podutils.is_terminal(pod):
                self._unbind(key)
                self.anti_affinity_pods.pop(key, None)
                self.set_consolidated(False)
                return
            old_node_name = self.bindings.get(key)
            if pod.spec.node_name:
                if old_node_name and old_node_name != pod.spec.node_name:
                    self._unbind(key)
                self.bindings[key] = pod.spec.node_name
                node = self.node_for(pod.spec.node_name)
                if node is not None:
                    node.update_for_pod(pod)
                    self._record_change(node.provider_id() or "*")
                if podutils.has_pod_anti_affinity(pod):
                    self.anti_affinity_pods[key] = pod
            self.set_consolidated(False)

    def delete_pod(self, key: NamespacedName) -> None:
        with self._mu:
            self._unbind(key)
            self.anti_affinity_pods.pop(key, None)
            self.set_consolidated(False)

    def _unbind(self, key: NamespacedName) -> None:
        node_name = self.bindings.pop(key, None)
        if node_name:
            node = self.node_for(node_name)
            if node is not None:
                node.cleanup_for_pod(key)
                # a termination frees room on the node
                self._record_change(node.provider_id() or "*")
