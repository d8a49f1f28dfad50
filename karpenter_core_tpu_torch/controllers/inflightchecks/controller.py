"""Node health reported as events (pkg/controllers/inflightchecks): a
node not initialized an hour after its creation, with what holds it
(failedinit.go:30-82); a node whose capacity is under 90% of what its
machine promised (nodeshape.go:26-76); a deleted node whose drain a
PodDisruptionBudget or a do-not-evict pod blocks (termination.go:26-55).
The recorder deduplicates the repeats; a node is checked every 10 minutes.
"""
from __future__ import annotations

import time
from typing import List, Optional

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.controllers.deprovisioning.core import PDBLimits
from karpenter_core_tpu_torch.utils import podutils

FAILED_INIT_TIMEOUT = 3600.0
NODE_SHAPE_RATIO = 0.9
PERIOD = 10 * 60.0


class InflightChecksController:
    def __init__(self, kube_client, cloud_provider, cluster, recorder, clock=None):
        self.kube_client = kube_client
        self.cloud_provider = cloud_provider
        self.cluster = cluster
        self.recorder = recorder
        self.clock = clock if clock is not None else time.time

    def reconcile(self, node) -> Optional[float]:
        if not node.metadata.labels.get(api_labels.PROVISIONER_NAME_LABEL_KEY):
            return None
        messages: List[str] = []
        messages += self._failed_init(node)
        messages += self._node_shape(node)
        messages += self._termination(node)
        for message in messages:
            self.recorder.node_inflight_check(node, message)
        return PERIOD

    def _failed_init(self, node) -> List[str]:
        if node.metadata.labels.get(api_labels.LABEL_NODE_INITIALIZED) == "true":
            return []
        if self.clock() - node.metadata.creation_timestamp < FAILED_INIT_TIMEOUT:
            return []
        why = []
        if not node.ready():
            why.append("node not ready")
        state_node = self.cluster.node_for(node.metadata.name) if self.cluster else None
        if state_node is not None and state_node.machine is not None:
            startup = {(t.key, t.value, t.effect) for t in state_node.machine.spec.startup_taints}
            remaining = [t for t in node.spec.taints if (t.key, t.value, t.effect) in startup]
            if remaining:
                why.append(f"startup taints remain: {[t.key for t in remaining]}")
        return [f"Node has not initialized in over 1 hour ({'; '.join(why) or 'unknown cause'})"]

    def _node_shape(self, node) -> List[str]:
        state_node = self.cluster.node_for(node.metadata.name) if self.cluster else None
        if state_node is None or not node.ready():
            return []
        expected = state_node.inflight_capacity or (
            state_node.machine.status.capacity if state_node.machine else {})
        out = []
        for name, quantity in expected.items():
            actual = node.status.capacity.get(name, 0.0)
            if quantity and actual < NODE_SHAPE_RATIO * quantity:
                out.append(f"expected {quantity:g} of resource {name}, but found {actual:g} "
                           f"({actual / quantity:.1%} of expected)")
        return out

    def _termination(self, node) -> List[str]:
        if node.metadata.deletion_timestamp is None:
            return []
        # only pods that must move can block a drain (node.go:30-48)
        pods = [p for p in self.kube_client.list("Pod", node_name=node.metadata.name)
                if not (podutils.is_owned_by_node(p) or podutils.is_owned_by_daemonset(p)
                        or podutils.is_terminal(p) or podutils.is_terminating(p))]
        messages = []
        pdb, ok = PDBLimits(self.kube_client).can_evict_pods(pods)
        if not ok:
            messages.append(f"Can't drain node, PDB {pdb} is blocking evictions")
        blockers = [f"pod {p.metadata.namespace}/{p.metadata.name} has do-not-evict"
                    for p in pods if podutils.has_do_not_evict(p)]
        if blockers:
            messages.append(f"Can't drain node, {'; '.join(blockers)}")
        return messages
