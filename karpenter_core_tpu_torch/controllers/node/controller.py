"""The node controller: initialization, the emptiness timestamp, the
termination finalizer and drift (node/{controller,initialization,
emptiness,finalizer,drift}.go). It acts only on nodes a provisioner
owns."""
from __future__ import annotations

import time
from typing import Optional

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.api.machine import Machine
from karpenter_core_tpu_torch.api.settings import current as current_settings
from karpenter_core_tpu_torch.utils import podutils


class NodeController:
    """node/controller.go:60-130."""

    DRIFT_REQUEUE = 5 * 60.0

    def __init__(self, kube_client, cloud_provider, cluster, clock=None):
        self.kube_client = kube_client
        self.cloud_provider = cloud_provider
        self.cluster = cluster
        self.clock = clock if clock is not None else time.time

    def reconcile(self, node) -> Optional[float]:
        provisioner_name = node.metadata.labels.get(api_labels.PROVISIONER_NAME_LABEL_KEY)
        if not provisioner_name or node.metadata.deletion_timestamp is not None:
            return None
        provisioner = self.kube_client.get("Provisioner", "", provisioner_name)
        if provisioner is None:
            return None
        changed = False
        changed |= self._initialization(node)
        changed |= self._emptiness(node, provisioner)
        changed |= self._finalizer(node)
        requeue = self._drift(node)
        if changed:
            self.kube_client.apply(node)
            self.cluster.update_node(node)
        return requeue

    def _initialization(self, node) -> bool:
        """node/initialization.go:39-70: a ready node without a Machine
        record gets the initialized label (the machine controller
        initializes the others)."""
        if node.metadata.labels.get(api_labels.LABEL_NODE_INITIALIZED) == "true":
            return False
        if not node.ready():
            return False
        state_node = self.cluster.node_for(node.metadata.name)
        if state_node is not None and state_node.machine is not None:
            return False
        node.metadata.labels[api_labels.LABEL_NODE_INITIALIZED] = "true"
        return True

    def _emptiness(self, node, provisioner) -> bool:
        """node/emptiness.go:44-90: stamp the time an initialized node
        became empty of non-daemon pods; remove the stamp when it is not."""
        if provisioner.spec.ttl_seconds_after_empty is None:
            return False
        if node.metadata.labels.get(api_labels.LABEL_NODE_INITIALIZED) != "true":
            return False
        empty = not any(
            not podutils.is_terminal(p) and not podutils.is_owned_by_daemonset(p)
            for p in self.kube_client.list("Pod", node_name=node.metadata.name,
                                           copy_objects=False)
        )
        key = api_labels.EMPTINESS_TIMESTAMP_ANNOTATION_KEY
        has_ts = key in node.metadata.annotations
        if empty and not has_ts:
            node.metadata.annotations[key] = str(self.clock())
            return True
        if not empty and has_ts:
            del node.metadata.annotations[key]
            return True
        return False

    def _finalizer(self, node) -> bool:
        """node/finalizer.go:36-50."""
        if api_labels.TERMINATION_FINALIZER not in node.metadata.finalizers:
            node.metadata.finalizers.append(api_labels.TERMINATION_FINALIZER)
            return True
        return False

    def _drift(self, node) -> Optional[float]:
        """node/drift.go:38-55: behind the feature gate, annotate a node
        the cloud provider reports drifted; requeue every 5 minutes."""
        if not current_settings().drift_enabled:
            return None
        key = api_labels.VOLUNTARY_DISRUPTION_ANNOTATION_KEY
        if node.metadata.annotations.get(key) == api_labels.VOLUNTARY_DISRUPTION_DRIFTED_VALUE:
            return None
        machine_name = node.metadata.labels.get(api_labels.MACHINE_NAME_LABEL_KEY)
        machine = self.kube_client.get("Machine", "", machine_name) if machine_name else None
        if machine is None:
            machine = Machine()
            machine.metadata.name = node.metadata.name
            machine.status.provider_id = node.spec.provider_id
        try:
            drifted = self.cloud_provider.is_machine_drifted(machine)
        except Exception:  # noqa: BLE001 — try again at the next requeue
            return self.DRIFT_REQUEUE
        if drifted:
            node.metadata.annotations[key] = api_labels.VOLUNTARY_DISRUPTION_DRIFTED_VALUE
            self.kube_client.apply(node)
            self.cluster.update_node(node)
        return self.DRIFT_REQUEUE
