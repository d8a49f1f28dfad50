"""Metrics scrapers: node/pod/provisioner gauges.

Mirrors reference pkg/controllers/metrics/{state/scraper/node.go, pod,
provisioner}: a 5s singleton scrape publishing node allocatable / pod
requests+limits / daemon overhead gauges labeled by well-known labels, the
per-pod phase gauge, and per-provisioner limit/usage gauges.
"""
from __future__ import annotations

import time

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.kube.objects import (
    LABEL_ARCH_STABLE,
    LABEL_INSTANCE_TYPE_STABLE,
    LABEL_OS_STABLE,
    LABEL_TOPOLOGY_REGION,
    LABEL_TOPOLOGY_ZONE,
)
from karpenter_core_tpu_torch.metrics.registry import NAMESPACE, REGISTRY

SCRAPE_PERIOD = 5.0

_WELL_KNOWN_GAUGE_LABELS = {
    "zone": LABEL_TOPOLOGY_ZONE,
    "region": LABEL_TOPOLOGY_REGION,
    "instance_type": LABEL_INSTANCE_TYPE_STABLE,
    "arch": LABEL_ARCH_STABLE,
    "os": LABEL_OS_STABLE,
    "capacity_type": api_labels.LABEL_CAPACITY_TYPE,
    "provisioner": api_labels.PROVISIONER_NAME_LABEL_KEY,
}


def _node_labels(state_node):
    """A node's series labels but resource_type, built once per node: each
    of its series adds its own resource_type."""
    labels = {"node_name": state_node.name()}
    node_labels = state_node.labels()
    for gauge_label, node_label in _WELL_KNOWN_GAUGE_LABELS.items():
        labels[gauge_label] = node_labels.get(node_label, "")
    return labels


class NodeMetricsController:
    """metrics/state/scraper/node.go:28-115."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.allocatable = REGISTRY.gauge(f"{NAMESPACE}_nodes_allocatable")
        self.pod_requests = REGISTRY.gauge(f"{NAMESPACE}_nodes_total_pod_requests")
        self.pod_limits = REGISTRY.gauge(f"{NAMESPACE}_nodes_total_pod_limits")
        self.daemon_requests = REGISTRY.gauge(f"{NAMESPACE}_nodes_total_daemon_requests")
        self.daemon_limits = REGISTRY.gauge(f"{NAMESPACE}_nodes_total_daemon_limits")
        self.overhead = REGISTRY.gauge(f"{NAMESPACE}_nodes_system_overhead")

    def reconcile(self) -> float:
        # build-then-swap: the old clear()-before-repopulate left a window
        # where a concurrent REGISTRY.expose() observed an empty/partial
        # scrape. Each gauge's new series set is built in full here and
        # swapped atomically under the gauge lock (Gauge.replace_all) —
        # a scrape sees the previous generation or the new one, never a
        # blank exposition mid-rebuild.
        series = {
            gauge: []
            for gauge in (
                self.allocatable, self.pod_requests, self.pod_limits,
                self.daemon_requests, self.daemon_limits, self.overhead,
            )
        }
        for state_node in self.cluster.nodes():
            base = _node_labels(state_node)
            for name, q in state_node.allocatable().items():
                series[self.allocatable].append((q, {**base, "resource_type": name}))
            for name, q in state_node.total_pod_requests().items():
                series[self.pod_requests].append((q, {**base, "resource_type": name}))
            for name, q in state_node.total_pod_limits().items():
                series[self.pod_limits].append((q, {**base, "resource_type": name}))
            for name, q in state_node.total_daemonset_requests().items():
                series[self.daemon_requests].append((q, {**base, "resource_type": name}))
            for name, q in state_node.total_daemonset_limits().items():
                series[self.daemon_limits].append((q, {**base, "resource_type": name}))
            capacity = state_node.capacity()
            allocatable = state_node.allocatable()
            for name, q in capacity.items():
                series[self.overhead].append(
                    (q - allocatable.get(name, 0.0), {**base, "resource_type": name})
                )
        for gauge, pairs in series.items():
            gauge.replace_all(pairs)
        return SCRAPE_PERIOD


class PodMetricsController:
    """metrics/pod/controller.go:118-163: cleanup-then-record — every event
    first drops the pod's previous gauge (so phase transitions don't leave
    stale series) and re-records unless the pod is gone."""

    def __init__(self, kube_client, clock=time.time):
        self.kube_client = kube_client
        self.clock = clock
        self.state = REGISTRY.gauge(f"{NAMESPACE}_pods_state")
        self.startup = REGISTRY.histogram(f"{NAMESPACE}_pods_startup_time_seconds")
        self._started = set()
        self._labels = {}  # (namespace, name) -> last recorded label set

    def reconcile(self, pod, deleted: bool = False) -> None:
        key = (pod.metadata.namespace, pod.metadata.name)
        prev = self._labels.pop(key, None)
        if prev is not None:
            self.state.delete(prev)
        if deleted:
            self._started.discard(pod.metadata.uid)
            return
        labels = {
            "name": pod.metadata.name,
            "namespace": pod.metadata.namespace,
            "phase": pod.status.phase,
            "node": pod.spec.node_name,
        }
        self.state.set(1.0, labels)
        self._labels[key] = labels
        if pod.status.phase == "Running" and pod.metadata.uid not in self._started:
            self._started.add(pod.metadata.uid)
            # observation guard: an unset/zero creationTimestamp would
            # record a multi-decade startup and negative clock skew a
            # negative one — both corrupt every percentile of the
            # histogram, so the observation is skipped (the pod still
            # counts as started: re-observing later would be worse)
            created = pod.metadata.creation_timestamp
            if created:
                elapsed = self.clock() - created
                if elapsed >= 0.0:
                    self.startup.observe(elapsed)


class ProvisionerMetricsController:
    """metrics/provisioner/controller.go:107-135: cleanup-then-record — the
    previous gauge set is dropped on every event so resource-type changes and
    provisioner deletion don't leave stale series."""

    def __init__(self, kube_client):
        self.kube_client = kube_client
        self.limit = REGISTRY.gauge(f"{NAMESPACE}_provisioner_limit")
        self.usage = REGISTRY.gauge(f"{NAMESPACE}_provisioner_usage")
        self.usage_pct = REGISTRY.gauge(f"{NAMESPACE}_provisioner_usage_pct")
        self._labels = {}  # provisioner name -> [(gauge, labels), ...]

    def reconcile(self, provisioner, deleted: bool = False) -> None:
        for gauge, labels in self._labels.pop(provisioner.name, []):
            gauge.delete(labels)
        if deleted:
            return
        recorded = []
        base = {"provisioner": provisioner.name}
        if provisioner.spec.limits is not None:
            for name, q in provisioner.spec.limits.resources.items():
                labels = {**base, "resource_type": name}
                self.limit.set(q, labels)
                recorded.append((self.limit, labels))
        for name, q in provisioner.status.resources.items():
            labels = {**base, "resource_type": name}
            self.usage.set(q, labels)
            recorded.append((self.usage, labels))
            if (
                provisioner.spec.limits is not None
                and provisioner.spec.limits.resources.get(name)
            ):
                self.usage_pct.set(
                    q / provisioner.spec.limits.resources[name] * 100.0, labels
                )
                recorded.append((self.usage_pct, labels))
        self._labels[provisioner.name] = recorded

    def prune(self, live_names) -> None:
        """Drop series for provisioners no longer in the cluster — the
        level-triggered analog of reconciling a NotFound key
        (controller.go:117-123)."""
        for name in set(self._labels) - set(live_names):
            for gauge, labels in self._labels.pop(name, []):
                gauge.delete(labels)
