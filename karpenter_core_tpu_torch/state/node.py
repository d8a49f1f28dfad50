"""StateNode: the cluster's view of one node and/or its Machine record
(state/node.go).

A node launched by a provisioner is first a Machine (a launch intent the
cloud provider resolved to a provider id, capacity and allocatable), then
a Machine with a registered Node, and is initialized once the machine
controller has seen the node ready. Until then the name, labels,
annotations, taints, capacity and allocatable read through the Machine,
the node's zero values backfilled from the machine's; a node without a
Machine record that is not initialized yet backfills from the in-flight
capacity of its instance type (node.go:137-221). The state node also
keeps the requests and limits of the pods bound to it, the host ports they hold, the
volumes they mount and the node's CSI attach limits, and the
consolidation state: marked for deletion, and nominated for pods until a
deadline on the node's clock.
"""
from __future__ import annotations

import copy
import time
from typing import Dict, List

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.api.machine import CONDITION_MACHINE_INITIALIZED
from karpenter_core_tpu_torch.kube.objects import (
    LABEL_HOSTNAME,
    TAINT_NODE_NOT_READY,
    TAINT_NODE_UNREACHABLE,
    NamespacedName,
    ResourceList,
    Taint,
    object_key,
)
from karpenter_core_tpu_torch.scheduling.hostportusage import HostPortUsage
from karpenter_core_tpu_torch.scheduling.volumeusage import VolumeCount, VolumeUsage
from karpenter_core_tpu_torch.utils import podutils, resources


class StateNode:
    def __init__(self, node=None, machine=None, clock=None):
        self.node = node
        self.machine = machine
        self.clock = clock if clock is not None else time.time
        self.marked_for_deletion = False
        self.nominated_until = 0.0
        self.inflight_allocatable: ResourceList = {}
        self.inflight_capacity: ResourceList = {}
        self.startup_taints: List[Taint] = []
        self.pod_requests: Dict[NamespacedName, ResourceList] = {}
        self.pod_limits: Dict[NamespacedName, ResourceList] = {}
        self.daemonset_requests: Dict[NamespacedName, ResourceList] = {}
        self.daemonset_limits: Dict[NamespacedName, ResourceList] = {}
        self.hostport_usage = HostPortUsage()
        self.volume_usage = VolumeUsage()
        self.volume_limits = VolumeCount()

    # -- identity (node.go:108-146) ------------------------------------------

    def _machine_view(self) -> bool:
        """Read through the Machine: it exists and the node is not
        initialized yet."""
        return self.machine is not None and not self.initialized()

    def name(self) -> str:
        if self._machine_view():
            return self.machine.name
        return self.node.name if self.node is not None else ""

    def provider_id(self) -> str:
        if self.node is not None and self.node.spec.provider_id:
            return self.node.spec.provider_id
        if self.machine is not None:
            return self.machine.status.provider_id
        return ""

    def hostname(self) -> str:
        return self.labels().get(LABEL_HOSTNAME) or self.name()

    def labels(self) -> Dict[str, str]:
        if self._machine_view():
            return self.machine.metadata.labels
        return self.node.metadata.labels if self.node is not None else {}

    def annotations(self) -> Dict[str, str]:
        if self._machine_view():
            return self.machine.metadata.annotations
        return self.node.metadata.annotations if self.node is not None else {}

    # -- lifecycle (node.go:75-113,181-231) -----------------------------------

    def initialized(self) -> bool:
        """A machine's node is initialized once the machine says so; a node
        without a Machine record once it carries the initialized label."""
        if self.machine is not None:
            return self.node is not None and self.machine.condition_true(
                CONDITION_MACHINE_INITIALIZED)
        if self.node is not None:
            return self.node.metadata.labels.get(api_labels.LABEL_NODE_INITIALIZED) == "true"
        return False

    def owned(self) -> bool:
        return self.labels().get(api_labels.PROVISIONER_NAME_LABEL_KEY, "") != ""

    def is_marked_for_deletion(self) -> bool:
        """Marked by the deprovisioner, or terminating: the Machine record,
        or the Node when no Machine backs it."""
        return (
            self.marked_for_deletion
            or (self.machine is not None
                and self.machine.metadata.deletion_timestamp is not None)
            or (self.node is not None and self.machine is None
                and self.node.metadata.deletion_timestamp is not None)
        )

    def nominate(self, settings=None) -> None:
        """Hold the node for pods the provisioner bound to it in
        simulation, for one nomination window (node.go:75-113)."""
        self.nominated_until = self.clock() + nomination_window(settings)

    def nominated(self) -> bool:
        return self.nominated_until > self.clock()

    # -- scheduling views (node.go:148-221) ------------------------------------

    def taints(self) -> List[Taint]:
        """Ephemeral and, before initialization, startup taints are
        masked (node.go:148-176)."""
        ephemeral = [
            Taint(key=TAINT_NODE_NOT_READY, effect="NoSchedule"),
            Taint(key=TAINT_NODE_UNREACHABLE, effect="NoSchedule"),
        ]
        initialized = self.initialized()
        if not initialized and self.owned():
            if self.machine is not None:
                ephemeral.extend(self.machine.spec.startup_taints)
            else:
                ephemeral.extend(self.startup_taints)
        if not initialized and self.machine is not None:
            taints = self.machine.spec.taints
        else:
            taints = self.node.spec.taints if self.node is not None else []
        return [t for t in taints if t not in ephemeral]

    def capacity(self) -> ResourceList:
        return self._capacity_like(lambda o: o.status.capacity, self.inflight_capacity)

    def allocatable(self) -> ResourceList:
        return self._capacity_like(lambda o: o.status.allocatable, self.inflight_allocatable)

    def _capacity_like(self, view, inflight: ResourceList) -> ResourceList:
        """node.go:194-221: before initialization the machine's (or, with
        no Machine record, the in-flight) values fill the node's zero
        values; after it, the node's alone."""
        if not self.initialized():
            if self.machine is not None:
                if self.node is None:
                    return dict(view(self.machine))
                ret = dict(view(self.node))
                for name, q in view(self.machine).items():
                    if not ret.get(name):
                        ret[name] = q
                return ret
            if self.owned() and self.node is not None:
                ret = dict(view(self.node))
                for name, q in inflight.items():
                    if not ret.get(name):
                        ret[name] = q
                return ret
        return dict(view(self.node)) if self.node is not None else {}

    def available(self) -> ResourceList:
        return resources.subtract(self.allocatable(), self.total_pod_requests())

    def total_pod_requests(self) -> ResourceList:
        return resources.merge(*self.pod_requests.values()) if self.pod_requests else {}

    def total_pod_limits(self) -> ResourceList:
        return resources.merge(*self.pod_limits.values()) if self.pod_limits else {}

    def total_daemonset_requests(self) -> ResourceList:
        if not self.daemonset_requests:
            return {}
        return resources.merge(*self.daemonset_requests.values())

    def total_daemonset_limits(self) -> ResourceList:
        if not self.daemonset_limits:
            return {}
        return resources.merge(*self.daemonset_limits.values())

    def update_for_pod(self, pod) -> None:
        """Account a pod bound to this node (node.go:293-307): its
        requests and limits, host ports and volumes."""
        key = object_key(pod)
        self.pod_requests[key] = resources.requests_for_pods(pod)
        self.pod_limits[key] = resources.limits_for_pods(pod)
        if podutils.is_owned_by_daemonset(pod):
            self.daemonset_requests[key] = resources.requests_for_pods(pod)
            self.daemonset_limits[key] = resources.limits_for_pods(pod)
        self.hostport_usage.add(pod)
        self.volume_usage.add(pod)

    def cleanup_for_pod(self, key: NamespacedName) -> None:
        """Forget a pod that left this node (node.go:309-321)."""
        self.hostport_usage.delete_pod(key)
        self.volume_usage.delete_pod(key)
        self.pod_requests.pop(key, None)
        self.pod_limits.pop(key, None)
        self.daemonset_requests.pop(key, None)
        self.daemonset_limits.pop(key, None)

    def deep_copy(self) -> "StateNode":
        out = StateNode(copy.deepcopy(self.node), copy.deepcopy(self.machine),
                        clock=self.clock)
        out.inflight_allocatable = dict(self.inflight_allocatable)
        out.inflight_capacity = dict(self.inflight_capacity)
        out.marked_for_deletion = self.marked_for_deletion
        out.nominated_until = self.nominated_until
        out.startup_taints = list(self.startup_taints)
        out.pod_requests = {k: dict(v) for k, v in self.pod_requests.items()}
        out.daemonset_requests = {k: dict(v) for k, v in self.daemonset_requests.items()}
        out.pod_limits = {k: dict(v) for k, v in self.pod_limits.items()}
        out.daemonset_limits = {k: dict(v) for k, v in self.daemonset_limits.items()}
        out.hostport_usage = self.hostport_usage.deep_copy()
        out.volume_usage = self.volume_usage.deep_copy()
        out.volume_limits = VolumeCount(self.volume_limits)
        return out


def nomination_window(settings=None) -> float:
    """max(10 s, 2 x batchMaxDuration) (node.go:328-334)."""
    from karpenter_core_tpu_torch.api.settings import current

    s = settings or current()
    return max(10.0, 2.0 * s.batch_max_duration)


def populate_volume_limits_from(kube_client, state_node: StateNode) -> None:
    """The CSINode -> volume_limits rule (cluster.go:430-444): each
    driver's allocatable count onto the state node."""
    if state_node.node is None:
        return
    csinode = kube_client.get("CSINode", "", state_node.node.metadata.name)
    if csinode is None:
        return
    for driver in csinode.drivers:
        if driver.allocatable_count is not None:
            state_node.volume_limits[driver.name] = driver.allocatable_count


def resolve_volume_limits(state_nodes, kube_client) -> None:
    """Fill EMPTY volume limits from the CSINode objects, for state nodes
    that did not come through a Cluster (which applies the rule on every
    node update). Populated nodes are left as they are: a solve's state
    nodes are a snapshot taken for that solve."""
    if kube_client is None:
        return
    for sn in state_nodes or []:
        if sn.node is None or sn.volume_limits:
            continue
        populate_volume_limits_from(kube_client, sn)
