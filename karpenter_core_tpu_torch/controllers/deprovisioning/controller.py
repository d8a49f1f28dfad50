"""The deprovisioning controller: the ordered chain of deprovisioners and
the execution of their Commands (deprovisioning/controller.go:72-253).

Each reconcile walks Expiration, Drift, Emptiness, EmptyNodeConsolidation,
MultiNodeConsolidation and SingleNodeConsolidation, and executes the first
Command that acts; when none acts the cluster is marked consolidated. A
replace cordons the nodes, launches the replacements, marks the nodes for
deletion and waits for the replacements to initialize, rolling the
cordons and marks back when a launch fails or the wait times out; then
the nodes are deleted (their termination finalizer drains them, and each
deletion is announced as a DeprovisioningTerminating event) and the
deletion is waited for. On a clock other than time.time both waits
return at once: the caller steps the lifecycle controllers.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

from karpenter_core_tpu_torch.api.labels import LABEL_NODE_INITIALIZED
from karpenter_core_tpu_torch.controllers.deprovisioning.consolidation import (
    EmptyNodeConsolidation,
    MultiNodeConsolidation,
    SingleNodeConsolidation,
)
from karpenter_core_tpu_torch.controllers.deprovisioning.core import (
    ACTION_DO_NOTHING,
    ACTION_REPLACE,
    ACTION_RETRY,
    Command,
    candidate_nodes,
)
from karpenter_core_tpu_torch.controllers.deprovisioning.deprovisioners import (
    Drift,
    Emptiness,
    Expiration,
)
from karpenter_core_tpu_torch.kube.client import NotFoundError
from karpenter_core_tpu_torch.metrics.registry import (
    NAMESPACE,
    NODES_CREATED,
    NODES_TERMINATED,
    REGISTRY,
)
from karpenter_core_tpu_torch.obs.log import get_logger

LOG = get_logger("karpenter.deprovisioning")

MAX_READINESS_WAIT = 9.5 * 60.0  # controller.go:62-70

# commands executed, by "<deprovisioner>/<action>"; the replacements it
# launches count in karpenter_nodes_created{reason="deprovisioning"} and
# the nodes it deletes in karpenter_nodes_terminated{reason=<deprovisioner>}
ACTIONS = REGISTRY.counter(f"{NAMESPACE}_deprovisioning_actions_performed")
# the reasons the chain's deprovisioners terminate under (their names)
DEPROVISIONER_REASONS = ("expiration", "drift", "emptiness", "consolidation")


def nodes_created() -> int:
    """Replacement nodes the deprovisioning controller launched."""
    return int(NODES_CREATED.get({"reason": "deprovisioning"}))


def nodes_terminated() -> int:
    """Nodes the deprovisioning controller deleted."""
    return int(sum(NODES_TERMINATED.get({"reason": r}) for r in DEPROVISIONER_REASONS))


def reset_counts() -> None:
    ACTIONS.clear()
    NODES_CREATED.clear({"reason": "deprovisioning"})
    for reason in DEPROVISIONER_REASONS:
        NODES_TERMINATED.clear({"reason": reason})


class DeprovisioningController:
    """controller.go:72-141. readiness_wait and readiness_poll (seconds)
    bound and pace the wait for replacements on time.time."""

    readiness_wait = MAX_READINESS_WAIT
    readiness_poll = 1.0

    def __init__(self, kube_client, cluster, provisioning, cloud_provider, recorder=None,
                 clock=None, validation_ttl: float = 15.0):
        self.kube_client = kube_client
        self.cluster = cluster
        self.provisioning = provisioning
        self.cloud_provider = cloud_provider
        self.recorder = recorder
        self.clock = clock if clock is not None else time.time
        args = (kube_client, cluster, provisioning, cloud_provider, recorder)
        kwargs = dict(clock=self.clock, validation_ttl=validation_ttl)
        self.deprovisioners = [
            Expiration(*args, **kwargs),
            Drift(*args, **kwargs),
            Emptiness(*args, **kwargs),
            EmptyNodeConsolidation(*args, **kwargs),
            MultiNodeConsolidation(*args, **kwargs),
            SingleNodeConsolidation(*args, **kwargs),
        ]

    def reconcile(self, stop: Optional[threading.Event] = None) -> bool:
        """One pass over the chain; True if a Command was executed
        (controller.go:107-141). Once `stop` (the operator's) is set the
        pass ends before its next deprovisioner and before a command, as a
        cancelled context ends upstream's: a process that is giving up its
        lease must not act."""
        for deprovisioner in self.deprovisioners:
            if stop is not None and stop.is_set():
                return False
            candidates = candidate_nodes(self.cluster, self.kube_client, self.cloud_provider,
                                         deprovisioner.should_deprovision, self.clock)
            if not candidates:
                continue
            cmd = deprovisioner.compute_command(candidates)
            if cmd.action == ACTION_DO_NOTHING:
                continue
            if cmd.action == ACTION_RETRY or (stop is not None and stop.is_set()):
                return False
            self.execute_command(deprovisioner, cmd)
            return True
        self.cluster.set_consolidated(True)
        return False

    def execute_command(self, deprovisioner, cmd: Command) -> None:
        """controller.go:143-194: launch any replacements first, then
        delete the nodes and wait for their deletion."""
        ACTIONS.inc({"action": f"{deprovisioner}/{cmd.action}"})
        LOG.info("deprovisioning command", deprovisioner=str(deprovisioner),
                 action=cmd.action, nodes=[n.metadata.name for n in cmd.nodes_to_remove],
                 replacements=len(cmd.replacement_machines or ()))
        if cmd.action == ACTION_REPLACE:
            if not self._launch_replacements(cmd):
                return
        for node in cmd.nodes_to_remove:
            if self.recorder:
                self.recorder.deprovisioning_terminating(node.metadata.name, str(cmd))
            try:
                self.kube_client.delete("Node", "", node.metadata.name)
                NODES_TERMINATED.inc({"reason": str(deprovisioner)})
            except NotFoundError:
                pass  # already gone
        self._wait_for_deletion(cmd.nodes_to_remove)

    def _launch_replacements(self, cmd: Command) -> bool:
        """controller.go:198-253: cordon, launch, mark for deletion, wait
        for the replacements to initialize; roll back on failure."""
        names = [n.metadata.name for n in cmd.nodes_to_remove]
        self._set_unschedulable(names, True)
        launched = self.provisioning.launch_machines(cmd.replacement_machines)
        if any(not n for n in launched):
            self._set_unschedulable(names, False)
            return False
        NODES_CREATED.inc({"reason": "deprovisioning"}, len(launched))
        self.cluster.mark_for_deletion(*names)
        deadline = self.clock() + self.readiness_wait
        while True:
            if all(self._initialized(name) for name in launched):
                return True
            if self.clock() >= deadline:
                self.cluster.unmark_for_deletion(*names)
                self._set_unschedulable(names, False)
                return False
            if self.clock is not time.time:
                return True  # a test clock: the caller drives initialization
            time.sleep(self.readiness_poll)

    def _initialized(self, node_name: str) -> bool:
        node = self.kube_client.get("Node", "", node_name)
        return node is not None and node.metadata.labels.get(LABEL_NODE_INITIALIZED) == "true"

    def _wait_for_deletion(self, nodes: List) -> None:
        """controller.go:175-194, bounded at 30 s; a test clock returns at
        once."""
        if self.clock is not time.time:
            return
        deadline = self.clock() + 30.0
        for node in nodes:
            while self.clock() < deadline:
                if self.kube_client.get("Node", "", node.metadata.name) is None:
                    break
                time.sleep(0.1)

    def _set_unschedulable(self, names: List[str], unschedulable: bool) -> None:
        for name in names:
            node = self.kube_client.get("Node", "", name)
            if node is None:
                continue
            if not unschedulable and node.metadata.deletion_timestamp is not None:
                continue
            if node.spec.unschedulable == unschedulable:
                continue
            node.spec.unschedulable = unschedulable
            self.kube_client.update(node)
