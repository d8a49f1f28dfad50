"""The Expiration, Drift and TTL-based Emptiness deprovisioners
(deprovisioning/{expiration,drift,emptiness}.go), on the consolidation
base and the exact simulate solve."""
from __future__ import annotations

from typing import List

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.api.settings import current as current_settings
from karpenter_core_tpu_torch.controllers.deprovisioning.consolidation import Consolidation
from karpenter_core_tpu_torch.controllers.deprovisioning.core import (
    ACTION_DELETE,
    ACTION_DO_NOTHING,
    ACTION_REPLACE,
    CandidateNode,
    CandidateNodeDeletingError,
    Command,
    PDBLimits,
    can_be_terminated,
    simulate_scheduling,
)
from karpenter_core_tpu_torch.utils import podutils

FAR_FUTURE = 1e18


def expiration_time(state_node, provisioner) -> float:
    """When the node expires: its creation time plus the provisioner's
    TTLSecondsUntilExpired (never without one)."""
    if provisioner is None or provisioner.spec.ttl_seconds_until_expired is None:
        return FAR_FUTURE
    if state_node.node is not None:
        created = state_node.node.metadata.creation_timestamp
    else:
        created = state_node.machine.metadata.creation_timestamp if state_node.machine else 0.0
    return created + float(provisioner.spec.ttl_seconds_until_expired)


def _command_for(candidate: CandidateNode, new_machines) -> Command:
    """Delete the node, or replace it by the machines its pods need."""
    if not new_machines:
        return Command(nodes_to_remove=[candidate.node], action=ACTION_DELETE)
    return Command(nodes_to_remove=[candidate.node], action=ACTION_REPLACE,
                   replacement_machines=new_machines)


class Expiration(Consolidation):
    """expiration.go:44-120: the most expired node first, replaced (or
    deleted) even if not every pod would schedule."""

    def __str__(self) -> str:
        return "expiration"

    def should_deprovision(self, state_node, provisioner, pods) -> bool:
        return self.clock() > expiration_time(state_node, provisioner)

    def compute_command(self, candidates: List[CandidateNode]) -> Command:
        candidates = sorted(candidates,
                            key=lambda c: expiration_time(c.state_node, c.provisioner))
        pdbs = PDBLimits(self.kube_client)
        for candidate in candidates:
            _, ok = can_be_terminated(candidate, pdbs)
            if not ok:
                continue
            try:
                new_machines, _all_scheduled = simulate_scheduling(
                    self.kube_client, self.cluster, self.provisioning, [candidate])
            except CandidateNodeDeletingError:
                continue
            return _command_for(candidate, new_machines)
        return Command(action=ACTION_DO_NOTHING)


class Drift(Consolidation):
    """drift.go:40-103: behind the feature gate, the nodes annotated
    voluntary-disruption=drifted, each only if all its pods schedule."""

    def __str__(self) -> str:
        return "drift"

    def should_deprovision(self, state_node, provisioner, pods) -> bool:
        if not current_settings().drift_enabled:
            return False
        return (state_node.annotations().get(api_labels.VOLUNTARY_DISRUPTION_ANNOTATION_KEY)
                == api_labels.VOLUNTARY_DISRUPTION_DRIFTED_VALUE)

    def compute_command(self, candidates: List[CandidateNode]) -> Command:
        pdbs = PDBLimits(self.kube_client)
        for candidate in candidates:
            _, ok = can_be_terminated(candidate, pdbs)
            if not ok:
                continue
            try:
                new_machines, all_scheduled = simulate_scheduling(
                    self.kube_client, self.cluster, self.provisioning, [candidate])
            except CandidateNodeDeletingError:
                continue
            if not all_scheduled:
                continue
            return _command_for(candidate, new_machines)
        return Command(action=ACTION_DO_NOTHING)


class Emptiness(Consolidation):
    """emptiness.go:44-127, the TTL path: delete the nodes empty for
    longer than the provisioner's TTLSecondsAfterEmpty, whether or not
    consolidation is on."""

    def __str__(self) -> str:
        return "emptiness"

    def should_deprovision(self, state_node, provisioner, pods) -> bool:
        if provisioner is None or provisioner.spec.ttl_seconds_after_empty is None:
            return False
        raw = state_node.annotations().get(api_labels.EMPTINESS_TIMESTAMP_ANNOTATION_KEY)
        if raw is None:
            return False
        try:
            emptiness_time = float(raw)
        except ValueError:
            return False
        return self.clock() > emptiness_time + float(provisioner.spec.ttl_seconds_after_empty)

    def compute_command(self, candidates: List[CandidateNode]) -> Command:
        empty = [c for c in candidates
                 if not any(not podutils.is_owned_by_daemonset(p) for p in c.pods)]
        if not empty:
            return Command(action=ACTION_DO_NOTHING)
        return Command(nodes_to_remove=[c.node for c in empty], action=ACTION_DELETE)
