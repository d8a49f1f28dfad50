"""Pod predicate helpers (pkg/utils/pod/scheduling.go), as far as the
solve and consolidation paths need them."""
from __future__ import annotations

import copy


def is_scheduled(pod) -> bool:
    return pod.spec.node_name != ""


def is_terminal(pod) -> bool:
    return pod.status.phase in ("Succeeded", "Failed")


def is_terminating(pod) -> bool:
    return pod.metadata.deletion_timestamp is not None


def is_owned_by_daemonset(pod) -> bool:
    return any(o.kind == "DaemonSet" for o in pod.metadata.owner_references)


def is_owned_by_node(pod) -> bool:
    return any(o.kind == "Node" for o in pod.metadata.owner_references)


def failed_to_schedule(pod) -> bool:
    """The PodScheduled condition is False with reason Unschedulable."""
    return any(
        c.type == "PodScheduled" and c.status == "False" and c.reason == "Unschedulable"
        for c in pod.status.conditions
    )


def is_provisionable(pod) -> bool:
    """The pod needs a new node (IsProvisionable)."""
    return (
        not is_scheduled(pod)
        and not is_terminal(pod)
        and not is_terminating(pod)
        and failed_to_schedule(pod)
        and not is_owned_by_daemonset(pod)
        and not is_owned_by_node(pod)
    )


def has_do_not_evict(pod) -> bool:
    from karpenter_core_tpu_torch.api.labels import DO_NOT_EVICT_POD_ANNOTATION_KEY

    return pod.metadata.annotations.get(DO_NOT_EVICT_POD_ANNOTATION_KEY) == "true"


def clone_for_simulation(pod):
    """A shallow clone for a scheduling simulation: a fresh Pod and PodSpec
    with node_name cleared, everything beneath shared and read-only."""
    clone = copy.copy(pod)
    clone.spec = copy.copy(pod.spec)
    clone.spec.node_name = ""
    return clone


def has_pod_anti_affinity(pod) -> bool:
    """True if the pod has any required pod anti-affinity term."""
    return (
        pod.spec.affinity is not None
        and pod.spec.affinity.pod_anti_affinity is not None
        and len(pod.spec.affinity.pod_anti_affinity.required) > 0
    )
