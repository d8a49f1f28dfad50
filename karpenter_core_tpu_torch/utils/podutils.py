"""Pod predicate helpers (pkg/utils/pod/scheduling.go), as far as the
solve path needs them."""
from __future__ import annotations


def is_scheduled(pod) -> bool:
    return pod.spec.node_name != ""


def is_terminal(pod) -> bool:
    return pod.status.phase in ("Succeeded", "Failed")


def is_terminating(pod) -> bool:
    return pod.metadata.deletion_timestamp is not None


def is_owned_by_daemonset(pod) -> bool:
    return any(o.kind == "DaemonSet" for o in pod.metadata.owner_references)


def has_pod_anti_affinity(pod) -> bool:
    """True if the pod has any required pod anti-affinity term."""
    return (
        pod.spec.affinity is not None
        and pod.spec.affinity.pod_anti_affinity is not None
        and len(pod.spec.affinity.pod_anti_affinity.required) > 0
    )
