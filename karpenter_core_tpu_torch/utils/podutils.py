"""Pod predicate helpers (pkg/utils/pod/scheduling.go), as far as the
host topology needs them."""
from __future__ import annotations


def has_pod_anti_affinity(pod) -> bool:
    """True if the pod has any required pod anti-affinity term."""
    return (
        pod.spec.affinity is not None
        and pod.spec.affinity.pod_anti_affinity is not None
        and len(pod.spec.affinity.pod_anti_affinity.required) > 0
    )
