"""Well-known label keys and capacity types (pkg/apis/v1alpha5/labels.go)."""
from __future__ import annotations

from karpenter_core_tpu_torch.kube.objects import (
    LABEL_ARCH_STABLE,
    LABEL_FAILURE_DOMAIN_BETA_REGION,
    LABEL_FAILURE_DOMAIN_BETA_ZONE,
    LABEL_INSTANCE_TYPE_BETA,
    LABEL_INSTANCE_TYPE_STABLE,
    LABEL_OS_STABLE,
    LABEL_TOPOLOGY_REGION,
    LABEL_TOPOLOGY_ZONE,
)

GROUP = "karpenter.sh"

ARCHITECTURE_AMD64 = "amd64"
ARCHITECTURE_ARM64 = "arm64"
CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"

PROVISIONER_NAME_LABEL_KEY = f"{GROUP}/provisioner-name"
# the pod label naming the tenant a workload bills to: the provisioner
# labels admission-to-bind latency with it; not a scheduling constraint
TENANT_LABEL_KEY = f"{GROUP}/tenant"
MACHINE_NAME_LABEL_KEY = f"{GROUP}/machine-name"
LABEL_NODE_INITIALIZED = f"{GROUP}/initialized"
LABEL_CAPACITY_TYPE = f"{GROUP}/capacity-type"

# a pod that must not be evicted, a node that must not be consolidated
DO_NOT_EVICT_POD_ANNOTATION_KEY = f"{GROUP}/do-not-evict"
DO_NOT_CONSOLIDATE_NODE_ANNOTATION_KEY = f"{GROUP}/do-not-consolidate"
# when a node became empty (the Emptiness deprovisioner's clock), and the
# drift mark the node controller sets (labels.go:33-44)
EMPTINESS_TIMESTAMP_ANNOTATION_KEY = f"{GROUP}/emptiness-timestamp"
VOLUNTARY_DISRUPTION_ANNOTATION_KEY = f"{GROUP}/voluntary-disruption"
VOLUNTARY_DISRUPTION_DRIFTED_VALUE = "drifted"
PROVIDER_COMPATIBILITY_ANNOTATION_KEY = "compatibility.karpenter.sh/provider"

# the node's termination finalizer: deletion waits for the drain
TERMINATION_FINALIZER = f"{GROUP}/termination"

# Labels in restricted domains the framework understands and can narrow
# (labels.go:78-89). Mutable: the fake cloud provider registers its extra
# well-known keys, as the reference's fake does.
WELL_KNOWN_LABELS = {
    PROVISIONER_NAME_LABEL_KEY,
    LABEL_TOPOLOGY_ZONE,
    LABEL_TOPOLOGY_REGION,
    LABEL_INSTANCE_TYPE_STABLE,
    LABEL_ARCH_STABLE,
    LABEL_OS_STABLE,
    LABEL_CAPACITY_TYPE,
}


def register_well_known_labels(*keys: str) -> None:
    WELL_KNOWN_LABELS.update(keys)


# Aliased label keys normalized into the well-known vocabulary
# (labels.go:98-107).
NORMALIZED_LABELS = {
    LABEL_FAILURE_DOMAIN_BETA_ZONE: LABEL_TOPOLOGY_ZONE,
    "beta.kubernetes.io/arch": LABEL_ARCH_STABLE,
    "beta.kubernetes.io/os": LABEL_OS_STABLE,
    LABEL_INSTANCE_TYPE_BETA: LABEL_INSTANCE_TYPE_STABLE,
    LABEL_FAILURE_DOMAIN_BETA_REGION: LABEL_TOPOLOGY_REGION,
}


# Label domains prohibited by the kubelet or reserved by the framework
# (labels.go:62-76), the allowed sub-domains, and labels never injected on
# nodes (labels.go:91-96).
RESTRICTED_LABEL_DOMAINS = frozenset({"kubernetes.io", "k8s.io", GROUP})
LABEL_DOMAIN_EXCEPTIONS = frozenset({"kops.k8s.io", "node.kubernetes.io",
                                     "testing.karpenter.sh"})
RESTRICTED_LABELS = frozenset({EMPTINESS_TIMESTAMP_ANNOTATION_KEY, "kubernetes.io/hostname"})


def is_restricted_node_label(key: str) -> bool:
    """True if the framework must not put the label on a node
    (labels.go:120-134): the well-known labels, which the cloud provider
    sets, and the restricted domains outside their exceptions."""
    if key in WELL_KNOWN_LABELS:
        return True
    domain = key.split("/", 1)[0] if "/" in key else ""
    if domain in LABEL_DOMAIN_EXCEPTIONS:
        return False
    if any(domain.endswith(d) for d in RESTRICTED_LABEL_DOMAINS):
        return True
    return key in RESTRICTED_LABELS


def is_restricted_label(key: str):
    """An error message if a requirement may not use the label, else None
    (labels.go:107-134)."""
    if key in WELL_KNOWN_LABELS:
        return None
    domain = key.split("/", 1)[0] if "/" in key else ""
    if domain in LABEL_DOMAIN_EXCEPTIONS:
        return None
    if any(domain.endswith(d) for d in RESTRICTED_LABEL_DOMAINS) or key in RESTRICTED_LABELS:
        return (
            f"label {key} is restricted; specify a well known label or a custom "
            f"label that does not use a restricted domain"
        )
    return None
