"""The provisioning controller, reduced to what the deprovisioning search
reads (provisioner.go:62-126,152-174,365-434): the solver it shares, the
pending pods a consolidation must still place, and the daemonset pods
every new machine carries. Batching, schedule() and machine launch belong
to the operator and are not here."""
from __future__ import annotations

import copy
from typing import List, Optional

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.api.validation import validate_requirement
from karpenter_core_tpu_torch.kube.objects import Pod
from karpenter_core_tpu_torch.scheduling.requirements import Requirements
from karpenter_core_tpu_torch.utils import podutils


def validate_volumes(kube_client, pod) -> Optional[str]:
    """validatePersistentVolumeClaims (volumetopology.go:146-199): an
    error when a volume names a missing claim, storage class or volume."""
    for volume in pod.spec.volumes:
        if volume.persistent_volume_claim is None:
            continue
        claim_name = volume.persistent_volume_claim.claim_name
        pvc = kube_client.get("PersistentVolumeClaim", pod.metadata.namespace, claim_name)
        if pvc is None:
            return f"persistent volume claim {claim_name!r} not found"
        storage_class_name = pvc.spec.storage_class_name
        if storage_class_name and kube_client.get("StorageClass", "",
                                                  storage_class_name) is None:
            return f"storage class {storage_class_name!r} not found"
        if pvc.spec.volume_name and kube_client.get("PersistentVolume", "",
                                                    pvc.spec.volume_name) is None:
            return f"persistent volume {pvc.spec.volume_name!r} not found"
    return None


class Provisioning:
    """The kube client, the cloud provider and the solver of the
    provisioning controller, with its two readers."""

    def __init__(self, kube_client, cloud_provider, solver):
        self.kube_client = kube_client
        self.cloud_provider = cloud_provider
        self.solver = solver

    def get_pending_pods(self) -> List[Pod]:
        """Provisionable pods (provisioner.go:152-174); a pod that fails
        validation (opted out of provisioned nodes, an invalid affinity
        requirement, a missing volume reference) is left out."""
        pods = self.kube_client.list("Pod", field_filter=lambda p: p.spec.node_name == "")
        return [p for p in pods
                if podutils.is_provisionable(p) and self._validate_pod(p) is None]

    def _validate_pod(self, pod) -> Optional[str]:
        """Provisioner.Validate (provisioner.go:376-434)."""
        for req in Requirements.from_pod(pod).values():
            if (req.key == api_labels.PROVISIONER_NAME_LABEL_KEY
                    and req.operator() == "DoesNotExist"):
                return (f"configured to not run on a Karpenter provisioned node "
                        f"via {req.key} DoesNotExist requirement")
        affinity = pod.spec.affinity
        if affinity is not None and affinity.node_affinity is not None:
            terms = list(affinity.node_affinity.required)
            terms.extend(p.preference for p in affinity.node_affinity.preferred)
            for term in terms:
                for expr in term.match_expressions:
                    errs = validate_requirement(expr)
                    if errs:
                        return "; ".join(errs)
        return validate_volumes(self.kube_client, pod)

    def get_daemonset_pods(self) -> List[Pod]:
        """One pod per DaemonSet template (provisioner.go:365-382)."""
        out = []
        for ds in self.kube_client.list("DaemonSet"):
            if ds.pod_template_spec is not None:
                pod = Pod(spec=copy.deepcopy(ds.pod_template_spec))
                pod.metadata.name = f"{ds.metadata.name}-daemon"
                pod.metadata.namespace = ds.metadata.namespace
                out.append(pod)
        return out
