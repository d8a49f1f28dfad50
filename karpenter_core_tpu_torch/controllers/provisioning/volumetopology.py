"""The zones a pod's volumes pin it to (volumetopology.go:36-199).

For each claim-backed volume the viable zones come from the bound
PersistentVolume's node affinity, or else from the StorageClass's allowed
topologies; inject() ANDs them into every required node-selector term of
the pod, so that relaxation cannot drop them. validate() finds a volume
that names a missing claim, storage class (an ephemeral volume's
included) or volume; provisioning leaves such a pod out of its batch.
"""
from __future__ import annotations

from typing import List, Optional

from karpenter_core_tpu_torch.kube.objects import (
    Affinity,
    NodeAffinity,
    NodeSelectorRequirement,
    NodeSelectorTerm,
)


class VolumeTopology:
    def __init__(self, kube_client):
        self.kube_client = kube_client

    def inject(self, pod):
        """Add the volumes' zone requirements to `pod` (in place); returns
        the pod."""
        requirements = self._get_requirements(pod)
        if not requirements:
            return pod
        if pod.spec.affinity is None:
            pod.spec.affinity = Affinity()
        if pod.spec.affinity.node_affinity is None:
            pod.spec.affinity.node_affinity = NodeAffinity()
        if not pod.spec.affinity.node_affinity.required:
            pod.spec.affinity.node_affinity.required = [NodeSelectorTerm()]
        for term in pod.spec.affinity.node_affinity.required:
            term.match_expressions.extend(requirements)
        return pod

    def validate(self, pod) -> Optional[str]:
        """An error when a volume names a claim, storage class or volume
        that does not exist; None otherwise."""
        for volume in pod.spec.volumes:
            storage_class_name = None
            volume_name = ""
            if volume.persistent_volume_claim is not None:
                claim_name = volume.persistent_volume_claim.claim_name
                pvc = self.kube_client.get("PersistentVolumeClaim", pod.metadata.namespace,
                                           claim_name)
                if pvc is None:
                    return f"persistent volume claim {claim_name!r} not found"
                storage_class_name = pvc.spec.storage_class_name
                volume_name = pvc.spec.volume_name
            elif volume.ephemeral is not None:
                storage_class_name = volume.ephemeral.storage_class_name
            if storage_class_name and self.kube_client.get(
                    "StorageClass", "", storage_class_name) is None:
                return f"storage class {storage_class_name!r} not found"
            if volume_name and self.kube_client.get("PersistentVolume", "",
                                                    volume_name) is None:
                return f"persistent volume {volume_name!r} not found"
        return None

    def _get_requirements(self, pod) -> List[NodeSelectorRequirement]:
        requirements: List[NodeSelectorRequirement] = []
        for volume in pod.spec.volumes:
            if volume.persistent_volume_claim is None:
                continue
            pvc = self.kube_client.get("PersistentVolumeClaim", pod.metadata.namespace,
                                       volume.persistent_volume_claim.claim_name)
            if pvc is None:
                continue
            reqs = self._from_bound_pv(pvc) or self._from_storage_class(pvc)
            if reqs:
                requirements.extend(reqs)
        return requirements

    def _from_bound_pv(self, pvc) -> Optional[List[NodeSelectorRequirement]]:
        if not pvc.spec.volume_name:
            return None
        pv = self.kube_client.get("PersistentVolume", "", pvc.spec.volume_name)
        if pv is None or not pv.spec.node_affinity_required:
            return None
        out = [expr for term in pv.spec.node_affinity_required
               for expr in term.match_expressions]
        return out or None

    def _from_storage_class(self, pvc) -> Optional[List[NodeSelectorRequirement]]:
        if not pvc.spec.storage_class_name:
            return None
        sc = self.kube_client.get("StorageClass", "", pvc.spec.storage_class_name)
        if sc is None or not sc.allowed_topologies:
            return None
        out = [NodeSelectorRequirement(expr.key, "In", list(expr.values))
               for term in sc.allowed_topologies for expr in term.match_label_expressions]
        return out or None
