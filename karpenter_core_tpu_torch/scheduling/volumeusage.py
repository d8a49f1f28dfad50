"""Per-node mounted volumes per CSI driver against CSINode limits
(pkg/scheduling/volumeusage.go:33-236). A pod's claims resolve through a
kube client: PVC -> the bound PV's CSI driver, else the StorageClass's
provisioner."""
from __future__ import annotations

from typing import Dict, Optional, Set

from karpenter_core_tpu_torch.kube.objects import NamespacedName, object_key

Volumes = Dict[str, Set[str]]  # CSI driver name -> set of "namespace/claim" ids


def _union(a: Volumes, b: Volumes) -> Volumes:
    out = {k: set(v) for k, v in a.items()}
    for k, v in b.items():
        out.setdefault(k, set()).update(v)
    return out


class VolumeCount(dict):
    """driver -> count; exceeds() compares against CSINode limits
    (volumeusage.go:102-131)."""

    def exceeds(self, limits: Dict[str, int]) -> bool:
        for driver, count in self.items():
            limit = limits.get(driver)
            if limit is not None and count > limit:
                return True
        return False


class VolumeUsage:
    """volumeusage.go:33-100."""

    def __init__(self, kube_client=None):
        self.kube_client = kube_client
        self.volumes: Volumes = {}
        self.pod_volumes: Dict[NamespacedName, Volumes] = {}

    def add(self, pod) -> None:
        pod_vols = self._resolve(pod)
        self.pod_volumes[object_key(pod)] = pod_vols
        self.volumes = _union(self.volumes, pod_vols)

    def validate(self, pod) -> VolumeCount:
        """Per-driver counts if the pod were added."""
        merged = _union(self.volumes, self._resolve(pod))
        return VolumeCount({driver: len(ids) for driver, ids in merged.items()})

    def delete_pod(self, key: NamespacedName) -> None:
        self.pod_volumes.pop(key, None)
        self.volumes = {}
        for vols in self.pod_volumes.values():
            self.volumes = _union(self.volumes, vols)

    def deep_copy(self) -> "VolumeUsage":
        out = VolumeUsage(self.kube_client)
        out.volumes = {k: set(v) for k, v in self.volumes.items()}
        out.pod_volumes = {
            pk: {k: set(v) for k, v in vols.items()}
            for pk, vols in self.pod_volumes.items()
        }
        return out

    def _resolve(self, pod) -> Volumes:
        """volumeusage.go:133-200: each PVC-backed volume's driver; a
        missing claim, or one whose driver cannot be found, contributes
        nothing."""
        result: Volumes = {}
        if self.kube_client is None:
            return result
        for volume in pod.spec.volumes:
            if volume.persistent_volume_claim is None:
                continue
            claim_name = volume.persistent_volume_claim.claim_name
            pvc = self.kube_client.get("PersistentVolumeClaim", pod.metadata.namespace,
                                       claim_name)
            if pvc is None:
                continue
            driver = self._driver_for(pvc)
            if driver:
                result.setdefault(driver, set()).add(
                    f"{pod.metadata.namespace}/{claim_name}")
        return result

    def _driver_for(self, pvc) -> Optional[str]:
        """A bound PV's CSI driver wins over the StorageClass provisioner."""
        if pvc.spec.volume_name:
            pv = self.kube_client.get("PersistentVolume", "", pvc.spec.volume_name)
            if pv is not None and pv.spec.csi is not None:
                return pv.spec.csi.driver
        if pvc.spec.storage_class_name:
            sc = self.kube_client.get("StorageClass", "", pvc.spec.storage_class_name)
            if sc is not None:
                return sc.provisioner
        return None
