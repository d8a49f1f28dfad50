"""The provisioning controller, reduced to what the deprovisioning chain
uses (provisioner.go:62-174,304-434): the solver it shares, the pending
pods a consolidation must still place, the daemonset pods every new
machine carries, and the launch of solved machines (a replacement's):
the provisioner-limits check, the create through the cloud provider, the
Machine record, the eager Node and the nomination. Batching, schedule(),
the insufficient-capacity cache, the launch retry, the launch-failure
metrics and the nomination events belong to the operator and are not
here."""
from __future__ import annotations

import concurrent.futures
import copy
import logging
from typing import List, Optional

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.api.validation import validate_requirement
from karpenter_core_tpu_torch.kube.client import AlreadyExistsError
from karpenter_core_tpu_torch.kube.objects import NodeStatus, Pod
from karpenter_core_tpu_torch.scheduling.requirements import Requirements
from karpenter_core_tpu_torch.utils import podutils

LOG = logging.getLogger("karpenter.provisioning")

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
    """The kube client, the cloud provider, the cluster and the solver of
    the provisioning controller, with its two readers and the launch."""

    def __init__(self, kube_client, cloud_provider, solver, cluster=None):
        self.kube_client = kube_client
        self.cloud_provider = cloud_provider
        self.solver = solver
        self.cluster = cluster

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

    # -- launching (provisioner.go:130-148,304-361) ---------------------------

    def launch_machines(self, machines) -> List[str]:
        """Launch the machines in parallel; the node name of each, "" where
        its launch failed."""
        if not machines:
            return []
        names: List[str] = []
        with concurrent.futures.ThreadPoolExecutor(max_workers=len(machines)) as pool:
            futures = [pool.submit(self._launch_one, m) for m in machines]
            for f in futures:
                try:
                    names.append(f.result())
                except Exception as e:  # noqa: BLE001 — the caller sees ""
                    names.append("")
                    LOG.warning("machine launch failed: %s: %s", type(e).__name__, e)
        return names

    def _launch_one(self, machine) -> str:
        """provisioner.go:304-361: the limits check, the create, the
        Machine record (its status through the status subresource), the
        eager Node, the nomination."""
        latest = self.kube_client.get("Provisioner", "", machine.provisioner_name)
        if latest is None:
            raise RuntimeError(f"provisioner {machine.provisioner_name} not found")
        if latest.spec.limits is not None:
            err = latest.spec.limits.exceeded_by(latest.status.resources)
            if err:
                raise RuntimeError(err)

        template = copy.copy(machine.template)  # templates are shared across machines
        template.instance_type_options = list(machine.instance_type_options)
        template.requirements = Requirements(machine.requirements.values())
        template.requests = dict(machine.requests)
        machine_cr = template.to_machine()
        created = self.cloud_provider.create(machine_cr)

        # the Machine record, named after the created node (node and machine
        # look each other up 1:1); provider id, capacity and allocatable
        # live under the status subresource, written on apply's version
        machine_cr.metadata.name = created.metadata.name
        machine_cr.status.provider_id = created.status.provider_id
        machine_cr.status.capacity = dict(created.status.capacity)
        machine_cr.status.allocatable = dict(created.status.allocatable)
        machine_cr.metadata.labels.update(created.metadata.labels)
        applied = self.kube_client.apply(machine_cr)
        machine_cr.metadata.resource_version = applied.metadata.resource_version
        self.kube_client.update_status(machine_cr)

        # the Node, created eagerly (provisioner.go:337-349)
        node = template.to_node()
        node.metadata.name = created.metadata.name
        node.metadata.labels.update(created.metadata.labels)
        node.spec.provider_id = created.status.provider_id
        node.status = NodeStatus()
        try:
            self.kube_client.create(node)
        except AlreadyExistsError:
            pass  # the node registered itself first
        self.cluster.update_node(node)
        self.cluster.nominate_node_for_pod(node.metadata.name)
        return node.metadata.name
