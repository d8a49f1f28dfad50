"""The provisioner resource counter (counter/controller.go:62-93): a
provisioner's status.resources is the summed capacity of the cluster's
nodes it launched, nodes marked for deletion left out. The launch's
limits check reads it."""
from __future__ import annotations

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.kube.client import NotFoundError
from karpenter_core_tpu_torch.utils import resources as resources_util


class CounterController:
    def __init__(self, kube_client, cluster):
        self.kube_client = kube_client
        self.cluster = cluster

    def reconcile(self, provisioner) -> None:
        resources = {}
        for node in self.cluster.nodes():
            if node.is_marked_for_deletion():
                continue
            if node.labels().get(api_labels.PROVISIONER_NAME_LABEL_KEY) != provisioner.name:
                continue
            resources = resources_util.merge(resources, node.capacity())
        provisioner.status.resources = resources
        # through the status subresource, as counter/controller.go:67 patches
        try:
            self.kube_client.update_status(provisioner)
        except NotFoundError:
            pass  # deleted meanwhile
