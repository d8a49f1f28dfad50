"""The instance-type filter of a scheduling machine (machine.go:137-159):
the types compatible with the requirements, whose allocatable fits the
requests, with an available offering in an allowed zone and capacity type.
Provisioning's failure explanation probes each template with it."""
from __future__ import annotations

from typing import List

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.cloudprovider.types import InstanceType
from karpenter_core_tpu_torch.kube.objects import LABEL_TOPOLOGY_ZONE, ResourceList
from karpenter_core_tpu_torch.scheduling.requirements import Requirements
from karpenter_core_tpu_torch.utils import resources as resources_util


def filter_instance_types_by_requirements(instance_types: List[InstanceType],
                                          requirements: Requirements,
                                          requests: ResourceList) -> List[InstanceType]:
    """compatible, fits and has an offering."""
    return [it for it in instance_types
            if _compatible(it, requirements) and _fits(it, requests)
            and _has_offering(it, requirements)]


def _compatible(instance_type: InstanceType, requirements: Requirements) -> bool:
    return instance_type.requirements.intersects(requirements) is None


def _fits(instance_type: InstanceType, requests: ResourceList) -> bool:
    return resources_util.fits(requests, instance_type.allocatable())


def _has_offering(instance_type: InstanceType, requirements: Requirements) -> bool:
    for offering in instance_type.offerings.available():
        if ((LABEL_TOPOLOGY_ZONE not in requirements
             or requirements.get_requirement(LABEL_TOPOLOGY_ZONE).has(offering.zone))
                and (api_labels.LABEL_CAPACITY_TYPE not in requirements
                     or requirements.get_requirement(api_labels.LABEL_CAPACITY_TYPE).has(
                         offering.capacity_type))):
            return True
    return False
