"""The kind registry (pkg/operator/scheme, pkg/apis/apis.go:19-45).

Kind names map to the dataclasses of kube.objects and the API types; the
registry says which kinds are namespaced, reads the CRD manifests from the
chart's templates (the single source, as in the reference package), and
lists the kinds the admission webhooks default and validate.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Type

from karpenter_core_tpu_torch.api.machine import Machine
from karpenter_core_tpu_torch.api.provisioner import Provisioner
from karpenter_core_tpu_torch.kube import objects as k8s

_CRD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "charts", "karpenter-core-tpu-crd", "templates",
)


class Scheme:
    """kind name -> type, with whether the kind is namespaced."""

    def __init__(self):
        self._types: Dict[str, Type] = {}
        self._namespaced: Dict[str, bool] = {}

    def register(self, type_: Type, namespaced: bool = True) -> "Scheme":
        self._types[type_.__name__] = type_
        self._namespaced[type_.__name__] = namespaced
        return self

    def type_for(self, kind: str) -> Optional[Type]:
        return self._types.get(kind)

    def new_object(self, kind: str):
        t = self.type_for(kind)
        if t is None:
            raise KeyError(f"kind {kind} is not registered in the scheme")
        return t()

    def recognizes(self, kind: str) -> bool:
        return kind in self._types

    def is_namespaced(self, kind: str) -> bool:
        return self._namespaced.get(kind, True)

    def kinds(self) -> List[str]:
        return sorted(self._types)


def default_scheme() -> Scheme:
    """The core kinds the controllers read and the karpenter API types
    (scheme.go:20-33)."""
    s = Scheme()
    # the karpenter CRDs are cluster-scoped (apis.go:19-31)
    s.register(Provisioner, namespaced=False)
    s.register(Machine, namespaced=False)
    s.register(k8s.Pod)
    s.register(k8s.Node, namespaced=False)
    s.register(k8s.Namespace, namespaced=False)
    s.register(k8s.ConfigMap)
    s.register(k8s.Secret)
    s.register(k8s.PersistentVolumeClaim)
    s.register(k8s.PersistentVolume, namespaced=False)
    s.register(k8s.StorageClass, namespaced=False)
    s.register(k8s.CSINode, namespaced=False)
    s.register(k8s.PodDisruptionBudget)
    s.register(k8s.DaemonSet)
    s.register(k8s.Event)
    s.register(k8s.Lease)
    return s


def crd_manifests() -> Dict[str, str]:
    """The CRD manifests by file name, read from the chart's templates
    (apis.go:22-31 embeds them)."""
    out = {}
    if os.path.isdir(_CRD_DIR):
        for fname in sorted(os.listdir(_CRD_DIR)):
            if fname.endswith(".yaml"):
                with open(os.path.join(_CRD_DIR, fname)) as f:
                    out[fname] = f.read()
    return out


# the kinds the admission webhooks default and validate (apis.go:34-45)
WEBHOOK_RESOURCES = ("Provisioner", "Machine")
