"""In-memory kube store: the read surface a provisioning solve uses.

The analog of the reference's InMemoryKubeClient (kube/client.py), cut to
what the solve path calls: objects are created into a store keyed by
(kind, namespace, name), read back by key, and listed by kind, namespace
and label selector. The store holds its own copies and hands out copies,
as an apiserver does. No watches, no updates, no status subresource:
nothing on the solve path uses them.

A solve accepts any object with this `get` / `list` surface (an adapter
over a real apiserver included).
"""
from __future__ import annotations

import copy
import threading
from typing import Dict, List, Optional

from karpenter_core_tpu_torch.kube.objects import LabelSelector, NamespacedName


class AlreadyExistsError(Exception):
    pass


def _kind_of(obj) -> str:
    return type(obj).__name__


class InMemoryKubeClient:
    """Object store keyed (kind, namespace, name); kinds are class names
    ("Pod", "Node", "PersistentVolumeClaim", "CSINode", ...)."""

    def __init__(self):
        self._mu = threading.RLock()
        self._objects: Dict[str, Dict[NamespacedName, object]] = {}

    def create(self, obj) -> object:
        kind = _kind_of(obj)
        with self._mu:
            key = NamespacedName(obj.metadata.namespace, obj.metadata.name)
            store = self._objects.setdefault(kind, {})
            if key in store:
                raise AlreadyExistsError(f"{kind} {key} already exists")
            store[key] = copy.deepcopy(obj)
            return copy.deepcopy(store[key])

    def get(self, kind: str, namespace: str, name: str) -> Optional[object]:
        with self._mu:
            obj = self._objects.get(kind, {}).get(NamespacedName(namespace, name))
            return copy.deepcopy(obj) if obj is not None else None

    def list(self, kind: str, namespace: Optional[str] = None,
             selector: Optional[LabelSelector] = None) -> List[object]:
        """Objects of `kind`, in creation order, optionally of one
        namespace and matching a label selector (None selects all)."""
        with self._mu:
            out = []
            for key, obj in self._objects.get(kind, {}).items():
                if namespace is not None and key.namespace != namespace:
                    continue
                if selector is not None and not selector.matches(obj.metadata.labels):
                    continue
                out.append(copy.deepcopy(obj))
            return out
