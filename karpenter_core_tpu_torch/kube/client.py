"""In-memory kube store: the surface a provisioning solve and the
cluster's informers use.

The analog of the reference's InMemoryKubeClient (kube/client.py), cut to
what those paths and the consolidation search call: objects are created,
updated and deleted in a store keyed by (kind, namespace, name), read back
by key, listed by kind, namespace, label selector and a field filter, and
watched; pods are evicted under their PodDisruptionBudgets. The store
holds its own copies and hands out copies, as an apiserver does, unless a
read-only reader asks for shared references (list(copy_objects=False)). A
watch delivers ("ADDED" | "MODIFIED" | "DELETED", object) tuples to a
queue.Queue per subscriber. Left out: the status subresource writes,
compare-and-update and finalizers (the operator's surface).

A solve accepts any object with this `get` / `list` surface (an adapter
over a real apiserver included).
"""
from __future__ import annotations

import copy
import queue
import threading
from typing import Callable, Dict, List, Optional, Tuple

from karpenter_core_tpu_torch.kube.objects import LabelSelector, NamespacedName

WatchEvent = Tuple[str, object]  # ("ADDED" | "MODIFIED" | "DELETED", object)

# kinds served with a status subresource: a plain update keeps the stored
# status, as an apiserver's PUT to the main resource does
STATUS_SUBRESOURCE_KINDS = frozenset({"Machine", "Provisioner", "Node", "Pod"})


class AlreadyExistsError(Exception):
    pass


class NotFoundError(Exception):
    pass


class EvictionBlockedError(Exception):
    """The eviction API's 429: a PodDisruptionBudget allows no disruption."""


def _kind_of(obj) -> str:
    return type(obj).__name__


class InMemoryKubeClient:
    """Object store keyed (kind, namespace, name) with watch fan-out; kinds
    are class names ("Pod", "Node", "PersistentVolumeClaim", "CSINode",
    ...)."""

    def __init__(self):
        self._mu = threading.RLock()
        self._objects: Dict[str, Dict[NamespacedName, object]] = {}
        self._watchers: Dict[str, List[queue.Queue]] = {}

    def create(self, obj) -> object:
        kind = _kind_of(obj)
        with self._mu:
            key = NamespacedName(obj.metadata.namespace, obj.metadata.name)
            store = self._objects.setdefault(kind, {})
            if key in store:
                raise AlreadyExistsError(f"{kind} {key} already exists")
            stored = store[key] = copy.deepcopy(obj)
            self._notify(kind, "ADDED", stored)
            return copy.deepcopy(stored)

    def get(self, kind: str, namespace: str, name: str) -> Optional[object]:
        with self._mu:
            obj = self._objects.get(kind, {}).get(NamespacedName(namespace, name))
            return copy.deepcopy(obj) if obj is not None else None

    def update(self, obj) -> object:
        """Replace a stored object; for the status-subresource kinds the
        stored status is kept."""
        kind = _kind_of(obj)
        with self._mu:
            key = NamespacedName(obj.metadata.namespace, obj.metadata.name)
            store = self._objects.setdefault(kind, {})
            if key not in store:
                raise NotFoundError(f"{kind} {key} not found")
            stored = copy.deepcopy(obj)
            if kind in STATUS_SUBRESOURCE_KINDS and hasattr(stored, "status"):
                stored.status = copy.deepcopy(store[key].status)
            store[key] = stored
            self._notify(kind, "MODIFIED", stored)
            return copy.deepcopy(stored)

    def delete(self, obj_or_kind, namespace: Optional[str] = None,
               name: Optional[str] = None) -> None:
        """delete(obj) or delete(kind, namespace, name)."""
        if isinstance(obj_or_kind, str):
            kind = obj_or_kind
        else:
            kind = _kind_of(obj_or_kind)
            namespace = obj_or_kind.metadata.namespace
            name = obj_or_kind.metadata.name
        with self._mu:
            key = NamespacedName(namespace, name)
            store = self._objects.get(kind, {})
            existing = store.pop(key, None)
            if existing is None:
                raise NotFoundError(f"{kind} {key} not found")
            self._notify(kind, "DELETED", existing)

    def list(self, kind: str, namespace: Optional[str] = None,
             selector: Optional[LabelSelector] = None,
             field_filter: Optional[Callable[[object], bool]] = None,
             copy_objects: bool = True) -> List[object]:
        """Objects of `kind`, in creation order, optionally of one
        namespace, matching a label selector (None selects all) and a
        field filter. copy_objects=False hands out the stored objects
        themselves, for readers that never mutate what they list (an
        informer cache's read idiom): the consolidation search reads
        every bound pod of the cluster each pass."""
        with self._mu:
            out = []
            for key, obj in self._objects.get(kind, {}).items():
                if namespace is not None and key.namespace != namespace:
                    continue
                if selector is not None and not selector.matches(obj.metadata.labels):
                    continue
                if field_filter is not None and not field_filter(obj):
                    continue
                out.append(copy.deepcopy(obj) if copy_objects else obj)
            return out

    def evict(self, namespace: str, name: str) -> None:
        """The pods/eviction call with the server's PDB check
        (eviction.go:111-124): raises EvictionBlockedError when more than
        one budget covers the pod or its budget allows no disruption;
        otherwise deletes the pod and takes one disruption from the
        budget. A missing pod is already evicted."""
        with self._mu:
            pod = self._objects.get("Pod", {}).get(NamespacedName(namespace, name))
            if pod is None:
                return
            matching = [
                pdb for pdb in self._objects.get("PodDisruptionBudget", {}).values()
                if pdb.spec.selector is not None
                and pdb.metadata.namespace == namespace
                and pdb.spec.selector.matches(pod.metadata.labels)
            ]
            if len(matching) > 1:
                raise EvictionBlockedError(
                    "This pod has more than one PodDisruptionBudget: "
                    + ", ".join(p.metadata.name for p in matching)
                )
            if matching:
                pdb = matching[0]
                if pdb.status.disruptions_allowed <= 0:
                    raise EvictionBlockedError(
                        "Cannot evict pod as it would violate the pod's disruption "
                        f"budget {pdb.metadata.namespace}/{pdb.metadata.name}"
                    )
                pdb.status.disruptions_allowed -= 1
            self.delete("Pod", namespace, name)

    # -- watches -------------------------------------------------------------

    def watch(self, kind: str, backlog: bool = True) -> queue.Queue:
        """Subscribe to a kind: a queue of WatchEvents. With backlog, the
        current objects are replayed first as ADDED."""
        q: queue.Queue = queue.Queue()
        with self._mu:
            if backlog:
                for obj in self._objects.get(kind, {}).values():
                    q.put(("ADDED", copy.deepcopy(obj)))
            self._watchers.setdefault(kind, []).append(q)
        return q

    def unwatch(self, kind: str, q: queue.Queue) -> None:
        with self._mu:
            if q in self._watchers.get(kind, []):
                self._watchers[kind].remove(q)

    def _notify(self, kind: str, event: str, obj) -> None:
        """Fan one event out to the kind's subscribers (under self._mu)."""
        for q in self._watchers.get(kind, []):
            q.put((event, copy.deepcopy(obj)))
