"""In-memory kube store: the surface a provisioning solve and the
cluster's informers use.

The analog of the reference's InMemoryKubeClient (kube/client.py), cut to
what those paths call: objects are created, updated and deleted in a store
keyed by (kind, namespace, name), read back by key, listed by kind,
namespace and label selector, and watched. The store holds its own copies
and hands out copies, as an apiserver does. A watch delivers ("ADDED" |
"MODIFIED" | "DELETED", object) tuples to a queue.Queue per subscriber.
Left out: the status subresource writes, compare-and-update, eviction and
finalizers (the consolidation path's surface).

A solve accepts any object with this `get` / `list` surface (an adapter
over a real apiserver included).
"""
from __future__ import annotations

import copy
import queue
import threading
from typing import Dict, List, Optional, Tuple

from karpenter_core_tpu_torch.kube.objects import LabelSelector, NamespacedName

WatchEvent = Tuple[str, object]  # ("ADDED" | "MODIFIED" | "DELETED", object)

# kinds served with a status subresource: a plain update keeps the stored
# status, as an apiserver's PUT to the main resource does
STATUS_SUBRESOURCE_KINDS = frozenset({"Machine", "Provisioner", "Node", "Pod"})


class AlreadyExistsError(Exception):
    pass


class NotFoundError(Exception):
    pass


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
