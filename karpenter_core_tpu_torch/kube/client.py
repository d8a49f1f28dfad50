"""In-memory kube store: the surface a provisioning solve, the cluster's
informers and the node lifecycle use.

The analog of the reference's InMemoryKubeClient (kube/client.py): objects
are created, updated and deleted in a store keyed by (kind, namespace,
name), read back by key, listed by kind, namespace, label selector and a
field filter, and watched; pods are evicted under their
PodDisruptionBudgets. Every write bumps a store-wide resource version.
The status-subresource kinds keep their stored status on a plain update
and take it only through update_status; compare_and_update is the
optimistic-concurrency write (ConflictError on a stale version); a delete
of an object that still has finalizers only stamps its deletion time, and
the object goes once finalize() removes the last of them. The store holds
its own copies and hands out copies, as an apiserver does, unless a
read-only reader asks for shared references (list(copy_objects=False)). A
watch delivers ("ADDED" | "MODIFIED" | "DELETED", object) tuples to a
queue.Queue per subscriber.

The store also keeps the pods of each node (list(node_name=...)): the
drain and the emptiness check read one node's pods, which would otherwise
be a filter over every pod of the cluster per node.

A solve accepts any object with this `get` / `list` surface (an adapter
over a real apiserver included).
"""
from __future__ import annotations

import copy
import itertools
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from karpenter_core_tpu_torch.kube.objects import LabelSelector, NamespacedName

WatchEvent = Tuple[str, object]  # ("ADDED" | "MODIFIED" | "DELETED", object)

# kinds served with a status subresource: a plain update keeps the stored
# status, as an apiserver's PUT to the main resource does
STATUS_SUBRESOURCE_KINDS = frozenset({"Machine", "Provisioner", "Node", "Pod"})


class ConflictError(Exception):
    """A resource-version conflict on update (the apiserver's 409)."""


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
    are class names ("Pod", "Node", "Machine", "PersistentVolumeClaim",
    "CSINode", ...)."""

    def __init__(self):
        self._mu = threading.RLock()
        self._objects: Dict[str, Dict[NamespacedName, object]] = {}
        self._watchers: Dict[str, List[queue.Queue]] = {}
        self._rv = 0
        # node name -> {pod key: creation sequence}; the sequence orders a
        # node's pods as the store does (creation order)
        self._pods_by_node: Dict[str, Dict[NamespacedName, int]] = {}
        self._pod_seq: Dict[NamespacedName, int] = {}
        self._seq = itertools.count()

    # -- the store and its pod index (under self._mu) ------------------------

    def _put(self, kind: str, key: NamespacedName, stored) -> None:
        store = self._objects.setdefault(kind, {})
        if kind == "Pod":
            old = store.get(key)
            if key not in self._pod_seq:
                self._pod_seq[key] = next(self._seq)
            if old is not None and old.spec.node_name != stored.spec.node_name:
                self._unindex(old.spec.node_name, key)
            if stored.spec.node_name:
                self._pods_by_node.setdefault(stored.spec.node_name, {})[key] = (
                    self._pod_seq[key])
        store[key] = stored

    def _drop(self, kind: str, key: NamespacedName) -> None:
        existing = self._objects[kind].pop(key)
        if kind == "Pod":
            self._pod_seq.pop(key, None)
            self._unindex(existing.spec.node_name, key)

    def _unindex(self, node_name: str, key: NamespacedName) -> None:
        pods = self._pods_by_node.get(node_name)
        if pods is not None:
            pods.pop(key, None)
            if not pods:
                del self._pods_by_node[node_name]

    def _bump(self, obj) -> None:
        self._rv += 1
        obj.metadata.resource_version = self._rv

    # -- writes ---------------------------------------------------------------

    def create(self, obj) -> object:
        kind = _kind_of(obj)
        with self._mu:
            key = NamespacedName(obj.metadata.namespace, obj.metadata.name)
            if key in self._objects.get(kind, {}):
                raise AlreadyExistsError(f"{kind} {key} already exists")
            self._bump(obj)
            stored = copy.deepcopy(obj)
            self._put(kind, key, stored)
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
            self._bump(obj)
            stored = copy.deepcopy(obj)
            if kind in STATUS_SUBRESOURCE_KINDS and hasattr(stored, "status"):
                stored.status = copy.deepcopy(store[key].status)
            self._put(kind, key, stored)
            self._notify(kind, "MODIFIED", stored)
            return copy.deepcopy(stored)

    def update_status(self, obj) -> object:
        """The status subresource's PUT: only obj.status is written; the
        stored spec and metadata stay as they are."""
        kind = _kind_of(obj)
        with self._mu:
            key = NamespacedName(obj.metadata.namespace, obj.metadata.name)
            store = self._objects.setdefault(kind, {})
            if key not in store:
                raise NotFoundError(f"{kind} {key} not found")
            # a fresh copy, so that a watcher's earlier object never changes
            stored = copy.deepcopy(store[key])
            self._bump(stored)
            obj.metadata.resource_version = stored.metadata.resource_version
            stored.status = copy.deepcopy(obj.status)
            self._put(kind, key, stored)
            self._notify(kind, "MODIFIED", stored)
            return copy.deepcopy(stored)

    def compare_and_update(self, obj, expected_rv: int) -> object:
        """Replace the stored object only if its resource version is still
        `expected_rv`; ConflictError otherwise (the apiserver's 409)."""
        kind = _kind_of(obj)
        with self._mu:
            key = NamespacedName(obj.metadata.namespace, obj.metadata.name)
            cur = self._objects.setdefault(kind, {}).get(key)
            if cur is None:
                raise NotFoundError(f"{kind} {key} not found")
            if cur.metadata.resource_version != expected_rv:
                raise ConflictError(
                    f"{kind} {key} resource_version "
                    f"{cur.metadata.resource_version} != expected {expected_rv}"
                )
            self._bump(obj)
            stored = copy.deepcopy(obj)
            self._put(kind, key, stored)
            self._notify(kind, "MODIFIED", stored)
            return copy.deepcopy(stored)

    def apply(self, obj) -> object:
        """Create or update."""
        kind = _kind_of(obj)
        with self._mu:
            key = NamespacedName(obj.metadata.namespace, obj.metadata.name)
            if key in self._objects.get(kind, {}):
                return self.update(obj)
            return self.create(obj)

    def delete(self, obj_or_kind, namespace: Optional[str] = None,
               name: Optional[str] = None) -> None:
        """delete(obj) or delete(kind, namespace, name). While the object
        has finalizers this only stamps its deletion time (wall clock) and
        emits MODIFIED; it is removed once finalize() clears them."""
        if isinstance(obj_or_kind, str):
            kind = obj_or_kind
        else:
            kind = _kind_of(obj_or_kind)
            namespace = obj_or_kind.metadata.namespace
            name = obj_or_kind.metadata.name
        with self._mu:
            key = NamespacedName(namespace, name)
            existing = self._objects.get(kind, {}).get(key)
            if existing is None:
                raise NotFoundError(f"{kind} {key} not found")
            if existing.metadata.finalizers:
                if existing.metadata.deletion_timestamp is None:
                    existing.metadata.deletion_timestamp = time.time()
                    self._bump(existing)
                    self._notify(kind, "MODIFIED", existing)
                return
            self._drop(kind, key)
            self._notify(kind, "DELETED", existing)

    def finalize(self, obj) -> None:
        """Write obj's finalizer list; a terminating object whose last
        finalizer went is removed."""
        kind = _kind_of(obj)
        with self._mu:
            key = NamespacedName(obj.metadata.namespace, obj.metadata.name)
            existing = self._objects.get(kind, {}).get(key)
            if existing is None:
                raise NotFoundError(f"{kind} {key} not found")
            existing.metadata.finalizers = list(obj.metadata.finalizers)
            if (existing.metadata.deletion_timestamp is not None
                    and not existing.metadata.finalizers):
                self._drop(kind, key)
                self._notify(kind, "DELETED", existing)
            else:
                self._bump(existing)
                obj.metadata.resource_version = existing.metadata.resource_version
                self._notify(kind, "MODIFIED", existing)

    # -- reads ----------------------------------------------------------------

    def list(self, kind: str, namespace: Optional[str] = None,
             selector: Optional[LabelSelector] = None,
             field_filter: Optional[Callable[[object], bool]] = None,
             copy_objects: bool = True, node_name: Optional[str] = None) -> List[object]:
        """Objects of `kind`, in creation order, optionally of one
        namespace, matching a label selector (None selects all) and a
        field filter; for pods, optionally only those bound to
        `node_name` (read from the store's index). copy_objects=False
        hands out the stored objects themselves, for readers that never
        mutate what they list (an informer cache's read idiom): the
        consolidation search reads every bound pod of the cluster each
        pass."""
        with self._mu:
            store = self._objects.get(kind, {})
            if node_name is not None:
                if kind != "Pod":
                    raise ValueError("node_name selects pods only")
                keys = self._pods_by_node.get(node_name, {})
                items = [(k, store[k]) for k in sorted(keys, key=keys.__getitem__)]
            else:
                items = store.items()
            out = []
            for key, obj in items:
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

