"""CacheSyncingClient: a write returns once the client's own watch has
delivered it (the reference package's testing/cachesyncing.py; upstream
pkg/test/cachesyncingclient.go:45).

A test that writes an object and at once asserts on state an informer
feeds cannot then race the watch's latency. The wrapper subscribes to a
kind before its first write and, after each write, reads its queue until
the event of that object (same kind and key, at least the written
resourceVersion; a DELETED for a delete) arrives: the fan-out has handed
the event to every queue subscribed before the write. It wraps either
client, the in-memory one or kube/apiserver.ApiServerKubeClient; reads
pass straight through.
"""
from __future__ import annotations

import queue
import time
from typing import Dict

from karpenter_core_tpu_torch.kube.objects import NamespacedName, object_key


class CacheSyncingClient:
    """A kube client whose create, update, apply, update_status and delete
    block until the client's own watch observed them."""

    def __init__(self, inner, timeout: float = 5.0):
        self._inner = inner
        self._timeout = timeout
        self._queues: Dict[str, "queue.Queue"] = {}

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _queue_for(self, kind: str) -> "queue.Queue":
        q = self._queues.get(kind)
        if q is None:
            q = self._inner.watch(kind, backlog=False)
            self._queues[kind] = q
        return q

    def _await_event(self, kind: str, key, min_rv: int, deleted: bool = False) -> None:
        q = self._queue_for(kind)
        deadline = time.monotonic() + self._timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"watch never observed {'deletion of ' if deleted else ''}"
                    f"{kind} {key} (rv>={min_rv}) within {self._timeout}s")
            try:
                event, obj = q.get(timeout=remaining)
            except queue.Empty:
                continue
            if object_key(obj) != key:
                continue
            if deleted and event == "DELETED":
                return
            if not deleted and obj.metadata.resource_version >= min_rv:
                return

    def _synced(self, write, obj):
        kind = type(obj).__name__
        self._queue_for(kind)  # subscribed before the write
        done = write(obj)
        self._await_event(kind, object_key(done), done.metadata.resource_version)
        return done

    def create(self, obj):
        return self._synced(self._inner.create, obj)

    def update(self, obj):
        return self._synced(self._inner.update, obj)

    def apply(self, obj):
        return self._synced(self._inner.apply, obj)

    def update_status(self, obj):
        return self._synced(self._inner.update_status, obj)

    def delete(self, obj_or_kind, namespace: str = None, name: str = None) -> None:
        if isinstance(obj_or_kind, str):
            kind, ns, nm = obj_or_kind, namespace or "", name
        else:
            kind = type(obj_or_kind).__name__
            ns = getattr(obj_or_kind.metadata, "namespace", "")
            nm = obj_or_kind.metadata.name
        self._queue_for(kind)
        self._inner.delete(obj_or_kind, namespace, name)
        self._await_event(kind, NamespacedName(ns, nm), 0, deleted=True)
