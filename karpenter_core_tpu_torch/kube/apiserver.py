"""The client of a real cluster: the in-memory client's surface over a
kube-apiserver's REST API (the reference package's kube/apiserver.py).

The control plane uses only the narrow surface of kube/client.py (get,
list, create, update, update_status, compare_and_update, apply, delete,
finalize, evict, watch, and the conflict errors). This adapter serves that
surface from an apiserver (client-go under controller-runtime upstream,
pkg/operator/operator.go:106-123). Objects convert through
kube/serialization.py and HTTP rides urllib, so no kubernetes package is
needed. The transport is any callable `(method, path, body, params=,
stream=, timeout=) -> (status, body[, headers])`: tests pass one over a
store in memory, and `in_cluster()` builds one from the pod's service
account.

Every request but a watch's rides a bounded retry loop: connection
failures, timeouts, 5xx and 429 back off with full jitter and honour
Retry-After, counted in `karpenter_kube_transport_retries_total` by
method. A write retries only the statuses an apiserver sends before it
applies anything (429, 503); a GET retries them all and ambiguous
connection failures too. A 409 is a semantic outcome and goes back to the
caller. The chaos point `kube.transport` is consulted once per attempt,
inside the loop, so an injected fault is retried as a wire fault is.

A list pages through `LIST_LIMIT` items at a time on the server's continue
tokens, and relists in full if a token expires (410). A watch is one pump
thread per call that streams newline-delimited events into a queue.Queue
of (event, object), as the in-memory client's watch does: a reconnect
resumes from the last resourceVersion seen, and a refused resume relists,
replaying the objects as ADDED and a synthetic DELETED for each one gone
meanwhile.
"""
from __future__ import annotations

import json
import os
import queue
import random
import ssl
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Tuple

from karpenter_core_tpu_torch import chaos
from karpenter_core_tpu_torch.kube.client import (
    AlreadyExistsError,
    ConflictError,
    EvictionBlockedError,
    NotFoundError,
    _kind_of,
)
from karpenter_core_tpu_torch.kube.serialization import from_k8s_dict, to_k8s_dict
from karpenter_core_tpu_torch.metrics.registry import NAMESPACE, REGISTRY
from karpenter_core_tpu_torch.obs.log import get_logger

LOG = get_logger("karpenter.kube")

KUBE_TRANSPORT_RETRIES = REGISTRY.counter(
    f"{NAMESPACE}_kube_transport_retries_total",
    "Apiserver requests retried after a transient transport failure "
    "(5xx/429/timeout/connection-reset), by HTTP method",
)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# kind -> (api prefix, plural, namespaced)
RESOURCES: Dict[str, Tuple[str, str, bool]] = {
    "Pod": ("/api/v1", "pods", True),
    "Node": ("/api/v1", "nodes", False),
    "Namespace": ("/api/v1", "namespaces", False),
    "ConfigMap": ("/api/v1", "configmaps", True),
    "Secret": ("/api/v1", "secrets", True),
    "PersistentVolumeClaim": ("/api/v1", "persistentvolumeclaims", True),
    "PersistentVolume": ("/api/v1", "persistentvolumes", False),
    "StorageClass": ("/apis/storage.k8s.io/v1", "storageclasses", False),
    "CSINode": ("/apis/storage.k8s.io/v1", "csinodes", False),
    "PodDisruptionBudget": ("/apis/policy/v1", "poddisruptionbudgets", True),
    "DaemonSet": ("/apis/apps/v1", "daemonsets", True),
    "Provisioner": ("/apis/karpenter.sh/v1alpha5", "provisioners", False),
    "Machine": ("/apis/karpenter.sh/v1alpha5", "machines", False),
    "Event": ("/api/v1", "events", True),
    "Lease": ("/apis/coordination.k8s.io/v1", "leases", True),
}

API_VERSIONS = {
    "Provisioner": "karpenter.sh/v1alpha5",
    "Machine": "karpenter.sh/v1alpha5",
    "StorageClass": "storage.k8s.io/v1",
    "CSINode": "storage.k8s.io/v1",
    "PodDisruptionBudget": "policy/v1",
    "DaemonSet": "apps/v1",
    "Lease": "coordination.k8s.io/v1",
}


class UrllibTransport:
    """The default transport: urllib, with the bearer token and CA of the
    pod's service account unless given."""

    def __init__(self, base_url: str, token: Optional[str] = None,
                 ca_cert: Optional[str] = None, insecure: bool = False):
        self.base_url = base_url.rstrip("/")
        if token is None:
            try:
                with open(f"{SA_DIR}/token") as f:
                    token = f.read().strip()
            except OSError:
                token = ""
        self.token = token
        if ca_cert is None:
            default_ca = f"{SA_DIR}/ca.crt"
            ca_cert = default_ca if os.path.exists(default_ca) else None
        if insecure:
            self.ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            self.ctx.check_hostname = False
            self.ctx.verify_mode = ssl.CERT_NONE
        elif ca_cert:
            self.ctx = ssl.create_default_context(cafile=ca_cert)
        else:
            self.ctx = ssl.create_default_context()

    def __call__(self, method: str, path: str, body: Optional[dict] = None,
                 params: Optional[dict] = None, stream: bool = False,
                 timeout: float = 30.0):
        url = self.base_url + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        req.add_header("Accept", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            # a watch stream stays open for as long as the server keeps it:
            # no read timeout there
            resp = urllib.request.urlopen(
                req, context=self.ctx if url.startswith("https") else None,
                timeout=None if stream else timeout,
            )
        except urllib.error.HTTPError as e:
            # the headers go along for Retry-After
            return e.code, e.read().decode(errors="replace"), dict(e.headers)
        if stream:
            return resp.status, resp  # the caller iterates the body
        with resp:
            return resp.status, resp.read().decode()


# The statuses the retry loop treats as transient. 409 is not one: a
# conflict is optimistic concurrency's answer, which the caller's rebase
# owns; the same stale write can never succeed.
TRANSIENT_HTTP = frozenset({429, 500, 502, 503, 504})
# A write retries only what an apiserver sends before applying the request
# (429, 503): a 500, 502 or 504 may come from a gateway after the write
# committed, and replaying it turns a success into AlreadyExists or
# NotFound (client-go draws the same line).
TRANSIENT_HTTP_NON_IDEMPOTENT = frozenset({429, 503})


class ApiServerKubeClient:
    """The in-memory client's surface over a live apiserver, each request
    through a bounded retry loop (client-go's rest.Client posture: an
    apiserver that blips slows a reconcile and does not fail it)."""

    # page size of a chunked LIST: an apiserver does not return 50,000
    # pods in one response (client-go's default chunk is 500)
    LIST_LIMIT = 500

    def __init__(self, transport, scheme=None, default_namespace: str = "default",
                 retry_attempts: int = 4, retry_base: float = 0.1,
                 retry_max: float = 2.0, rng: Optional[random.Random] = None):
        from karpenter_core_tpu_torch.api.scheme import default_scheme

        self.transport = transport
        self.scheme = scheme or default_scheme()
        self.default_namespace = default_namespace
        self.retry_attempts = retry_attempts
        self.retry_base = retry_base
        self.retry_max = retry_max
        self._rng = rng or random.Random()
        self._watch_threads: List[threading.Thread] = []
        self._watch_cancels: Dict[int, threading.Event] = {}
        self._watch_mu = threading.Lock()
        self._stop = threading.Event()

    # -- the transport and its retries -----------------------------------------

    def _backoff(self, attempt: int, retry_after: Optional[str]) -> float:
        """Full jitter (N controllers retrying one blip must not land
        together again); a Retry-After in seconds wins, capped at
        retry_max."""
        if retry_after:
            try:
                return min(float(retry_after), self.retry_max)
            except ValueError:
                pass  # the HTTP-date form: back off instead
        from karpenter_core_tpu_torch.utils.backoff import full_jitter

        return full_jitter(attempt, self.retry_base, self.retry_max, self._rng)

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 params: Optional[dict] = None, timeout: float = 30.0,
                 transient: Optional[frozenset] = None):
        """One logical request: (status, body). Transient failures are
        retried up to retry_attempts times; a 409 or another 4xx returns
        as it came. `transient` narrows the statuses retried where a call
        gives one of them a meaning (an eviction's PDB 429); by default it
        is TRANSIENT_HTTP for a GET and TRANSIENT_HTTP_NON_IDEMPOTENT for
        a write."""
        if transient is None:
            transient = TRANSIENT_HTTP if method == "GET" else TRANSIENT_HTTP_NON_IDEMPOTENT
        attempt = 0
        while True:
            retry_after = None
            try:
                chaos.maybe_fail(chaos.KUBE_TRANSPORT)
                result = self.transport(method, path, body, params=params, timeout=timeout)
            except (ConnectionError, TimeoutError, OSError):
                # urllib's URLError and socket timeouts are OSErrors. The
                # request may have been applied before the connection died,
                # so only a GET replays it.
                if method != "GET" or attempt >= self.retry_attempts:
                    raise
                status = None
            else:
                status, resp_body = result[0], result[1]
                headers = result[2] if len(result) > 2 else {}
                if status not in transient or attempt >= self.retry_attempts:
                    return status, resp_body
                retry_after = {k.lower(): v for k, v in (headers or {}).items()}.get(
                    "retry-after")
            KUBE_TRANSPORT_RETRIES.inc({"method": method})
            delay = self._backoff(attempt, retry_after)
            attempt += 1
            LOG.warning("kube transport retry", method=method, path=path, status=status,
                        attempt=attempt, delay_s=round(delay, 3))
            if delay > 0:
                time.sleep(delay)

    @classmethod
    def in_cluster(cls, **kwargs) -> "ApiServerKubeClient":
        """The client of the cluster this process runs in: the service's
        address from the environment, the service account's token and CA."""
        from karpenter_core_tpu_torch.obs import envflags

        host = envflags.raw("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
        port = envflags.raw("KUBERNETES_SERVICE_PORT", "443")
        return cls(UrllibTransport(f"https://{host}:{port}"), **kwargs)

    # -- paths and encoding ------------------------------------------------------

    def _path(self, kind: str, namespace: str = "", name: str = "") -> str:
        prefix, plural, namespaced = RESOURCES[kind]
        path = prefix
        if namespaced:
            path += f"/namespaces/{namespace or self.default_namespace}"
        path += f"/{plural}"
        if name:
            path += f"/{name}"
        return path

    @staticmethod
    def _collection(kind: str, namespace: Optional[str] = None) -> str:
        """A kind's collection: one namespace's, or every namespace's."""
        prefix, plural, namespaced = RESOURCES[kind]
        if namespaced and namespace:
            return f"{prefix}/namespaces/{namespace}/{plural}"
        return f"{prefix}/{plural}"

    def _cls(self, kind: str):
        return self.scheme.type_for(kind)

    def _decode(self, kind: str, raw: dict):
        obj = from_k8s_dict(self._cls(kind), raw)
        rv = (raw.get("metadata") or {}).get("resourceVersion")
        if rv is not None:
            try:
                obj.metadata.resource_version = int(rv)
            except (TypeError, ValueError):
                obj.metadata.resource_version = 0
        return obj

    def _encode(self, obj) -> dict:
        kind = _kind_of(obj)
        raw = to_k8s_dict(obj)
        raw["kind"] = kind
        raw["apiVersion"] = API_VERSIONS.get(kind, "v1")
        meta = raw.setdefault("metadata", {})
        rv = meta.pop("resourceVersion", None)
        if rv:
            meta["resourceVersion"] = str(rv)
        if not RESOURCES[kind][2]:
            meta.pop("namespace", None)
        elif not meta.get("namespace"):
            meta["namespace"] = self.default_namespace
        return raw

    # -- the client surface --------------------------------------------------------

    def new_object(self, kind: str):
        return self._cls(kind)()

    def create(self, obj):
        kind = _kind_of(obj)
        ns = getattr(obj.metadata, "namespace", "")
        status, body = self._request("POST", self._path(kind, ns), self._encode(obj))
        if status == 409:
            raise AlreadyExistsError(f"{kind} {obj.metadata.name} already exists")
        self._raise_for(status, body, kind, obj.metadata.name)
        return self._decode(kind, json.loads(body))

    def get(self, kind: str, namespace: str, name: str):
        status, body = self._request("GET", self._path(kind, namespace, name))
        if status == 404:
            return None
        self._raise_for(status, body, kind, name)
        return self._decode(kind, json.loads(body))

    def update(self, obj):
        kind = _kind_of(obj)
        ns = getattr(obj.metadata, "namespace", "")
        status, body = self._request("PUT", self._path(kind, ns, obj.metadata.name),
                                     self._encode(obj))
        if status == 409:
            raise ConflictError(f"{kind} {obj.metadata.name} resource version conflict")
        if status == 404:
            raise NotFoundError(f"{kind} {obj.metadata.name} not found")
        self._raise_for(status, body, kind, obj.metadata.name)
        return self._decode(kind, json.loads(body))

    def compare_and_update(self, obj, expected_rv: int):
        obj.metadata.resource_version = expected_rv
        return self.update(obj)

    def update_status(self, obj):
        """PUT to the status subresource: the CRDs declare one, so a plain
        PUT drops a status change (upstream's Status().Patch,
        counter/controller.go:67). A write that meets a 409 re-reads the
        resourceVersion once and retries, as a status patch would not
        conflict with a spec change: a /status PUT persists only status."""
        kind = _kind_of(obj)
        ns = getattr(obj.metadata, "namespace", "")
        path = self._path(kind, ns, obj.metadata.name) + "/status"
        status, body = self._request("PUT", path, self._encode(obj))
        if status == 409:
            current = self.get(kind, ns, obj.metadata.name)
            if current is None:
                raise NotFoundError(f"{kind} {obj.metadata.name} not found")
            obj.metadata.resource_version = current.metadata.resource_version
            status, body = self._request("PUT", path, self._encode(obj))
            if status == 409:
                raise ConflictError(f"{kind} {obj.metadata.name} resource version conflict")
        if status == 404:
            raise NotFoundError(f"{kind} {obj.metadata.name} not found")
        self._raise_for(status, body, kind, obj.metadata.name)
        return self._decode(kind, json.loads(body))

    def evict(self, namespace: str, name: str) -> None:
        """POST the pods/eviction subresource. A 429 is the PDB's verdict
        (EvictionBlockedError, which the eviction queue requeues), not a
        rate limit, so the retry loop leaves it alone (upstream
        eviction.go:111-124); a pod already gone is a success."""
        body = {
            "apiVersion": "policy/v1",
            "kind": "Eviction",
            "metadata": {"name": name, "namespace": namespace},
        }
        status, resp = self._request(
            "POST", self._path("Pod", namespace, name) + "/eviction", body,
            transient=TRANSIENT_HTTP_NON_IDEMPOTENT - {429},
        )
        if status == 404:
            return
        if status == 429:
            raise EvictionBlockedError(str(resp)[:200])
        self._raise_for(status, resp, "Pod", name)

    def apply(self, obj):
        try:
            return self.create(obj)
        except AlreadyExistsError:
            kind = _kind_of(obj)
            current = self.get(kind, getattr(obj.metadata, "namespace", ""), obj.metadata.name)
            if current is not None:
                obj.metadata.resource_version = current.metadata.resource_version
            return self.update(obj)

    def delete(self, obj_or_kind, namespace: Optional[str] = None,
               name: Optional[str] = None) -> None:
        if isinstance(obj_or_kind, str):
            kind = obj_or_kind
        else:
            kind = _kind_of(obj_or_kind)
            namespace = getattr(obj_or_kind.metadata, "namespace", "")
            name = obj_or_kind.metadata.name
        status, body = self._request("DELETE", self._path(kind, namespace or "", name))
        if status == 404:
            raise NotFoundError(f"{kind} {name} not found")
        self._raise_for(status, body, kind, name)

    def finalize(self, obj) -> None:
        """Persist a finalizer's removal, so the apiserver completes the
        deletion."""
        self.update(obj)

    def list(self, kind: str, namespace: Optional[str] = None, selector=None,
             field_filter=None, copy_objects: bool = True,
             node_name: Optional[str] = None) -> List[object]:
        """Every object of `kind`, LIST_LIMIT a page. A continue token that
        expired mid-way (410: etcd compacted the snapshot) gives one full
        list instead, as client-go's ListPager does. `node_name` lists the
        pods bound to one node (the in-memory client's index; here the
        `spec.nodeName` field selector, applied again on the answer).
        Decoded objects are always fresh, so `copy_objects` changes
        nothing here."""
        path = self._collection(kind, namespace)
        base: Dict[str, str] = {}
        if node_name is not None:
            if kind != "Pod":
                raise ValueError("node_name selects pods only")
            base["fieldSelector"] = f"spec.nodeName={node_name}"
        items: List[object] = []
        params = dict(base, limit=str(self.LIST_LIMIT))
        while True:
            status, body = self._request("GET", path, params=params)
            if status == 410 and "continue" in params:
                status, body = self._request("GET", path, params=base or None)
                self._raise_for(status, body, kind, "")
                items = [self._decode(kind, raw) for raw in json.loads(body).get("items", [])]
                break
            self._raise_for(status, body, kind, "")
            page = json.loads(body)
            items.extend(self._decode(kind, raw) for raw in page.get("items", []))
            token = (page.get("metadata") or {}).get("continue")
            if not token:
                break
            params = dict(base, limit=str(self.LIST_LIMIT), **{"continue": token})
        if node_name is not None:
            items = [o for o in items if o.spec.node_name == node_name]
        if selector is not None:
            items = [o for o in items if selector.matches(o.metadata.labels)]
        if field_filter is not None:
            items = [o for o in items if field_filter(o)]
        return items

    def namespaces(self) -> List[str]:
        return [n.metadata.name for n in self.list("Namespace")]

    # -- watches -------------------------------------------------------------------

    def watch(self, kind: str, backlog: bool = True) -> "queue.Queue":
        """A queue of (event, object) that a pump thread fills from the
        apiserver's watch stream, as the in-memory client's watch does.

        A namespaced kind is watched in every namespace, as list() lists
        it (the reference's pump streams only the default namespace's,
        while its relist lists them all). With `backlog` the current
        objects come first as ADDED (a relist on the caller's thread). A dropped stream reconnects from the last
        resourceVersion seen; a refused resume (410, a stream error)
        relists, replaying the objects as ADDED and a DELETED for each
        one that vanished while the stream was down (the informer's
        list-then-watch contract: no ghosts)."""
        q: "queue.Queue" = queue.Queue()
        known: Dict[Tuple[str, str], bool] = {}  # the keys delivered and not deleted
        last_rv: Dict[str, Optional[int]] = {"v": None}
        # unwatch() sets it, so that a consumer that swaps queues retires
        # the old pump instead of leaking a thread and a stream
        cancel = threading.Event()
        with self._watch_mu:
            self._watch_cancels[id(q)] = cancel

        def stopped() -> bool:
            return self._stop.is_set() or cancel.is_set()

        def note_rv(obj) -> None:
            rv = obj.metadata.resource_version
            if rv:
                last_rv["v"] = max(int(last_rv["v"] or 0), int(rv))

        def relist() -> None:
            current = {}
            for obj in self.list(kind):
                current[(getattr(obj.metadata, "namespace", ""), obj.metadata.name)] = True
                q.put(("ADDED", obj))
                note_rv(obj)
            for key in list(known):
                if key not in current:
                    gone = self.new_object(kind)
                    gone.metadata.namespace, gone.metadata.name = key
                    q.put(("DELETED", gone))
            known.clear()
            known.update(current)

        if backlog:
            relist()

        def pump() -> None:
            fresh = backlog  # the backlog's relist already ran
            while not stopped():
                try:
                    if not fresh:
                        relist()
                    fresh = False
                    params = {"watch": "true"}
                    if last_rv["v"] is not None:
                        params["resourceVersion"] = str(last_rv["v"])
                    result = self.transport("GET", self._collection(kind), params=params,
                                            stream=True)
                    status, resp = result[0], result[1]
                    if status != 200:
                        last_rv["v"] = None  # too old to resume: relist
                        cancel.wait(2.0)
                        continue
                    for line in resp:
                        if stopped():
                            return
                        if not line.strip():
                            continue  # a keep-alive
                        event = json.loads(line)
                        etype = event.get("type", "MODIFIED")
                        obj = self._decode(kind, event.get("object", {}))
                        key = (getattr(obj.metadata, "namespace", ""), obj.metadata.name)
                        if etype == "DELETED":
                            known.pop(key, None)
                        else:
                            known[key] = True
                        note_rv(obj)
                        q.put((etype, obj))
                except Exception:
                    cancel.wait(2.0)  # the stream dropped: relist and resume

        t = threading.Thread(target=pump, daemon=True, name=f"apiserver-watch-{kind}")
        with self._watch_mu:
            self._watch_threads.append(t)
        t.start()
        return q

    def unwatch(self, kind: str, q) -> None:
        """Retire the queue's pump: it exits at its next event, stream
        error or reconnect (a pump blocked inside a silent stream waits
        for the stream's next line)."""
        with self._watch_mu:
            cancel = self._watch_cancels.pop(id(q), None)
        if cancel is not None:
            cancel.set()

    def watch_threads(self) -> List[threading.Thread]:
        """The pump threads started so far, live or not."""
        with self._watch_mu:
            return list(self._watch_threads)

    def close(self) -> None:
        """Stop every pump: each exits at its next line (a keep-alive
        included) or at once from a reconnect's wait."""
        self._stop.set()
        with self._watch_mu:
            cancels = list(self._watch_cancels.values())
        for cancel in cancels:
            cancel.set()

    # -- errors --------------------------------------------------------------------

    @staticmethod
    def _raise_for(status: int, body, kind: str, name: str) -> None:
        if status >= 400:
            raise RuntimeError(f"apiserver {status} for {kind} {name}: {str(body)[:200]}")
