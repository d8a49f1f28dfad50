"""A test apiserver: the port's in-memory store behind the REST surface that
kube/apiserver.ApiServerKubeClient speaks, called in process as the client's
transport or served over HTTP on 127.0.0.1.

This is test scaffolding, not a part of the operator: chip_smoke.py's phase 16
runs the operator against it over HTTP, and the tests call it in process.

    python -m karpenter_core_tpu_torch.testing.apiserver [--load PATH]
        [--chaos-p P] [--chaos-seed S]

serves an ApiStore (loaded from a pickled list of objects), prints
`apiserver <port>` once it listens, and serves until its stdin closes or it
gets SIGTERM. ApiServerProcess starts it and stops it.
"""
from __future__ import annotations

import copy
import json
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import threading
import urllib.request

from karpenter_core_tpu_torch import chaos
from karpenter_core_tpu_torch.kube.apiserver import (
    API_VERSIONS,
    RESOURCES,
    ApiServerKubeClient,
    UrllibTransport,
)
from karpenter_core_tpu_torch.kube.client import (
    AlreadyExistsError,
    EvictionBlockedError,
    InMemoryKubeClient,
    NotFoundError,
)
from karpenter_core_tpu_torch.kube.objects import NamespacedName
from karpenter_core_tpu_torch.kube.serialization import from_k8s_dict, to_k8s_dict

_KIND_OF_PLURAL = {plural: kind for kind, (_p, plural, _n) in RESOURCES.items()}
# the keep-alive a watch stream sends while it has no event, so that a
# client's pump sees its stop within this many seconds
WATCH_HEARTBEAT_S = 0.5
# the directory that holds the package, where `python -m` finds it
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class ApiStore(InMemoryKubeClient):
    """The port's in-memory store behind a kube-apiserver's REST surface.
    Called as `store(method, path, body, params=, stream=, timeout=)` it is
    an ApiServerKubeClient transport; ApiHTTPServer serves the same calls
    over HTTP. It answers:
      * GET, POST, PUT and DELETE on RESOURCES' paths, an object's
        `/status` subresource (only the status is written) and
        `pods/<name>/eviction` (429 when a PodDisruptionBudget blocks);
      * a PUT or a /status PUT whose resourceVersion is not the stored one
        with 409, as a create of an existing name;
      * a collection GET in pages of `limit` with `continue` tokens over a
        snapshot taken at the first page, 410 once the snapshot expired
        (`expire_lists()`), `fieldSelector=spec.nodeName=<node>` for pods;
      * a watch (`watch=true`) as newline-delimited JSON events: without a
        resourceVersion the current objects as ADDED, then every later
        event; from a resourceVersion every event after it, or 410 when
        the log was compacted past it (`compact()`); a blank line every
        WATCH_HEARTBEAT_S while there is no event; `drop_watches()` ends
        every open stream, as an apiserver's restart does.
    A delete takes a resourceVersion of its own, as an apiserver's does.
    Each object's JSON is encoded once per write (as an apiserver's watch
    cache keeps it) and served from there by every read of that version.
    A fault the chaos point `kube.transport` injects into the store answers
    503 (the store's own consult: where this runs in its own process, that
    is the server's fault and not the client's). `stats` counts requests by
    verb and kind, pages, watch connections and resumes, and the statuses
    that are not 2xx; ApiHTTPServer adds the bytes on the wire."""

    def __init__(self):
        super().__init__()
        self._cv = threading.Condition()
        self._log = {}        # kind -> [(rv, namespace, line)] in rv order
        self._compacted = {}  # kind -> the rv the log was compacted to
        self._lists = {}      # continue token -> the listed objects
        self._texts = {}      # (kind, namespace, name) -> (rv, its JSON)
        self._tokens = 0
        self._drops = 0
        self.closed = False
        self.stats = {"requests": {}, "by_kind": {}, "pages": 0, "watches": {}, "resumed": 0,
                      "status": {}}

    # -- the event log ---------------------------------------------------------------

    def _notify(self, kind, event, obj):
        if event == "DELETED":
            obj = copy.deepcopy(obj)
            self._bump(obj)
        super()._notify(kind, event, obj)
        text = json.dumps(self.encode(obj))
        key = (kind, obj.metadata.namespace, obj.metadata.name)
        line = f'{{"type": "{event}", "object": {text}}}\n'.encode()
        with self._cv:
            if event == "DELETED":
                self._texts.pop(key, None)
            else:
                self._texts[key] = (obj.metadata.resource_version, text)
            self._log.setdefault(kind, []).append(
                (obj.metadata.resource_version, obj.metadata.namespace, line))
            self._cv.notify_all()

    def evict(self, namespace: str, name: str) -> None:
        # the eviction takes a disruption from its budget in place, with no
        # event: the budgets' encoded texts of the namespace go stale
        try:
            super().evict(namespace, name)
        finally:
            with self._cv:
                for key in [k for k in self._texts
                            if k[0] == "PodDisruptionBudget" and k[1] == namespace]:
                    del self._texts[key]

    def compact(self, kind=None) -> None:
        """Forget the events so far: a watch resuming before now gets 410."""
        with self._mu, self._cv:
            for k in ([kind] if kind else list(RESOURCES)):
                self._log[k] = []
                self._compacted[k] = self._rv

    def drop_watches(self) -> None:
        with self._cv:
            self._drops += 1
            self._cv.notify_all()

    def expire_lists(self) -> None:
        with self._cv:
            self._lists.clear()

    def close(self) -> None:
        with self._cv:
            self.closed = True
            self._cv.notify_all()

    # -- encoding --------------------------------------------------------------------

    @staticmethod
    def encode(obj) -> dict:
        kind = type(obj).__name__
        raw = to_k8s_dict(obj)
        raw["kind"] = kind
        raw["apiVersion"] = API_VERSIONS.get(kind, "v1")
        meta = raw.setdefault("metadata", {})
        meta["resourceVersion"] = str(obj.metadata.resource_version)
        if not RESOURCES[kind][2]:
            meta.pop("namespace", None)
        return raw

    def _text(self, kind, obj) -> str:
        """obj's JSON, from the write that stored this version of it."""
        hit = self._texts.get((kind, obj.metadata.namespace, obj.metadata.name))
        if hit is not None and hit[0] == obj.metadata.resource_version:
            return hit[1]
        return json.dumps(self.encode(obj))

    def decode(self, kind, raw):
        obj = from_k8s_dict(self.scheme.type_for(kind), raw)
        rv = (raw.get("metadata") or {}).get("resourceVersion")
        obj.metadata.resource_version = int(rv) if rv else 0
        return obj

    # -- the transport ---------------------------------------------------------------

    @staticmethod
    def parse(path):
        """(kind, namespace, name, subresource) of a RESOURCES path."""
        parts = [p for p in path.split("/") if p]
        parts = parts[2:] if parts[0] == "api" else parts[3:]
        ns = ""
        if parts[:1] == ["namespaces"] and len(parts) > 2:
            ns, parts = parts[1], parts[2:]
        kind = _KIND_OF_PLURAL[parts[0]]
        return kind, ns, (parts[1] if len(parts) > 1 else ""), (
            parts[2] if len(parts) > 2 else "")

    def __call__(self, method, path, body=None, params=None, stream=False, timeout=30.0):
        params = dict(params or {})
        watch = params.get("watch") == "true"
        verb = "WATCH" if watch else ("LIST" if method == "GET" and self._is_collection(path)
                                      else method)
        kind_verb = f"{verb} {self._kind_of_path(path)}"
        with self._cv:
            self.stats["requests"][verb] = self.stats["requests"].get(verb, 0) + 1
            self.stats["by_kind"][kind_verb] = self.stats["by_kind"].get(kind_verb, 0) + 1
        try:
            got = self._rest_serve(method, path, body, params, watch)
        except Exception as exc:  # noqa: BLE001 — a chaos fault is a 503
            if "chaos" not in str(exc):
                raise
            got = (503, json.dumps({"reason": "ServiceUnavailable", "message": str(exc)}))
        if got[0] >= 300:
            with self._cv:
                key = str(got[0])
                self.stats["status"][key] = self.stats["status"].get(key, 0) + 1
        return got

    @classmethod
    def _kind_of_path(cls, path):
        try:
            return cls.parse(path)[0]
        except (KeyError, IndexError):
            return "?"

    @staticmethod
    def _is_collection(path):
        return path.rstrip("/").rsplit("/", 1)[-1] in _KIND_OF_PLURAL

    def _rest_serve(self, method, path, body, params, watch):
        kind, ns, name, sub = self.parse(path)
        if watch:
            return self._rest_watch(kind, ns, params.get("resourceVersion"))
        if method == "GET" and not name:
            return self._rest_list(kind, ns, params)
        if method == "GET":
            obj = self.get(kind, ns, name)
            return (200, self._text(kind, obj)) if obj is not None else (404, "{}")
        if method == "POST" and sub == "eviction":
            if self.get("Pod", ns, name) is None:
                return 404, "{}"
            try:
                self.evict(ns, name)
            except EvictionBlockedError as exc:
                return 429, json.dumps({"reason": "TooManyRequests", "message": str(exc)})
            return 201, json.dumps(body or {})
        if method == "POST":
            obj = self.decode(kind, body)
            try:
                return 201, self._text(kind, self.create(obj))
            except AlreadyExistsError:
                return 409, json.dumps({"reason": "AlreadyExists"})
        if method == "PUT":
            return self._rest_put(kind, ns, name, sub, body)
        if method == "DELETE":
            try:
                self.delete(kind, ns, name)
            except NotFoundError:
                return 404, "{}"
            return 200, "{}"
        return 405, "{}"

    def _rest_put(self, kind, ns, name, sub, body):
        obj = self.decode(kind, body)
        with self._mu:
            cur = self._objects.get(kind, {}).get(NamespacedName(ns, name))
            if cur is None:
                return 404, "{}"
            sent = obj.metadata.resource_version
            if sent and sent != cur.metadata.resource_version:
                return 409, json.dumps({"reason": "Conflict"})
            if sub == "status":
                return 200, self._text(kind, self.update_status(obj))
            if (cur.metadata.deletion_timestamp is not None
                    and list(obj.metadata.finalizers) != list(cur.metadata.finalizers)):
                # a terminating object's finalizer write; the last one gone
                # completes the delete
                self.finalize(obj)
                done = self._objects.get(kind, {}).get(NamespacedName(ns, name))
                return 200, self._text(kind, done if done is not None else obj)
            return 200, self._text(kind, self.update(obj))

    def _rest_list(self, kind, ns, params):
        token = params.get("continue")
        limit = int(params.get("limit") or 0)
        if token:
            with self._cv:
                objs = self._lists.pop(token, None)
            if objs is None:
                return 410, json.dumps({"reason": "Expired"})
            off = int(token.split(":")[1])
        else:
            field = params.get("fieldSelector", "")
            node = field[len("spec.nodeName="):] if field.startswith("spec.nodeName=") else None
            objs = self.list(kind, namespace=ns or None, copy_objects=False, node_name=node)
            off = 0
        page = objs[off:off + limit] if limit else objs[off:]
        with self._mu:
            meta = {"resourceVersion": str(self._rv)}
        with self._cv:
            if limit and off + limit < len(objs):
                self._tokens += 1
                nxt = f"{self._tokens}:{off + limit}"
                self._lists[nxt] = objs
                meta["continue"] = nxt
            self.stats["pages"] += 1
        items = ",".join(self._text(kind, o) for o in page)
        return 200, f'{{"metadata": {json.dumps(meta)}, "items": [{items}]}}'

    def _rest_watch(self, kind, ns, rv):
        with self._mu, self._cv:
            if rv is not None and int(rv) < self._compacted.get(kind, 0):
                return 410, json.dumps({"reason": "Expired", "message": "too old"})
            w = self.stats["watches"]
            w[kind] = w.get(kind, 0) + 1
            if rv is None:
                start = self._rv
                initial = [
                    f'{{"type": "ADDED", "object": {self._text(kind, o)}}}\n'.encode()
                    for o in self.list(kind, namespace=ns or None, copy_objects=False)]
            else:
                start, initial = int(rv), []
                self.stats["resumed"] += 1
            drops = self._drops
        return 200, self._rest_stream(kind, ns, start, initial, drops)

    def _rest_stream(self, kind, ns, start, initial, drops):
        yield from initial
        seen = start
        while True:
            with self._cv:
                log = self._log.get(kind, [])
                lo, hi = 0, len(log)  # the first event after `seen`
                while lo < hi:
                    mid = (lo + hi) // 2
                    if log[mid][0] <= seen:
                        lo = mid + 1
                    else:
                        hi = mid
                batch = log[lo:]
                if not batch:
                    if self.closed or self._drops != drops:
                        return
                    self._cv.wait(WATCH_HEARTBEAT_S)
                    if self.closed or self._drops != drops:
                        return
            if not batch:
                yield b"\n"
                continue
            for ev_rv, ev_ns, line in batch:
                seen = ev_rv
                if not ns or ev_ns == ns:
                    yield line


class ApiHTTPServer:
    """An ApiStore served over HTTP/1.1 on 127.0.0.1 at an ephemeral port,
    one thread per connection; a watch answers with a chunked body of
    newline-delimited events. `url` is what UrllibTransport takes.
    `/debug/stats` answers the store's counts, and a POST to `/debug/reset`
    puts an empty store in place of the current one."""

    def __init__(self, store: ApiStore):
        import http.server

        self.store = store
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _handle(self, method):
                import urllib.parse

                url = urllib.parse.urlsplit(self.path)
                params = dict(urllib.parse.parse_qsl(url.query))
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n)) if n else None
                outer.wire["in"] += n
                if url.path == "/debug/stats":
                    status, resp = 200, json.dumps(outer.stats())
                else:
                    try:
                        if url.path == "/debug/reset":
                            outer.reset()
                            status, resp = 200, "{}"
                        else:
                            status, resp = outer.store(method, url.path, body,
                                                       params=params)[:2]
                    except Exception as exc:  # noqa: BLE001 — answered, and counted
                        outer.errors.append(f"{method} {self.path}: {exc!r}")
                        status, resp = 500, json.dumps({"reason": "InternalError"})
                if isinstance(resp, str):
                    data = resp.encode()
                    self.send_response(status)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    outer.wire["out"] += len(data)
                    return
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                self.close_connection = True
                try:
                    for line in resp:
                        self.wfile.write(b"%x\r\n%s\r\n" % (len(line), line))
                        self.wfile.flush()
                        outer.wire["out"] += len(line)
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass  # the client went away
                finally:
                    resp.close()

            def do_GET(self):
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

            def do_PUT(self):
                self._handle("PUT")

            def do_DELETE(self):
                self._handle("DELETE")

        self.wire = {"in": 0, "out": 0}
        self.errors = []

        class Server(http.server.ThreadingHTTPServer):
            # the operator opens hundreds of connections at once (its launch
            # pool): the default backlog of 5 resets them
            request_queue_size = 1024

        self.httpd = Server(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, name="apiserver-http",
                                       daemon=True)
        self.thread.start()

    def reset(self) -> None:
        """An empty store in place of the current one, whose streams end."""
        fresh = ApiStore()
        fresh.stats = self.store.stats  # the counts run across resets
        old, self.store = self.store, fresh
        old.close()

    def stats(self) -> dict:
        with self.store._cv:
            return json.loads(json.dumps(dict(self.store.stats, wire=self.wire,
                                              errors=self.errors[:5],
                                              n_errors=len(self.errors))))

    def close(self) -> None:
        self.store.close()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5)


class ApiServerProcess:
    """An ApiStore served over HTTP by a process of its own (this module's
    main()), as an apiserver runs beside the operator: it loads every
    object of `client` (pickled through a temporary file), then arms the
    chaos point `kube.transport` at probability `chaos_p` in its own
    process, so that an injected fault is a 503 on the wire, and serves on
    127.0.0.1. It starts at once; `url` waits until it serves. close()
    stops it and waits for it."""

    def __init__(self, client, chaos_p: float = 0.0, chaos_seed: int = 16,
                 start_timeout: float = 180.0):
        self.chaos_p = chaos_p
        self.start_timeout = start_timeout
        self._url = None
        fd, self._load = tempfile.mkstemp(prefix="karpenter-apiserver-", suffix=".pkl")
        objs = [o for kind in RESOURCES for o in client.list(kind, copy_objects=False)]
        with os.fdopen(fd, "wb") as f:
            pickle.dump(objs, f, protocol=pickle.HIGHEST_PROTOCOL)
        self.objects = len(objs)
        self._err = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", __name__, "--load", self._load,
             "--chaos-p", repr(chaos_p), "--chaos-seed", str(chaos_seed)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self._err, cwd=_ROOT,
            start_new_session=True)
        self.pid = self.proc.pid

    @property
    def url(self) -> str:
        if self._url is None:
            import select

            ready, _, _ = select.select([self.proc.stdout], [], [], self.start_timeout)
            line = self.proc.stdout.readline().decode() if ready else ""
            if not line.startswith("apiserver "):
                raise AssertionError(f"the apiserver process did not start: {line!r} "
                                     f"{self.stderr_tail()}")
            self._url = f"http://127.0.0.1:{int(line.split()[1])}"
        return self._url

    def client(self) -> ApiServerKubeClient:
        return ApiServerKubeClient(UrllibTransport(self.url))

    def stats(self) -> dict:
        with urllib.request.urlopen(self.url + "/debug/stats", timeout=30) as r:
            return json.loads(r.read())

    def stderr_tail(self) -> str:
        self._err.seek(0)
        return self._err.read()[-3000:].decode(errors="replace")

    def close(self) -> None:
        """Stop the process (its stdin closed, then a terminate, then a
        kill) and remove the load file."""
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
                self.proc.wait(timeout=10)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.terminate()
                try:
                    self.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
                    self.proc.wait()
        if os.path.exists(self._load):
            os.unlink(self._load)


def main(argv=None) -> int:
    """ApiServerProcess's side: load, arm, print `apiserver <port>` once it
    serves, and serve until stdin closes or SIGTERM."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m karpenter_core_tpu_torch.testing.apiserver")
    ap.add_argument("--load", default="")
    ap.add_argument("--chaos-p", type=float, default=0.0)
    ap.add_argument("--chaos-seed", type=int, default=16)
    args = ap.parse_args(argv)
    store = ApiStore()
    if args.load:
        with open(args.load, "rb") as f:
            for obj in pickle.load(f):
                store.create(obj)
    if args.chaos_p > 0:
        chaos.arm(chaos.KUBE_TRANSPORT, error="runtime", probability=args.chaos_p,
                  seed=args.chaos_seed)
    srv = ApiHTTPServer(store)
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    threading.Thread(target=lambda: (sys.stdin.read(), done.set()), daemon=True,
                     name="apiserver-stdin").start()
    # the port hand-off: the one line the parent's `url` reads
    sys.stdout.write(f"apiserver {srv.port}\n")
    sys.stdout.flush()
    done.wait()
    srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
