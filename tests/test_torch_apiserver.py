"""The port's real-cluster client (kube/apiserver.py) against the reference's
and against the test apiserver of testing/apiserver.py (the port's
in-memory store behind the REST surface, called in process or served over
HTTP).

- Parity: both packages' clients make the same requests (method, path,
  params, body) for the same operations on objects built alike.
- The port's differences, each a fault the reference's suites or the
  race gate found, with the test that held it:
  * list(node_name=...): the port's controllers list one node's pods
    through the in-memory client's index; the REST client answers it with
    the `spec.nodeName` field selector (the operator over the adapter
    raised TypeError);
  * a namespaced kind is watched in every namespace, as it is listed (the
    reference streams only the default namespace's events while its
    relist lists them all);
  * close() wakes a pump waiting to reconnect;
  * the operator's watch pumps call `jitter` before each delivery (the
    deflake harness's randomized delays; the port's pumps ignored it).
- A relist's synthetic DELETED reaches state/informer.drain as a real one
  does, and the operator runs over HTTP.
"""
import json
import queue
import random
import time

import pytest

from karpenter_core_tpu_torch import chaos
from karpenter_core_tpu_torch.cloudprovider import fake
from karpenter_core_tpu_torch.kube.apiserver import (
    KUBE_TRANSPORT_RETRIES,
    ApiServerKubeClient,
    UrllibTransport,
)
from karpenter_core_tpu_torch.kube.client import ConflictError, EvictionBlockedError
from karpenter_core_tpu_torch.state import informer
from karpenter_core_tpu_torch.state.cluster import Cluster
from karpenter_core_tpu_torch.testing import make_machine, make_node, make_pdb, make_pod
from karpenter_core_tpu_torch.testing.apiserver import ApiHTTPServer, ApiStore
from karpenter_core_tpu_torch.testing.racegate import deflake_iteration


class Recording:
    """A transport that records each request and answers from a script."""

    def __init__(self, answer):
        self.calls, self.answer = [], answer

    def __call__(self, method, path, body=None, params=None, stream=False, timeout=30.0):
        self.calls.append((method, path, json.dumps(params, sort_keys=True),
                           json.dumps(body, sort_keys=True)))
        return self.answer(method, path, body, params)


def _answer(method, path, body, params):
    if method == "GET" and path.endswith("s"):
        return 200, json.dumps({"metadata": {}, "items": []})
    obj = dict(body or {"metadata": {"name": path.rsplit("/", 1)[-1]}})
    obj.setdefault("metadata", {})["resourceVersion"] = "7"
    return 200 if method != "POST" else 201, json.dumps(obj)


def _ops(pkg):
    """The same operations through one package's client and builders."""
    if pkg == "reference":
        from karpenter_core_tpu.kube.apiserver import ApiServerKubeClient as Client
        from karpenter_core_tpu.testing import make_machine as mm, make_pod as mp
    else:
        Client, mm, mp = ApiServerKubeClient, make_machine, make_pod
    rec = Recording(_answer)
    c = Client(rec)
    pod = mp(name="p", requests={"cpu": "1", "memory": "1Gi"})
    pod.metadata.uid, pod.metadata.creation_timestamp = "uid-p", 1000.0
    c.create(pod)
    c.get("Pod", "default", "p")
    pod.metadata.resource_version = 7
    pod.metadata.labels["x"] = "1"
    c.update(pod)
    machine = mm(name="m")
    machine.metadata.uid, machine.metadata.creation_timestamp = "uid-m", 1000.0
    machine.metadata.resource_version = 7
    c.update_status(machine)
    c.list("Pod")
    c.list("Node")
    c.evict("default", "p")
    c.delete("Pod", "default", "p")
    return rec.calls


def test_requests_match_the_reference_client():
    assert _ops("port") == _ops("reference")


def test_list_by_node_name_uses_the_field_selector():
    store = ApiStore()
    rec = Recording(lambda m, p, b, params: store(m, p, b, params=params))
    c = ApiServerKubeClient(rec)
    c.create(make_node(name="n1"))
    c.create(make_pod(name="on-n1", node_name="n1"))
    c.create(make_pod(name="on-n2", node_name="n2"))
    c.create(make_pod(name="pending"))
    assert [p.metadata.name for p in c.list("Pod", node_name="n1")] == ["on-n1"]
    assert '"fieldSelector": "spec.nodeName=n1"' in rec.calls[-1][2]
    with pytest.raises(ValueError):
        c.list("Node", node_name="n1")


def test_watch_covers_every_namespace():
    store = ApiStore()
    c = ApiServerKubeClient(store)
    try:
        q = c.watch("Pod", backlog=False)
        time.sleep(0.2)  # the stream is open
        c.create(make_pod(name="elsewhere", namespace="team-a"))
        c.create(make_pod(name="here"))
        got = {q.get(timeout=5)[1].metadata.name for _ in range(2)}
        assert got == {"elsewhere", "here"}
    finally:
        c.close()


def test_close_wakes_a_pump_waiting_to_reconnect():
    def refusing(method, path, body=None, params=None, stream=False, timeout=30.0):
        if stream:
            return 410, "{}"
        return 200, json.dumps({"metadata": {}, "items": []})

    c = ApiServerKubeClient(refusing)
    c.watch("Pod", backlog=False)
    time.sleep(0.2)  # the pump is in its 2 s wait to reconnect
    t0 = time.monotonic()
    c.close()
    for t in c.watch_threads():
        t.join(timeout=5)
    assert not any(t.is_alive() for t in c.watch_threads())
    assert time.monotonic() - t0 < 1.0


def test_relist_deletes_reach_the_informer():
    """A pod deleted while the stream was down, past a compaction: the
    resume is refused (410), the pump relists, and its synthetic DELETED
    takes the binding out of a Cluster fed by informer.drain."""
    store = ApiStore()
    c = ApiServerKubeClient(store)
    cluster = Cluster(c, fake.FakeCloudProvider(fake.instance_types(2)))
    pods = informer.PodInformer(cluster)
    try:
        c.create(make_pod(name="a", node_name="n1"))
        c.create(make_pod(name="b", node_name="n1"))
        q = c.watch("Pod", backlog=True)
        deadline = time.monotonic() + 5
        while len(cluster.bindings) < 2 and time.monotonic() < deadline:
            informer.drain(q, pods)
            time.sleep(0.05)
        assert {k.name for k in cluster.bindings} == {"a", "b"}
        store.drop_watches()
        c.delete("Pod", "default", "a")
        store.compact()
        deadline = time.monotonic() + 10
        while len(cluster.bindings) > 1 and time.monotonic() < deadline:
            informer.drain(q, pods)
            time.sleep(0.05)
        assert {k.name for k in cluster.bindings} == {"b"}
        assert store.stats["status"].get("410", 0) >= 1
    finally:
        c.close()


def test_store_serves_the_protocol():
    """Pages over a snapshot with continue tokens (410 once expired, then
    one full list), 409 on a stale resourceVersion, the status subresource,
    evictions under a PodDisruptionBudget, a delete's own version."""
    store = ApiStore()
    c = ApiServerKubeClient(store)
    c.LIST_LIMIT = 2
    for i in range(5):
        c.create(make_pod(name=f"p{i}", labels={"app": "web"}))
    assert len(c.list("Pod")) == 5 and store.stats["pages"] == 3
    real = store.__call__

    def expiring(method, path, body=None, params=None, **kw):
        if params and params.get("continue"):
            store.expire_lists()
        return real(method, path, body, params=params, **kw)

    c.transport = expiring
    assert len(c.list("Pod")) == 5 and store.stats["status"]["410"] == 1
    c.transport = store
    pod = c.get("Pod", "default", "p0")
    stale = pod.metadata.resource_version
    pod.metadata.labels["v"] = "1"
    c.update(pod)
    pod.metadata.resource_version = stale
    with pytest.raises(ConflictError):
        c.update(pod)
    m = c.create(make_machine())
    m.status.provider_id = "fake://m"
    m.metadata.labels["dropped"] = "1"
    c.update_status(m)
    got = c.get("Machine", "", m.metadata.name)
    assert got.status.provider_id == "fake://m" and "dropped" not in got.metadata.labels
    c.create(make_pdb("web", {"app": "web"}, disruptions_allowed=1))
    c.evict("default", "p1")
    with pytest.raises(EvictionBlockedError):
        c.evict("default", "p2")
    before = store._rv
    c.delete("Pod", "default", "p3")
    assert store._rv == before + 1


def test_injected_fault_in_the_store_is_a_retried_503():
    """In one process the client's consult of `kube.transport` comes first
    and the store's second: a fault after one consult fires in the store,
    which answers 503, and the client retries the POST."""
    store = ApiStore()
    c = ApiServerKubeClient(store, retry_base=0.001, retry_max=0.01, rng=random.Random(3))
    before = KUBE_TRANSPORT_RETRIES.get({"method": "POST"})
    fault = chaos.arm(chaos.KUBE_TRANSPORT, error="runtime", times=1, after=1)
    try:
        c.create(make_pod(name="once"))
    finally:
        chaos.reset()
    assert fault.injected == 1 and store.stats["status"]["503"] == 1
    assert KUBE_TRANSPORT_RETRIES.get({"method": "POST"}) == before + 1
    assert c.get("Pod", "default", "once") is not None


def test_operator_jitter_runs_in_every_pump():
    from karpenter_core_tpu_torch.api.settings import Settings
    from karpenter_core_tpu_torch.operator import new_operator
    from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

    op = new_operator(fake.FakeCloudProvider(fake.instance_types(2)),
                      settings=Settings(batch_idle_duration=0.02, batch_max_duration=0.05),
                      solver=TorchSolver(device="cpu"))
    calls = queue.Queue()
    op.jitter = lambda: calls.put(1)
    op.start()
    try:
        op.kube_client.create(make_pod(name="jittered"))
        calls.get(timeout=5)
    finally:
        assert op.stop() == []


def test_operator_over_http():
    """tests/test_deflake.py's iteration over UrllibTransport to the store
    served on 127.0.0.1: every surviving pod provisioned, no pump failed,
    every thread gone after the stop and the close."""
    from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

    srv = ApiHTTPServer(ApiStore())
    kube = ApiServerKubeClient(UrllibTransport(srv.url))
    try:
        run = deflake_iteration(5, kube_client=kube,
                                           solver=TorchSolver(device="cpu"))
    finally:
        kube.close()
        srv.close()
    for t in kube.watch_threads():
        t.join(timeout=5)
    assert run["machines"] >= 1 and not any(t.is_alive() for t in kube.watch_threads())
    stats = srv.stats()
    assert stats["requests"]["WATCH"] >= 4 and stats["n_errors"] == 0, stats


def test_cache_syncing_client_over_the_adapter():
    from karpenter_core_tpu_torch.testing.cachesyncing import CacheSyncingClient

    store = ApiStore()
    inner = ApiServerKubeClient(store)
    client = CacheSyncingClient(inner)
    try:
        created = client.create(make_pod(name="synced"))
        created.metadata.labels["x"] = "y"
        assert client.update(created).metadata.resource_version > \
            created.metadata.resource_version
        client.delete("Pod", "default", "synced")
        assert client.get("Pod", "default", "synced") is None
    finally:
        inner.close()


def test_in_cluster_reads_the_service_address(monkeypatch):
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
    c = ApiServerKubeClient.in_cluster()
    assert c.transport.base_url == "https://10.0.0.1:6443"
