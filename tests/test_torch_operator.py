"""The operator of the PyTorch port against the JAX reference, on the CPU.

Host modules first, each against its reference counterpart on the same
inputs: the ICE cache on a fake clock, the backoff shapes under a seeded
Random, the batcher's windows, the event recorder (ring, posted Event
objects, dedupe, rate limit), the volume topology, the counter and the
inflight checks, and the controller runtime (Singleton, Typed,
reconcile_concurrently).

Then `op.step()` end to end: the reference's new_operator with
TPUSolver(backend="mxu", incremental="off") and the port's with
TorchSolver(device="cpu", incremental="off") build the same world (names,
uids and creation times pinned) on a FakeClock and step alike; after each
step the nodes, machines, launches (each create's requirements and
requests), pod bindings, nominations, events, counters and the
provisioners' status.resources must be equal. Launched nodes are named
fake-machine-N from each package's own counter, in launch-thread order,
so a launched node is named by what it is: its instance type, zone and
capacity type and the pods nominated to it.

Last, the background runtime: start() provisions a pending pod within a
bounded wait and stop() joins every thread.
"""
import random
import re
import threading
import time
from types import SimpleNamespace

import pytest

from karpenter_core_tpu.api import settings as jsettings
from karpenter_core_tpu_torch.api import settings as tsettings
from karpenter_core_tpu_torch.controllers.provisioning import provisioner as tprov
from karpenter_core_tpu_torch.operator import controller as tctrl
from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

PROV = "karpenter.sh/provisioner-name"
INIT = "karpenter.sh/initialized"
CT = "karpenter.sh/capacity-type"
ZONE = "topology.kubernetes.io/zone"
ITYPE = "node.kubernetes.io/instance-type"
T0 = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _reset_settings():
    yield
    jsettings.set_current(jsettings.Settings())
    tsettings.set_current(tsettings.Settings())


def _mods(pkg):
    if pkg == "jax":
        from karpenter_core_tpu import events, testing as t
        from karpenter_core_tpu.api import settings
        from karpenter_core_tpu.cloudprovider import fake, icecache, types
        from karpenter_core_tpu.controllers.provisioning import batcher, volumetopology
        from karpenter_core_tpu.kube import client, objects
        from karpenter_core_tpu.operator import controller, new_operator
        from karpenter_core_tpu.utils import backoff
    else:
        from karpenter_core_tpu_torch import events, testing as t
        from karpenter_core_tpu_torch.api import settings
        from karpenter_core_tpu_torch.cloudprovider import fake, icecache, types
        from karpenter_core_tpu_torch.controllers.provisioning import batcher, volumetopology
        from karpenter_core_tpu_torch.kube import client, objects
        from karpenter_core_tpu_torch.operator import controller, new_operator
        from karpenter_core_tpu_torch.utils import backoff
    return SimpleNamespace(pkg=pkg, events=events, t=t, settings=settings, fake=fake,
                           icecache=icecache, types=types, batcher=batcher,
                           volumetopology=volumetopology, client=client, o=objects,
                           controller=controller, new_operator=new_operator,
                           backoff=backoff)


def both(fn):
    """fn(mods) on both packages; the observations must be equal."""
    ref, port = fn(_mods("jax")), fn(_mods("torch"))
    assert port == ref
    return port


# -- the ICE cache and the backoff shapes ---------------------------------------

def test_ice_cache_record_mask_and_expiry():
    def run(m):
        clock = m.t.FakeClock(T0)
        cache = m.icecache.ICECache(ttl=60.0, clock=clock)
        its = m.fake.instance_types(4)
        out = [cache.next_expiry_in(), len(cache), cache.mask(its) is its]
        ice = m.types.InsufficientCapacityError
        out.append(cache.record(ice("no key")))
        out.append(cache.record(ice("zone", instance_type="fake-it-1", zone="test-zone-1",
                                    capacity_type="spot")))
        clock.advance(20)
        out.append(cache.record(ice("type", instance_type="fake-it-2")))

        def avail():
            return [(it.name, sorted((o.zone, o.capacity_type, o.available)
                                     for o in it.offerings)) for it in cache.mask(its)]

        out += [avail(), sorted(cache.keys()), cache.next_expiry_in()]
        clock.advance(45)  # the first entry expires
        out += [avail(), len(cache), cache.next_expiry_in()]
        clock.advance(60)
        out += [len(cache), cache.next_expiry_in(), cache.mask(its) is its]
        return out

    got = both(run)
    assert got[3:6] == [False, True, True] and got[-3:] == [0, None, True]


def test_backoff_shapes_under_a_seeded_random():
    def run(m):
        rng = random.Random(11)
        full = [m.backoff.full_jitter(a, 0.05, 30.0, rng) for a in range(12)]
        prev, dec = 0.005, []
        for _ in range(12):
            prev = m.backoff.decorrelated_jitter(prev, 0.005, 10.0, rng)
            dec.append(prev)
        return full, dec

    full, dec = both(run)
    assert all(0 <= w <= min(30.0, 0.05 * 2 ** a) for a, w in enumerate(full))
    assert all(0.005 <= w <= 10.0 for w in dec)


# -- the batcher (the counterparts of test_controllers.py:551, 592) ------------

def test_batcher_max_window_hard_cap_under_continuous_triggers():
    from karpenter_core_tpu_torch.controllers.provisioning.batcher import Batcher

    b = Batcher(settings=tsettings.Settings(batch_idle_duration=10.0,
                                            batch_max_duration=0.25))
    b.trigger()
    stop = threading.Event()

    def keep_triggering():
        while not stop.is_set():
            b.trigger()
            time.sleep(0.002)

    t = threading.Thread(target=keep_triggering, daemon=True)
    t.start()
    try:
        t0 = time.monotonic()
        assert b.wait(timeout=1.0)
        elapsed = time.monotonic() - t0
    finally:
        stop.set()
        t.join()
    assert 0.25 <= elapsed < 1.0, elapsed
    assert b.last_window["closed_by"] == "max"


def test_batcher_wait_quantum_capped_by_deadline():
    from karpenter_core_tpu_torch.controllers.provisioning.batcher import Batcher

    b = Batcher(settings=tsettings.Settings(batch_idle_duration=0.05,
                                            batch_max_duration=5.0))
    assert not b.wait(timeout=0.05)
    b.trigger()
    t0 = time.monotonic()
    assert b.wait(timeout=1.0)
    assert 0.05 <= time.monotonic() - t0 < 0.5
    assert b.last_window["closed_by"] == "idle"


# -- the event recorder -----------------------------------------------------------

def test_recorder_ring_posts_dedupe_and_rate_limit():
    def run(m):
        clock = m.t.FakeClock(T0)
        client = m.client.InMemoryKubeClient()
        rec = m.events.Recorder(clock=clock, kube_client=client)
        pods = [m.t.make_pod(name=f"p{i}") for i in range(14)]
        node = m.t.make_node(name="n1")
        published = []
        for p in pods:  # a burst of 10 passes, then the bucket is empty
            rec.nominate_pod(p, "node-a")
        rec.nominate_pod(pods[0], "node-a")
        rec.pod_failed_to_schedule(pods[1], "no instance type")
        rec.pod_failed_to_schedule(pods[1], "no instance type")  # deduplicated
        rec.evict_pod(pods[2])
        rec.node_failed_to_drain(node, "1 pods are waiting to be evicted")
        rec.node_inflight_check(node, "expected 4 of resource cpu")
        rec.deprovisioning_blocked("Node", "n1", "not empty")
        rec.deprovisioning_launching("m1", "expiration")
        rec.deprovisioning_terminating("n1", "delete, terminating ['n1']")
        clock.advance(1.0)  # refills 5 nomination tokens
        for p in pods[10:]:
            rec.nominate_pod(p, "node-b")
        published.append(rec.publish(m.events.Event("Node", "n1", "Normal", "Tested", "a",
                                                     dedupe_values=("k",))))
        published.append(rec.publish(m.events.Event("Node", "n1", "Normal", "Tested", "b",
                                                     dedupe_values=("k",))))
        clock.advance(m.events.Recorder.DEDUPE_TTL + 1)
        published.append(rec.publish(m.events.Event("Node", "n1", "Normal", "Tested", "b",
                                                     dedupe_values=("k",))))
        assert rec.flush(timeout=10.0)
        posted = sorted(
            (e.metadata.namespace, e.metadata.name, e.involved_object.kind,
             e.involved_object.namespace, e.involved_object.name, e.reason, e.message,
             e.type, e.first_timestamp, e.last_timestamp)
            for e in client.list("Event"))
        return (rec.export(), posted, published,
                [e.reason for e in rec.for_object("Node", "n1")])

    export, posted, published, for_n1 = both(run)
    assert sum(e["reason"] == "Nominated" for e in export) == 14
    assert len(posted) == len(export)
    assert published == [True, False, True]
    assert for_n1 == ["FailedDraining", "FailedInflightCheck", "Unconsolidatable",
                      "DeprovisioningTerminating", "Tested", "Tested"]


# -- the volume topology ----------------------------------------------------------

def test_volume_topology_inject_and_validate():
    def run(m):
        t, o = m.t, m.o
        client = m.client.InMemoryKubeClient()
        for obj in (t.make_storage_class("zonal-sc", "fake.csi", zones=["test-zone-3"]),
                    t.make_storage_class("plain-sc", "fake.csi"),
                    t.make_pvc("zonal-claim", storage_class="zonal-sc"),
                    t.make_pv("bound-pv", zones=["test-zone-2"]),
                    t.make_pvc("bound-claim", volume_name="bound-pv", storage_class="zonal-sc"),
                    t.make_pv("free-pv"),
                    t.make_pvc("free-claim", volume_name="free-pv", storage_class="plain-sc"),
                    t.make_pvc("lost-sc-claim", storage_class="gone-sc"),
                    t.make_pvc("lost-pv-claim", volume_name="gone-pv")):
            client.create(obj)
        vt = m.volumetopology.VolumeTopology(client)
        term = o.NodeSelectorTerm(match_expressions=[
            o.NodeSelectorRequirement("kubernetes.io/arch", "In", ["amd64"])])
        other = o.NodeSelectorTerm(match_expressions=[
            o.NodeSelectorRequirement("kubernetes.io/os", "In", ["linux"])])
        cases = {
            "storage class": ([t.pvc_volume("zonal-claim")], None),
            "bound volume": ([t.pvc_volume("bound-claim")], None),
            "no zones": ([t.pvc_volume("free-claim")], None),
            "two claims, two terms": ([t.pvc_volume("zonal-claim"), t.pvc_volume("bound-claim")],
                                      [term, other]),
            "missing claim": ([t.pvc_volume("nope")], None),
            "missing storage class": ([t.pvc_volume("lost-sc-claim")], None),
            "missing volume": ([t.pvc_volume("lost-pv-claim")], None),
            "ephemeral, missing class": ([o.Volume(name="eph", ephemeral=o.EphemeralVolumeSource(
                storage_class_name="gone-sc"))], None),
        }
        out = {}
        for name, (volumes, required) in cases.items():
            pod = t.make_pod(name=name.replace(" ", "-").replace(",", ""),
                             node_affinity_required=required)
            pod.spec.volumes.extend(volumes)
            err = vt.validate(pod)
            injected = vt.inject(pod)
            na = injected.spec.affinity.node_affinity if injected.spec.affinity else None
            out[name] = (err, None if na is None else [
                [(r.key, r.operator, list(r.values)) for r in term_.match_expressions]
                for term_ in na.required])
        return out

    got = both(run)
    assert got["storage class"][1] == [[(ZONE, "In", ["test-zone-3"])]]
    assert got["missing volume"][0] == "persistent volume 'gone-pv' not found"


# -- the controller runtime (test_operator_runtime.py:22-80, 316-433) ------------

def test_singleton_interval_requeue_backoff_and_reset():
    assert tctrl.Singleton("t-ok", lambda: None, interval=2.5).reconcile_once() == 2.5
    assert tctrl.Singleton("t-rq", lambda: 0.25, interval=2.5).reconcile_once() == 0.25

    def boom():
        raise RuntimeError("kaboom")

    def waits(m, name, seed):
        s = m.controller.Singleton(name, boom, interval=1.0, rng=random.Random(seed))
        return [s.reconcile_once() for _ in range(6)]

    before = tctrl.RECONCILE_ERRORS.get({"controller": "t-err"})
    ref, port = waits(_mods("jax"), "t-err", 7), waits(_mods("torch"), "t-err", 7)
    assert port == ref  # the same decorrelated-jitter ladder
    assert tctrl.RECONCILE_ERRORS.get({"controller": "t-err"}) == before + 6
    prev = tctrl.ERROR_BACKOFF_BASE
    for w in port:
        assert tctrl.ERROR_BACKOFF_BASE <= w <= min(max(prev * 3, tctrl.ERROR_BACKOFF_BASE),
                                                    tctrl.ERROR_BACKOFF_MAX)
        prev = w
    assert waits(_mods("torch"), "t-err2", 99) != port

    state = {"fail": True}

    def flaky():
        if state["fail"]:
            raise RuntimeError("once")

    s = tctrl.Singleton("t-flaky", flaky, interval=1.0)
    s.reconcile_once()
    state["fail"] = False
    assert s.reconcile_once() == 1.0 and s._failures == 0
    assert tctrl.RECONCILE_DURATION.count_since(labels={"controller": "t-flaky"}) == 2


def test_singleton_loop_survives_errors_and_stops():
    calls = []

    def boom():
        calls.append(1)
        raise RuntimeError("kaboom")

    stop = threading.Event()
    s = tctrl.Singleton("t-loop", boom, interval=0.0)
    thread = s.start(stop)
    deadline = time.monotonic() + 10
    while len(calls) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    stop.set()
    thread.join(timeout=15)
    assert len(calls) >= 3 and not thread.is_alive()


def test_typed_refetches_finalizes_and_ignores_missing():
    def run(m):
        client = m.client.InMemoryKubeClient()
        live = m.t.make_node(name="typed-node", labels={PROV: "default"})
        dying = m.t.make_node(name="dying-node")
        dying.metadata.finalizers.append("testing/finalizer")
        client.create(live)
        client.create(dying)
        client.delete("Node", "", "dying-node")
        calls = []

        class Inner:
            def reconcile(self, obj):
                calls.append(("reconcile", obj.metadata.name, obj.metadata.labels.get(PROV)))

            def finalize(self, obj):
                calls.append(("finalize", obj.metadata.name))

        class NoFinalize:
            def reconcile(self, obj):
                calls.append(("reconcile only", obj.metadata.name))

        typed = m.controller.Typed(client, "Node", Inner())
        typed.reconcile_key("typed-node")
        typed.reconcile_key("dying-node")
        typed.reconcile_key("gone")
        m.controller.Typed(client, "Node", NoFinalize()).reconcile_key("dying-node")
        return calls, typed.name

    calls, name = both(run)
    assert calls == [("reconcile", "typed-node", "default"), ("finalize", "dying-node"),
                     ("reconcile only", "dying-node")]


def test_injection_names_the_controller():
    def run(m):
        from importlib import import_module

        injection = import_module(m.controller.__name__.rsplit(".", 1)[0] + ".injection")
        seen = []
        m.controller.Singleton("t-named", lambda: seen.append(injection.controller_name())
                               ).reconcile_once()
        m.controller.reconcile_concurrently("t-pool", [0], lambda _i: seen.append(
            injection.controller_name()), max_workers=1)
        with injection.with_controller_name("outer"):
            seen.append(injection.controller_name())
        return seen, injection.controller_name()

    assert both(run) == (["t-named", "t-pool", "outer"], "")


def _terminator(m):
    from importlib import import_module

    root = m.controller.__name__.split(".", 1)[0]
    return import_module(root + ".controllers.machine.terminator")


@pytest.mark.parametrize("gate", ["pdb", "checker"])
def test_eviction_worker_retries_a_blocked_pod_on_the_reference_delays(gate):
    """The worker thread evicts a free pod at once and retries a pod its
    budget blocks (the client's PodDisruptionBudget, or pdb_checker) after
    0.1, 0.2 and 0.4 s until the budget allows it; stop() ends the thread."""
    blocked_for = 3

    def run(m):
        t, o = m.t, m.o
        client = m.client.InMemoryKubeClient()
        for name in ("free", "held"):
            client.create(t.make_pod(name=name, labels={"app": name}, node_name="n1"))
        attempts = []  # (pod name, monotonic time)

        def allowed(name):
            attempts.append((name, time.monotonic()))
            return name != "held" or sum(a[0] == "held" for a in attempts) > blocked_for

        checker = None
        if gate == "pdb":
            client.create(o.PodDisruptionBudget(
                metadata=o.ObjectMeta(name="held-pdb", namespace="default"),
                spec=o.PodDisruptionBudgetSpec(
                    selector=o.LabelSelector(match_labels={"app": "held"})),
                status=o.PodDisruptionBudgetStatus(disruptions_allowed=0)))
            evict = client.evict

            def gated_evict(namespace, name):
                if allowed(name) and name == "held":
                    pdb = client.get("PodDisruptionBudget", "default", "held-pdb")
                    pdb.status.disruptions_allowed = 1
                    client.update(pdb)
                return evict(namespace, name)

            client.evict = gated_evict
        else:
            def checker(pod):
                return allowed(pod.metadata.name)

        rec = m.events.Recorder(clock=t.FakeClock(T0))
        queue = _terminator(m).EvictionQueue(client, recorder=rec, pdb_checker=checker)
        queue.start()
        thread = queue._thread
        try:
            queue.add(*client.list("Pod"))
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and client.list("Pod"):
                time.sleep(0.01)
        finally:
            queue.stop()
            thread.join(timeout=2.0)
        held = [at for name, at in attempts if name == "held"]
        gaps = [b - a for a, b in zip(held, held[1:])]
        for k, gap in enumerate(gaps):  # late by the poll at most, never early
            assert 0.1 * 2 ** k - 0.005 <= gap < 0.1 * 2 ** k + 0.5, (m.pkg, gaps)
        return ([name for name, _ in attempts], [p.metadata.name for p in client.list("Pod")],
                sorted((e["name"], e["reason"]) for e in rec.export()), thread.is_alive())

    order, left, events, alive = both(run)
    assert order == ["free"] + ["held"] * (blocked_for + 1)
    assert left == [] and not alive
    assert events == [("default/free", "Evicted"), ("default/held", "Evicted")]


def test_eviction_queue_keeps_one_live_entry_per_key():
    """A key drained synchronously and added again has one live heap
    entry: the retry left from before the drain is skipped, and a requeue
    for the old generation pushes nothing."""
    from karpenter_core_tpu_torch.controllers.machine.terminator import EvictionQueue
    from karpenter_core_tpu_torch.kube.client import InMemoryKubeClient
    from karpenter_core_tpu_torch.testing import make_pod

    client = InMemoryKubeClient()
    gate = {"open": False}
    queue = EvictionQueue(client, pdb_checker=lambda pod: gate["open"])

    def live():
        return [e for e in queue._heap if queue._set.get(e[2]) == e[4]]

    client.create(make_pod(name="held", node_name="n1"))
    queue.add(client.get("Pod", "default", "held"))
    key, attempts, old = queue._pop_ready(0)
    assert attempts == 0 and not queue.evict(key)
    queue._requeue(key, attempts, old)
    gate["open"] = True
    queue.drain()
    assert len(queue) == 0 and client.get("Pod", "default", "held") is None
    gate["open"] = False
    client.create(make_pod(name="held", node_name="n1"))
    queue.add(client.get("Pod", "default", "held"))
    assert len(queue._heap) == 2 and len(live()) == 1
    queue._requeue(key, 1, old)
    assert len(live()) == 1
    assert queue._pop_ready(0)[1:] == (0, queue._set[key])
    assert queue._pop_ready(0.15) is None and queue._heap == []


@pytest.mark.parametrize("data", [
    {},
    {"batchMaxDuration": "1m30s", "batchIdleDuration": "500ms",
     "ttlAfterNotRegistered": "", "featureGates.driftEnabled": "TRUE",
     "batchMaxPods": "1000", "consolidationDisruptionBudget": "3"},
    {"ttlAfterNotRegistered": "2h", "batchMaxPods": "9000",
     "bucketLadder": "a:16:8:4:4, b:9000:64:8:16,"},
    {"batchMaxPods": "70000"},
    {"batchMaxDuration": "10"},
    {"batchIdleDuration": "0s"},
    {"batchMaxDuration": "-1s"},
    {"ttlAfterNotRegistered": "0s"},
    {"featureGates.driftEnabled": "yes"},
    {"batchMaxPods": "-1"},
    {"batchMaxPods": "many"},
    {"consolidationDisruptionBudget": "-2"},
    {"bucketLadder": "a:16:8:4"},
    {"bucketLadder": "a:16:8:4:x"},
    {"bucketLadder": "a:16:8:4:0"},
    {"bucketLadder": " , "},
    {"bucketLadder": "a:16:8:4:4,b:32:8:8:8"},
], ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()) or "empty")
def test_settings_from_config_map_matches_reference(data):
    """from_config_map's parse and validation, and the batch cap and
    steady-state tier of what it parses, against the reference."""
    def run(m):
        try:
            s = m.settings.Settings.from_config_map(dict(data))
        except ValueError as e:
            return "ValueError", str(e)
        tier = s.steady_state_tier()
        return (s.batch_max_duration, s.batch_idle_duration, s.ttl_after_not_registered,
                s.drift_enabled, s.batch_max_pods, s.consolidation_disruption_budget,
                [(g.name, g.pods, g.items, g.instance_types, g.existing_nodes)
                 for g in s.bucket_ladder],
                s.effective_batch_max_pods(), tier and tier.name)

    both(run)


def test_reconcile_concurrently_counts_errors_and_completes():
    done = []

    def rec(i):
        if i % 3 == 0:
            raise RuntimeError("boom")
        time.sleep(0.01)
        done.append((i, threading.current_thread().name))

    before = tctrl.RECONCILE_ERRORS.get({"controller": "partest"})
    assert tctrl.reconcile_concurrently("partest", range(10), rec, max_workers=4) == 4
    assert sorted(i for i, _ in done) == [1, 2, 4, 5, 7, 8]
    assert all(name.startswith("partest-") for _, name in done)
    assert tctrl.RECONCILE_ERRORS.get({"controller": "partest"}) == before + 4
    assert tctrl.reconcile_concurrently("partest", [], rec) == 0


# -- op.step() against the reference ----------------------------------------------

_LAUNCHED = re.compile(r"fake-machine-\d+")


class _Side:
    """One package's operator over a fresh client, a fake provider and a
    FakeClock, with the readers the comparison needs."""

    def __init__(self, pkg, types=10, settings=None, max_nodes=64):
        m = self.m = _mods(pkg)
        self.clock = m.t.FakeClock(T0)
        self.cp = m.fake.FakeCloudProvider(m.fake.instance_types(types))
        if pkg == "jax":
            from karpenter_core_tpu.solver.tpu_solver import TPUSolver

            from karpenter_core_tpu.controllers.provisioning import provisioner as jprov

            solver = TPUSolver(max_nodes=max_nodes, backend="mxu", incremental="off")
            jprov.PENDING_PODS.set(0.0)  # a gauge: what the last pass saw
            self._counters = self._ref_counters
        else:
            solver = TorchSolver(max_nodes=max_nodes, device="cpu", incremental="off")
            tprov.reset_counts()
            self._counters = self._port_counters
        kw = dict(settings or {})
        self.op = m.new_operator(self.cp, settings=m.settings.Settings(**kw), solver=solver,
                                 clock=self.clock)
        for d in self.op.deprovisioning.deprovisioners:
            d.validation_ttl = 0.0
        self.client = self.op.kube_client
        self.nominated = []  # (pod key, node name) from the bind feed
        self.op.provisioning.bind_listeners.append(
            lambda p, n: self.nominated.append(
                (f"{p.metadata.namespace}/{p.metadata.name}", n)))
        self._base = self._counters(raw=True)

    # -- the counters, against a baseline taken at the start ------------------

    def _ref_counters(self, raw=False):
        from karpenter_core_tpu.controllers.provisioning import provisioner as jprov
        from karpenter_core_tpu.metrics.registry import NODES_CREATED

        out = {f"launch_failures/{r}": jprov.LAUNCH_FAILURES.get({"reason": r})
               for r in ("insufficient_capacity", "transient", "error")}
        out["retriggers"] = jprov.LAUNCH_RESOLVE_RETRIGGERS.get()
        out["nodes_created"] = NODES_CREATED.get({"reason": "provisioning"})
        if raw:
            return out
        out = {k: v - self._base[k] for k, v in out.items()}
        out["pending_pods"] = jprov.PENDING_PODS.get()
        return out

    def _port_counters(self, raw=False):
        out = {f"launch_failures/{r}": tprov.LAUNCH_FAILURES.get({"reason": r})
               for r in ("insufficient_capacity", "transient", "error")}
        out["retriggers"] = tprov.LAUNCH_RESOLVE_RETRIGGERS.get()
        out["nodes_created"] = tprov.NODES_CREATED.get({"reason": "provisioning"})
        if raw:
            return out
        out = {k: v - self._base[k] for k, v in out.items()}
        out["pending_pods"] = tprov.PENDING_PODS.get()
        assert tprov.FALLBACKS["solver"] == 0
        return out

    # -- the world --------------------------------------------------------------

    def provisioner(self, name="default", **kw):
        self.client.create(self.m.t.make_provisioner(name=name, **kw))

    def pod(self, name, i=0, **kw):
        pod = self.m.t.make_pod(name=name, **kw)
        pod.metadata.uid = f"uid-{name}"
        pod.metadata.creation_timestamp = T0 - 1000 + i
        self.client.create(pod)
        return pod

    def step(self, **kw):
        summary = self.op.step(**kw)
        self.op.recorder.flush(timeout=10.0)
        return summary

    def kubelet(self, bind=True):
        """The kubelet of every launched node: Ready with its machine's
        capacity; each nominated pod binds to its node and runs."""
        for node in self.client.list("Node"):
            machine = self.client.get("Machine", "", node.metadata.name)
            if machine is not None and not node.status.capacity:
                node.status.capacity = dict(machine.status.capacity)
                node.status.allocatable = dict(machine.status.allocatable)
            if not node.ready():
                node.status.conditions.append(self.m.o.Condition(type="Ready", status="True"))
            self.client.update_status(node)
        if bind:
            for key, node_name in self.nominated:
                ns, name = key.split("/")
                pod = self.client.get("Pod", ns, name)
                if pod is not None and not pod.spec.node_name:
                    pod.spec.node_name = node_name
                    pod.status.phase = "Running"
                    self.client.update(pod)

    # -- what is compared ---------------------------------------------------------

    def _canon(self):
        """Launched node name -> what it is: its instance type, zone,
        capacity type and the pods nominated to it."""
        pods = {}
        for key, node in self.nominated:
            pods.setdefault(node, set()).add(key)
        names = {}
        for n in self.client.list("Node"):
            if _LAUNCHED.fullmatch(n.metadata.name):
                lb = n.metadata.labels
                names[n.metadata.name] = (f"<{lb.get(ITYPE)}/{lb.get(ZONE)}/{lb.get(CT)}:"
                                          f"{','.join(sorted(pods.get(n.metadata.name, ())))}>")
        for mc in self.client.list("Machine"):
            if mc.metadata.name not in names and _LAUNCHED.fullmatch(mc.metadata.name):
                lb = mc.metadata.labels
                names[mc.metadata.name] = f"<{lb.get(ITYPE)}/{lb.get(ZONE)}/{lb.get(CT)}:gone>"

        def canon(text):
            return _LAUNCHED.sub(lambda mt: names.get(mt.group(0), "<launched>"), text or "")

        return canon

    def observe(self):
        canon = self._canon()
        c = self.client
        nodes = sorted(
            (canon(n.metadata.name), n.metadata.labels.get(ITYPE), n.metadata.labels.get(ZONE),
             n.metadata.labels.get(CT), n.metadata.labels.get(PROV),
             n.metadata.labels.get(INIT), n.spec.unschedulable,
             n.metadata.deletion_timestamp is not None, sorted(n.metadata.finalizers),
             sorted((t.key, t.effect) for t in n.spec.taints), n.ready())
            for n in c.list("Node"))
        machines = sorted(
            (canon(mc.metadata.name), mc.metadata.labels.get(ITYPE),
             sorted((cd.type, cd.status, cd.reason) for cd in mc.status.conditions),
             sorted(mc.status.capacity.items()))
            for mc in c.list("Machine"))
        launches = sorted(
            (sorted((r.key, r.operator, sorted(r.values)) for r in call.spec.requirements),
             sorted(call.spec.resources.requests.items()))
            for call in self.cp.create_calls)
        pods = sorted((p.metadata.name, canon(p.spec.node_name), p.status.phase)
                      for p in c.list("Pod"))
        nominated = sorted((k, canon(n)) for k, n in self.nominated)
        events = sorted((e.involved_kind, canon(e.involved_name), e.type, e.reason,
                         canon(e.message)) for e in self.op.recorder.events)
        posted = sorted((e.involved_object.kind, canon(e.involved_object.name), e.reason,
                         canon(e.message)) for e in c.list("Event"))
        resources = {p.metadata.name: sorted(p.status.resources.items())
                     for p in c.list("Provisioner")}
        return {"nodes": nodes, "machines": machines, "launches": launches, "pods": pods,
                "nominated": nominated, "events": events, "posted": posted,
                "counters": self._counters(), "resources": resources}


def run_both(script, **kw):
    """script(side) on the reference and on the port; equal observations."""
    ref = script(_Side("jax", **kw))
    port = script(_Side("torch", **kw))
    assert port == ref
    return port


def _provisioning_end_to_end(s):
    s.provisioner()
    for i in range(5):
        s.pod(f"e2e-{i}", i, requests={"cpu": "1"})
    summary = s.step()
    return [summary, s.observe()]


def _machine_lifecycle(s):
    s.provisioner()
    s.pod("life-0", requests={"cpu": "1"})
    out = [s.step(), s.observe()]
    s.kubelet()
    return out + [s.step(), s.observe()]


def _liveness(s):
    machine = s.m.t.make_machine(name="zombie")
    machine.metadata.creation_timestamp = s.clock()
    s.client.create(machine)
    s.cp.next_create_err = RuntimeError("no capacity")
    out = [s.step(), s.observe()]
    s.clock.advance(16 * 60)  # past ttl_after_not_registered
    s.cp.next_create_err = RuntimeError("no capacity")
    return out + [s.step(), s.observe()]


def _termination(s, annotations=None):
    s.provisioner()
    s.pod("term-0", requests={"cpu": "1"}, annotations=annotations)
    s.step()
    s.kubelet()
    out = [s.step(), s.observe()]
    node = s.client.list("Node")[0]
    s.client.delete("Node", "", node.metadata.name)
    for _ in range(2):
        out += [s.step(), s.observe()]
    return out


def _do_not_evict(s):
    return _termination(s, annotations={"karpenter.sh/do-not-evict": "true"})


def _emptiness(s):
    s.provisioner(ttl_seconds_after_empty=30)
    s.pod("empty-0", requests={"cpu": "1"})
    s.step()
    s.kubelet()
    s.step()
    pod = s.client.get("Pod", "default", "empty-0")
    pod.status.phase = "Succeeded"
    s.client.update_status(pod)
    out = [s.step(), s.observe(), s.step(deprovision=True)]
    s.clock.advance(31)
    out += [s.step(deprovision=True), s.step(), s.observe()]
    return out


def _multi_node_consolidation(s):
    s.provisioner(consolidation_enabled=True)
    for i in range(2):
        node = s.m.t.make_node(
            name=f"big-{i}", labels={PROV: "default", INIT: "true", ITYPE: "fake-it-9",
                                     CT: "on-demand", ZONE: "test-zone-1"},
            capacity={"cpu": "10", "memory": "20Gi", "pods": "100"})
        node.metadata.uid = f"uid-big-{i}"
        node.metadata.creation_timestamp = T0 - 500
        s.client.create(node)
        s.pod(f"big-{i}-p", i, requests={"cpu": "1"}, node_name=node.metadata.name,
              unschedulable=False, phase="Running")
    s.op.sync_state()
    acted = s.op.deprovisioning.reconcile()
    s.op.recorder.flush(timeout=10.0)
    return [acted, s.observe(), s.step(), s.observe()]


def _counter(s):
    s.provisioner()
    s.pod("count-0", requests={"cpu": "1"})
    s.step()
    s.kubelet()
    return [s.step(), s.observe()]


def _failed_scheduling(s):
    s.provisioner()
    s.pod("typo", 0, requests={"cpu": "1"}, node_selector={"zone": "test-zone-1"})
    s.pod("huge", 1, requests={"cpu": "10000"})
    s.pod("taint", 2, requests={"cpu": "1"},
          node_selector={"karpenter.sh/capacity-type": "reserved"})
    out = [s.step(), s.observe()]
    msgs = [e[4] for e in out[1]["events"] if e[3] == "FailedScheduling"]
    assert any('label "zone" does not have known values '
               '(typo of "topology.kubernetes.io/zone"?)' in x for x in msgs), msgs
    assert any("no instance type satisfied resources" in x for x in msgs), msgs
    return out


def _batch_cap(s):
    s.provisioner()
    for i in range(7):
        s.pod(f"cap-{i}", i, requests={"cpu": "0.5"})
    out = []
    for _ in range(3):
        out += [s.step(), s.op.provisioning.batcher._trigger.is_set(), s.observe()]
        s.kubelet()
    assert len(s.nominated) == 7
    return out


def _ice(s):
    """The cheapest type is exhausted in every pool: its launches fail,
    the cache masks it, and the next pass places the pods elsewhere."""
    s.provisioner()
    s.cp.insufficient_capacity = {("fake-it-1", "", "")}
    s.pod("ice-0", requests={"cpu": "1.5"})
    out = [s.step(), sorted(s.op.provisioning.ice_cache.keys()), s.observe()]
    out += [s.step(), s.observe()]
    assert not any(n[1] == "fake-it-1" for n in out[-1]["nodes"])
    return out


def _limits(s):
    """The counter's resources stop a second launch past the limit."""
    s.provisioner(limits={"cpu": "3"})
    s.pod("lim-0", 0, requests={"cpu": "2"})
    out = [s.step(), s.observe()]
    s.kubelet()
    s.pod("lim-1", 1, requests={"cpu": "2"})
    out += [s.step(), s.observe()]
    return out


STEP_CASES = {
    "provisioning end to end": _provisioning_end_to_end,
    "machine lifecycle to initialized": _machine_lifecycle,
    "liveness": _liveness,
    "termination": _termination,
    "do-not-evict": _do_not_evict,
    "emptiness": _emptiness,
    "multi-node consolidation": _multi_node_consolidation,
    "counter": _counter,
    "failed scheduling causes": _failed_scheduling,
    "ice": _ice,
    "provisioner limits": _limits,
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_operator_step_matches_reference(case):
    out = run_both(STEP_CASES[case])
    if case == "provisioning end to end":
        assert out[0]["launched"] >= 1 and out[1]["counters"]["nodes_created"] >= 1
    if case == "counter":
        assert dict(out[1]["resources"]["default"])["cpu"] > 0
    if case == "do-not-evict":
        assert any(e[3] == "FailedDraining" for e in out[-1]["events"])
    if case == "ice":
        assert out[1] == [("fake-it-1", "", "")]
        assert out[2]["counters"]["launch_failures/insufficient_capacity"] >= 1
        assert out[2]["counters"]["retriggers"] == 1
    if case == "provisioner limits":
        assert out[2]["launched"] == 0 and dict(out[3]["resources"]["default"])["cpu"] == 3.0
        assert ("Pod", "default/lim-1", "Warning", "FailedScheduling",
                "Failed to schedule pod, unschedulable") in out[3]["events"]


def test_batch_cap_retriggers_until_the_backlog_is_empty():
    out = run_both(_batch_cap, settings={"batch_max_pods": 3})
    assert [o["launched"] > 0 for o in out[0::3]] == [True, True, True]
    assert out[1]  # the deferred pods re-triggered the batcher at once


# -- the counter and the inflight checks (the counterparts of test_aux.py) ------

def _inflight(m, clock, op, case):
    t, o = m.t, m.o
    if case == "failed init":
        node = t.make_node(name="stuck", labels={PROV: "default"}, capacity={"cpu": "4"},
                           ready=False)
        node.metadata.creation_timestamp = clock() - 2 * 3600
    elif case == "young":
        node = t.make_node(name="stuck", labels={PROV: "default"}, capacity={"cpu": "4"},
                           ready=False)
        node.metadata.creation_timestamp = clock() - 60
    elif case == "startup taint":
        machine = t.make_machine(name="mc", provider_id="fake://stuck", capacity={"cpu": "4"})
        machine.spec.startup_taints = [o.Taint(key="never.leaves/taint", effect="NoSchedule")]
        op.kube_client.create(machine)
        node = t.make_node(name="stuck", labels={PROV: "default"}, capacity={"cpu": "4"},
                           provider_id="fake://stuck",
                           taints=[o.Taint(key="never.leaves/taint", effect="NoSchedule")])
        node.metadata.creation_timestamp = clock() - 2 * 3600
    else:  # a stuck termination: a do-not-evict pod, and a PDB at 0
        node = t.make_node(name="stuck", labels={PROV: "default"}, capacity={"cpu": "4"})
        node.metadata.finalizers.append("karpenter.sh/termination")
        for name, extra in (("guarded", {"labels": {"app": "guarded"}}),
                            ("pinned", {"annotations": {"karpenter.sh/do-not-evict": "true"}})):
            pod = t.make_pod(name=name, node_name="stuck", unschedulable=False, **extra)
            pod.status.phase = "Running"
            op.kube_client.create(pod)
        pdb = o.PodDisruptionBudget(
            spec=o.PodDisruptionBudgetSpec(selector=o.LabelSelector(
                match_labels={"app": "guarded"})),
            status=o.PodDisruptionBudgetStatus(disruptions_allowed=0))
        pdb.metadata.name, pdb.metadata.namespace = "guard", "default"
        op.kube_client.create(pdb)
    op.kube_client.create(node)
    if case == "stuck termination":
        op.kube_client.delete("Node", "", "stuck")
    op.sync_state()
    node = op.kube_client.get("Node", "", "stuck")
    period = op.inflight_checks.reconcile(node)
    return period, [e.message for e in op.recorder.for_object("Node", "stuck")]


@pytest.mark.parametrize("case", ["failed init", "young", "startup taint",
                                  "stuck termination", "node shape"])
def test_inflight_checks_match_reference(case):
    def run(m):
        clock = m.t.FakeClock(T0)
        solver = None
        if m.pkg == "torch":
            solver = TorchSolver(max_nodes=64, device="cpu", incremental="off")
        else:
            from karpenter_core_tpu.solver.tpu_solver import TPUSolver

            solver = TPUSolver(max_nodes=64, backend="mxu", incremental="off")
        op = m.new_operator(m.fake.FakeCloudProvider(m.fake.instance_types(10)),
                            settings=m.settings.Settings(), solver=solver, clock=clock)
        if case != "node shape":
            return _inflight(m, clock, op, case)
        op.kube_client.create(m.t.make_provisioner(name="default"))
        pod = m.t.make_pod(name="shape-0", requests={"cpu": "1"})
        pod.metadata.uid = "uid-shape-0"
        op.kube_client.create(pod)
        op.step()
        node = op.kube_client.list("Node")[0]
        machine = op.kube_client.get("Machine", "", node.metadata.name)
        node.status.capacity = {k: v * 0.5 for k, v in machine.status.capacity.items()}
        node.status.allocatable = dict(node.status.capacity)
        node.status.conditions.append(m.o.Condition(type="Ready", status="True"))
        op.kube_client.update_status(node)
        op.sync_state()
        period = op.inflight_checks.reconcile(op.kube_client.get("Node", "",
                                                                 node.metadata.name))
        return period, [e.message for e in op.recorder.for_object("Node", node.metadata.name)]

    period, messages = both(run)
    if case == "young":
        assert not messages
    else:
        assert messages, case


# -- the background runtime (test_operator_runtime.py:226) ------------------------

def test_start_provisions_a_pending_pod_and_stop_joins_every_thread():
    from karpenter_core_tpu_torch.cloudprovider import fake
    from karpenter_core_tpu_torch.operator import new_operator
    from karpenter_core_tpu_torch.testing import make_pod, make_provisioner

    def errors():
        return {tuple(sorted(k.items())): v for k, v in tctrl.RECONCILE_ERRORS.series()}

    before = errors()
    op = new_operator(fake.FakeCloudProvider(fake.instance_types(5)),
                      settings=tsettings.Settings(batch_idle_duration=0.05,
                                                  batch_max_duration=0.1),
                      solver=TorchSolver(max_nodes=64, device="cpu"))
    op.kube_client.create(make_provisioner(name="default"))
    op.start()
    alive = None
    try:
        op.kube_client.create(make_pod(name="bg-0", requests={"cpu": "1"}))
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and not op.kube_client.list("Machine"):
            time.sleep(0.05)
        assert op.kube_client.list("Machine"), "no machine launched within 60 s"
        while time.monotonic() < deadline and not op.recorder.for_object("Pod",
                                                                         "default/bg-0"):
            time.sleep(0.05)
        assert [e.reason for e in op.recorder.for_object("Pod", "default/bg-0")] == [
            "Nominated"]
        assert all(s._thread.is_alive() for s in op.singletons)
    finally:
        alive = op.stop()
    assert alive == []
    assert not op.eviction_queue._thread
    assert {k: v for k, v in errors().items() if before.get(k) != v} == {}


# -- what hides no card: the solver factory and the fallback ---------------------

def test_build_solver_never_falls_back_to_the_cpu():
    import torch

    from karpenter_core_tpu_torch.solver.factory import build_solver

    solver = build_solver(max_nodes=32, device="cpu")
    assert isinstance(solver, TorchSolver) and solver.device.type == "cpu"
    assert solver.max_nodes == 32
    single = build_solver(max_nodes=32, mode="single", device="cpu")
    assert isinstance(single, TorchSolver) and single.device.type == "cpu"
    with pytest.raises(RuntimeError, match="only one device"):
        build_solver(mode="sharded", device="cpu")
    with pytest.raises(ValueError):
        build_solver(mode="greedy", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            build_solver()


def test_a_solver_exception_propagates_unless_a_fallback_is_given():
    from karpenter_core_tpu_torch.cloudprovider import fake
    from karpenter_core_tpu_torch.operator import new_operator
    from karpenter_core_tpu_torch.testing import FakeClock, make_pod, make_provisioner

    class Broken:
        def solve(self, *a, **kw):
            raise RuntimeError("the card is gone")

    from karpenter_core_tpu_torch.api.validation import ValidationError

    # with_webhooks installs admission on the client: an invalid write fails
    admitted = new_operator(fake.FakeCloudProvider(), solver=Broken(), with_webhooks=True)
    bad = make_provisioner(name="bad")
    bad.spec.ttl_seconds_until_expired = -1
    with pytest.raises(ValidationError, match="ttlSecondsUntilExpired"):
        admitted.kube_client.create(bad)
    op = new_operator(fake.FakeCloudProvider(fake.instance_types(4)), solver=Broken(),
                      clock=FakeClock())
    op.kube_client.create(make_provisioner(name="default"))
    op.kube_client.create(make_pod(name="fb-0", requests={"cpu": "1"}))
    tprov.reset_counts()
    with pytest.raises(RuntimeError, match="the card is gone"):
        op.step()
    assert tprov.FALLBACKS["solver"] == 0 and not op.kube_client.list("Machine")
    op.provisioning.fallback_solver = TorchSolver(max_nodes=32, device="cpu")
    assert op.step()["launched"] == 1
    assert tprov.FALLBACKS["solver"] == 1
