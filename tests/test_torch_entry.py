"""The port's process entry (operator/__main__.py) and the modules it
wires, on the CPU.

- run(..., device="cpu") end to end with a stop_event: the prewarm of the
  S and M tiers, leader election, a backlog provisioned through the
  ResilientSolver, every endpoint of the health server, the webhook
  server, and a clean stop (threads joined, the lease released);
- what the entry refuses: no card, KARPENTER_SOLVER_MODE=sharded over one
  device; a run
  with KARPENTER_CHAOS armed (two injected create failures, every pod
  nominated) and a malformed spec refused; the primary it wires: the
  solver host by default, a
  RemoteSolver for a solver endpoint (flag or environment), the
  in-process TorchSolver with KARPENTER_SOLVER_HOST=off, and the brownout
  loop KARPENTER_SLO_BROWNOUT arms;
- resolve_settings from the karpenter-global-settings ConfigMap against
  the reference's;
- apply_server_gc_tuning, restored by its fixture;
- karpenter_bucket_overflow_total against the reference's, axis by axis;
- TorchSolver.prewarm_snapshot and solver/prewarm.py: outcomes, the
  metrics, a failing tier, and the per-solve state and residency a
  prewarm must leave alone, running beside live solves;
- new_operator(with_webhooks=True), the leader elector's renew thread.
"""
import contextlib
import gc
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

import karpenter_core_tpu.api.settings as jsettings
import karpenter_core_tpu.operator.__main__ as jentry
import karpenter_core_tpu.solver.encode as jencode
from karpenter_core_tpu.metrics.registry import REGISTRY as JREGISTRY
from karpenter_core_tpu_torch.api import settings as tsettings
from karpenter_core_tpu_torch.api.validation import ValidationError
from karpenter_core_tpu_torch.cloudprovider import fake
from karpenter_core_tpu_torch.kube.client import InMemoryKubeClient
from karpenter_core_tpu_torch.kube.objects import ConfigMap, ObjectMeta
from karpenter_core_tpu_torch.metrics.registry import NAMESPACE, REGISTRY
from karpenter_core_tpu_torch.obs import TRACER
from karpenter_core_tpu_torch.obs import log as tlog
from karpenter_core_tpu_torch.obs.flightrec import FLIGHTREC
from karpenter_core_tpu_torch.operator import __main__ as entry
from karpenter_core_tpu_torch.operator import injection, leaderelection, new_operator
from karpenter_core_tpu_torch.operator.options import parse_options
from karpenter_core_tpu_torch.ops import pack
from karpenter_core_tpu_torch.solver import encode as tencode
from karpenter_core_tpu_torch.solver import prewarm as tprewarm
from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver
from karpenter_core_tpu_torch.testing import make_pod, make_provisioner
from karpenter_core_tpu_torch.utils import gctuning
from karpenter_core_tpu_torch.webhooks.server import HAVE_CRYPTOGRAPHY


@contextlib.contextmanager
def _restored_gc():
    """apply_server_gc_tuning changes the whole process's collector: put
    back the threshold, unfreeze, and forget that it was applied."""
    threshold, applied = gc.get_threshold(), gctuning._applied
    try:
        yield threshold
    finally:
        gc.unfreeze()
        gc.set_threshold(*threshold)
        gctuning._applied = applied


@pytest.fixture
def gc_state():
    with _restored_gc() as threshold:
        yield threshold


@pytest.fixture
def process_state(gc_state):
    """What run() arms process-wide: the collector, the tracer, the flight
    recorder, the structured log, the injected defaults, the settings."""
    tracing, recording = TRACER.enabled, FLIGHTREC.enabled
    level, fmt, stream = tlog.SINK.level, tlog.SINK.fmt, tlog.SINK.stream
    yield
    TRACER.enabled = tracing
    FLIGHTREC.enabled = recording
    tlog.SINK.configure(level=level, fmt=fmt, stream=stream)
    injection._default_options = injection._default_settings = None
    tsettings.set_current(tsettings.Settings())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.read()


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


# -- run() end to end ------------------------------------------------------------


def test_run_serves_a_backlog_end_to_end_on_the_cpu(monkeypatch, process_state):
    # the suite's conftest turns the prewarm off for every operator run
    monkeypatch.setenv("KARPENTER_PREWARM", "1")
    monkeypatch.setenv("KARPENTER_PREWARM_TIERS", "S,M")
    # 101 types x 200 pods passes the ResilientSolver's small-batch bound
    # (20,000), so the backlog is the card's solver's, not the host's
    cp = fake.FakeCloudProvider(fake.instance_types(101))
    client = InMemoryKubeClient()
    client.create(make_provisioner(name="default"))
    client.create(ConfigMap(metadata=ObjectMeta(name="karpenter-global-settings",
                                                namespace="karpenter"),
                            data={"batchIdleDuration": "50ms", "batchMaxDuration": "1s"}))
    argv = ["--metrics-port", "0", "--enable-profiling"]
    if HAVE_CRYPTOGRAPHY:
        argv += ["--webhook-port", str(_free_port())]
    else:
        argv += ["--disable-webhook"]
    opts = parse_options(argv)
    stop = threading.Event()
    got = {}
    for name in ("TOTAL", "READY"):
        getattr(tprewarm, f"PREWARM_{name}").clear()

    def main():
        try:
            got["op"] = entry.run(cp, kube_client=client, stop_event=stop, options=opts,
                                  device="cpu", on_start=lambda p: got.update(proc=p))
        except BaseException as exc:  # noqa: BLE001 — reported by the test
            got["error"] = exc

    before = {t.ident for t in threading.enumerate()}
    t = threading.Thread(target=main, name="entry-under-test")
    t.start()
    try:
        _wait(lambda: "proc" in got or "error" in got, 120, "the entry to start")
        assert "error" not in got, got.get("error")
        proc = got["proc"]
        _wait(lambda: tprewarm.PREWARM_READY.get() == 1.0, 300, "the prewarm")
        outcomes = {labels["tier"]: labels["outcome"]
                    for labels, _ in tprewarm.PREWARM_TOTAL.series()}
        assert outcomes == {"S": "compiled", "M": "compiled"}
        # the lease is the elector's, the settings the ConfigMap's
        lease = client.get("Lease", leaderelection.LEASE_NAMESPACE, leaderelection.LEASE_NAME)
        assert lease.spec.holder_identity == proc.elector.identity
        assert proc.settings.batch_idle_duration == 0.05
        assert injection.get_settings() is proc.settings
        assert injection.get_options() is opts
        # a backlog, nominated through the wired solver
        bound = {}
        proc.operator.provisioning.bind_listeners.append(
            lambda pod, node: bound.__setitem__(pod.metadata.name, node))
        names = [f"bl-{i}" for i in range(200)]
        for i, name in enumerate(names):
            client.create(make_pod(name=name, requests={"cpu": ["250m", "1"][i % 2]},
                                   uid=f"uid-bl-{i}"))
        _wait(lambda: set(names) <= set(bound), 120, "every backlog pod nominated")
        assert client.list("Machine")
        report = proc.solver.health_report()
        assert report["healthy"] is True and report["breaker"] == "closed"
        port = proc.health_port
        for path in ("/healthz", "/readyz"):
            assert _get(port, path)[0] == 200
        status, body = _get(port, "/metrics")
        text = body.decode()
        for family in ("karpenter_prewarm_ready 1", "karpenter_prewarm_total",
                       "karpenter_slo_error_budget_remaining", "karpenter_solver_solve_duration"):
            assert family in text, family
        health = json.loads(_get(port, "/debug/health")[1])
        assert health["status"] == "ok" and health["solver"]["breaker"] == "closed"
        config = json.loads(_get(port, "/debug/config")[1])
        assert config["options"]["enable_profiling"] is True
        assert config["settings"]["batch_idle_duration"] == 0.05
        index = json.loads(_get(port, "/debug/")[1])
        for ep in index["endpoints"]:
            if ep["path"] != "/metrics":
                assert _get(port, ep["path"])[0] == 200, ep["path"]
        assert {"/debug/tenants", "/debug/timeline", "/debug/programs"} <= {
            ep["path"] for ep in index["endpoints"]}
        programs = json.loads(_get(port, "/debug/programs")[1])
        assert any(r["family"] == "solve" for r in programs["programs"])
        spans = {sp.name for sp in TRACER.spans()}
        assert {"solver.prewarm", "solver.solve", "provisioner.reconcile"} <= spans
        if HAVE_CRYPTOGRAPHY:
            assert proc.webhook is not None and proc.webhook.port == opts.webhook_port
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive()
    assert "error" not in got, got.get("error")
    proc = got["proc"]
    assert proc.alive == []
    lease = client.get("Lease", leaderelection.LEASE_NAMESPACE, leaderelection.LEASE_NAME)
    assert lease.spec.renew_time is None
    # every thread the entry started is gone, but the reconcile pools'
    # idle workers, which live for the process (operator/controller._pools)
    from karpenter_core_tpu_torch.operator import controller as opcontroller

    pooled = {th for pool in opcontroller._pools.values() for th in pool._threads}
    left = [th.name for th in threading.enumerate()
            if th.ident not in before and th.is_alive() and th is not t
            and th not in pooled]
    assert not left, left
    with pytest.raises(urllib.error.URLError):
        _get(proc.health_port, "/healthz")
    assert gc.get_threshold()[2] == 100 and gctuning._applied


def test_run_refuses_without_a_card(process_state):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry.run(fake.FakeCloudProvider(), options=parse_options(["--metrics-port", "0"]))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry.main(["--metrics-port", "0"])


@pytest.mark.parametrize("env,argv,item", [
    ({"KARPENTER_SOLVER_MODE": "sharded"}, [], "only one device is visible"),
], ids=["sharded"])
def test_run_refuses_what_is_not_ported(monkeypatch, process_state, env, argv, item):
    """KARPENTER_SOLVER_MODE=sharded over one device fails the start, as
    the reference's factory does (a grid needs two devices or more)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match=item):
        entry.run(fake.FakeCloudProvider(), options=parse_options(argv + ["--metrics-port",
                                                                          "0"]),
                  device="cpu")
    assert threading.active_count() == threads  # refused before anything started


def test_run_arms_karpenter_chaos(monkeypatch, process_state):
    """KARPENTER_CHAOS set before run(): its points are armed for the run
    (the reference's entry arms the spec at import), so two cloud-provider
    creates fail, the launch retries, and every pod is nominated; a
    malformed spec fails the start."""
    from karpenter_core_tpu_torch import chaos
    from karpenter_core_tpu_torch.chaos import CHAOS_INJECTED_TOTAL

    chaos.reset()
    monkeypatch.setenv("KARPENTER_CHAOS", "cloudprovider.create=error:conn,times:2")
    series = {"point": chaos.CLOUDPROVIDER_CREATE, "error": "conn"}
    before = CHAOS_INJECTED_TOTAL.get(series)
    cp = fake.FakeCloudProvider(fake.instance_types(8))
    client = InMemoryKubeClient()
    client.create(make_provisioner(name="default"))
    client.create(ConfigMap(metadata=ObjectMeta(name="karpenter-global-settings",
                                                namespace="karpenter"),
                            data={"batchIdleDuration": "50ms", "batchMaxDuration": "500ms"}))
    stop, got, bound = threading.Event(), {}, {}

    def main():
        try:
            entry.run(cp, kube_client=client, stop_event=stop, device="cpu",
                      on_start=lambda p: got.update(proc=p),
                      options=parse_options(["--metrics-port", "0", "--no-leader-elect",
                                             "--disable-webhook"]))
        except BaseException as exc:  # noqa: BLE001 — reported by the test
            got["error"] = exc

    t = threading.Thread(target=main, name="entry-under-chaos")
    t.start()
    try:
        _wait(lambda: "proc" in got or "error" in got, 120, "the entry to start")
        assert "error" not in got, got.get("error")
        fault = chaos.armed_points()[chaos.CLOUDPROVIDER_CREATE]
        got["proc"].operator.provisioning.bind_listeners.append(
            lambda pod, node: bound.__setitem__(pod.metadata.name, node))
        names = [f"ch-{i}" for i in range(6)]
        for i, name in enumerate(names):
            client.create(make_pod(name=name, requests={"cpu": "1"}, uid=f"uid-ch-{i}"))
        _wait(lambda: set(names) <= set(bound), 120, "every pod nominated")
    finally:
        stop.set()
        t.join(timeout=60)
        chaos.reset()
    assert not t.is_alive() and "error" not in got, got.get("error")
    assert fault.injected == 2 and fault.calls > 2
    assert CHAOS_INJECTED_TOTAL.get(series) == before + 2
    assert client.list("Machine")
    monkeypatch.setenv("KARPENTER_CHAOS", "cloudprovider.craete=error:conn")
    with pytest.raises(ValueError, match="unknown chaos fault point"):
        entry.run(cp, options=parse_options(["--metrics-port", "0"]), device="cpu")
    assert chaos.armed_points() == {}


@pytest.mark.parametrize("env,argv,want", [
    ({"KARPENTER_SOLVER_HOST": "on", "KARPENTER_SLO_BROWNOUT": "1"}, [], "HostSolver"),
    ({"KARPENTER_SOLVER_ENDPOINT": "127.0.0.1:1"}, [], "RemoteSolver"),
    ({}, ["--solver-endpoint", "127.0.0.1:1"], "RemoteSolver"),
    ({"KARPENTER_SOLVER_HOST": "off"}, [], "TorchSolver"),
], ids=["solver-host", "solver-endpoint-env", "solver-endpoint-flag", "in-process"])
def test_run_wires_the_primary(monkeypatch, process_state, env, argv, want):
    """The reference entry's wiring: the host (the default; the suite's
    conftest turns it off), a RemoteSolver for an endpoint, the in-process
    solver with the host off. An out-of-process primary is watched by its
    own watchdog and probed through health(); the host's child is never
    spawned here (no solve, no prewarm) and its close() leaves nothing."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    stop, got = threading.Event(), {}

    def on_start(proc):
        got["proc"] = proc
        stop.set()

    entry.run(fake.FakeCloudProvider(), stop_event=stop, device="cpu", on_start=on_start,
              options=parse_options(argv + ["--metrics-port", "0", "--no-leader-elect",
                                            "--disable-webhook"]))
    proc = got["proc"]
    assert type(proc.primary).__name__ == want
    remote = want != "TorchSolver"
    assert (proc.solver.wedge_stale_after is None) is remote
    if want == "HostSolver":
        assert proc.primary.device == "cpu" and proc.primary.host.pid is None
        gate = proc.primary.admission
        assert gate.ladder is not None and gate.brownout_prefer is not None
        names = {o.name for o in entry.build_slo_engine(admission=gate).objectives}
        assert "gate-admission" in names
    if want == "RemoteSolver":
        assert proc.primary.target == "127.0.0.1:1"
    assert proc.alive == []


def test_build_primary_refuses_host_mode_and_builds_in_process(monkeypatch):
    """build_primary: KARPENTER_SOLVER_HOST on builds the HostSolver (its
    child spawns at first use, on the device given), off the in-process
    TorchSolver, whatever host_default says."""
    from karpenter_core_tpu_torch.solver import factory
    from karpenter_core_tpu_torch.solver.host import HostSolver

    monkeypatch.setenv("KARPENTER_SOLVER_HOST", "on")
    host = factory.build_primary(max_nodes=64, device="cpu")
    assert isinstance(host, HostSolver) and host.max_nodes == 64
    assert factory.describe(host) == "HostSolver(cpu)" and host.host.pid is None
    host.close()
    monkeypatch.setenv("KARPENTER_SOLVER_HOST", "off")
    solver = factory.build_primary(max_nodes=64, host_default=True, device="cpu")
    assert isinstance(solver, TorchSolver) and solver.max_nodes == 64
    assert factory.describe(solver) == "TorchSolver(cpu)"
    monkeypatch.delenv("KARPENTER_SOLVER_HOST")
    assert isinstance(factory.build_primary(device="cpu", host_default=True), HostSolver)


# -- settings, options, injection --------------------------------------------------


@pytest.mark.parametrize("data", [
    {"batchIdleDuration": "2s", "batchMaxDuration": "20s"},
    {"batchMaxDuration": "1m", "bucketLadder": "S:16:8:4:2,M:32:16:8:4"},
    {},
], ids=["windows", "ladder", "empty"])
def test_resolve_settings_from_the_config_map_as_the_reference(data):
    from karpenter_core_tpu.kube.client import InMemoryKubeClient as JClient
    from karpenter_core_tpu.kube.objects import ConfigMap as JConfigMap
    from karpenter_core_tpu.kube.objects import ObjectMeta as JMeta

    tclient, jclient = InMemoryKubeClient(), JClient()
    tclient.create(ConfigMap(metadata=ObjectMeta(name="karpenter-global-settings",
                                                 namespace="karpenter"), data=dict(data)))
    jclient.create(JConfigMap(metadata=JMeta(name="karpenter-global-settings",
                                             namespace="karpenter"), data=dict(data)))
    from karpenter_core_tpu.operator.options import parse_options as jparse

    got = entry.resolve_settings(tclient, parse_options([]))
    want = jentry.resolve_settings(jclient, jparse([]))
    assert repr(got) == repr(want)
    # without the ConfigMap the flags decide
    opts = parse_options(["--batch-idle-seconds", "0.5"])
    assert entry.resolve_settings(InMemoryKubeClient(), opts).batch_idle_duration == 0.5


def test_options_match_the_reference(monkeypatch):
    from karpenter_core_tpu.operator.options import parse_options as jparse

    monkeypatch.setenv("KARPENTER_WEBHOOK_PORT", "9443")
    monkeypatch.setenv("KARPENTER_DISABLE_WEBHOOK", "1")
    argv = ["--metrics-port", "9000", "--no-leader-elect", "--memory-limit", "1024"]
    assert vars(parse_options(argv)) == vars(jparse(argv))


def test_injection_defaults_are_seen_from_every_thread():
    s = tsettings.Settings(batch_max_duration=7.0)
    try:
        injection.inject_defaults(options="opts", settings=s)
        seen = {}
        th = threading.Thread(target=lambda: seen.update(
            o=injection.get_options(), s=injection.get_settings()))
        th.start()
        th.join()
        assert seen == {"o": "opts", "s": s}
        with injection.with_settings(tsettings.Settings(batch_max_duration=1.0)):
            assert injection.get_settings().batch_max_duration == 1.0
        assert injection.get_settings() is s
    finally:
        injection._default_options = injection._default_settings = None


# -- gc tuning ---------------------------------------------------------------------


def test_apply_server_gc_tuning_is_idempotent_and_restored():
    before = gc.get_threshold()
    a0, a1, _ = before
    with _restored_gc():
        gctuning.apply_server_gc_tuning()
        assert gc.get_threshold() == (a0, a1, 100)
        assert gc.get_freeze_count() > 0
        gctuning.apply_server_gc_tuning(gen2_threshold=7)  # the first call's stays
        assert gc.get_threshold() == (a0, a1, 100)
    assert gc.get_threshold() == before
    assert gc.get_freeze_count() == 0
    assert not gctuning._applied


# -- the overflow counter ------------------------------------------------------------


def test_bucket_overflow_counter_matches_the_reference():
    jladder = (jsettings.GeometryTier("S", pods=128, items=32, instance_types=4,
                                      existing_nodes=8),)
    tladder = (tsettings.GeometryTier("S", pods=128, items=32, instance_types=4,
                                      existing_nodes=8),)
    cases = [(65, "items", 32), (300, "items", 32), (9, "existing_nodes", 8),
             (5, "instance_types", 1), (4, "instance_types", 1), (40, "existing_nodes", 8)]
    name = f"{NAMESPACE}_bucket_overflow_total"
    jc, tc = JREGISTRY.counter(name), REGISTRY.counter(name)
    axes = ("items", "existing_nodes", "instance_types")
    jb = {a: jc.get({"axis": a}) for a in axes}
    tb = {a: tc.get({"axis": a}) for a in axes}
    for n, axis, lo in cases:
        assert tencode.ladder_pad(n, tladder, axis, lo) == jencode.ladder_pad(n, jladder,
                                                                              axis, lo)
    jd = {a: jc.get({"axis": a}) - jb[a] for a in axes}
    td = {a: tc.get({"axis": a}) - tb[a] for a in axes}
    assert td == jd == {"items": 2, "existing_nodes": 2, "instance_types": 1}


def test_encode_counts_overflow_through_the_settings_ladder():
    """encode_snapshot pads against the process-wide Settings' ladder, as
    the reference's does, and counts an overflowing axis."""
    ladder = (tsettings.GeometryTier("S", pods=64, items=32, instance_types=2,
                                     existing_nodes=8),)
    prev = tsettings.current()
    tsettings.set_current(tsettings.Settings(bucket_ladder=ladder))
    counter = REGISTRY.counter(f"{NAMESPACE}_bucket_overflow_total")
    before = counter.get({"axis": "instance_types"})
    try:
        snap = tencode.encode_snapshot([make_pod(requests={"cpu": "1"})],
                                       [make_provisioner(name="default")],
                                       {"default": fake.instance_types(5)})
    finally:
        tsettings.set_current(prev)
    assert snap.type_alloc.shape[0] == 8  # 5 past the rung of 2: 2 -> 4 -> 8
    assert counter.get({"axis": "instance_types"}) == before + 1


# -- the prewarm ---------------------------------------------------------------------


SMALL = (tsettings.GeometryTier("S", pods=128, items=32, instance_types=8, existing_nodes=8),
         tsettings.GeometryTier("M", pods=256, items=64, instance_types=8, existing_nodes=16))


def test_prewarm_outcomes_metrics_and_span():
    provs = [make_provisioner(name="default")]
    its = {"default": fake.instance_types(5)}
    solver = TorchSolver(max_nodes=48, device="cpu")
    settings = tsettings.Settings(bucket_ladder=SMALL, batch_max_pods=100)
    tprewarm.PREWARM_TOTAL.clear()
    TRACER.enable()
    TRACER.clear()
    try:
        assert tprewarm.prewarm(solver, provs, its, settings=settings) == {
            "S": "compiled", "M": "compiled"}
        assert tprewarm.PREWARM_READY.get() == 1.0
        assert tprewarm.prewarm(solver, provs, its, settings=settings) == {
            "S": "cached", "M": "cached"}
        spans = [sp for sp in TRACER.spans() if sp.name == "solver.prewarm"]
    finally:
        TRACER.disable()
    # the steady-state tier first (the batch cap of 100 lands on S)
    assert [sp.attrs["tier"] for sp in spans] == ["S", "M", "S", "M"]
    assert tprewarm.PREWARM_TOTAL.get({"tier": "S", "outcome": "cached"}) == 1.0
    stop = threading.Event()
    stop.set()
    assert tprewarm.prewarm(solver, provs, its, settings=settings, stop=stop) == {
        "S": "skipped", "M": "skipped"}
    assert tprewarm.PREWARM_READY.get() == 0.0


def test_prewarm_tier_failure_is_visible_and_survived(monkeypatch):
    provs = [make_provisioner(name="default")]
    its = {"default": fake.instance_types(5)}
    solver = TorchSolver(max_nodes=48, device="cpu")
    calls = []

    def failing(snap, provisioners):
        calls.append(snap)
        if len(calls) == 1:
            raise RuntimeError("injected tier failure")
        return "compiled"

    monkeypatch.setattr(solver, "prewarm_snapshot", failing)
    was = tlog.SINK.level
    tlog.SINK.configure(level=tlog.INFO, stream=None)
    try:
        out = tprewarm.prewarm(solver, provs, its,
                               settings=tsettings.Settings(bucket_ladder=SMALL,
                                                           batch_max_pods=100))
        warnings = [r for r in tlog.SINK.records() if r.get("msg") == "prewarm tier failed"]
    finally:
        tlog.SINK.level = was
    assert out == {"S": "error", "M": "compiled"}
    assert tprewarm.PREWARM_READY.get() == 0.0
    assert warnings and warnings[-1]["tier"] == "S" and warnings[-1]["level"] == "warning"


def test_prewarm_leaves_the_live_solve_state_alone():
    """A prewarm neither reads nor evicts a resident prescreen tensor, and
    leaves last_phase_ms, last_prescreen_* and the scan's counts as the
    last live solve left them; a live solve after it equals one on a fresh
    solver."""
    provs = [make_provisioner(name="default")]
    its = {"default": fake.instance_types(5)}
    pods = [make_pod(name=f"p-{i}", requests={"cpu": str(0.1 + 0.01 * (i % 7))},
                     uid=f"uid-p-{i}", creation_timestamp=1000.0 + i) for i in range(40)]
    solver = TorchSolver(max_nodes=48, device="cpu")
    first = solver.solve(pods, provs, its)
    state = (dict(solver.last_phase_ms), solver.last_prescreen_mode,
             solver.last_prescreen_delta, solver.last_prescreen_launches,
             dict(pack.LAST_SCAN), list(solver._inc_screens))
    resident = {k: inc.resident(k) for k, inc in solver._inc_screens.items()}
    settings = tsettings.Settings(bucket_ladder=SMALL)
    for _ in range(2):
        tprewarm.prewarm(solver, provs, its, settings=settings)
    assert (dict(solver.last_phase_ms), solver.last_prescreen_mode,
            solver.last_prescreen_delta, solver.last_prescreen_launches,
            dict(pack.LAST_SCAN), list(solver._inc_screens)) == state
    for k, inc in solver._inc_screens.items():
        assert inc.resident(k) is resident[k]
    again = solver.solve(pods, provs, its)
    fresh = TorchSolver(max_nodes=48, device="cpu").solve(pods, provs, its)
    from karpenter_core_tpu_torch.solver.torch_solver import placements_json

    assert placements_json(again) == placements_json(fresh) == placements_json(first)


def test_prewarm_and_live_solves_serialize_on_the_solver_lock(monkeypatch):
    """A prewarm_snapshot never takes the state live solves carry: the
    solver's lock guards only that state's hand-over, so prewarms on one
    thread and live solves on another neither wait for each other nor
    disturb the residency (one carried state throughout, every solve after
    the first a refresh), and the solves equal a fresh solver's."""
    from karpenter_core_tpu_torch.solver import torch_solver

    provs = [make_provisioner(name="default")]
    its = {"default": fake.instance_types(5)}
    solver = TorchSolver(max_nodes=48, device="cpu")
    carried = solver._carried
    calls = []
    real = torch_solver.device_args

    def tracked(*a, **kw):
        calls.append(threading.current_thread().name)
        time.sleep(0.02)
        return real(*a, **kw)

    monkeypatch.setattr(torch_solver, "device_args", tracked)
    pods = [make_pod(name=f"lv-{i}", requests={"cpu": "1"}, uid=f"uid-lv-{i}",
                     creation_timestamp=1000.0 + i) for i in range(10)]
    settings = tsettings.Settings(bucket_ladder=SMALL)
    th = threading.Thread(target=lambda: [tprewarm.prewarm(solver, provs, its,
                                                           settings=settings)
                                          for _ in range(3)], name="prewarm")
    th.start()
    from karpenter_core_tpu_torch.solver.torch_solver import placements_json

    placements, modes = [], []
    for _ in range(5):
        placements.append(placements_json(solver.solve(pods, provs, its)))
        modes.append(solver.last_prescreen_mode)
    th.join(timeout=120)
    assert not th.is_alive()
    assert {"prewarm", threading.current_thread().name} <= set(calls)
    assert solver._carried is carried and not carried.held
    assert modes[1:] == ["refresh"] * (len(modes) - 1), modes
    fresh = placements_json(TorchSolver(max_nodes=48, device="cpu").solve(pods, provs, its))
    assert placements == [fresh] * len(placements)


# -- webhooks and leader election ----------------------------------------------------


def test_new_operator_with_webhooks_installs_admission():
    op = new_operator(fake.FakeCloudProvider(), solver=TorchSolver(device="cpu"),
                      with_webhooks=True)
    op.kube_client.create(make_provisioner(name="ok"))
    bad = make_provisioner(name="bad")
    bad.spec.ttl_seconds_after_empty = -1
    with pytest.raises(ValidationError, match="ttlSecondsAfterEmpty"):
        op.kube_client.create(bad)
    with pytest.raises(ValidationError, match="invalid settings"):
        op.kube_client.create(ConfigMap(
            metadata=ObjectMeta(name="karpenter-global-settings", namespace="karpenter"),
            data={"batchMaxDuration": "soon"}))
    plain = new_operator(fake.FakeCloudProvider(), solver=TorchSolver(device="cpu"))
    plain.kube_client.create(bad)  # no admission by default


@pytest.mark.skipif(not HAVE_CRYPTOGRAPHY, reason="the webhook's TLS needs `cryptography`")
def test_webhook_server_stop_joins_its_threads():
    from karpenter_core_tpu_torch.webhooks.server import WebhookServer

    srv = WebhookServer(InMemoryKubeClient())
    srv.start()
    threads = [srv._thread, srv._rotator]
    srv.stop()
    assert not any(t.is_alive() for t in threads)


def test_elector_renews_until_stopped_and_then_releases():
    client = InMemoryKubeClient()
    now = [1000.0]
    elector = leaderelection.LeaderElector(client, identity="a", clock=lambda: now[0])
    stop = threading.Event()
    assert elector.acquire_blocking(stop)
    saved = leaderelection.RENEW_PERIOD
    leaderelection.RENEW_PERIOD = 0.02
    try:
        elector.start_renewing(stop)
        now[0] = 1005.0
        _wait(lambda: client.get("Lease", leaderelection.LEASE_NAMESPACE,
                                 leaderelection.LEASE_NAME).spec.renew_time == 1005.0,
              10, "a renewal")
        stop.set()
        assert elector.join()
        elector.release()
    finally:
        leaderelection.RENEW_PERIOD = saved
    time.sleep(0.05)  # a renewal after the release would land here
    lease = client.get("Lease", leaderelection.LEASE_NAMESPACE, leaderelection.LEASE_NAME)
    assert lease.spec.renew_time is None
    b = leaderelection.LeaderElector(client, identity="b", clock=lambda: now[0])
    assert b.try_acquire()


def test_lease_round_trips_the_wire_format():
    from karpenter_core_tpu.kube.serialization import from_k8s_dict as jfrom
    from karpenter_core_tpu.kube.objects import Lease as JLease
    from karpenter_core_tpu_torch.kube.objects import Lease, LeaseSpec
    from karpenter_core_tpu_torch.kube.serialization import from_k8s_dict, to_k8s_dict

    lease = Lease(metadata=ObjectMeta(name="l", namespace="kube-system", uid="u",
                                      creation_timestamp=1.0),
                  spec=LeaseSpec(holder_identity="a", acquire_time=1700000000.5,
                                 renew_time=1700000001.25, lease_transitions=2))
    wire = to_k8s_dict(lease)
    assert wire["spec"]["renewTime"].endswith("Z")
    assert from_k8s_dict(Lease, wire) == lease
    assert jfrom(JLease, json.loads(json.dumps(wire))).spec.renew_time == 1700000001.25


def test_debug_backend_on_the_cpu():
    import torch

    body = json.loads(entry._debug_backend())
    assert body["torch"] == torch.__version__
    assert body["build_dir"].endswith("csrc/build")
    if not torch.cuda.is_available():
        assert body["cuda_available"] is False and body["loaded"] == []
