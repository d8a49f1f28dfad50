"""The port's ResilientSolver, probe and live solve record against the
reference's, on the CPU.

Each case of tests/test_resilient_recovery.py runs one script against
both packages' ResilientSolver (a fake clock and an injected prober where
the reference's case has them; the primary a GreedySolver subclass, as
there) and the two must agree on the registry series the script moves,
the Solver events, the breaker's state and the abandoned-thread inventory.
The reference's cases inject their hang through its chaos module; here
the primary hangs on an event of the test's own, the same on both sides.
`test_hang_drill_readmits_while_the_zombie_sleeps` hangs a real
`TorchSolver(device="cpu")` primary through the port's own
`solver.device.hang` point (the reference's `TPUSolver` through its own),
in the in-process soak drill's shape.
"""
import json
import threading
import time
from types import SimpleNamespace

import pytest

from karpenter_core_tpu_torch.obs import FLIGHTREC, flightrec as trec
from karpenter_core_tpu_torch.solver import fallback as tfallback
from karpenter_core_tpu_torch.solver import torch_solver as tsolver
from karpenter_core_tpu_torch.utils import supervise as tsupervise

from tests.test_torch_cuda import workload

SERIES = ("SOLVER_FALLBACK_TOTAL", "SOLVER_SMALL_BATCH_TOTAL", "BREAKER_TRANSITIONS",
          "SOLVER_WEDGED_TOTAL", "SOLVER_ABANDONED_TOTAL")


def _side(pkg):
    if pkg == "jax":
        from karpenter_core_tpu import testing
        from karpenter_core_tpu.api import settings
        from karpenter_core_tpu.cloudprovider import fake
        from karpenter_core_tpu.events import Recorder
        from karpenter_core_tpu.operator import new_operator
        from karpenter_core_tpu.solver import fallback
        from karpenter_core_tpu.solver.tpu_solver import GreedySolver
        from karpenter_core_tpu.utils import supervise
    else:
        from karpenter_core_tpu_torch import testing
        from karpenter_core_tpu_torch.api import settings
        from karpenter_core_tpu_torch.cloudprovider import fake
        from karpenter_core_tpu_torch.events import Recorder
        from karpenter_core_tpu_torch.operator import new_operator
        from karpenter_core_tpu_torch.solver import fallback
        from karpenter_core_tpu_torch.solver.torch_solver import GreedySolver
        from karpenter_core_tpu_torch.utils import supervise
    side = SimpleNamespace(pkg=pkg, t=testing, fake=fake, Recorder=Recorder, fb=fallback,
                           GreedySolver=GreedySolver, supervise=supervise,
                           Settings=settings.Settings, new_operator=new_operator,
                           hang=SimpleNamespace(latency=0.0, times=0, release=threading.Event()))

    class CountingPrimary(GreedySolver):
        """A working primary that counts its solves."""

        def __init__(self):
            super().__init__()
            self.calls = 0

        def solve(self, *a, **k):
            self.calls += 1
            return super().solve(*a, **k)

    class DispatchingPrimary(CountingPrimary):
        """A primary that touches the bound heartbeat as a device dispatch
        does and, while a hang is armed, goes silent for its latency."""

        def solve(self, *a, **k):
            supervise.touch_heartbeat()
            if side.hang.times > 0:
                side.hang.times -= 1
                side.hang.release.wait(side.hang.latency)
            supervise.touch_heartbeat()
            return super().solve(*a, **k)

    side.CountingPrimary, side.DispatchingPrimary = CountingPrimary, DispatchingPrimary
    return side


def _series(side):
    fb = side.fb
    out = {}
    for name in SERIES:
        for labels, v in getattr(fb, name).series():
            out[(name, tuple(sorted(labels.items())))] = v
    return out


def _delta(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def _inputs(side, n=5):
    t = side.t
    return ([t.make_pod(requests={"cpu": "1"}) for _ in range(n)],
            [t.make_provisioner(name="default")],
            {"default": side.fake.instance_types(10)})


def _wedge_pair(side, prober, **overrides):
    primary = side.DispatchingPrimary()
    kwargs = dict(prober=prober, small_batch_work_max=0, solve_timeout=10.0,
                  wedge_stale_after=0.3, watchdog_poll=0.05, reprobe_interval=0.4)
    kwargs.update(overrides)
    return primary, side.fb.ResilientSolver(primary, side.GreedySolver(), **kwargs)


def _arm(side, latency):
    side.hang.latency, side.hang.times = latency, 1


def _report(resilient):
    """health_report() less its timings."""
    r = resilient.health_report()
    r.pop("heartbeat_age_s")
    r["wedge_history"] = [{k: v for k, v in h.items() if k not in ("ts", "heartbeat_age_s")}
                          for h in r["wedge_history"]]
    return r


def _events(recorder):
    return [(e.reason, e.type) for e in recorder.for_object("Solver", "solver")]


# -- the ten cases of tests/test_resilient_recovery.py ----------------------------


def case_healthy_ttl_expiry_detects_midlife_wedge_on_big_batches(side):
    clock = side.t.FakeClock()
    health = {"reason": None}
    probes = []

    def prober():
        probes.append(clock())
        return health["reason"]

    primary = side.CountingPrimary()
    resilient = side.fb.ResilientSolver(primary, side.GreedySolver(), clock=clock,
                                        prober=prober, healthy_recheck_interval=600.0,
                                        small_batch_work_max=0)
    inputs = _inputs(side)
    resilient.solve(*inputs)
    assert primary.calls == 1 and len(probes) == 1
    resilient.solve(*inputs)
    assert len(probes) == 1
    health["reason"] = "tunnel wedged"
    clock.advance(601)
    result = resilient.solve(*inputs)
    assert result.pod_count_new() == 5
    assert len(probes) == 2
    assert primary.calls == 2
    assert resilient._healthy is False
    return resilient, None, (primary.calls, len(probes))


def case_unhealthy_backend_reprobe_restores_primary(side):
    clock = side.t.FakeClock()
    health = {"reason": "backend probe timed out after 60s"}
    primary = side.CountingPrimary()
    recorder = side.Recorder(clock=clock)
    resilient = side.fb.ResilientSolver(primary, side.GreedySolver(), clock=clock,
                                        recorder=recorder, prober=lambda: health["reason"],
                                        reprobe_interval=300.0, small_batch_work_max=0)
    inputs = _inputs(side)
    resilient.solve(*inputs)
    assert primary.calls == 0 and resilient._healthy is False
    resilient.solve(*inputs)
    assert primary.calls == 0
    health["reason"] = None
    resilient.solve(*inputs)
    assert primary.calls == 0
    clock.advance(301)
    result = resilient.solve(*inputs)
    assert result.pod_count_new() == 5
    assert primary.calls == 1
    assert resilient._healthy is True
    reasons = [e.reason for e in recorder.for_object("Solver", "solver")]
    assert "SolverDegraded" in reasons and "SolverRecovered" in reasons
    return resilient, recorder, primary.calls


def case_fallback_events_are_deduped(side):
    clock = side.t.FakeClock()

    class DyingPrimary(side.CountingPrimary):
        def solve(self, *a, **k):
            self.calls += 1
            raise RuntimeError("UNAVAILABLE: tunnel wedged")

    primary = DyingPrimary()
    recorder = side.Recorder(clock=clock)
    resilient = side.fb.ResilientSolver(primary, side.GreedySolver(), clock=clock,
                                        recorder=recorder, prober=lambda: None,
                                        reprobe_interval=0.0, small_batch_work_max=0)
    inputs = _inputs(side)
    for _ in range(6):
        resilient.solve(*inputs)
        clock.advance(1.0)
    degraded = [e for e in recorder.for_object("Solver", "solver")
                if e.reason == "SolverDegraded"]
    assert primary.calls >= 6
    assert len(degraded) == 1
    clock.advance(side.Recorder.DEDUPE_TTL + 1)
    resilient.solve(*inputs)
    degraded = [e for e in recorder.for_object("Solver", "solver")
                if e.reason == "SolverDegraded"]
    assert len(degraded) == 2
    return resilient, recorder, primary.calls


def case_wedge_cycle_fallback_breaker_and_prober_gated_readmission(side):
    """Hang, heartbeat staleness, abandoned as wedged, the breaker open at
    once, the fallback admitting, no probe while open, and after the reset
    TTL exactly one probe (never a live solve) re-admits the primary."""
    probes = []

    def prober():
        probes.append(time.monotonic())
        return None

    primary, resilient = _wedge_pair(side, prober)
    inputs = _inputs(side)
    wedged_before = side.fb.SOLVER_WEDGED_TOTAL.get() or 0.0
    # one hang, longer than the staleness threshold, on the next dispatch
    _arm(side, 30.0)
    resilient.solve(*inputs)  # establishes health (first probe)
    probes_before = len(probes)
    result = resilient.solve(*inputs)
    assert result.pod_count_new() == 5
    assert (side.fb.SOLVER_WEDGED_TOTAL.get() or 0.0) == wedged_before + 1
    assert resilient.breaker.state == side.fb.CircuitBreaker.OPEN
    assert resilient._healthy is False
    report = resilient.health_report()
    assert report["abandoned_total"] == 1
    [t] = report["abandoned_threads"]
    assert t["name"].startswith("primary-solve-abandoned-1-wedged")
    assert report["wedge_history"][-1]["kind"] == "wedged"
    report = _report(resilient)
    calls_before = primary.calls
    resilient.solve(*inputs)
    assert primary.calls == calls_before
    assert len(probes) == probes_before
    time.sleep(0.5)
    result = resilient.solve(*inputs)
    assert result.pod_count_new() == 5
    assert len(probes) == probes_before + 1
    assert resilient.breaker.state == side.fb.CircuitBreaker.CLOSED
    assert resilient._healthy is True
    assert primary.calls > calls_before
    return resilient, None, (report, primary.calls, len(probes))


def case_wedge_readmission_blocked_while_probe_still_fails(side):
    health = {"reason": "still wedged"}
    primary, resilient = _wedge_pair(side, lambda: health["reason"])
    inputs = _inputs(side)
    _arm(side, 30.0)
    resilient._healthy = True
    resilient._last_probe = time.time()
    resilient.solve(*inputs)
    calls_after_wedge = primary.calls
    time.sleep(0.5)
    result = resilient.solve(*inputs)
    assert result.pod_count_new() == 5
    assert primary.calls == calls_after_wedge
    assert resilient.breaker.state == side.fb.CircuitBreaker.OPEN
    health["reason"] = None
    time.sleep(0.5)
    resilient.solve(*inputs)
    assert resilient.breaker.state == side.fb.CircuitBreaker.CLOSED
    assert primary.calls == calls_after_wedge + 1
    return resilient, None, primary.calls


def case_slow_timeout_abandonment_is_named_counted_and_trips_breaker(side):
    release = threading.Event()
    supervise = side.supervise

    class SlowAlivePrimary(side.CountingPrimary):
        def solve(self, *a, **k):
            for _ in range(100):
                supervise.touch_heartbeat()
                if release.wait(0.05):
                    break
            raise RuntimeError("never reached before the watchdog")

    primary = SlowAlivePrimary()
    resilient = side.fb.ResilientSolver(primary, side.GreedySolver(), prober=lambda: None,
                                        small_batch_work_max=0, solve_timeout=0.4,
                                        wedge_stale_after=5.0, watchdog_poll=0.05,
                                        reprobe_interval=60.0)
    inputs = _inputs(side)
    result = resilient.solve(*inputs)
    report = _report(resilient)
    release.set()
    assert result.pod_count_new() == 5
    assert report["abandoned_total"] == 1
    [t] = report["abandoned_threads"]
    assert t["name"].startswith("primary-solve-abandoned-1-timeout")
    assert report["wedge_history"][-1]["kind"] == "timeout"
    assert resilient.breaker.state == side.fb.CircuitBreaker.OPEN
    calls = primary.calls
    resilient.solve(*inputs)
    assert primary.calls == calls
    return resilient, None, report


def case_health_report_shape_for_debug_endpoint(side):
    primary, resilient = _wedge_pair(side, lambda: None)
    resilient.solve(*_inputs(side))
    report = resilient.health_report()
    json.dumps(report)
    assert report["healthy"] is True
    assert report["breaker"] == side.fb.CircuitBreaker.CLOSED
    assert report["heartbeat_age_s"] is not None
    assert report["wedge_stale_after_s"] == 0.3
    assert report["abandoned_threads"] == []
    assert report["abandoned_live"] == 0
    assert report["abandoned_reaped"] == 0
    assert report["host"] is None
    return resilient, None, sorted(report)


def case_abandoned_zombie_reaped_when_thread_finally_exits(side):
    primary, resilient = _wedge_pair(side, lambda: None)
    inputs = _inputs(side)
    resilient._healthy = True
    resilient._last_probe = time.time()
    _arm(side, 1.0)
    resilient.solve(*inputs)
    report = resilient.health_report()
    assert report["abandoned_total"] == 1
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        report = resilient.health_report()
        if report["abandoned_live"] == 0:
            break
        time.sleep(0.1)
    assert report["abandoned_live"] == 0
    assert report["abandoned_reaped"] == 1
    assert report["abandoned_total"] == 1
    [t] = report["abandoned_threads"]
    assert t["reaped"] is True and t["alive"] is False
    assert t["name"].startswith("primary-solve-abandoned-1-wedged")
    return resilient, None, None


def case_abandoned_inventory_never_drops_live_zombies(side):
    class FakeThread:
        def __init__(self, alive):
            self._alive = alive
            self.name = ""

        def is_alive(self):
            return self._alive

    primary, resilient = _wedge_pair(side, lambda: None)
    for i in range(60):
        resilient._abandon(FakeThread(alive=(i % 10 == 0)), "wedged", 1.0)
    report = resilient.health_report()
    assert report["abandoned_total"] == 60
    assert report["abandoned_live"] == 6
    live = [t for t in report["abandoned_threads"] if not t["reaped"]]
    assert len(live) == 6
    assert len(report["abandoned_threads"]) <= side.fb.ResilientSolver.MAX_REAPED_RECORDS
    assert report["abandoned_reaped"] == 54
    return resilient, None, None


def case_wedge_cycle_through_operator_admission_continues(side):
    """The real provisioning controller with the wedging primary behind
    the wrapper, wired by hand as the reference's process entry wires it:
    admission continues on the fallback, and the prober re-admits."""
    cp = side.fake.FakeCloudProvider(side.fake.instance_types(10))
    primary, resilient = _wedge_pair(side, lambda: None)
    op = side.new_operator(cp, settings=side.Settings(batch_idle_duration=0.02,
                                                      batch_max_duration=0.2),
                           solver=resilient)
    op.provisioning.fallback_solver = resilient
    op.kube_client.create(side.t.make_provisioner(name="default"))
    _arm(side, 30.0)
    op.start()
    try:
        for _ in range(4):
            op.kube_client.create(side.t.make_pod(requests={"cpu": "1"}))
        deadline = time.monotonic() + 20.0
        covered = False
        while time.monotonic() < deadline and not covered:
            time.sleep(0.1)
            op.sync_state()
            result = op.provisioning.schedule()
            covered = result is None or (not result.new_machines and not result.failed_pods)
        assert covered
        wedged = side.fb.SOLVER_WEDGED_TOTAL.get() or 0.0
        assert wedged >= 1 or resilient._abandon_count == 0
        time.sleep(0.6)
        assert resilient.healthy() is True
        assert resilient.breaker.state == side.fb.CircuitBreaker.CLOSED
    finally:
        op.stop()
    return None, None, (covered, resilient._abandon_count <= 1)


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


# a probe still running past this long after its test is a leak
PROBE_GRACE_S = 10.0


def _quiesce(side):
    """Start a case from the process-wide state a fresh process has, as far
    as the case reads it. Tests that ran earlier on this process (an xdist
    worker runs whole files one after another) leave two things behind: a
    background card probe ("solver-probe") still running can transition a
    breaker and move the series; and the breaker-open gauge keeps the
    sample of its last transition, so that after a file that drove only
    the port's ResilientSolver the port's gauge reads 0.0 where the
    reference's has no sample. So wait for such probes (failing if one
    outlives PROBE_GRACE_S), then drop the gauge's sample."""
    deadline = time.monotonic() + PROBE_GRACE_S
    while any(t.name == "solver-probe" and t.is_alive() for t in threading.enumerate()):
        if time.monotonic() > deadline:
            raise AssertionError("a background solver probe outlived its test")
        time.sleep(0.02)
    side.fb.BREAKER_OPEN.delete({"breaker": "solver.device"})


def _run(pkg, case):
    side = _side(pkg)
    _quiesce(side)
    before = _series(side)
    try:
        resilient, recorder, extra = CASES[case](side)
    finally:
        side.hang.release.set()  # no hung primary outlives its case
    obs = {"series": _delta(before, _series(side)), "extra": extra}
    if resilient is not None:
        obs["breaker"] = resilient.breaker.state
        obs["open_gauge"] = side.fb.BREAKER_OPEN.get({"breaker": "solver.device"})
        obs["inventory"] = [(r["name"], r["kind"]) for r in resilient._abandoned]
    if recorder is not None:
        obs["events"] = _events(recorder)
    return obs


@pytest.mark.parametrize("case", sorted(CASES))
def test_recovery_case_matches_reference(case):
    want, got = _run("jax", case), _run("torch", case)
    if case == "wedge_cycle_through_operator_admission_continues":
        # the background loop's solves race the test's: only the outcome
        # and the accounting's bounds are the same script's
        assert got["extra"] == want["extra"] == (True, True)
        return
    assert got == want


def test_cases_start_clean_after_an_earlier_file():
    """What an earlier port-only file leaves on the worker (the port's open
    gauge at 0.0, a background probe of a breaker still running) must not
    reach a case: the first case in CASES' order runs against the
    reference after both."""
    case = sorted(CASES)[0]
    tfallback.BREAKER_OPEN.set(0.0, {"breaker": "solver.device"})
    straggler = tfallback.CircuitBreaker(name="solver.device")

    def late_probe():
        time.sleep(0.3)
        straggler.record_failure()
        straggler.record_failure()
        straggler.record_failure()

    probe = threading.Thread(target=late_probe, daemon=True, name="solver-probe")
    probe.start()
    got = _run("torch", case)
    assert not probe.is_alive()
    assert got == _run("jax", case)


def test_recovery_cases_cover_the_reference_file():
    import ast
    import os

    path = os.path.join(os.path.dirname(__file__), "test_resilient_recovery.py")
    tree = ast.parse(open(path).read())
    names = {n.name[len("test_"):] for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    assert names == set(CASES) and len(names) == 10


# -- the live record hook ------------------------------------------------------------


@pytest.fixture
def armed_recorder():
    was = FLIGHTREC.enabled
    FLIGHTREC.clear()
    FLIGHTREC.enable()
    yield FLIGHTREC
    FLIGHTREC.clear()
    if not was:
        FLIGHTREC.disable()


@pytest.mark.parametrize("family", ["bulk", "spread", "anti"])
def test_primary_record_replays_to_its_solve(armed_recorder, family):
    """A solve the card's solver served is recorded as "primary" with the
    "torch" replayer and replays (solver_kind=None) to its placements."""
    pods, provs, its, daemons, nodes, mn, client, cluster = workload(family, "torch")
    resilient = tfallback.ResilientSolver(
        tsolver.TorchSolver(max_nodes=mn, device="cpu"), tsolver.GreedySolver(),
        prober=lambda: None, small_batch_work_max=0, solve_timeout=600.0,
        wedge_stale_after=300.0)
    res = resilient.solve(pods, provs, its, daemons, nodes, kube_client=client, cluster=cluster)
    record = armed_recorder.last()
    assert (record["backend"], record["replayer"]) == ("primary", "torch")
    assert record["outcome"]["placements"] == trec.canonical_placements(res)
    placements, _ = trec.replay(record, device="cpu")
    assert trec.placements_json(placements) == trec.placements_json(res)


@pytest.mark.parametrize("reason", ["backend_unavailable", "primary_error", "small_batch"])
def test_fallback_record_replays_through_greedy(armed_recorder, reason):
    """A fallback solve is recorded as "host.<reason>" with the "greedy"
    replayer, the primary's error stamped, and replays on GreedySolver to
    its placements; a fallback that raises too closes the record through
    finish_error."""
    pods, provs, its, daemons, nodes, mn, client, cluster = workload("bulk", "torch")

    class Raising(tsolver.TorchSolver):
        def solve(self, *a, **k):
            raise RuntimeError("device lost")

    primary = (Raising if reason == "primary_error" else tsolver.TorchSolver)(
        max_nodes=mn, device="cpu")
    resilient = tfallback.ResilientSolver(
        primary, tsolver.GreedySolver(),
        prober=(lambda: "no card") if reason == "backend_unavailable" else (lambda: None),
        small_batch_work_max=10 ** 9 if reason == "small_batch" else 0)
    res = resilient.solve(pods, provs, its, daemons, nodes)
    record = armed_recorder.last()
    assert (record["backend"], record["replayer"]) == (f"host.{reason}", "greedy")
    assert ("primary_error" in record) == (reason == "primary_error")
    placements, _ = trec.replay(record)
    assert trec.placements_json(placements) == trec.placements_json(res)

    class Broken:
        def solve(self, *a, **k):
            raise ValueError("fallback broken")

    broken = tfallback.ResilientSolver(Raising(max_nodes=mn, device="cpu"), Broken(),
                                       prober=lambda: None, small_batch_work_max=0)
    with pytest.raises(ValueError, match="fallback broken"):
        broken.solve(pods, provs, its, daemons, nodes)
    record = armed_recorder.last()
    assert record["backend"] == "host.primary_error" and record["replayer"] == "greedy"
    assert record["error"] == "ValueError: fallback broken"
    assert record["primary_error"] == "RuntimeError: device lost"


def test_records_name_their_replayer_as_the_reference_does():
    """The same scripts through both packages' wrappers give records with
    the same backend, replayer and placements (the replayer is each
    package's name for its primary)."""
    from karpenter_core_tpu.obs import flightrec as jrec

    out = {}
    for pkg, rec_mod in (("jax", jrec), ("torch", trec)):
        side = _side(pkg)
        recorder = rec_mod.FlightRecorder().enable()
        was = side.fb.FLIGHTREC
        side.fb.FLIGHTREC = recorder
        try:
            rows = []
            for prober in (lambda: None, lambda: "dead"):
                resilient = side.fb.ResilientSolver(side.CountingPrimary(), side.GreedySolver(),
                                                    prober=prober, small_batch_work_max=0)
                pods = [side.t.make_pod(name=f"p{i}", requests={"cpu": "1"}) for i in range(5)]
                for i, p in enumerate(pods):
                    p.metadata.uid, p.metadata.creation_timestamp = f"u{i}", 1000.0
                resilient.solve(pods, [side.t.make_provisioner(name="default")],
                                {"default": side.fake.instance_types(10)})
                r = recorder.last()
                rows.append((r["backend"], r["replayer"],
                             rec_mod.placements_json(r["outcome"]["placements"])))
            out[pkg] = rows
        finally:
            side.fb.FLIGHTREC = was
    assert [b for b, _r, _p in out["torch"]] == [b for b, _r, _p in out["jax"]]
    assert [r for _b, r, _p in out["jax"]] == ["tpu", "greedy"]
    assert [r for _b, r, _p in out["torch"]] == ["torch", "greedy"]
    assert [p for _b, _r, p in out["torch"]] == [p for _b, _r, p in out["jax"]]


# -- the probe ------------------------------------------------------------------------


def test_probe_backend_reports_no_card_and_names_no_jax(monkeypatch):
    """Without a card the probe returns a one-line reason, not None; its
    command imports torch alone and builds nothing."""
    import torch

    assert "jax" not in tfallback.PROBE_CODE and "karpenter" not in tfallback.PROBE_CODE
    seen = []
    real = tfallback.subprocess.run

    def spy(cmd, *a, **k):
        seen.append(cmd)
        return real(cmd, *a, **k)

    monkeypatch.setattr(tfallback.subprocess, "run", spy)
    reason = tfallback.probe_backend(timeout=60.0)
    assert len(seen) == 1 and not any("jax" in part for part in seen[0])
    if torch.cuda.is_available():
        assert reason is None
    else:
        assert reason == "no CUDA device is available"
    monkeypatch.setattr(tfallback, "probe_backend", lambda timeout: f"probed {timeout:.0f}s")
    assert tfallback.probe_for(tsolver.GreedySolver(), 60.0) == "probed 60s"

    class Remote:
        def health(self, timeout):
            raise ConnectionError("refused")

    assert tfallback.probe_for(Remote()) == (
        "solver service health check failed: ConnectionError: refused")


def test_probe_timeout_is_a_reason(monkeypatch):
    def hang(*a, **k):
        raise tfallback.subprocess.TimeoutExpired(a[0], k.get("timeout"))

    monkeypatch.setattr(tfallback.subprocess, "run", hang)
    assert tfallback.probe_backend(timeout=7.0) == "backend probe timed out after 7s"


# -- the heartbeat the phase marks touch -------------------------------------------------


class _Labels:
    def __init__(self, heartbeat_cls):
        self.labels = []
        outer = self

        class Recording(heartbeat_cls):
            def touch(self, label=None):
                outer.labels.append(label)
                super().touch(label)

        self.hb = Recording()


# phases one solver marks and the other does not: the port marks encode and
# decode, the reference its bundle packing
_ONE_SIDED = {"solver.phase.encode", "solver.phase.decode", "solver.phase.pack"}


@pytest.mark.parametrize("family", ["bulk", "relax"])
def test_torch_solver_touches_the_reference_labels_in_order(family):
    from karpenter_core_tpu.solver.tpu_solver import TPUSolver
    from karpenter_core_tpu.utils import supervise as jsupervise

    jp, jprov, jits, jds, jn, mn, _c, _cl = workload(family, "jax")
    tp, tprov, tits, tds, tn, _, _c, _cl = workload(family, "torch")
    ref, port = _Labels(jsupervise.ThreadHeartbeat), _Labels(tsupervise.ThreadHeartbeat)
    jsupervise.bind_heartbeat(ref.hb)
    tsupervise.bind_heartbeat(port.hb)
    try:
        TPUSolver(max_nodes=mn, backend="mxu", incremental="off").solve(jp, jprov, jits, jds, jn)
        solver = tsolver.TorchSolver(max_nodes=mn, device="cpu")
        solver.solve(tp, tprov, tits, tds, tn)
    finally:
        jsupervise.bind_heartbeat(None)
        tsupervise.bind_heartbeat(None)
    assert port.labels[:2] == ["solver.phase.encode", "solver.phase.device"]
    assert {f"solver.phase.{k}" for k in solver.last_phase_ms} <= set(port.labels)
    assert [x for x in port.labels if x not in _ONE_SIDED] == [
        x for x in ref.labels if x not in _ONE_SIDED]
    assert port.hb.label() == "solver.phase.decode"


def test_replan_touches_the_replan_labels():
    from karpenter_core_tpu_torch import testing as tt
    from karpenter_core_tpu_torch.solver.encode import encode_snapshot

    pods, provs, its, daemons, nodes, mn, client, cluster = workload("cluster", "torch")
    solver = tsolver.TorchSolver(max_nodes=mn, device="cpu")
    snap = encode_snapshot(pods, provs, its, daemons, nodes, client, cluster, max_nodes=mn)
    counts, exist_open = tt.subset_planes(snap, 2)
    rec = _Labels(tsupervise.ThreadHeartbeat)
    tsupervise.bind_heartbeat(rec.hb)
    try:
        solver.replan_screen(snap, provs, counts, exist_open, cluster=cluster)
    finally:
        tsupervise.bind_heartbeat(None)
    assert rec.labels == ["solver.phase.replan.device"] + [
        f"solver.phase.replan.{k}" for k in solver.last_replan_phase_ms]


def test_unbound_heartbeat_touch_is_a_no_op():
    assert tsupervise.bound_heartbeat() is None
    tsupervise.touch_heartbeat("solver.phase.device")
    hb = tsupervise.ThreadHeartbeat(clock=iter([1.0, 4.5]).__next__)
    assert hb.age() is None
    hb.touch("solver.phase.args")
    assert hb.label() == "solver.phase.args" and hb.age() == 3.5


def test_file_heartbeat_matches_reference(tmp_path):
    """The file heartbeat of a supervised worker process: a labelled touch
    writes the label, a bare touch keeps it, the age reads the mtime."""
    from karpenter_core_tpu.utils import supervise as jsupervise

    out = []
    for mod in (jsupervise, tsupervise):
        hb = mod.Heartbeat(str(tmp_path / f"{mod.__name__}.hb"))
        seen = [hb.age(), hb.read_label()]
        hb.touch("solver.phase.device")
        hb.touch()
        age = hb.age()
        seen += [hb.read_label(), age is not None and 0.0 <= age < 60.0]
        out.append(seen)
    assert out[1] == out[0] == [None, "", "solver.phase.device", True]


# -- the in-process wedge drill through the chaos hang point ------------------------


def _hang_drill(pkg):
    """hack/soak.py's in-process wedge drill on a real device solver: a
    `solver.device.hang` of 6 s after two consults against a 2 s staleness
    threshold. The hung solve is abandoned as wedged and greedy serves it;
    the breaker's reset TTL passes on a fake clock, and the re-admitted
    solve must run while the zombie still sleeps inside its dispatch."""
    side = _side(pkg)
    if pkg == "jax":
        from karpenter_core_tpu import chaos
        from karpenter_core_tpu.obs.flightrec import canonical_placements, placements_json
        from karpenter_core_tpu.solver.tpu_solver import TPUSolver

        primary = TPUSolver(max_nodes=64)
    else:
        from karpenter_core_tpu_torch import chaos
        from karpenter_core_tpu_torch.obs.flightrec import canonical_placements, placements_json

        primary = tsolver.TorchSolver(max_nodes=64, device="cpu")
    t = side.t
    pods = []
    for i in range(8):
        p = t.make_pod(name=f"drill-{i}", requests={"cpu": "1", "memory": "512Mi"})
        p.metadata.uid, p.metadata.creation_timestamp = f"uid-drill-{i}", 1000.0 + i
        pods.append(p)
    inputs = (pods, [t.make_provisioner(name="default")],
              {"default": side.fake.instance_types(10)})
    clock = t.FakeClock()
    recorder = side.Recorder(clock=clock)
    resilient = side.fb.ResilientSolver(
        primary, side.GreedySolver(), clock=clock, recorder=recorder, prober=lambda: None,
        small_batch_work_max=0, solve_timeout=10.0, wedge_stale_after=2.0, watchdog_poll=0.2,
        reprobe_interval=3.0)
    primary.solve(*inputs)  # the geometry's cold costs, outside the drill
    before = _series(side)
    fault = chaos.arm(chaos.SOLVER_DEVICE_HANG, error=None, latency=6.0, times=1, after=2,
                      seed=44)
    try:
        placements = [placements_json(canonical_placements(resilient.solve(*inputs)))
                      for _ in range(2)]
        hung_at = time.monotonic()
        served = resilient.solve(*inputs)
        wedged = (fault.injected, resilient.breaker.state, resilient._healthy)
        clock.advance(3.5)
        readmitted = resilient.solve(*inputs)
        readmitted_after = time.monotonic() - hung_at
        zombie_live = resilient.health_report()["abandoned_live"]
    finally:
        chaos.disarm(chaos.SOLVER_DEVICE_HANG)
    deadline = time.monotonic() + 30.0
    while resilient.health_report()["abandoned_live"] and time.monotonic() < deadline:
        time.sleep(0.1)
    after_zombie = resilient.solve(*inputs)
    report = _report(resilient)
    # the last phase label differs by the phases one solver marks and the
    # other does not (_ONE_SIDED: the port's last is decode, the reference's
    # fetch)
    report.pop("heartbeat_phase")
    return {
        "placements": placements + [placements_json(canonical_placements(r))
                                    for r in (served, readmitted, after_zombie)],
        "wedged": wedged,
        "readmitted": (resilient.breaker.state, resilient._healthy),
        "zombie_live_at_readmission": zombie_live,
        "readmitted_before_the_zombie_woke": readmitted_after < 6.0,
        "series": _delta(before, _series(side)),
        "events": _events(recorder),
        "report": report,
    }


def test_hang_drill_readmits_while_the_zombie_sleeps():
    """A dispatch abandoned inside the hang keeps running in its thread;
    the re-admitted solve must not wait for it (the port's carried state
    is handed over, not locked across the dispatch), as the reference's
    does not. Events, breaker transitions, the abandoned inventory and
    every solve's placements equal the reference's."""
    want, got = _hang_drill("jax"), _hang_drill("torch")
    assert got["wedged"][0] == 1 and got["wedged"][2] is False
    assert got["zombie_live_at_readmission"] == 1
    assert got["readmitted_before_the_zombie_woke"], got
    assert got["readmitted"] == (tfallback.CircuitBreaker.CLOSED, True)
    assert got == want
