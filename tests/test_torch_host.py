"""The port's solver host (solver/host.py) on the CPU: its child solves with
device="cpu".

- HostSolver against the in-process TorchSolver on the shared workload
  families (placements byte-identical), and against the reference's
  HostSolver on the mixed family; replan and prewarm likewise;
- the host with `grpc` and `google.protobuf` unimportable (a blocker
  package first on the path of the parent and of its child): a solve
  completes, and the gRPC entry points raise an ImportError naming them;
- a crash (SIGKILL of the child) and a wedge (SIGSTOP mid-dispatch) each
  kill and respawn it: the old pid reaped, no live zombie, no parent
  thread left; under ResilientSolver the wedge is served by greedy and
  re-admitted through health();
- the admission gate's deadline-expired, queue-full-with-retry-after and
  brownout cases;
- the metrics, program and launch mergers idempotent across a respawn.

Every spawn and read carries its own timeout (spawn_timeout,
solve_timeout), and every fixture closes its child (a process-group kill).
"""
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from karpenter_core_tpu.obs.flightrec import canonical_placements, placements_json
from karpenter_core_tpu_torch.metrics.registry import REGISTRY
from karpenter_core_tpu_torch.obs import TRACER, proghealth
from karpenter_core_tpu_torch.solver import host as host_mod
from karpenter_core_tpu_torch.solver.fallback import ResilientSolver
from karpenter_core_tpu_torch.solver.host import AdmissionGate, HostSolver
from karpenter_core_tpu_torch.solver.service import (
    SolverDeadlineExceededError,
    SolverResourceExhaustedError,
    SolverUnavailableError,
)
from karpenter_core_tpu_torch.solver.torch_solver import GreedySolver, TorchSolver

from tests.test_torch_cuda import workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("mixed", "spread", "cluster")


def _canon(result) -> bytes:
    return placements_json(canonical_placements(result))


def _solve(solver, w):
    pods, provs, its, daemons, nodes, _max_nodes, client, cluster = w
    return solver.solve(pods, provs, its, daemonset_pods=daemons, state_nodes=nodes,
                        kube_client=client, cluster=cluster)


def _host(**kw):
    kw.setdefault("spawn_timeout", 90.0)
    kw.setdefault("solve_timeout", 90.0)
    return HostSolver(device="cpu", **kw)


def _gone(pid) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.fixture(scope="module")
def host():
    hs = _host(max_nodes=64)
    yield hs
    hs.close()


@pytest.mark.parametrize("family", FAMILIES)
def test_host_solve_byte_identical_to_in_process(host, family):
    w = workload(family, "torch")
    host.max_nodes = w[5]
    got = _solve(host, w)
    want = _solve(TorchSolver(max_nodes=w[5], device="cpu"), w)
    assert _canon(got) == _canon(want)
    assert got.rounds == want.rounds
    assert host.health()["device"] == "cpu"


def test_host_solve_byte_identical_to_reference_host():
    from karpenter_core_tpu.solver.host import HostSolver as JHostSolver

    jw, tw = workload("mixed", "jax"), workload("mixed", "torch")
    jhs = JHostSolver(max_nodes=jw[5], child_env={"KARPENTER_SOLVER_MODE": "single"},
                      spawn_timeout=120.0, solve_timeout=120.0)
    ths = _host(max_nodes=tw[5])
    try:
        assert _canon(_solve(ths, tw)) == _canon(_solve(jhs, jw))
    finally:
        jhs.close()
        ths.close()


def test_host_packs_sequentially_under_segmented_scan():
    """A child started with KCT_PACK_SCAN=segmented serves with the
    sequential scan, as the reference's child does: placements
    byte-identical to the in-process sequential solve, no segment phase in
    the child."""
    from tests.test_torch_cuda import _mods
    from tests.test_torch_segmented import MAX_NODES, pool_workload

    pods, provs, its, _nodes = pool_workload(_mods("torch"), 7)
    hs = _host(max_nodes=MAX_NODES, child_env={"KCT_PACK_SCAN": "segmented"})
    try:
        got = hs.solve(pods, provs, its)
        assert "device" in hs.last_child_phase_ms
        assert "segment" not in hs.last_child_phase_ms
    finally:
        hs.close()
    want = TorchSolver(max_nodes=MAX_NODES, device="cpu", pack_scan="sequential").solve(
        pods, provs, its)
    assert _canon(got) == _canon(want)


def test_host_replan_and_prewarm_match_in_process(host):
    w = workload("cluster", "torch")
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = w
    host.max_nodes = max_nodes
    snap = host.encode(pods, provs, its, daemons, nodes, client, cluster)
    E = snap.exist_used.shape[0]
    count_rows = np.zeros((3, snap.item_pad), np.int32)
    count_rows[:, 0] = (1, 2, 3)
    exist_open = np.ones((3, E), bool)
    exist_open[1, 0] = False
    got_v, got_p = host.replan_screen(snap, provs, count_rows, exist_open, want_slots=True)
    want_v, want_p = TorchSolver(max_nodes=max_nodes, device="cpu").replan_screen(
        snap, provs, count_rows, exist_open, want_slots=True)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_p, want_p)
    # the prewarm: first sight of a geometry pays, a repeat is cached, as
    # TorchSolver's
    other = host.encode(pods[: len(pods) // 2], provs, its, daemons, nodes, client, cluster)
    local = TorchSolver(max_nodes=max_nodes, device="cpu")
    assert host.prewarm_snapshot(other, provs) == local.prewarm_snapshot(other, provs)
    assert host.prewarm_snapshot(other, provs) == "cached"
    stats = host.host.stats()
    assert stats["replans"] == 1 and stats["entries"] >= 2


def test_host_report_and_probe(host):
    report = host.host_report()
    assert report["alive"] and report["ready"] and report["device"] == "cpu"
    assert report["admission"]["deadline_violations"] == 0
    assert set(report["launches"]) >= {"screen", "screen_prep", "block", "row_n1", "row_b1"}
    info = host.health()
    assert info["status"] == "ok" and info["platform"] == "cpu" and info["pid"] == host.host.pid


# a sitecustomize that every interpreter with it on the path runs at
# start-up: grpc and google.protobuf cannot be imported there
_BLOCKER = textwrap.dedent('''
    import sys

    class _Blocker:
        def find_spec(self, name, path=None, target=None):
            if name == "grpc" or name.startswith(("grpc.", "google.protobuf")):
                raise ImportError(f"blocked for this test: {name}")
            return None

    sys.meta_path.insert(0, _Blocker())
''')


def test_host_runs_without_grpc_or_protobuf(tmp_path):
    """grpc and google.protobuf unimportable in the parent and the child (a
    sys.meta_path blocker in a sitecustomize both start with): the host
    still solves; serve() and RemoteSolver name the package."""
    (tmp_path / "sitecustomize.py").write_text(_BLOCKER)
    script = textwrap.dedent("""
        import sys
        from karpenter_core_tpu_torch.cloudprovider import fake
        from karpenter_core_tpu_torch.solver import service
        from karpenter_core_tpu_torch.solver.host import HostSolver
        from karpenter_core_tpu_torch.testing import make_pod, make_provisioner
        for name in ("grpc", "google.protobuf"):
            try:
                __import__(name)
            except ImportError:
                pass
            else:
                raise SystemExit(f"{name} imported")
        hs = HostSolver(max_nodes=32, device="cpu", spawn_timeout=90, solve_timeout=90)
        try:
            res = hs.solve([make_pod(requests={"cpu": "1"}) for _ in range(6)],
                           [make_provisioner(name="default")],
                           {"default": fake.instance_types(4)})
            assert res.pod_count_new() == 6, res
        finally:
            hs.close()
        for call in (lambda: service.serve(device="cpu"),
                     lambda: service.RemoteSolver("127.0.0.1:1")):
            try:
                call()
            except ImportError as e:
                assert "grpc" in str(e), e
            else:
                raise SystemExit("no ImportError")
        assert not [m for m in sys.modules if m == "grpc" or m.startswith("google.protobuf")]
        print("solved without grpc")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=150)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "solved without grpc" in out.stdout


def test_crash_kills_and_respawns(host):
    w = workload("mixed", "torch")
    host.max_nodes = w[5]
    baseline = _solve(host, w)
    old_pid, gen = host.host.pid, host.host.generation
    os.kill(old_pid, signal.SIGKILL)
    time.sleep(0.1)
    again = _solve(host, w)  # the dead child is found, reaped and respawned
    assert _canon(again) == _canon(baseline)
    assert host.host.generation == gen + 1 and host.host.pid != old_pid
    assert host.host.last_kill["kind"] == "crashed"
    assert _gone(old_pid), "the killed child must be reaped, not a zombie"


def test_wedge_kills_respawns_and_is_readmitted(monkeypatch):
    """SIGSTOP the child once its dispatch is in flight: the watchdog kills
    the group at stale_after, greedy serves the solve, health() respawns
    and probes the child, and the next solve is byte-identical to the
    in-process one."""
    # stale_after above the longest phase of a CPU solve at this size
    hs = _host(max_nodes=64, stale_after=5.0)
    resilient = ResilientSolver(hs, GreedySolver(), small_batch_work_max=0,
                                solve_timeout=60.0, wedge_stale_after=None,
                                reprobe_interval=0.5, probe_timeout=60.0)
    stop_next = threading.Event()
    real_write = host_mod._write_frame

    def write(stream, header, body=b""):
        real_write(stream, header, body)
        if header.get("op") == "solve" and stop_next.is_set():
            stop_next.clear()
            os.kill(hs.host.pid, signal.SIGSTOP)

    monkeypatch.setattr(host_mod, "_write_frame", write)
    threads = set(threading.enumerate())
    try:
        w = workload("mixed", "torch")
        r1 = _solve(resilient, w)
        wedged_pid = hs.host.pid
        stop_next.set()
        t0 = time.monotonic()
        r2 = _solve(resilient, w)
        assert time.monotonic() - t0 < 30
        assert r2.pod_count_new() + r2.pod_count_existing() > 0, "greedy served the wedge"
        report = resilient.health_report()
        assert report["wedge_history"][-1]["kind"] == "wedged"
        assert report["abandoned_live"] == 0
        assert report["host"]["generation"] == 2 and report["host"]["last_kill"]["pid"] == \
            wedged_pid
        assert report["host"]["last_kill"]["kind"] == "wedged"
        assert _gone(wedged_pid)
        time.sleep(0.6)
        r3 = _solve(resilient, w)
        assert resilient.breaker.state == "closed"
        assert _canon(r3) == _canon(r1)
        assert _canon(r3) == _canon(_solve(TorchSolver(max_nodes=w[5], device="cpu"), w))
    finally:
        hs.close()
    left = [t for t in threading.enumerate() if t not in threads and t.is_alive()]
    assert not left, left


def test_child_without_a_card_is_an_error_not_a_cpu_solve():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    hs = HostSolver(max_nodes=32, spawn_timeout=60.0)
    try:
        with pytest.raises(SolverUnavailableError, match="no CUDA device"):
            hs.health(timeout=60.0)
        assert not hs.host.alive()
    finally:
        hs.close()


# -- the admission gate ----------------------------------------------------------


def _occupied_gate(**kwargs):
    gate = AdmissionGate(name="torch-test", **kwargs)
    release, started = threading.Event(), threading.Event()

    def occupy():
        with gate.admitted():
            started.set()
            release.wait(20)

    t = threading.Thread(target=occupy, daemon=True, name="gate-occupier")
    t.start()
    assert started.wait(5)
    return gate, release, t


def test_gate_deadline_expired_never_dispatched():
    gate, release, t = _occupied_gate(max_queue=4)
    with pytest.raises(SolverDeadlineExceededError, match="never dispatched"):
        with gate.admitted(deadline_s=0.2):
            pass
    assert gate.dispatched_total == 1 and gate.stats()["shed"] == {"deadline_expired": 1}
    release.set()
    t.join(5)


def test_gate_queue_full_sheds_with_retry_after():
    gate, release, t = _occupied_gate(max_queue=0)
    with pytest.raises(SolverResourceExhaustedError) as exc:
        with gate.admitted():
            pass
    assert exc.value.shed_reason == "queue_full" and exc.value.retry_after_s > 0
    assert exc.value.marks_unhealthy is False and "retry_after_ms=" in str(exc.value)
    release.set()
    t.join(5)


def test_gate_brownout_sheds_before_queue_full():
    gate, release, t = _occupied_gate(max_queue=8, brownout_at=1)
    with pytest.raises(SolverResourceExhaustedError) as exc:
        with gate.admitted():
            pass
    assert exc.value.shed_reason == "brownout"
    release.set()
    t.join(5)


def test_host_queue_deadline_reaches_the_gate(host):
    release, started = threading.Event(), threading.Event()

    def occupy():
        with host.admission.admitted():
            started.set()
            release.wait(20)

    t = threading.Thread(target=occupy, daemon=True, name="host-occupier")
    t.start()
    assert started.wait(5)
    solves = host.host.stats()["solves"]
    host.queue_deadline_s = 0.2
    try:
        with pytest.raises(SolverDeadlineExceededError):
            _solve(host, workload("mixed", "torch"))
    finally:
        host.queue_deadline_s = None
        release.set()
        t.join(5)
    assert host.host.stats()["solves"] == solves, "an expired request never dispatches"


# -- the mergers across a respawn ------------------------------------------------------


def test_mergers_idempotent_across_respawn():
    TRACER.enable()
    proghealth.reset(enabled=True)
    hs = _host(max_nodes=64)

    def device_count():
        fam = hs.host.metrics.families().get("karpenter_solver_phase_duration_seconds")
        for labels, state in (fam or {}).get("series", ()):
            if labels.get("phase") == "device":
                assert labels["process"] == "solver-host"
                return state["count"]
        return 0

    def solve_execs():
        snap = proghealth.full_snapshot()
        return snap["totals"].get("solver-host", {}).get("solve", {}).get("exec_total", 0)

    try:
        w = workload("mixed", "torch")
        _solve(hs, w)
        _solve(hs, w)
        rounds = device_count()
        assert rounds >= 2 and solve_execs() == rounds
        hs.host.stats()
        hs.host.stats()
        assert device_count() == rounds and solve_execs() == rounds
        assert 'process="solver-host"' in REGISTRY.expose()
        procs = {r["process"] for r in proghealth.full_snapshot()["programs"]}
        assert "solver-host" in procs
        os.kill(hs.host.pid, signal.SIGKILL)
        time.sleep(0.1)
        _solve(hs, w)
        hs.host.stats()
        assert device_count() == rounds * 3 // 2 and solve_execs() == rounds * 3 // 2
    finally:
        hs.close()
        TRACER.disable()
        TRACER.clear()
        proghealth.reset()
    assert hs.host.metrics not in REGISTRY._externals


def test_launch_totals_fold_each_generation_once():
    lt = host_mod._LaunchTotals()
    lt.ingest(1, {"screen": 3, "block": 2})
    lt.ingest(1, {"screen": 5, "block": 3})  # cumulative: replaces
    assert lt.totals() == {"block": 3, "screen": 5}
    lt.retire(1)
    lt.retire(1)
    lt.ingest(2, {"screen": 1, "block": 0})
    assert lt.totals() == {"block": 3, "screen": 6}
    lt.reset()
    lt.ingest(3, {"screen": 2, "block": 1})  # a skipped retire folds on the bump
    assert lt.totals() == {"block": 1, "screen": 2}
