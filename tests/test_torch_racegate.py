"""The race gate over the port's own threads, on the CPU.

The reference's conftest arms the reference's lockwatch and racewatch for
the whole session; they track only locks allocated under
`karpenter_core_tpu/`, so they never see one of the port's. This file runs
the port's threaded scenarios in fresh interpreters with the port's
testing/lockwatch.py and testing/racewatch.py armed first (sampling off,
the cap at 128), before any module of the port that allocates a lock is
imported, so that module-level locks are tracked too. Each interpreter
prints one JSON line (racegate.race_report(): the tracked lock sites and
the instrumented classes of the port, the accesses recorded, the cycles,
the unsuppressed races with their witnesses, the suppressed hits), and the
test holds it to zero cycles and zero unsuppressed races.

The scenarios, in three interpreters:
- operator: tests/test_deflake.py's harness over the in-memory client and
  over kube/apiserver.ApiServerKubeClient (its transport
  testing/apiserver.py's ApiStore, the port's InMemoryKubeClient behind
  the REST surface), a
  new_operator(...).start() and stop(), and the ResilientSolver hang drill
  of tests/test_torch_fallback.py on a real TorchSolver;
- boundary: a HostSolver solve, the child killed, and the solve that
  respawns it; serve() with RemoteSolver from two threads at once;
- soak: a short SoakDriver.run() with faults armed from KARPENTER_CHAOS.
chip_smoke.py's phase 16a runs the deflake leg the same way on the card,
over HTTP.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_TIMEOUT_S = 300

def _gate(group: str, env=None) -> dict:
    from karpenter_core_tpu_torch.testing.racegate import RACE_ARM

    code = RACE_ARM.format(root=ROOT) + (
        "import tests.test_torch_racegate as gate\n"
        f"gate.run_group({group!r})\n")
    full_env = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
    full_env.pop("KARPENTER_LOCKWATCH", None)
    full_env.pop("KARPENTER_RACEWATCH", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=GATE_TIMEOUT_S, cwd=ROOT, env=full_env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _check(got: dict, scenarios) -> None:
    assert got["scenarios"] == list(scenarios), got["scenarios"]
    assert got["cycles"] == [], got["witnesses"]
    assert got["races"] == [], got["witnesses"]
    assert got["tracked_sites"] > 0 and got["instrumented_classes"] > 0, got
    assert all(s.startswith("karpenter_core_tpu_torch" + os.sep) for s in got["sites"])


# -- the scenarios (run inside the armed interpreter) ----------------------------


def _deflake_in_memory():
    from karpenter_core_tpu_torch.testing import racegate
    from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

    solver = TorchSolver(device="cpu")
    return [racegate.deflake_iteration(seed, solver=solver) for seed in (11, 12)]


def _deflake_over_apiserver():
    from karpenter_core_tpu_torch.kube.apiserver import ApiServerKubeClient
    from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver
    from karpenter_core_tpu_torch.testing import racegate
    from karpenter_core_tpu_torch.testing.apiserver import ApiStore

    solver = TorchSolver(device="cpu")
    runs = []
    for seed in (21, 22):
        store = ApiStore()
        kube = ApiServerKubeClient(store)
        try:
            runs.append(racegate.deflake_iteration(seed, kube_client=kube, solver=solver))
        finally:
            kube.close()
            store.close()
        deadline = time.time() + 5.0
        while any(t.is_alive() for t in kube.watch_threads()) and time.time() < deadline:
            time.sleep(0.05)
        assert not any(t.is_alive() for t in kube.watch_threads())
    return runs


def _operator_start_stop():
    from karpenter_core_tpu_torch.api.settings import Settings
    from karpenter_core_tpu_torch.cloudprovider import fake
    from karpenter_core_tpu_torch.operator import new_operator
    from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver
    from karpenter_core_tpu_torch.testing import make_pod, make_provisioner

    op = new_operator(fake.FakeCloudProvider(fake.instance_types(5)),
                      settings=Settings(batch_idle_duration=0.05, batch_max_duration=0.2),
                      solver=TorchSolver(device="cpu"))
    op.kube_client.create(make_provisioner(name="default"))
    op.start()
    try:
        for i in range(6):
            op.kube_client.create(make_pod(name=f"start-{i}", requests={"cpu": "1"}))
        deadline = time.time() + 20.0
        while not op.kube_client.list("Machine") and time.time() < deadline:
            time.sleep(0.05)
        machines = len(op.kube_client.list("Machine"))
    finally:
        alive = op.stop()
    assert machines and not alive, (machines, alive)
    return {"machines": machines}


def _hang_drill():
    from karpenter_core_tpu_torch import chaos
    from karpenter_core_tpu_torch.cloudprovider import fake
    from karpenter_core_tpu_torch.events import Recorder
    from karpenter_core_tpu_torch.solver.fallback import CircuitBreaker, ResilientSolver
    from karpenter_core_tpu_torch.solver.torch_solver import GreedySolver, TorchSolver
    from karpenter_core_tpu_torch.testing import FakeClock, make_pod, make_provisioner

    primary = TorchSolver(max_nodes=64, device="cpu")
    pods = [make_pod(name=f"drill-{i}", requests={"cpu": "1", "memory": "512Mi"})
            for i in range(8)]
    inputs = (pods, [make_provisioner(name="default")],
              {"default": fake.instance_types(10)})
    clock = FakeClock()
    resilient = ResilientSolver(
        primary, GreedySolver(), clock=clock, recorder=Recorder(clock=clock),
        prober=lambda: None, small_batch_work_max=0, solve_timeout=10.0,
        wedge_stale_after=2.0, watchdog_poll=0.2, reprobe_interval=3.0)
    primary.solve(*inputs)
    fault = chaos.arm(chaos.SOLVER_DEVICE_HANG, error=None, latency=6.0, times=1, after=2,
                      seed=44)
    try:
        for _ in range(3):
            resilient.solve(*inputs)
        wedged = fault.injected
        clock.advance(3.5)
        resilient.solve(*inputs)
        readmitted = resilient.breaker.state
    finally:
        chaos.disarm(chaos.SOLVER_DEVICE_HANG)
    deadline = time.monotonic() + 30.0
    while resilient.health_report()["abandoned_live"] and time.monotonic() < deadline:
        time.sleep(0.1)
    resilient.solve(*inputs)
    assert wedged == 1 and readmitted == CircuitBreaker.CLOSED, (wedged, readmitted)
    return {"wedged": wedged, "breaker": readmitted}


def _workload():
    from karpenter_core_tpu_torch.cloudprovider import fake
    from karpenter_core_tpu_torch.testing import make_pod, make_provisioner

    pods = [make_pod(name=f"w-{i}", requests={"cpu": "1"}, uid=f"uid-w-{i}",
                     creation_timestamp=1000.0 + i) for i in range(10)]
    return pods, [make_provisioner(name="default")], {"default": fake.instance_types(10)}


def _host_kill_respawn():
    from karpenter_core_tpu_torch.solver.host import HostSolver
    from karpenter_core_tpu_torch.solver.torch_solver import placements_json

    hs = HostSolver(max_nodes=64, device="cpu", spawn_timeout=120.0, solve_timeout=120.0)
    try:
        first = placements_json(hs.solve(*_workload()))
        pid, gen = hs.host.pid, hs.host.generation
        os.kill(pid, signal.SIGKILL)
        time.sleep(0.1)
        again = placements_json(hs.solve(*_workload()))
        assert again == first and hs.host.generation == gen + 1
        return {"generations": hs.host.generation}
    finally:
        hs.close()


def _serve_remote():
    from karpenter_core_tpu_torch.solver.service import RemoteSolver, serve
    from karpenter_core_tpu_torch.solver.torch_solver import placements_json

    server, port, _service = serve(device="cpu")
    remote = RemoteSolver(f"127.0.0.1:{port}", max_nodes=64)
    got = []
    try:
        threads = [threading.Thread(
            target=lambda: got.append(placements_json(remote.solve(*_workload()))),
            name=f"remote-{i}") for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        remote.close()
        server.stop(0).wait(10)
    assert len(got) == 2 and got[0] == got[1]
    return {"solves": len(got)}


def _soak():
    from karpenter_core_tpu_torch import chaos, loadgen
    from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

    armed = sorted(chaos.armed_points())
    config = loadgen.ChurnConfig(seed=7, duration_s=4.0, arrival_rate=3.0,
                                 termination_rate=1.5, resize_rate=0.2, initial_nodes=4)
    driver = loadgen.SoakDriver(config, max_nodes=64,
                                solver=TorchSolver(max_nodes=64, device="cpu"),
                                tail_timeout_s=15.0)
    report = driver.run()
    cols = report.as_columns()
    assert armed and cols["churn_loops_alive"] and not cols["churn_unbound_at_end"], cols
    return {"armed": armed, "binds": cols["churn_binds"],
            "injected": {p: f.injected for p, f in chaos.armed_points().items()}}


GROUPS = {
    "operator": {"deflake_in_memory": _deflake_in_memory,
                 "deflake_over_apiserver": _deflake_over_apiserver,
                 "operator_start_stop": _operator_start_stop,
                 "hang_drill": _hang_drill},
    "boundary": {"host_kill_respawn": _host_kill_respawn, "serve_remote": _serve_remote},
    "soak": {"soak": _soak},
}
SOAK_CHAOS = "state.diff=error:conn,p:0.1;cloudprovider.create=error:conn,times:2"


def run_group(group: str) -> None:
    """Inside the armed interpreter: the group's scenarios in order, then
    the watchers' report as one JSON line."""
    from karpenter_core_tpu_torch.testing import racegate

    results = {name: fn() for name, fn in GROUPS[group].items()}
    print(json.dumps(dict(racegate.race_report(), scenarios=list(results),
                          results=results)), flush=True)


# -- the tests --------------------------------------------------------------------


def test_race_gate_operator_threads():
    got = _gate("operator")
    _check(got, GROUPS["operator"])
    # the operator's threads took the locks of the operator's classes
    assert {"karpenter_core_tpu_torch.kube.apiserver.ApiServerKubeClient",
            "karpenter_core_tpu_torch.solver.fallback.ResilientSolver",
            "karpenter_core_tpu_torch.solver.torch_solver.TorchSolver",
            "karpenter_core_tpu_torch.state.cluster.Cluster"} <= set(got["classes"])


def test_race_gate_solver_boundary_threads():
    got = _gate("boundary")
    _check(got, GROUPS["boundary"])
    assert {"karpenter_core_tpu_torch.solver.host.SolverHost",
            "karpenter_core_tpu_torch.solver.service.SolverService"} <= set(got["classes"])


def test_race_gate_soak_with_chaos_armed():
    got = _gate("soak", env={"KARPENTER_CHAOS": SOAK_CHAOS, "KARPENTER_CHAOS_SEED": "7"})
    _check(got, GROUPS["soak"])
    assert got["results"]["soak"]["armed"] == ["cloudprovider.create", "state.diff"]
    assert "karpenter_core_tpu_torch.chaos.Fault" in got["classes"]
