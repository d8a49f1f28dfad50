"""The port's race watchers themselves, and one regression test for each
race the race gate (tests/test_torch_racegate.py) found in the port.

Each regression test installs a standalone LockWatch (so that the class
under test allocates a tracked lock) and a RaceWatch over it that records
the port's frames only, drives the pre-fix interleaving on the real class
from two threads, and requires no candidate race. Before the fixes each
field was written from two threads under no common lock:
- Batcher.last_window, by the provisioning loop after construction;
- TorchSolver.last_phase_ms and last_prescreen_{mode,delta,launches}, by
  solves on ResilientSolver's per-call threads, which no longer share one
  lock across a dispatch;
- SolverService.last_phase_ms and last_prescreen_mode, by concurrent RPCs.
A phases dict is published once its solve has filled it: a reader sees the
last solve's phases or the new ones, never a dict still being written
(the dict used to be published first and filled after, which the watchers
cannot see).
Every watcher a test installs comes off in its teardown, and
threading.Lock is again the session's factory.
"""
import threading
import time

import pytest

from karpenter_core_tpu_torch.testing import lockwatch, racewatch


@pytest.fixture
def watch():
    """A LockWatch installed over the session's factory, and a RaceWatch
    over it recording the port's frames; both off again after the test."""
    before = (threading.Lock, threading.RLock)
    lw = lockwatch.LockWatch().install()
    rw = racewatch.RaceWatch(lock_watch=lw, access_cap=0,
                             access_filter=lockwatch.in_package).install()
    try:
        yield rw
    finally:
        rw.uninstall()
        lw.uninstall()
        assert (threading.Lock, threading.RLock) == before


def _on_threads(*fns):
    for i, fn in enumerate(fns):
        t = threading.Thread(target=fn, name=f"races-{i}")
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()


def _workload(n=6):
    from karpenter_core_tpu_torch.cloudprovider import fake
    from karpenter_core_tpu_torch.testing import make_pod, make_provisioner

    pods = [make_pod(name=f"r-{i}", requests={"cpu": "1"}, uid=f"uid-r-{i}",
                     creation_timestamp=1000.0 + i) for i in range(n)]
    return pods, [make_provisioner(name="default")], {"default": fake.instance_types(6)}


# -- the watchers ------------------------------------------------------------------


def test_package_filters_take_whole_components():
    """The port's filters do not claim the reference's files or modules
    (the reference's substring and prefix tests would claim the port's)."""
    import karpenter_core_tpu_torch.solver.fallback as port_module

    root = lockwatch.os.path.dirname(lockwatch._PKG_DIR)
    assert lockwatch.in_package(port_module.__file__)
    assert not lockwatch.in_package(lockwatch.os.path.join(
        root, "karpenter_core_tpu", "solver", "fallback.py"))
    assert racewatch.in_package_module("karpenter_core_tpu_torch.solver.fallback")
    assert not racewatch.in_package_module("karpenter_core_tpu.solver.fallback")
    assert not racewatch.in_package_module("karpenter_core_tpu_torchvision")

    class Foreign:
        pass

    Foreign.__module__ = "karpenter_core_tpu.solver.fallback"
    assert not racewatch._default_class_filter(Foreign)


def test_uninstall_is_last_in_first_out():
    """A watcher installed over another is uninstalled first; the other
    refuses to come off from under it."""
    session = (threading.Lock, threading.RLock)
    outer = lockwatch.LockWatch().install()
    inner = lockwatch.LockWatch().install()
    try:
        with pytest.raises(RuntimeError, match="uninstall the later patch first"):
            outer.uninstall()
        assert threading.Lock is inner._factories[0]
    finally:
        inner.uninstall()
        outer.uninstall()
    assert (threading.Lock, threading.RLock) == session


def test_port_locks_are_tracked_over_the_session_factory():
    """Installed over the session's watcher, the port's tracks a lock the
    port allocates and passes the test's own through untouched."""
    from karpenter_core_tpu_torch.solver.encode import EncodeReuse

    lw = lockwatch.LockWatch().install()
    try:
        reuse = EncodeReuse()
        mine = threading.Lock()
    finally:
        lw.uninstall()
    assert isinstance(reuse._lock, lockwatch.TrackedLock)
    assert not isinstance(mine, lockwatch.TrackedLock)
    assert any(s.startswith("karpenter_core_tpu_torch") for s in lw.sites())


def test_racewatch_uninstall_unhooks_its_allocation_hook():
    lw = lockwatch.LockWatch()
    rw = racewatch.RaceWatch(lock_watch=lw)
    for _ in range(2):
        rw.install()
        rw.uninstall()
    assert lw._alloc_hooks == []


# -- the races the gate found --------------------------------------------------------


def test_batcher_last_window_written_under_its_lock(watch):
    from karpenter_core_tpu_torch.api.settings import Settings
    from karpenter_core_tpu_torch.controllers.provisioning.batcher import Batcher

    b = Batcher(Settings(batch_idle_duration=0.01, batch_max_duration=0.05))

    def window():
        b.trigger()
        assert b.wait(timeout=1.0)

    _on_threads(window, window)
    assert watch.stats()["tracked_instances"] >= 1
    assert watch.races() == [], watch.report()


def test_torch_solver_results_published_under_its_lock(watch):
    from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

    solver = TorchSolver(max_nodes=64, device="cpu")
    inputs = _workload()
    _on_threads(lambda: solver.solve(*inputs), lambda: solver.solve(*inputs))
    assert solver.last_prescreen_mode in ("full", "refresh")
    assert "decode" in solver.last_phase_ms
    assert watch.races() == [], watch.report()


def test_solver_service_results_published_under_its_lock(watch):
    from karpenter_core_tpu_torch.solver.service import RemoteSolver, serve

    server, port, service = serve(device="cpu")
    remote = RemoteSolver(f"127.0.0.1:{port}", max_nodes=64)
    try:
        inputs = _workload()
        _on_threads(lambda: remote.solve(*inputs), lambda: remote.solve(*inputs))
        assert "fetch" in service.phase_ms()
    finally:
        remote.close()
        server.stop(0).wait(10)
    assert watch.races() == [], watch.report()


def test_torch_solver_publishes_its_phases_once_filled(monkeypatch):
    from karpenter_core_tpu_torch.solver import torch_solver

    solver = torch_solver.TorchSolver(max_nodes=64, device="cpu")
    inputs = _workload()
    solver.solve(*inputs)
    first = solver.last_phase_ms
    seen = []
    real = torch_solver.dispatch_solve

    def dispatch(*a, **kw):
        seen.append(solver.last_phase_ms)  # read while the solve runs
        return real(*a, **kw)

    monkeypatch.setattr(torch_solver, "dispatch_solve", dispatch)
    solver.solve(*inputs)
    assert seen and all(s is first for s in seen)
    assert solver.last_phase_ms is not first
    assert set(solver.last_phase_ms) == set(first) >= {"encode", "device", "decode"}


def test_solver_service_publishes_its_phases_once_filled(monkeypatch):
    from karpenter_core_tpu_torch.solver import service as service_mod
    from karpenter_core_tpu_torch.solver.service import RemoteSolver, serve

    server, port, service = serve(device="cpu")
    remote = RemoteSolver(f"127.0.0.1:{port}", max_nodes=64)
    try:
        inputs = _workload()
        remote.solve(*inputs)
        first = service.phase_ms()
        seen = []
        real = service_mod.dispatch_solve

        def dispatch(*a, **kw):
            seen.append(service.phase_ms())  # read while the RPC runs
            return real(*a, **kw)

        monkeypatch.setattr(service_mod, "dispatch_solve", dispatch)
        remote.solve(*inputs)
        assert seen and all(s == first for s in seen)
        assert set(service.phase_ms()) == set(first) >= {"upload", "device", "fetch"}
    finally:
        remote.close()
        server.stop(0).wait(10)
