"""The race gate's harness: the lines that arm the port's lockwatch and
racewatch first in a fresh interpreter, the deflake iteration that drives
the operator's threads (upstream pkg/test/randomdelay.go's randomized pump
delays and two churn threads), and the watchers' report.

A gated interpreter starts with RACE_ARM.format(root=<the repo's root>),
so that every lock of the port, module-level ones included, is allocated
under the watchers, and then imports this module and the scenarios it
runs. tests/test_torch_racegate.py and chip_smoke.py's phase 16a run it so.
"""
from __future__ import annotations

import os
import random
import threading
import time

from karpenter_core_tpu_torch import testing
from karpenter_core_tpu_torch.api import settings as api_settings
from karpenter_core_tpu_torch.cloudprovider import fake
from karpenter_core_tpu_torch.operator import controller as operator_controller
from karpenter_core_tpu_torch.operator import new_operator

# tests/test_deflake.py's batching: windows short enough that the churn
# threads' pods reach several batches
DEFLAKE_SETTINGS = dict(batch_idle_duration=0.02, batch_max_duration=0.05)


def _pump_errors() -> float:
    with operator_controller.RECONCILE_ERRORS._mu:
        snapshot = dict(operator_controller.RECONCILE_ERRORS.values)
    return sum(n for labels, n in snapshot.items()
               if any(v.startswith("watch-") for _k, v in labels))


def deflake_iteration(seed: int, kube_client=None, solver=None, n_pods: int = 12,
                      quiesce_s: float = 10.0) -> dict:
    """One iteration of tests/test_deflake.py's harness on the port:
    Operator.start() over `kube_client` (in memory when None) with each
    watch pump delayed by a random 0-3 ms before every event, a creator
    thread adding `n_pods` pods of 0.5 cpu and a deleter thread removing
    some of them meanwhile, then the stop. Fatal: the launched machines'
    cpu not covering every surviving pod within `quiesce_s`, a watch
    pump's error, a singleton loop dead before the stop, a thread alive
    after it."""
    rng = random.Random(seed)
    cp = fake.FakeCloudProvider(fake.instance_types(5))
    op = new_operator(cp, kube_client=kube_client,
                      settings=api_settings.Settings(**DEFLAKE_SETTINGS), solver=solver)
    op.jitter = lambda: time.sleep(rng.random() * 0.003)
    client = op.kube_client
    client.create(testing.make_provisioner(name="default"))
    errors_before = _pump_errors()
    t0 = time.perf_counter()
    op.start()
    created, deleted = [], []
    stop_churn = threading.Event()

    def creator():
        for _ in range(n_pods):
            if stop_churn.is_set():
                break
            pod = testing.make_pod(requests={"cpu": "0.5"})
            client.create(pod)
            created.append(pod)
            time.sleep(rng.random() * 0.01)

    def deleter():
        while not stop_churn.is_set():
            if len(created) > len(deleted) + 2 and rng.random() < 0.4:
                pod = created[len(deleted)]
                client.delete("Pod", pod.metadata.namespace, pod.metadata.name)
                deleted.append(pod)
            time.sleep(rng.random() * 0.01)

    threads = [threading.Thread(target=creator, name="deflake-creator", daemon=True),
               threading.Thread(target=deleter, name="deflake-deleter", daemon=True)]
    try:
        for th in threads:
            th.start()
        threads[0].join(timeout=30.0)
        stop_churn.set()
        threads[1].join(timeout=30.0)
        survivors = {p.metadata.name for p in created} - {p.metadata.name for p in deleted}
        demand = 0.5 * len(survivors)
        capacity, machines = 0.0, []
        deadline = time.monotonic() + quiesce_s
        while time.monotonic() < deadline:
            machines = client.list("Machine")
            capacity = sum(m.status.capacity.get("cpu") or 0.0 for m in machines)
            if machines and capacity >= demand:
                break
            time.sleep(0.05)
        if not machines or capacity < demand:
            raise AssertionError(f"deflake seed {seed}: capacity {capacity} for "
                                 f"{len(survivors)} survivors after {quiesce_s} s")
        if _pump_errors() != errors_before:
            raise AssertionError(f"deflake seed {seed}: a watch pump failed")
        dead = [s.name for s in op.singletons if not s._thread.is_alive()]
        if dead:
            raise AssertionError(f"deflake seed {seed}: singletons died: {dead}")
    finally:
        stop_churn.set()
        alive = op.stop()
    if alive:
        raise AssertionError(f"deflake seed {seed}: threads alive after the stop: "
                             f"{[th.name for th in alive]}")
    return {"seed": seed, "created": len(created), "deleted": len(deleted),
            "machines": len(machines), "capacity": capacity, "demand": demand,
            "wall_s": round(time.perf_counter() - t0, 3)}


# the first lines of a race-gated interpreter: the port's watchers armed
# (sampling off, the cap at 128) before any module that allocates a lock
RACE_ARM = (
    "import sys; sys.path.insert(0, {root!r})\n"
    "from karpenter_core_tpu_torch.testing import lockwatch, racewatch\n"
    "assert lockwatch.arm('1') and racewatch.arm('1', sample='1', cap='128')\n"
)


def race_report() -> dict:
    """What the port's armed watchers saw: the tracked lock sites and the
    instrumented classes of the port, the accesses recorded, the
    acquisition-order cycles and the unsuppressed races (each with its
    witnesses), and the suppressed hits."""
    from karpenter_core_tpu_torch.testing import lockwatch, racewatch

    lw, rw = lockwatch.GLOBAL, racewatch.GLOBAL
    st = rw.stats()
    sites = [s for s in lw.sites() if s.startswith("karpenter_core_tpu_torch" + os.sep)]
    classes = [c for c in rw.instrumented_classes() if c.startswith("karpenter_core_tpu_torch.")]
    races = rw.races()
    return {"tracked_sites": len(sites), "instrumented_classes": len(classes),
            "accesses": st["recorded_accesses"], "tracked_instances": st["tracked_instances"],
            "cycles": lw.cycles(), "races": [r.key for r in races],
            "suppressed_hits": st["suppressed_hits"], "classes": classes, "sites": sites,
            "witnesses": (lw.report() if lw.cycles() else "")
            + (rw.report() if races else "")}
