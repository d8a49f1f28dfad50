"""The port's load generation (karpenter_core_tpu_torch.loadgen) against
the reference's (karpenter_core_tpu.loadgen), on the CPU.

- ChurnGenerator: the same config gives the same event list.
- ScenarioMixer: the same rng gives pods with equal specs (names, uids and
  creation timestamps pinned, as tests/test_torch_scheduler.py pins them).
- SoakDriver.run_steps() on a FakeClock, with TorchSolver(device="cpu") on
  the port's side and the reference's TPUSolver on JAX's CPU, at
  tests/test_loadgen.py's configuration: equal counts, equal virtual-time
  admission percentiles and byte-identical placements of every solve,
  unarmed and with the soak's `state.diff` and `cloudprovider.create`
  faults armed (seeded as hack/soak.py seeds them).

Both runs launch machines one at a time (a serial executor in place of the
launch pool) with the fake provider's and the machine template's name
counters restarted, so that launched machines and nodes take the same
names in both packages; the pods' uids are pinned to their names.

The incremental outcomes differ by design where the reference keys its
resident tensor on its compiled program and the port on what the tensor
reads (ROADMAP Queue C, "Known, by design"): a solve whose compiled key
changed but whose residency key did not is a full_miss there and a refresh
here. The test holds every other outcome equal, and every solve whose
modes differ to that case.
"""
import concurrent.futures
import importlib
import itertools
from dataclasses import asdict

import numpy as np
import pytest

from karpenter_core_tpu.loadgen import churn as jchurn
from karpenter_core_tpu_torch.loadgen import churn as tchurn

PKGS = {"jax": "karpenter_core_tpu", "torch": "karpenter_core_tpu_torch"}
# test_loadgen.py's fixture, hack/soak.py's smoke drill and chip_smoke's
# steady churn at a cluster's size
CONFIGS = {
    "default": {},
    "fixture": dict(seed=5, duration_s=6.0, arrival_rate=2.0, termination_rate=1.2,
                    resize_rate=0.2, initial_pods=10, initial_nodes=10),
    "soak_smoke": dict(seed=42, duration_s=12.0, arrival_rate=2.5, termination_rate=1.5,
                       resize_rate=0.2, initial_nodes=12),
    "steady": dict(seed=42, duration_s=30.0, arrival_rate=40.0, termination_rate=24.0,
                   resize_rate=3.2, initial_nodes=1000),
}


def _mod(pkg, name):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 5, 42])
def test_churn_events_equal_the_reference_s(config, seed):
    kw = dict(CONFIGS[config], seed=seed)
    want = jchurn.ChurnGenerator(jchurn.ChurnConfig(**kw)).events()
    got = tchurn.ChurnGenerator(tchurn.ChurnConfig(**kw)).events()
    assert [asdict(e) for e in got] == [asdict(e) for e in want]
    assert len(got) > 0


def test_churn_config_rejects_alike():
    for bad in (dict(burst_amplitude=1.5), dict(duration_s=0.0), dict(mix={"generic": 0.0}),
                dict(mix={"generic": -1.0, "bulk": 2.0})):
        for churn in (jchurn, tchurn):
            with pytest.raises(ValueError):
                churn.ChurnConfig(**bad)


def _pod_dicts(pkg, seed, plan):
    scenarios = _mod(pkg, "loadgen.scenarios")
    to_dict = _mod(pkg, "kube.serialization").to_k8s_dict
    mixer = scenarios.ScenarioMixer(np.random.default_rng(seed))
    out = []
    for scenario, count in plan:
        for pod in mixer.make(scenario, count):
            pod.metadata.uid = f"uid-{pod.metadata.name}"
            pod.metadata.creation_timestamp = 1_700_000_000.0
            out.append(to_dict(pod))
    return out


@pytest.mark.parametrize("seed", [0, 5, 42])
def test_scenario_mixer_builds_the_reference_s_pods(seed):
    plan = [("generic", 3), ("bulk", 7), ("spread", 2), ("anti", 2), ("generic", 1),
            ("bulk", 3), ("anti", 1), ("spread", 4)]
    want, got = _pod_dicts("jax", seed, plan), _pod_dicts("torch", seed, plan)
    assert got == want and len(got) == 23
    jscen = _mod("jax", "loadgen.scenarios")
    tscen = _mod("torch", "loadgen.scenarios")
    for name in ("APPS", "TENANT_POOL", "SPREAD_APPS", "ANTI_APPS", "CPU_STEPS", "MEM_STEPS"):
        assert getattr(tscen, name) == getattr(jscen, name)
    assert sorted(tscen.SCENARIOS) == sorted(jscen.SCENARIOS)


# -- SoakDriver.run_steps against the reference's ---------------------------------


class SerialPool:
    """concurrent.futures.ThreadPoolExecutor's surface, running each task
    at submit: launches in submission order, names in that order."""

    def __init__(self, max_workers=None, **_kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        return False

    def submit(self, fn, *a, **kw):
        future = concurrent.futures.Future()
        try:
            future.set_result(fn(*a, **kw))
        except BaseException as exc:  # noqa: BLE001 — the future carries it
            future.set_exception(exc)
        return future

    def shutdown(self, *_a, **_kw):
        pass


def _soak(pkg, armed, monkeypatch):
    chaos = _mod(pkg, "chaos")
    testing = _mod(pkg, "testing")
    flightrec = _mod(pkg, "obs.flightrec")
    loadgen = _mod(pkg, "loadgen")
    monkeypatch.setattr(_mod(pkg, "cloudprovider.fake"), "_name_counter", itertools.count(1))
    monkeypatch.setattr(_mod(pkg, "scheduling.machinetemplate"), "_node_id",
                        itertools.count(1))

    def pinned(*a, **kw):
        pod = testing.make_pod(*a, **kw)
        pod.metadata.uid = f"uid-{pod.metadata.name}"
        return pod

    for name in ("loadgen.scenarios", "loadgen.driver"):
        monkeypatch.setattr(_mod(pkg, name), "make_pod", pinned)
    if pkg == "jax":
        solver = _mod(pkg, "solver.tpu_solver").TPUSolver(
            max_nodes=64, screen_mode="prescreen", profile_phases=True)
    else:
        solver = _mod(pkg, "solver.torch_solver").TorchSolver(max_nodes=64, device="cpu")
    solves = []
    inner = solver.solve

    def recorded(*a, **kw):
        result = inner(*a, **kw)
        key = next(reversed(solver._inc_screens)) if solver._inc_screens else None
        solves.append((flightrec.placements_json(flightrec.canonical_placements(result)),
                       solver.last_prescreen_mode, key))
        return result

    solver.solve = recorded
    chaos.reset()
    try:
        if armed:
            # hack/soak.py:446-449, its seed the config's
            chaos.arm(chaos.STATE_DIFF, error="conn", probability=0.05, seed=5)
            chaos.arm(chaos.CLOUDPROVIDER_CREATE, error="conn", probability=0.02, seed=6)
        driver = loadgen.SoakDriver(loadgen.ChurnConfig(**CONFIGS["fixture"]),
                                    clock=testing.FakeClock(), solver=solver, max_nodes=64)
        report = driver.run_steps()
        injected = {p: (f.calls, f.injected) for p, f in chaos.armed_points().items()}
    finally:
        chaos.reset()
    return report, solves, injected


COUNTS = ("pods_created", "pods_terminated", "resizes", "binds", "unbound_at_end",
          "machines_launched", "admission_count", "admission_p50_s", "admission_p99_s",
          "pending_max", "pending_mean", "chaos_injected", "loops_alive")


@pytest.mark.parametrize("armed", [False, True], ids=["unarmed", "armed"])
def test_soak_run_steps_matches_the_reference(armed, monkeypatch):
    monkeypatch.setattr(concurrent.futures, "ThreadPoolExecutor", SerialPool)
    want, want_solves, want_injected = _soak("jax", armed, monkeypatch)
    got, got_solves, got_injected = _soak("torch", armed, monkeypatch)
    assert {k: getattr(got, k) for k in COUNTS} == {k: getattr(want, k) for k in COUNTS}
    assert got_injected == want_injected
    assert got.binds > 0 and got.unbound_at_end == 0 and got.pods_created > 20
    if armed:
        assert got.chaos_injected > 0
    # byte-identical placements of every solve
    assert [s[0] for s in got_solves] == [s[0] for s in want_solves]
    # the incremental outcomes: equal but for the residency keys' width
    assert sum(got.inc_outcomes.values()) == sum(want.inc_outcomes.values()) == len(got_solves)
    for outcome in ("full_wide", "full_shape", "full_gated", "full_deg"):
        assert got.inc_outcomes[outcome] == want.inc_outcomes[outcome], outcome
    differ = 0
    for k, (w, g) in enumerate(zip(want_solves, got_solves)):
        if w[1] == g[1]:
            continue
        # the reference met a compiled key other than its last one's, the
        # port's residency key is the last one's
        assert (w[1], g[1]) == ("full", "refresh"), k
        assert k > 0 and w[2] != want_solves[k - 1][2] and g[2] == got_solves[k - 1][2], k
        differ += 1
    assert got.inc_outcomes["refresh"] - want.inc_outcomes["refresh"] == differ
    assert want.inc_outcomes["full_miss"] - got.inc_outcomes["full_miss"] == differ
