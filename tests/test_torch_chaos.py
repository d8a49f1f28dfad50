"""The port's fault-injection registry (karpenter_core_tpu_torch.chaos)
against the reference's (karpenter_core_tpu.chaos), on the CPU.

The same spec and seed must fire on the same consults in both packages
(each point keeps its own seeded random.Random, as the reference's does),
raise exceptions of the same class that each package's
`classify_exception` classifies alike, and count alike in
`karpenter_chaos_injected_total`. `parse_spec` must accept and reject the
same strings. The port's chaos and loadgen packages must load no JAX and
nothing of the reference.
"""
import itertools
import subprocess
import sys

import pytest

from karpenter_core_tpu import chaos as jchaos
from karpenter_core_tpu.solver.service import classify_exception as jclassify
from karpenter_core_tpu_torch import chaos as tchaos
from karpenter_core_tpu_torch.solver.service import classify_exception as tclassify

CALLS = 1000
KINDS = sorted(jchaos.ERROR_KINDS) + [None]
SCHEDULES = [
    dict(),
    dict(probability=0.3, seed=42),
    dict(probability=0.05, seed=5),
    dict(probability=0.5, seed=None),
    dict(after=7, times=3),
    dict(after=100, probability=0.2, seed=9),
    dict(times=25, probability=0.7, seed=1),
    dict(latency=0.0005, times=2, after=4),
]


@pytest.fixture(autouse=True)
def _disarmed():
    jchaos.reset()
    tchaos.reset()
    yield
    jchaos.reset()
    tchaos.reset()


def _pattern(chaos, classify, point, kind, schedule):
    """Per consult: whether it fired, and what it raised (the class's name,
    its classification, its `transient`); then the fault's counters and the
    injected-total delta."""
    series = {"point": point, "error": "latency" if kind is None else kind}
    before = chaos.CHAOS_INJECTED_TOTAL.get(series)
    fault = chaos.arm(point, error=kind, **schedule)
    out = []
    for _ in range(CALLS):
        injected = fault.injected
        try:
            chaos.maybe_fail(point)
            raised = None
        except Exception as exc:  # noqa: BLE001 — the injected fault itself
            raised = (type(exc).__name__, classify(exc)[0], getattr(exc, "transient", None))
        out.append((fault.injected - injected, raised))
    chaos.disarm(point)
    return out, fault.calls, fault.injected, chaos.CHAOS_INJECTED_TOTAL.get(series) - before


def test_points_and_kinds_are_the_reference_s():
    assert tchaos.KNOWN_POINTS == jchaos.KNOWN_POINTS
    assert sorted(tchaos.ERROR_KINDS) == sorted(jchaos.ERROR_KINDS)
    assert tchaos.CHAOS_INJECTED_TOTAL.name == jchaos.CHAOS_INJECTED_TOTAL.name


@pytest.mark.parametrize("point", jchaos.KNOWN_POINTS)
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k or "none")
def test_every_point_and_kind_fires_alike(point, kind):
    """One schedule per (point, kind) pair, cycling through SCHEDULES, so
    that every schedule meets every kind across the points."""
    index = (jchaos.KNOWN_POINTS.index(point) + KINDS.index(kind)) % len(SCHEDULES)
    schedule = SCHEDULES[index]
    want = _pattern(jchaos, jclassify, point, kind, schedule)
    got = _pattern(tchaos, tclassify, point, kind, schedule)
    assert got == want
    fired = sum(f for f, _raised in got[0])
    assert fired == got[2] == got[3] and fired > 0
    assert all((raised is not None) == (f == 1 and kind is not None) for f, raised in got[0])


@pytest.mark.parametrize("schedule", SCHEDULES, ids=lambda s: ",".join(
    f"{k}:{v}" for k, v in s.items()) or "always")
def test_every_schedule_fires_alike(schedule):
    want = _pattern(jchaos, jclassify, "t.point", "conn", schedule)
    got = _pattern(tchaos, tclassify, "t.point", "conn", schedule)
    assert got == want


def test_interleaved_points_keep_their_own_streams():
    """Two points armed at once, consulted in one interleaved order: each
    point's rng advances only on its own consults, in both packages."""
    order = [jchaos.STATE_DIFF, jchaos.CLOUDPROVIDER_CREATE] * 300 + [jchaos.STATE_DIFF] * 50

    def run(chaos):
        chaos.arm(chaos.STATE_DIFF, error="conn", probability=0.05, seed=42)
        chaos.arm(chaos.CLOUDPROVIDER_CREATE, error="conn", probability=0.02, seed=43)
        out = []
        for point in order:
            try:
                chaos.maybe_fail(point)
                out.append(0)
            except ConnectionResetError:
                out.append(1)
        return out

    assert run(tchaos) == run(jchaos)


SPECS = [
    "cloudprovider.create=error:ice,times:3",
    "cloudprovider.create=error:ice,times:3;kube.transport=error:conn,p:0.1,seed:42;"
    "solver.rpc=error:unavailable,latency:0.01,after:5",
    "kube.transport=error:none,latency:0.5",
    "solver.device.hang=error:none,latency:600,times:1",
    "solver.host.crash=error:runtime,times:1,after:2",
    "solver.rpc.overload=error:exhausted,p:0.5,seed:7",
    "solver.gate.flood=error:exhausted,p:0.25,seed:3",
    "state.diff=error:conn,p:0.05; cloudprovider.create = error:conn , p:0.02 ;",
    "solver.segment=error:runtime",
    "state.watch=error:timeout,after:0,times:0",
    " ; ",
    "",
    # rejected
    "kube.transport",
    "=error:conn",
    "kube.transport=error",
    "kube.transport=error:nosuchkind",
    "kube.transport=frobnicate:1",
    "cloudprovider.craete=error:ice,times:3",
    "state.diff=p:often",
    "state.diff=times:1.5",
    "state.diff=seed:x",
    "t.point=error:conn",
]


def _parsed(chaos, spec, default_seed):
    try:
        faults = chaos.parse_spec(spec, default_seed=default_seed)
    except Exception as exc:  # noqa: BLE001 — the rejection both must share
        return ("rejected", type(exc).__name__, str(exc))
    return {p: (f.point, f.error, f.probability, f.latency, f.times, f.after, f.seed)
            for p, f in faults.items()}


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("default_seed", [None, 11])
def test_parse_spec_accepts_and_rejects_alike(spec, default_seed):
    assert _parsed(tchaos, spec, default_seed) == _parsed(jchaos, spec, default_seed)


def test_env_spec_fires_alike():
    """KARPENTER_CHAOS and KARPENTER_CHAOS_SEED armed through each
    package's arm_from_env fire on the same consults."""
    env = {"KARPENTER_CHAOS": "state.diff=error:conn,p:0.3;cloudprovider.create=error:ice,"
                              "after:3,times:4", "KARPENTER_CHAOS_SEED": "17"}

    def run(chaos):
        armed = chaos.arm_from_env(env)
        out = []
        for point in itertools.islice(itertools.cycle(sorted(armed)), 200):
            try:
                chaos.maybe_fail(point)
                out.append(None)
            except Exception as exc:  # noqa: BLE001
                out.append(type(exc).__name__)
        return sorted(armed), out

    assert run(tchaos) == run(jchaos)


def test_keep_armed_leaves_an_armed_point_alone():
    """The process entry's second arming keeps the import-time Fault (and
    its counts) and arms only what is not armed yet."""
    env = {"KARPENTER_CHAOS": "state.diff=error:conn;cloudprovider.create=error:ice"}
    first = tchaos.arm(tchaos.STATE_DIFF, error="conn", times=1)
    with pytest.raises(ConnectionResetError):
        tchaos.maybe_fail(tchaos.STATE_DIFF)
    armed = tchaos.arm_from_env(env, keep_armed=True)
    assert sorted(armed) == [tchaos.CLOUDPROVIDER_CREATE]
    assert tchaos.armed_points()[tchaos.STATE_DIFF] is first and first.injected == 1


FRESH = """
import importlib, pkgutil, sys
import karpenter_core_tpu_torch.chaos, karpenter_core_tpu_torch.loadgen as lg
import karpenter_core_tpu_torch.analysis as an
for pkg in (lg, an):
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"{pkg.__name__}.{m.name}")
bad = sorted(n for n in sys.modules if n == "jax" or n.startswith(("jax.", "jaxlib"))
             or n == "karpenter_core_tpu" or n.startswith("karpenter_core_tpu."))
print(",".join(bad) or "clean")
"""


def test_fresh_interpreter_loads_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", FRESH], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "clean", out.stdout
