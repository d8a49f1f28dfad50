"""Fault injection (chaos): named, deterministic fault points that the
port's code consults through maybe_fail(name), the counterpart of the
reference's karpenter_core_tpu/chaos with the same points, schedules,
error kinds and env grammar, so that one spec and seed fire on the same
consults in both packages.

The control plane must degrade, never stall; the chaos suites arm these
points to drive faults through a full operator loop and show that pods
still schedule.

Discipline:

  * maybe_fail() on an un-armed registry is ONE dict lookup returning
    immediately: the hooks live on hot paths (every kube CRUD, every
    machine launch, every solver RPC and device dispatch);
  * faults are DETERMINISTIC: probability rides a per-point seeded
    random.Random (the reference's generator), so a chaos run replays
    exactly under a fixed seed;
  * schedules compose: `after` skips the first K consults, `times` injects
    N faults then recovers, `p` injects at a rate, `latency` delays
    instead of (or before) raising.

Arming is programmatic (arm()/disarm()/reset() or the armed() context
manager) or declarative through KARPENTER_CHAOS, armed at import:

    KARPENTER_CHAOS="cloudprovider.create=error:ice,times:3;state.diff=error:conn,p:0.1,seed:42"

Grammar:

    spec    := clause (';' clause)*
    clause  := point '=' param (',' param)*
    param   := key ':' value
    keys    := error | p | latency | times | after | seed

KARPENTER_CHAOS_SEED is the default per-point seed. Error kinds map to the
typed exceptions each edge classifies: conn/timeout/transport (kube
transport), unavailable/deadline (solver RPC retry and circuit breaker),
ice/incompatible (cloud-provider capacity handling), exhausted (the
admission gate's RESOURCE_EXHAUSTED), runtime (generic); `none` is a
latency-only fault.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Optional, Union

from karpenter_core_tpu_torch.metrics.registry import NAMESPACE, REGISTRY
from karpenter_core_tpu_torch.obs import envflags
from karpenter_core_tpu_torch.obs.log import get_logger

LOG = get_logger("karpenter.chaos")

CHAOS_INJECTED_TOTAL = REGISTRY.counter(
    f"{NAMESPACE}_chaos_injected_total",
    "Faults injected by the chaos registry, by fault point and error kind",
)

# canonical fault-point names — production call sites use these constants so
# a typo'd hook fails review, not silently never fires
KUBE_TRANSPORT = "kube.transport"
CLOUDPROVIDER_CREATE = "cloudprovider.create"
SOLVER_RPC = "solver.rpc"
SOLVER_DEVICE = "solver.device"
# the wedge shape: the dispatch HANGS instead of erroring. Arm with
# error:none and a latency past the watchdog, so that the wedge ->
# open breaker -> fallback -> re-admit cycle is drivable in process; the
# sleeping thread wakes later, the abandoned-thread shape the supervisor
# accounting names
SOLVER_DEVICE_HANG = "solver.device.hang"
# the solver host's crash shape: the child dies mid-dispatch (an OOM kill,
# a fault in the device runtime). The hook lives in the PARENT
# (solver/host.SolverHost.call): an injected fault becomes a SIGKILL of the
# child's process group, so the drill runs the real crash -> respawn cycle
SOLVER_HOST_CRASH = "solver.host.crash"
# queue-full injection at the admission gate (solver/host.AdmissionGate):
# models overload shedding without needing a real burst — arm with
# error:exhausted so callers see the same typed RESOURCE_EXHAUSTED a full
# queue raises
SOLVER_RPC_OVERLOAD = "solver.rpc.overload"
# tenant-flood injection at the admission gate (solver/host.AdmissionGate):
# an armed fault does NOT error the request — the gate re-attributes it to
# one synthetic flooding tenant (CHAOS_FLOOD_TENANT), so arming `p:<frac>`
# mid-churn converts that fraction of live traffic into a flood that must
# trip per-tenant quota/brownout isolation while every real tenant's
# accounting stays clean. Arm with error:exhausted (any kind works; the
# raised fault is swallowed at the hook)
SOLVER_GATE_FLOOD = "solver.gate.flood"
# the segmented pack-scan dispatch (TorchSolver's segmented attempt,
# consulted before the partition): an injected fault models a device
# failure inside the segmented attempt, and the solve DEGRADES to the
# sequential scan with last_segment_stats reason "error:<Type>"
SOLVER_SEGMENT = "solver.segment"
STATE_WATCH = "state.watch"
# the state-store delta feed the incremental solve path gates on
# (state.Cluster.changes_since): an injected fault models dropped or
# duplicated deltas, and the contract is that the consumer DEGRADES to a
# full re-encode instead of trusting a feed that may have lied
STATE_DIFF = "state.diff"

KNOWN_POINTS = (
    KUBE_TRANSPORT,
    CLOUDPROVIDER_CREATE,
    SOLVER_RPC,
    SOLVER_DEVICE,
    SOLVER_DEVICE_HANG,
    SOLVER_HOST_CRASH,
    SOLVER_RPC_OVERLOAD,
    SOLVER_GATE_FLOOD,
    SOLVER_SEGMENT,
    STATE_WATCH,
    STATE_DIFF,
)


def _err_conn() -> Exception:
    return ConnectionResetError("chaos: injected connection reset")


def _err_timeout() -> Exception:
    return TimeoutError("chaos: injected timeout")


def _err_transport() -> Exception:
    return ConnectionError("chaos: injected transport error")


def _err_unavailable() -> Exception:
    from karpenter_core_tpu_torch.solver.service import SolverUnavailableError

    return SolverUnavailableError("chaos: injected UNAVAILABLE")


def _err_deadline() -> Exception:
    from karpenter_core_tpu_torch.solver.service import SolverDeadlineExceededError

    return SolverDeadlineExceededError("chaos: injected DEADLINE_EXCEEDED")


def _err_ice() -> Exception:
    from karpenter_core_tpu_torch.cloudprovider.types import InsufficientCapacityError

    return InsufficientCapacityError("chaos: injected insufficient capacity")


def _err_incompatible() -> Exception:
    from karpenter_core_tpu_torch.cloudprovider.types import (
        IncompatibleRequirementsError,
    )

    return IncompatibleRequirementsError("chaos: injected incompatibility")


def _err_exhausted() -> Exception:
    from karpenter_core_tpu_torch.solver.service import SolverResourceExhaustedError

    return SolverResourceExhaustedError(
        "chaos: injected RESOURCE_EXHAUSTED (admission queue full)"
    )


def _err_runtime() -> Exception:
    return RuntimeError("chaos: injected fault")


# error-kind name -> zero-arg exception factory (lazy imports: chaos is a
# leaf module every layer hooks into; importing the layers here would cycle)
ERROR_KINDS: Dict[str, Callable[[], Exception]] = {
    "conn": _err_conn,
    "timeout": _err_timeout,
    "transport": _err_transport,
    "unavailable": _err_unavailable,
    "deadline": _err_deadline,
    "ice": _err_ice,
    "incompatible": _err_incompatible,
    "exhausted": _err_exhausted,
    "runtime": _err_runtime,
}


class Fault:
    """One armed fault point. Thread-safe: concurrent reconcile workers hit
    the same point and the schedule (after/times/probability) must count
    globally, not per thread."""

    def __init__(
        self,
        point: str,
        error: Union[str, Exception, type, Callable[[], Exception], None] = "runtime",
        probability: float = 1.0,
        latency: float = 0.0,
        times: Optional[int] = None,
        after: int = 0,
        seed: Optional[int] = None,
    ):
        self.point = point
        self.error = error
        self.probability = float(probability)
        self.latency = float(latency)
        self.times = times
        self.after = int(after)
        self.seed = seed
        self._rng = random.Random(seed if seed is not None else 0)
        self._mu = threading.Lock()
        self.calls = 0  # times maybe_fail consulted this point
        self.injected = 0  # times a fault actually fired

    # -- error construction -------------------------------------------------

    def _kind(self) -> str:
        error = self.error
        if error is None:
            return "latency"
        if isinstance(error, str):
            return error
        if isinstance(error, BaseException):
            return type(error).__name__
        if isinstance(error, type):
            return error.__name__
        return getattr(error, "__name__", "callable")

    def _build_error(self) -> Optional[Exception]:
        error = self.error
        if error is None:  # latency-only fault
            return None
        if isinstance(error, str):
            try:
                factory = ERROR_KINDS[error]
            except KeyError:
                raise ValueError(
                    f"unknown chaos error kind {error!r} "
                    f"(known: {', '.join(sorted(ERROR_KINDS))})"
                ) from None
            return factory()
        if isinstance(error, BaseException):
            return error
        # exception class or zero-arg factory
        return error()

    # -- firing -------------------------------------------------------------

    def fire(self) -> None:
        """Decide + inject. Raises the configured error (after any
        configured latency) when the schedule says this call fails."""
        with self._mu:
            self.calls += 1
            if self.calls <= self.after:
                return
            if self.times is not None and self.injected >= self.times:
                return
            if self.probability < 1.0 and self._rng.random() >= self.probability:
                return
            self.injected += 1
            injected = self.injected
            kind = self._kind()
        CHAOS_INJECTED_TOTAL.inc({"point": self.point, "error": kind})
        # a chaos run's log trail shows exactly which call got the fault
        # (correlated by the bound controller/reconcile fields + trace id)
        LOG.debug(
            "chaos fault injected", point=self.point, kind=kind,
            injected=injected,
        )
        if self.latency > 0.0:
            time.sleep(self.latency)
        err = self._build_error()
        if err is not None:
            raise err

    def __repr__(self) -> str:  # armed-state introspection in tests/debug
        with self._mu:  # counters mutate under _mu; read them there too
            calls, injected = self.calls, self.injected
        return (
            f"Fault({self.point!r}, error={self._kind()!r}, "
            f"p={self.probability}, latency={self.latency}, "
            f"times={self.times}, after={self.after}, seed={self.seed}, "
            f"calls={calls}, injected={injected})"
        )


# the armed set. Read lock-free by maybe_fail (CPython dict reads are
# atomic; arming mid-flight is inherently racy anyway — chaos runs arm
# before starting the loop), written under _ARM_MU.
_ARMED: Dict[str, Fault] = {}
_ARM_MU = threading.Lock()


def maybe_fail(point: str) -> None:
    """The production hook. Un-armed (the permanent production state):
    one dict lookup, no allocation, returns immediately."""
    fault = _ARMED.get(point)
    if fault is None:
        return
    fault.fire()


def arm(
    point: str,
    error: Union[str, Exception, type, Callable[[], Exception], None] = "runtime",
    probability: float = 1.0,
    latency: float = 0.0,
    times: Optional[int] = None,
    after: int = 0,
    seed: Optional[int] = None,
) -> Fault:
    """Arm a fault point; returns the Fault for schedule/counter asserts.
    Re-arming replaces the previous fault at that point."""
    fault = Fault(point, error, probability, latency, times, after, seed)
    with _ARM_MU:
        _ARMED[point] = fault
    return fault


def disarm(point: str) -> Optional[Fault]:
    with _ARM_MU:
        return _ARMED.pop(point, None)


def reset() -> None:
    """Disarm everything (test teardown)."""
    with _ARM_MU:
        _ARMED.clear()


def armed_points() -> Dict[str, Fault]:
    with _ARM_MU:
        return dict(_ARMED)


class armed:
    """Context manager: arm for the duration of a with-block, restoring the
    point's previous state on exit (tests nest chaos scopes safely)."""

    def __init__(self, point: str, **kwargs):
        self.point = point
        self.kwargs = kwargs
        self.fault: Optional[Fault] = None
        self._previous: Optional[Fault] = None

    def __enter__(self) -> Fault:
        with _ARM_MU:
            self._previous = _ARMED.get(self.point)
        self.fault = arm(self.point, **self.kwargs)
        return self.fault

    def __exit__(self, exc_type, exc, tb) -> bool:
        with _ARM_MU:
            if self._previous is None:
                _ARMED.pop(self.point, None)
            else:
                _ARMED[self.point] = self._previous
        return False


# ---------------------------------------------------------------------------
# KARPENTER_CHAOS env spec


def parse_spec(spec: str, default_seed: Optional[int] = None) -> Dict[str, Fault]:
    """Parse the env grammar into {point: Fault} without arming (pure,
    testable). Raises ValueError on malformed clauses — a typo'd chaos spec
    must fail loudly at startup, not silently inject nothing."""
    faults: Dict[str, Fault] = {}
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if "=" not in clause:
            raise ValueError(f"chaos clause {clause!r} is missing '=' (point=params)")
        point, _, params = clause.partition("=")
        point = point.strip()
        if not point:
            raise ValueError(f"chaos clause {clause!r} has an empty fault point")
        if point not in KNOWN_POINTS:
            # a typo'd point would arm nothing and the chaos run would pass
            # vacuously — the exact silent failure this parser must refuse.
            # (Programmatic arm() stays free-form for tests.)
            raise ValueError(
                f"unknown chaos fault point {point!r} "
                f"(known: {', '.join(KNOWN_POINTS)})"
            )
        kwargs: dict = {}
        for param in params.split(","):
            param = param.strip()
            if not param:
                continue
            if ":" not in param:
                raise ValueError(
                    f"chaos param {param!r} in {clause!r} is missing ':' (key:value)"
                )
            key, _, value = param.partition(":")
            key, value = key.strip(), value.strip()
            if key == "error":
                if value not in ERROR_KINDS and value != "none":
                    raise ValueError(
                        f"unknown chaos error kind {value!r} "
                        f"(known: {', '.join(sorted(ERROR_KINDS))}, none)"
                    )
                kwargs["error"] = None if value == "none" else value
            elif key == "p":
                kwargs["probability"] = float(value)
            elif key == "latency":
                kwargs["latency"] = float(value)
            elif key == "times":
                kwargs["times"] = int(value)
            elif key == "after":
                kwargs["after"] = int(value)
            elif key == "seed":
                kwargs["seed"] = int(value)
            else:
                raise ValueError(
                    f"unknown chaos param key {key!r} "
                    "(known: error, p, latency, times, after, seed)"
                )
        if "seed" not in kwargs and default_seed is not None:
            kwargs["seed"] = default_seed
        faults[point] = Fault(point, **kwargs)
    return faults


def arm_from_env(environ=None, keep_armed: bool = False) -> Dict[str, Fault]:
    """Arm fault points from KARPENTER_CHAOS (+ KARPENTER_CHAOS_SEED as the
    default per-point seed). Called by entrypoints; a no-op when unset.
    With keep_armed, a point already armed keeps its Fault and counts (the
    process entry's call after the import-time one). Returns the faults
    armed by this call."""
    environ = environ if environ is not None else envflags.environ()
    spec = environ.get("KARPENTER_CHAOS", "").strip()
    if not spec:
        return {}
    seed_raw = environ.get("KARPENTER_CHAOS_SEED", "").strip()
    default_seed = int(seed_raw) if seed_raw else None
    faults = parse_spec(spec, default_seed=default_seed)
    with _ARM_MU:
        if keep_armed:
            faults = {p: f for p, f in faults.items() if p not in _ARMED}
        _ARMED.update(faults)
    return faults


# arming at import mirrors the tracer's KARPENTER_TPU_TRACE hook: any
# entrypoint (operator, solver service, bench, a one-off script) opts into
# chaos uniformly by exporting the spec
arm_from_env()
