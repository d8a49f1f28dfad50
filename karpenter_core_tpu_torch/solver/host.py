"""The solver host: the device dispatch in a supervised child process that
a watchdog can kill, and the admission control in front of it (the
reference's solver/host.py).

In process, a wedged dispatch can only be abandoned: its thread keeps the
card, the resident [N, C] tensor and the solver's lock until the call
returns or the process dies (solver/fallback.py). Here the dispatch runs
across a process boundary instead:

  * ``host_main``: the child (`python -m karpenter_core_tpu_torch.solver.host
    --heartbeat PATH --device cuda`), a ``SolverService`` on the device the
    parent names (over the grid of its devices under
    KARPENTER_SOLVER_MODE, solver/factory.detect_mesh), behind length-prefixed frames on stdin/stdout, the
    messages those of solver/codec.py (protobuf's wire format, no protobuf
    or grpc needed). A file ``Heartbeat`` is its process heartbeat
    (utils/supervise), so the phase marks of every dispatch touch the file
    the parent's watchdog reads. It is the process that launches the
    kernels: every response and stats frame carries its launch counts,
    metric snapshot and program inventory.
  * ``SolverHost``: the parent's process manager: a process-group spawn
    (`subprocess`, never a fork of a process that may hold CUDA state),
    the heartbeat-file watchdog while a dispatch is in flight, `killpg`
    SIGKILL on a wedge or a budget overrun, eager respawn, the child's
    stderr tail with the environment's secrets redacted, the salvage of a
    killed child's span spill, and the metrics, program and launch mergers
    that fold each generation exactly once.
  * ``AdmissionGate``: bounded, deadline-aware, fair-share admission
    shared by the host facade and the gRPC service, with the per-tenant
    ``BrownoutLadder`` (device -> greedy -> shed) the SLO engine drives.
  * ``HostSolver``: the Solver facade (TorchSolver's and RemoteSolver's
    interface): encode on the host, ship the tensors over the pipe, decode
    on the host. The parent does no device work. A wedge means kill and
    respawn, and ``health()``, the ResilientSolver breaker's half-open
    trial, respawns the child if needed and probes it.

KARPENTER_SOLVER_HOST=off keeps TorchSolver in process (the default of
solver/factory.build_primary outside the operator entry).

The child reads these variables (the parent's environment, with
`child_env` on top): KCT_PACK_SCREEN and KCT_INCREMENTAL (ops/compat.py),
KARPENTER_TPU_TRACE (the parent's tracer state when
unset), KARPENTER_TPU_LOG, KARPENTER_PROGHEALTH and the build directory of
ops/cuda_build.py; KARPENTER_SOLVER_HOST is forced off in it. The child
packs with the sequential scan whatever KCT_PACK_SCAN says, as the
reference's does (its SolverService never reads the scan mode).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import select
import signal
import struct
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

from karpenter_core_tpu_torch import chaos
from karpenter_core_tpu_torch.metrics.registry import (
    NAMESPACE,
    REGISTRY,
    ProcessSeriesMerger,
    snapshot_families,
)
from karpenter_core_tpu_torch.obs import TRACER, envflags, proghealth, reqctx
from karpenter_core_tpu_torch.obs.log import get_logger
from karpenter_core_tpu_torch.obs.tracer import export_spans
from karpenter_core_tpu_torch.solver import codec as pb
from karpenter_core_tpu_torch.solver.fallback import SolverWedgedError
from karpenter_core_tpu_torch.solver.service import (
    SolverDeadlineExceededError,
    SolverResourceExhaustedError,
    SolverUnavailableError,
    decode_response,
    error_from_string,
    replan_request,
    replan_response,
    solve_request,
)
from karpenter_core_tpu_torch.solver.torch_solver import (
    DEFAULT_MAX_RELAX_ROUNDS,
    SolveResult,
    solve_with_relaxation,
)
from karpenter_core_tpu_torch.utils import supervise

LOG = get_logger("karpenter.solver.host")

SOLVER_QUEUE_DEPTH = REGISTRY.gauge(
    f"{NAMESPACE}_solver_queue_depth",
    "Solver admission-gate depth (in-flight + queued dispatches), by gate",
)
SOLVER_SHED_TOTAL = REGISTRY.counter(
    f"{NAMESPACE}_solver_shed_total",
    "Solver requests shed by the admission gate instead of queued "
    "unboundedly, by gate and reason (queue_full, tenant_quota, brownout, "
    "brownout_shed, deadline_expired, injected) and tenant when a request "
    "context is bound",
)
SOLVER_QUEUE_WAIT = REGISTRY.histogram(
    f"{NAMESPACE}_solver_queue_wait_seconds",
    "Seconds an admitted request waited in the gate before dispatch, by "
    "gate (and tenant when a request context is bound)",
)
DEADLINE_VIOLATIONS_TOTAL = REGISTRY.counter(
    f"{NAMESPACE}_solver_deadline_violations_total",
    "Requests whose deadline the gate could not honor, by gate, stage and "
    "tenant. stage=queue: expired while waiting and shed, NEVER dispatched "
    "— expected under flood, attributed to the tenant that overran its "
    "budget. stage=dispatch: reached dispatch past the deadline — "
    "structurally zero; any increment is a gate bug dashboards should "
    "page on",
)
GATE_DEMOTIONS_TOTAL = REGISTRY.counter(
    f"{NAMESPACE}_gate_demotions_total",
    "Brownout-ladder demotions at the admission gate, by tenant and the "
    "rung demoted to (greedy = shed to the local fallback, shed = hard "
    "shed with a long retry-after); promotions are tracer instant events "
    "and ladder stats, not a counter",
)
HOST_RESPAWN_TOTAL = REGISTRY.counter(
    f"{NAMESPACE}_solver_host_respawn_total",
    "Solver host processes killed and respawned, by reason "
    "(wedged = heartbeat stale, timeout = budget overrun, crashed = the "
    "host died on its own, chaos = injected crash)",
)
HOST_RECOVERY_SECONDS = REGISTRY.gauge(
    f"{NAMESPACE}_solver_host_recovery_seconds",
    "Seconds from the most recent solver-host spawn to its ready frame "
    "(process boot; the first solve additionally pays the persistent-"
    "compile-cache load for its geometry)",
)


# ---------------------------------------------------------------------------
# deadline-aware admission control

# the sub-queue key of requests with no bound tenant: never a metric label
_NO_TENANT = ""
# the synthetic tenant the `solver.gate.flood` chaos point bills traffic
# to: arming it turns a fraction of live requests into one flooding
# tenant, so quota and brownout isolation can be drilled mid-churn without
# touching the real tenants' accounting
CHAOS_FLOOD_TENANT = "chaos-flood"
# DRR weights are clamped into [1/16, 16]: the floor bounds the rotations
# before some queue holds a full dispatch credit, the ceiling keeps one
# tenant from taking every rotation
_MIN_WEIGHT = 1.0 / 16.0
_MAX_WEIGHT = 16.0

_LADDER_RUNGS = ("device", "greedy", "shed")


class BrownoutLadder:
    """The closed SLO -> admission loop: a per-tenant brownout ladder.

    ``burn`` (typically ``SloEngine.fast_burn``) maps a guarded tenant
    label to its fast-window burn rate, and the ladder walks that tenant
    down ``device -> greedy -> shed`` one rung at a time:

      * burn >= ``demote_at``: demote one rung; the first demotion is
        immediate, a further one waits out ``hold_s``, so one bad window
        cannot jump a tenant straight to the hard shed;
      * burn < ``promote_below`` for ``hold_s``: promote one rung back.

    The two thresholds and the dwell are the hysteresis: a tenant
    oscillating around the threshold changes rung at most once per
    ``hold_s``. Probes are rate-limited to one per ``eval_interval_s`` per
    tenant, the cached rung answering in between; a failing probe holds
    the rung (a sick probe is no evidence that a tenant started burning).

    Demotions count in ``karpenter_gate_demotions_total{tenant,reason}``;
    every transition is a ``solver.gate.demote`` / ``solver.gate.promote``
    tracer instant event."""

    def __init__(self, burn, demote_at: float = 1.0, promote_below: float = 0.5,
                 hold_s: float = 30.0, eval_interval_s: float = 1.0, clock=time.monotonic):
        self.burn = burn
        self.demote_at = float(demote_at)
        self.promote_below = float(promote_below)
        self.hold_s = float(hold_s)
        self.eval_interval_s = float(eval_interval_s)
        self._clock = clock
        self._mu = threading.Lock()
        # guarded label -> [rung index, rung-entered ts, last-probe ts, burn]
        self._state: Dict[str, list] = {}
        self.demotions_total = 0
        self.promotions_total = 0

    def review(self, label: str) -> str:
        """The current rung of `label` (a guard-admitted tenant label),
        probing the burn at most once per ``eval_interval_s``."""
        now = self._clock()
        with self._mu:
            st = self._state.get(label)
            if st is None:
                st = self._state[label] = [0, now, float("-inf"), 0.0]
            if now - st[2] < self.eval_interval_s:
                return _LADDER_RUNGS[st[0]]
            st[2] = now
        # the probe reads the SLO engine (its own locks): never under _mu
        try:
            burn = float(self.burn(label))
        except Exception:  # noqa: BLE001 — a sick probe holds the rung
            burn = None
        with self._mu:
            st = self._state[label]
            if burn is None:
                return _LADDER_RUNGS[st[0]]
            st[3] = burn
            rung = st[0]
            dwelt = now - st[1]
            if (burn >= self.demote_at and rung < len(_LADDER_RUNGS) - 1
                    and (rung == 0 or dwelt >= self.hold_s)):
                st[0], st[1] = rung + 1, now
                self._transition_locked(label, rung, rung + 1, burn)
            elif burn < self.promote_below and rung > 0 and dwelt >= self.hold_s:
                st[0], st[1] = rung - 1, now
                self._transition_locked(label, rung, rung - 1, burn)
            return _LADDER_RUNGS[st[0]]

    def _transition_locked(self, label: str, frm: int, to: int, burn: float) -> None:
        if to > frm:
            self.demotions_total += 1
            GATE_DEMOTIONS_TOTAL.inc({"tenant": reqctx.TENANTS.admit(label),
                                      "reason": _LADDER_RUNGS[to]})
            name = "solver.gate.demote"
        else:
            self.promotions_total += 1
            name = "solver.gate.promote"
        TRACER.instant(name, tenant=label, frm=_LADDER_RUNGS[frm], to=_LADDER_RUNGS[to],
                       burn=round(burn, 3))

    def level(self, label: str) -> str:
        with self._mu:
            st = self._state.get(label)
            return _LADDER_RUNGS[st[0]] if st is not None else "device"

    def stats(self) -> Dict[str, object]:
        now = self._clock()
        with self._mu:
            return {
                "demote_at": self.demote_at,
                "promote_below": self.promote_below,
                "hold_s": self.hold_s,
                "demotions_total": self.demotions_total,
                "promotions_total": self.promotions_total,
                "tenants": {
                    label: {"level": _LADDER_RUNGS[st[0]], "burn": round(st[3], 3),
                            "dwell_s": round(now - st[1], 3)}
                    for label, st in self._state.items()
                },
            }


class _Ticket:
    """One queued admission. ``order`` is the earliest-deadline-first key
    within the tenant's sub-queue: deadline first (None last), arrival
    breaking ties."""

    __slots__ = ("key", "deadline", "seq", "order")

    def __init__(self, key: str, deadline: Optional[float], seq: int):
        self.key = key
        self.deadline = deadline
        self.seq = seq
        self.order = (deadline if deadline is not None else float("inf"), seq)


class AdmissionGate:
    """Bounded fair-share admission in front of a serial dispatch resource.

    Under overload requests shed rather than queue forever:

      * one bounded sub-queue per RequestContext tenant (the tenant guard
        caps their count; overflow tenants share the `other` queue,
        unbound requests an unnamed one);
      * dispatch order is weighted deficit-round-robin across tenants
        (``weights``, 1.0 by default) and earliest-deadline-first within
        one: a flooding tenant lengthens only its own queue;
      * at most ``max_queue`` requests wait in all, and at most
        ``tenant_quota`` (when set) per tenant; a full quota sheds the
        offending tenant with RESOURCE_EXHAUSTED and its own retry-after
        (its queue depth times its service-time EMA);
      * ``brownout_at`` (< max_queue) sheds early with the same typed
        error, which ResilientSolver classifies as a request outcome and
        serves from the greedy fallback, so the ladder degrades device ->
        greedy before anything errors; ``ladder`` does the same per tenant
        from its SLO burn;
      * a request whose deadline expires while it waits is never
        dispatched (shed as deadline_expired, a DEADLINE_EXCEEDED billed to
        its tenant); a bound ``RequestContext.deadline_s`` tightens the
        budget and orders the request in its sub-queue.

    Thread-safe; ``clock`` is injectable."""

    def __init__(self, name: str = "solver", max_queue: int = 8,
                 brownout_at: Optional[int] = None, max_inflight: int = 1,
                 clock=time.monotonic, brownout_prefer=None,
                 tenant_quota: Optional[int] = None,
                 weights: Optional[Dict[str, float]] = None,
                 ladder: Optional[BrownoutLadder] = None):
        self.name = name
        self.max_queue = int(max_queue)
        self.brownout_at = brownout_at
        self.max_inflight = int(max_inflight)
        self._clock = clock
        # tenant -> bool: True sheds the tenant in the brownout band (its
        # error budget is spent); None sheds everyone there
        self.brownout_prefer = brownout_prefer
        self.tenant_quota = int(tenant_quota) if tenant_quota is not None else None
        self.weights: Dict[str, float] = dict(weights or {})
        self.ladder = ladder
        self._cond = threading.Condition()
        self._inflight = 0
        self._ema: Optional[float] = None
        self.accepted_total = 0
        self.dispatched_total = 0
        self.deadline_violations = 0  # structurally zero; asserted, not hoped
        self._seq = itertools.count()
        # sub-queue key (guarded label, or "" unbound) -> EDF-ordered tickets
        self._queues: Dict[str, list] = {}
        # the DRR ring: keys with a non-empty sub-queue, in visit order
        self._ring: list = []
        self._deficit: Dict[str, float] = {}
        # tickets granted a dispatch slot, their threads not yet awake
        self._granted: set = set()
        self._shed_counts: Dict[str, int] = {}
        self._tenant_ema: Dict[str, float] = {}
        self._dispatched_by: Dict[str, int] = {}
        self._shed_by: Dict[str, Dict[str, int]] = {}
        self._expired_in_queue: Dict[str, int] = {}
        # guarded tenant label -> depth (in flight + queued)
        self._tenant_depth: Dict[str, int] = {}

    # -- internals (callers hold self._cond) --------------------------------

    def _waiting_locked(self) -> int:
        return sum(len(q) for q in self._queues.values()) + len(self._granted)

    def _depth_locked(self) -> int:
        return self._inflight + self._waiting_locked()

    def _publish_depth_locked(self) -> None:
        SOLVER_QUEUE_DEPTH.set(float(self._depth_locked()), {"gate": self.name})

    def _retry_after_locked(self, key: str = _NO_TENANT) -> float:
        """The tenant's own queue depth times its own service-time EMA
        (the gate's EMA, then 0.25 s, when it has none yet)."""
        est = self._tenant_ema.get(key)
        if est is None:
            est = self._ema if self._ema is not None else 0.25
        depth = len(self._queues.get(key, ())) + self._inflight + len(self._granted)
        return min(5.0, (depth + 1) * est)

    def _weight_of(self, key: str) -> float:
        try:
            w = float(self.weights.get(key, 1.0))
        except (TypeError, ValueError):
            w = 1.0
        return min(_MAX_WEIGHT, max(_MIN_WEIGHT, w))

    def _enqueue_locked(self, ticket: _Ticket) -> None:
        q = self._queues.get(ticket.key)
        if q is None:
            q = self._queues[ticket.key] = []
            self._ring.append(ticket.key)
        for i, other in enumerate(q):
            if ticket.order < other.order:
                q.insert(i, ticket)
                break
        else:
            q.append(ticket)

    def _retire_queue_locked(self, key: str) -> None:
        self._queues.pop(key, None)
        if key in self._ring:
            self._ring.remove(key)
        self._deficit.pop(key, None)

    def _select_locked(self) -> Optional[_Ticket]:
        """The next ticket to grant: weighted deficit-round-robin across
        the sub-queues, the EDF head within each. A visit deposits the
        tenant's weight, a dispatch spends 1.0; the weight floor bounds
        the visits before some queue holds a full credit."""
        ring = self._ring
        max_visits = (int(1.0 / _MIN_WEIGHT) + 1) * max(1, len(ring)) + 1
        for _ in range(max_visits):
            if not ring:
                return None
            key = ring[0]
            q = self._queues.get(key)
            if not q:
                self._retire_queue_locked(key)
                continue
            credit = self._deficit.get(key, 0.0) + self._weight_of(key)
            if credit >= 1.0:
                self._deficit[key] = credit - 1.0
                ticket = q.pop(0)
                if not q:
                    self._retire_queue_locked(key)
                else:
                    ring.append(ring.pop(0))
                return ticket
            self._deficit[key] = credit
            ring.append(ring.pop(0))
        return None  # unreachable: the weight floor bounds the rotations

    def _grant_locked(self) -> None:
        granted = False
        while self._inflight + len(self._granted) < self.max_inflight:
            ticket = self._select_locked()
            if ticket is None:
                break
            self._granted.add(ticket)
            granted = True
        if granted:
            self._cond.notify_all()

    def _abandon_locked(self, ticket: _Ticket) -> None:
        if ticket in self._granted:
            self._granted.discard(ticket)
            return
        q = self._queues.get(ticket.key)
        if q is not None:
            try:
                q.remove(ticket)
            except ValueError:
                pass
            if not q:
                self._retire_queue_locked(ticket.key)

    def _tenant_enter_locked(self, tenant: str) -> None:
        label = reqctx.TENANTS.admit(tenant)
        depth = self._tenant_depth.get(label, 0) + 1
        self._tenant_depth[label] = depth
        SOLVER_QUEUE_DEPTH.set(float(depth),
                               {"gate": self.name, "tenant": reqctx.TENANTS.admit(tenant)})

    def _tenant_exit_locked(self, tenant: str) -> None:
        label = reqctx.TENANTS.admit(tenant)
        depth = self._tenant_depth.get(label, 0) - 1
        if depth <= 0:
            self._tenant_depth.pop(label, None)
            SOLVER_QUEUE_DEPTH.delete({"gate": self.name, "tenant": reqctx.TENANTS.admit(tenant)})
        else:
            self._tenant_depth[label] = depth
            SOLVER_QUEUE_DEPTH.set(float(depth),
                                   {"gate": self.name, "tenant": reqctx.TENANTS.admit(tenant)})

    def _shed_locked(self, reason: str, retry_after: Optional[float], detail: str,
                     tenant: Optional[str] = None):
        self._shed_counts[reason] = self._shed_counts.get(reason, 0) + 1
        key = reqctx.TENANTS.admit(tenant) if tenant is not None else _NO_TENANT
        by = self._shed_by.setdefault(key, {})
        by[reason] = by.get(reason, 0) + 1
        if tenant is not None:
            SOLVER_SHED_TOTAL.inc({"gate": self.name, "reason": reason,
                                   "tenant": reqctx.TENANTS.admit(tenant)})
        else:
            SOLVER_SHED_TOTAL.inc({"gate": self.name, "reason": reason})
        if reason == "deadline_expired":
            err: Exception = SolverDeadlineExceededError(detail)
        else:
            err = SolverResourceExhaustedError(detail)
        err.shed_reason = reason
        err.retry_after_s = retry_after
        return err

    def _expired_locked(self, deadline_s: Optional[float], where: str,
                        tenant: Optional[str]):
        """A queue-expiry shed, billed to the tenant whose request overran
        its budget while waiting (the deadline-violations counter's
        stage="queue" series; stage="dispatch" is structurally zero)."""
        key = reqctx.TENANTS.admit(tenant) if tenant is not None else _NO_TENANT
        self._expired_in_queue[key] = self._expired_in_queue.get(key, 0) + 1
        if tenant is not None:
            DEADLINE_VIOLATIONS_TOTAL.inc({"gate": self.name, "stage": "queue",
                                           "tenant": reqctx.TENANTS.admit(tenant)})
        else:
            DEADLINE_VIOLATIONS_TOTAL.inc({"gate": self.name, "stage": "queue"})
        budget = f"{deadline_s:.2f}s" if deadline_s is not None else "its"
        return self._shed_locked("deadline_expired", None,
                                 f"deadline expired after {budget} budget {where}",
                                 tenant=tenant)

    def _brownout_sheds(self, tenant: Optional[str]) -> bool:
        """Whether this request sheds in the brownout band: everyone with
        no preference hook; with one (SloEngine.budget_exhausted), only
        tenants whose budget is spent. A failing hook sheds (brownout
        protects the device)."""
        prefer = self.brownout_prefer
        if prefer is None:
            return True
        try:
            return bool(prefer(tenant))
        except Exception:  # noqa: BLE001 — a sick hook must not widen admission
            return True

    # -- the gate ------------------------------------------------------------

    @contextlib.contextmanager
    def admitted(self, deadline_s: Optional[float] = None):
        """Admit one dispatch. ``deadline_s`` is the request's remaining
        budget in seconds (None: none; a bound RequestContext.deadline_s
        tightens it). Yields the budget left at dispatch (never <= 0: an
        expired request raises instead). Raises RESOURCE_EXHAUSTED or
        DEADLINE_EXCEEDED on a shed; the dispatch runs outside the gate's
        lock. The chaos point `solver.gate.flood` re-attributes the
        request to CHAOS_FLOOD_TENANT (it never errors it);
        `solver.rpc.overload` sheds it as "injected", raising the injected
        error."""
        tenant = reqctx.current_tenant()
        try:
            chaos.maybe_fail(chaos.SOLVER_GATE_FLOOD)
        except Exception:  # noqa: BLE001 — any armed kind floods
            tenant = CHAOS_FLOOD_TENANT
        try:
            chaos.maybe_fail(chaos.SOLVER_RPC_OVERLOAD)
        except Exception:
            with self._cond:
                self._shed_counts["injected"] = self._shed_counts.get("injected", 0) + 1
                key = reqctx.TENANTS.admit(tenant) if tenant is not None else _NO_TENANT
                by = self._shed_by.setdefault(key, {})
                by["injected"] = by.get("injected", 0) + 1
            if tenant is not None:
                SOLVER_SHED_TOTAL.inc({"gate": self.name, "reason": "injected",
                                       "tenant": reqctx.TENANTS.admit(tenant)})
            else:
                SOLVER_SHED_TOTAL.inc({"gate": self.name, "reason": "injected"})
            raise
        clock = self._clock
        entered = clock()
        ctx_deadline = reqctx.current_deadline()
        if ctx_deadline is not None:
            deadline_s = ctx_deadline if deadline_s is None else min(deadline_s, ctx_deadline)
        deadline = entered + deadline_s if deadline_s is not None else None
        label = reqctx.TENANTS.admit(tenant) if tenant is not None else None
        key = label if label is not None else _NO_TENANT
        ladder = self.ladder
        if ladder is not None and label is not None:
            rung = ladder.review(label)
            if rung != "device":
                with self._cond:
                    if rung == "shed":
                        raise self._shed_locked(
                            "brownout_shed", ladder.hold_s,
                            "tenant browned out (ladder rung shed, burn-driven): hard shed; "
                            f"retry_after_ms={int(ladder.hold_s * 1000)}", tenant=tenant)
                    ra = self._retry_after_locked(key)
                    raise self._shed_locked(
                        "brownout", ra,
                        "tenant browned out (ladder rung greedy, burn-driven): serve the "
                        f"local fallback; retry_after_ms={int(ra * 1000)}", tenant=tenant)
        with self._cond:
            # max_queue bounds waiters: a request the idle gate can dispatch
            # at once never sheds
            must_wait = (self._inflight >= self.max_inflight or bool(self._granted)
                         or bool(self._queues))
            waiting = self._waiting_locked()
            if must_wait and waiting >= self.max_queue:
                ra = self._retry_after_locked(key)
                raise self._shed_locked(
                    "queue_full", ra,
                    f"solver admission queue full ({waiting} queued, max {self.max_queue}); "
                    f"retry_after_ms={int(ra * 1000)}", tenant=tenant)
            quota = self.tenant_quota
            if quota is not None and must_wait:
                mine = len(self._queues.get(key, ()))
                if mine >= quota:
                    ra = self._retry_after_locked(key)
                    raise self._shed_locked(
                        "tenant_quota", ra,
                        f"per-tenant admission quota full ({mine} queued for this tenant, "
                        f"quota {quota}); retry_after_ms={int(ra * 1000)}", tenant=tenant)
            if (self.brownout_at is not None and self._depth_locked() >= self.brownout_at
                    and self._brownout_sheds(tenant)):
                ra = self._retry_after_locked(key)
                raise self._shed_locked(
                    "brownout", ra,
                    f"solver admission brownout (depth {self._depth_locked()} >= "
                    f"{self.brownout_at}): serve the local fallback; "
                    f"retry_after_ms={int(ra * 1000)}", tenant=tenant)
            ticket = _Ticket(key, deadline, next(self._seq))
            self._enqueue_locked(ticket)
            self.accepted_total += 1
            if tenant is not None:
                self._tenant_enter_locked(tenant)
            self._publish_depth_locked()
            self._grant_locked()
            try:
                while ticket not in self._granted:
                    timeout = 0.5
                    if deadline is not None:
                        remaining = deadline - clock()
                        if remaining <= 0:
                            raise self._expired_locked(
                                deadline_s, "while queued; never dispatched", tenant)
                        timeout = min(timeout, remaining)
                    self._cond.wait(timeout)
                self._granted.discard(ticket)
                # an accepted request never reaches the device past its
                # deadline
                if deadline is not None and deadline - clock() <= 0:
                    raise self._expired_locked(deadline_s, "at dispatch; never dispatched",
                                               tenant)
            except BaseException:
                self._abandon_locked(ticket)
                if tenant is not None:
                    self._tenant_exit_locked(tenant)
                self._publish_depth_locked()
                # the abandoned slot (or grant) passes on
                self._grant_locked()
                self._cond.notify_all()
                raise
            self._inflight += 1
            self.dispatched_total += 1
            self._dispatched_by[key] = self._dispatched_by.get(key, 0) + 1
            self._publish_depth_locked()
        t0 = clock()
        try:
            if tenant is not None:
                SOLVER_QUEUE_WAIT.observe(t0 - entered, {
                    "gate": self.name, "tenant": reqctx.TENANTS.admit(tenant)})
            else:
                SOLVER_QUEUE_WAIT.observe(t0 - entered, {"gate": self.name})
            remaining = (deadline - t0) if deadline is not None else None
            if remaining is not None and remaining <= 0:
                # the invariant broke between the last check and here: count
                # it where dashboards page, and shed instead of dispatching
                with self._cond:
                    self.deadline_violations += 1
                    err = self._shed_locked(
                        "deadline_expired", None,
                        f"deadline expired after {deadline_s:.2f}s budget between "
                        "admission and dispatch", tenant=tenant)
                if tenant is not None:
                    DEADLINE_VIOLATIONS_TOTAL.inc({"gate": self.name, "stage": "dispatch",
                                                   "tenant": reqctx.TENANTS.admit(tenant)})
                else:
                    DEADLINE_VIOLATIONS_TOTAL.inc({"gate": self.name, "stage": "dispatch"})
                raise err
            yield remaining
        finally:
            dt = clock() - t0
            with self._cond:
                self._inflight -= 1
                if tenant is not None:
                    self._tenant_exit_locked(tenant)
                self._ema = dt if self._ema is None else 0.8 * self._ema + 0.2 * dt
                if label is not None:
                    prev = self._tenant_ema.get(label)
                    self._tenant_ema[label] = dt if prev is None else 0.8 * prev + 0.2 * dt
                self._publish_depth_locked()
                self._grant_locked()
                self._cond.notify_all()

    def admission_totals(self) -> Dict[Optional[str], Tuple[int, int]]:
        """(good, total) admission outcomes per guarded tenant label and a
        None aggregate: the SLO engine's source for its ratio objective
        over the gate. good = dispatched; bad = capacity sheds
        (queue_full, tenant_quota) and in-queue deadline expiries. Ladder
        and hook sheds (brownout, brownout_shed) are left out: counted as
        burn, a demoted tenant's residual traffic would keep its burn over
        the promote threshold forever."""
        bad_reasons = ("queue_full", "tenant_quota", "deadline_expired")
        with self._cond:
            out: Dict[Optional[str], Tuple[int, int]] = {}
            agg_good = agg_bad = 0
            for key in set(self._dispatched_by) | set(self._shed_by):
                good = self._dispatched_by.get(key, 0)
                by = self._shed_by.get(key, {})
                bad = sum(by.get(r, 0) for r in bad_reasons)
                agg_good += good
                agg_bad += bad
                if key != _NO_TENANT and (good or bad):
                    out[key] = (good, good + bad)
            out[None] = (agg_good, agg_good + agg_bad)
            return out

    def stats(self) -> Dict[str, object]:
        ladder = self.ladder
        ladder_stats = ladder.stats() if ladder is not None else None
        with self._cond:
            return {
                "name": self.name,
                "inflight": self._inflight,
                "queued": self._waiting_locked(),
                "max_queue": self.max_queue,
                "tenant_quota": self.tenant_quota,
                "brownout_at": self.brownout_at,
                "accepted_total": self.accepted_total,
                "dispatched_total": self.dispatched_total,
                "shed": dict(self._shed_counts),
                "tenants": dict(self._tenant_depth),
                "deadline_violations": self.deadline_violations,
                "service_ema_s": round(self._ema, 4) if self._ema is not None else None,
                # the fair-share plane ("" is the unbound requests' queue)
                "queues": {k: len(q) for k, q in self._queues.items()},
                "weights": dict(self.weights),
                "service_ema_by_tenant": {k: round(v, 4) for k, v in self._tenant_ema.items()},
                "dispatched_by_tenant": {k: v for k, v in self._dispatched_by.items()
                                         if k != _NO_TENANT},
                "shed_by_tenant": {k: dict(v) for k, v in self._shed_by.items()
                                   if k != _NO_TENANT},
                "expired_in_queue": {k: v for k, v in self._expired_in_queue.items()
                                     if k != _NO_TENANT},
                "ladder": ladder_stats,
            }


# ---------------------------------------------------------------------------
# frames: a big-endian (header length, body length) pair, the header's
# sort-keyed JSON, the body's bytes

_MAX_FRAME_PART = 2**32 - 1


def _write_frame(stream, header: Dict[str, object], body: bytes = b"") -> None:
    hdr = json.dumps(header, sort_keys=True).encode()
    if len(body) > _MAX_FRAME_PART or len(hdr) > _MAX_FRAME_PART:
        raise ValueError(f"solver host frame too large ({len(hdr)} + {len(body)} bytes)")
    stream.write(struct.pack(">II", len(hdr), len(body)))
    stream.write(hdr)
    if body:
        stream.write(body)
    stream.flush()


def _read_exact(stream, n: int) -> bytes:
    chunks = []
    while n > 0:
        chunk = stream.read(n)
        if not chunk:
            raise EOFError("solver host stream closed")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _read_frame(stream) -> Tuple[Dict[str, object], bytes]:
    hdr_len, body_len = struct.unpack(">II", _read_exact(stream, 8))
    header = json.loads(_read_exact(stream, hdr_len).decode())
    body = _read_exact(stream, body_len) if body_len else b""
    return header, body


class _PipeReader:
    """Deadline-aware reader over the child's stdout: select-sliced waits,
    so the caller's `on_tick` (heartbeat staleness, budget, liveness) runs
    between them. A frame's bytes gather in a buffer sized from its
    length prefix (one copy, however large). EOFError on a closed pipe."""

    def __init__(self, f):
        self._fd = f.fileno()
        self._buf = bytearray()

    def read_frame(self, on_tick=None, poll_s: float = 0.25):
        while True:
            if len(self._buf) >= 8:
                hdr_len, body_len = struct.unpack(">II", self._buf[:8])
                total = 8 + hdr_len + body_len
                if len(self._buf) >= total:
                    raw = bytes(self._buf[:total])
                    del self._buf[:total]
                    header = json.loads(raw[8:8 + hdr_len].decode())
                    return header, raw[8 + hdr_len:]
                want = total - len(self._buf)
            else:
                want = 8 - len(self._buf)
            ready, _, _ = select.select([self._fd], [], [], poll_s)
            if ready:
                chunk = os.read(self._fd, max(1 << 16, min(want, 1 << 24)))
                if not chunk:
                    raise EOFError("solver host stdout closed")
                self._buf += chunk
            elif on_tick is not None:
                on_tick()


class _LaunchTotals:
    """The child's kernel launch counts (ops/screen.py's, by kernel and by
    form), merged across generations as the metrics are: each frame
    carries its generation's cumulative counts, a dead generation's last
    counts fold into the base once. `reset()` makes now the zero."""

    def __init__(self):
        self._mu = threading.Lock()
        self._base: Dict[str, int] = {}
        self._live: Dict[str, int] = {}
        self._live_gen: Optional[int] = None
        self._zero: Dict[str, int] = {}

    def _fold_locked(self) -> None:
        for k, v in self._live.items():
            self._base[k] = self._base.get(k, 0) + v
        self._live, self._live_gen = {}, None

    def ingest(self, generation: int, counts: Dict[str, int]) -> None:
        with self._mu:
            if self._live_gen is not None and generation != self._live_gen:
                self._fold_locked()
            self._live_gen = generation
            self._live = {k: int(v) for k, v in counts.items()}

    def retire(self, generation: int) -> None:
        with self._mu:
            if self._live_gen == generation:
                self._fold_locked()

    def totals(self) -> Dict[str, int]:
        with self._mu:
            keys = set(self._base) | set(self._live) | set(self._zero)
            return {k: self._base.get(k, 0) + self._live.get(k, 0) - self._zero.get(k, 0)
                    for k in sorted(keys)}

    def reset(self) -> None:
        with self._mu:
            keys = set(self._base) | set(self._live)
            self._zero = {k: self._base.get(k, 0) + self._live.get(k, 0) for k in keys}


# ---------------------------------------------------------------------------
# parent: the supervised host process


def _package_root() -> str:
    import karpenter_core_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(karpenter_core_tpu_torch.__file__)))


class SolverHost:
    """Spawn, supervise and kill the child.

    One dispatch in flight at a time (the device is serial). While one is,
    the watchdog reads the heartbeat file the child's phase marks touch:
    silence past ``stale_after`` is a wedge (kill the whole process group
    now), a dispatch past ``solve_timeout`` an overrun (the same kill, a
    different classification). Every kill respawns at once, so the
    ResilientSolver breaker's half-open probe finds a live child."""

    def __init__(self, *, stale_after: Optional[float] = 600.0, solve_timeout: float = 600.0,
                 spawn_timeout: float = 180.0, probe_timeout: float = 30.0,
                 poll_s: float = 0.25, child_env: Optional[Dict[str, str]] = None,
                 workdir: Optional[str] = None, device: str = "cuda"):
        self.stale_after = stale_after
        self.solve_timeout = solve_timeout
        self.spawn_timeout = spawn_timeout
        self.probe_timeout = probe_timeout
        self.poll_s = poll_s
        self.device = str(device)
        self.child_env = dict(child_env or {})
        self.workdir = workdir or tempfile.mkdtemp(prefix="karpenter-solver-host-")
        self.generation = 0
        self.respawns = 0
        self.last_recovery_s: Optional[float] = None
        # the last child's boot: its spawn to its ready frame (the torch
        # import, the card's context, the screen library), and of that
        # the seconds after its imports
        self.last_boot_s: Optional[float] = None
        self.last_startup_s: Optional[float] = None
        self.last_kill: Optional[Dict[str, object]] = None
        self._proc: Optional[subprocess.Popen] = None
        self._reader: Optional[_PipeReader] = None
        self._ready = False
        self._hb_path = ""
        self._stderr_path = ""
        self._spawned_at = 0.0
        self._seq = itertools.count(1)
        # the child's cumulative metric snapshots, merged per generation
        # and exposed by the parent's /metrics under process="solver-host"
        self.metrics = ProcessSeriesMerger("solver-host")
        self._metrics_registered = False
        # the child's program inventory, merged alike, in /debug/programs
        self.programs = proghealth.ProgramInventoryMerger("solver-host")
        self._programs_registered = False
        # the child's kernel launches
        self.launches = _LaunchTotals()
        # serializes frame exchanges (one dispatch in flight)
        self._mu = threading.Lock()
        # leaf lock of the lifecycle metadata (generation, _proc, _ready,
        # respawns, last_kill, last_recovery_s, _hb_path): report(),
        # alive() and pid never wait on _mu, which a dispatch holds for its
        # whole budget; the order is always _mu -> _meta_mu
        self._meta_mu = threading.Lock()

    # -- lifecycle -----------------------------------------------------------

    def _spawn_locked(self) -> None:
        with self._meta_mu:
            self.generation += 1
            gen = self.generation
            hb_path = os.path.join(self.workdir, f"hb-{gen}")
            self._hb_path = hb_path
        self._stderr_path = os.path.join(self.workdir, f"stderr-{gen}.log")
        env = dict(envflags.environ())
        env.update(self.child_env)
        # the child never builds a host of its own
        env["KARPENTER_SOLVER_HOST"] = "off"
        # tracing follows the parent's tracer unless the environment names it
        if not env.get("KARPENTER_TPU_TRACE"):
            env["KARPENTER_TPU_TRACE"] = "1" if TRACER.enabled else "0"
        # the child imports this package from where the parent did
        root = _package_root()
        path = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = root + (os.pathsep + path if path else "")
        stderr_f = open(self._stderr_path, "wb")
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "karpenter_core_tpu_torch.solver.host",
                 "--heartbeat", hb_path, "--device", self.device],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=stderr_f, env=env,
                start_new_session=True,
            )
        finally:
            stderr_f.close()
        self._reader = _PipeReader(proc.stdout)
        self._spawned_at = time.monotonic()
        with self._meta_mu:
            self._proc = proc
            self._ready = False
            if gen > 1:
                self.respawns += 1
        TRACER.instant("solver.host.spawn", pid=proc.pid, generation=gen)
        LOG.info("solver host spawned", pid=proc.pid, generation=gen, device=self.device)

    def _stderr_tail(self) -> str:
        tail = supervise.tail_bytes_of(self._stderr_path, 4096)
        return supervise.redact_env_text(tail) if tail else ""

    def _kill_locked(self, kind: str, note: str, respawn: bool = True,
                     salvage: bool = False) -> None:
        with self._meta_mu:
            proc = self._proc
            hb_path = self._hb_path
        phase = supervise.Heartbeat(hb_path).read_label() if hb_path else ""
        if proc is not None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            try:
                proc.wait(timeout=30)
            except (subprocess.TimeoutExpired, OSError):
                pass
            for stream in (proc.stdin, proc.stdout):
                try:
                    if stream is not None:
                        stream.close()
                except OSError:
                    pass
        tail = self._stderr_tail()
        with self._meta_mu:
            gen = self.generation
            self.last_kill = {"generation": gen, "kind": kind, "note": note, "phase": phase,
                              "pid": proc.pid if proc is not None else None,
                              "at": time.monotonic(), "stderr_tail": tail}
            self._proc = None
            self._ready = False
        self._reader = None
        # the dead generation's last snapshots fold exactly once: the
        # respawned one counts from zero on top of them
        self.metrics.retire(gen)
        self.programs.retire(gen)
        self.launches.retire(gen)
        if salvage:
            # a mid-dispatch kill: the response (and its spans) never came;
            # graft what the child spilled beside its heartbeat
            self._salvage_spans(gen, proc.pid if proc is not None else None)
        TRACER.instant("solver.host.kill", kind=kind, generation=gen, phase=phase)
        if respawn:
            HOST_RESPAWN_TOTAL.inc({"reason": kind})
        LOG.warning("solver host killed", kind=kind, note=note, generation=gen, phase=phase)
        if respawn:
            # eager: the breaker's half-open trial must find a child to probe
            self._spawn_locked()

    def _spill_path(self) -> str:
        with self._meta_mu:
            hb_path = self._hb_path
        return f"{hb_path}.spans" if hb_path else ""

    def _salvage_spans(self, generation: int, pid: Optional[int]) -> None:
        """Graft a killed child's span spill (best-effort, once): the
        child's ring of finished solver.* spans since its dispatch
        started."""
        path = self._spill_path()
        if not path:
            return
        try:
            with open(path, "rb") as f:
                payload = json.loads(f.read().decode())
        except (OSError, ValueError):
            return
        try:
            os.unlink(path)
        except OSError:
            pass
        TRACER.graft(payload, pid=pid, generation=generation, salvaged=True)

    def close(self) -> None:
        """Shut the child down (a process-group kill; no respawn) and
        unregister the merged sources."""
        with self._mu:
            if self._metrics_registered:
                REGISTRY.remove_external(self.metrics)
                self._metrics_registered = False
            if self._programs_registered:
                proghealth.remove_source("solver-host", self.programs.snapshot)
                self._programs_registered = False
            proc = self._proc_get()
            if proc is None:
                return
            try:
                _write_frame(proc.stdin, {"op": "shutdown", "id": 0})
            except (OSError, ValueError):
                pass
            self._kill_locked("shutdown", "close() called", respawn=False)

    def _proc_get(self) -> Optional[subprocess.Popen]:
        with self._meta_mu:
            return self._proc

    @property
    def pid(self) -> Optional[int]:
        proc = self._proc_get()
        return proc.pid if proc is not None else None

    def alive(self) -> bool:
        proc = self._proc_get()
        return proc is not None and proc.poll() is None

    def heartbeat_age(self) -> Optional[float]:
        with self._meta_mu:
            hb_path = self._hb_path
        return supervise.Heartbeat(hb_path).age() if hb_path else None

    # -- readiness -----------------------------------------------------------

    def _ensure_running_locked(self) -> None:
        proc = self._proc_get()
        if proc is not None and proc.poll() is not None:
            self._kill_locked("crashed", f"host exited rc={proc.poll()} between dispatches")
        if self._proc_get() is None:
            self._spawn_locked()
        with self._meta_mu:
            ready = self._ready
        if not ready:
            self._wait_ready_locked()

    def _wait_ready_locked(self) -> None:
        deadline = time.monotonic() + self.spawn_timeout

        def tick():
            proc = self._proc_get()
            if proc is None or proc.poll() is not None:
                raise EOFError("solver host died before ready")
            if time.monotonic() >= deadline:
                raise TimeoutError(f"solver host not ready within {self.spawn_timeout:.0f}s")

        try:
            while True:
                header, _body = self._reader.read_frame(on_tick=tick, poll_s=self.poll_s)
                if header.get("op") == "ready":
                    break
        except (EOFError, TimeoutError, OSError) as e:
            tail = self._stderr_tail()
            # a child that cannot start (no card, a failed library load) is
            # not respawned in a loop: the next call spawns afresh
            self._kill_locked("crashed", f"never became ready: {e}", respawn=False)
            raise SolverUnavailableError(
                f"solver host failed to start: {e}"
                + (f"; stderr tail: {tail[-500:]}" if tail else "")) from e
        recovery = time.monotonic() - self._spawned_at
        sent = header.get("sent_at")
        with self._meta_mu:
            self._ready = True
            self.last_recovery_s = recovery
            self.last_startup_s = header.get("startup_s")
            # CLOCK_MONOTONIC is one clock for every process of the host
            self.last_boot_s = (sent - self._spawned_at
                                if isinstance(sent, (int, float)) else recovery)
            gen = self.generation
        HOST_RECOVERY_SECONDS.set(recovery)
        LOG.info("solver host ready", pid=self.pid, generation=gen,
                 recovery_s=round(recovery, 2))

    def ensure_running(self) -> None:
        with self._mu:
            self._ensure_running_locked()

    # -- dispatch ------------------------------------------------------------

    def call(self, op: str, body: bytes = b"", expires_in_s: Optional[float] = None,
             timeout: Optional[float] = None,
             watch_heartbeat: bool = True) -> Tuple[Dict[str, object], bytes]:
        """One request/response exchange. Kills and respawns the child on
        heartbeat staleness (SolverWedgedError), a budget overrun
        (TimeoutError: the process is killed, nothing leaks) or its death
        (SolverUnavailableError)."""
        with self._mu:
            return self._call_locked(op, body, expires_in_s, timeout, watch_heartbeat)

    def _call_locked(self, op: str, body: bytes, expires_in_s: Optional[float],
                     timeout: Optional[float],
                     watch_heartbeat: bool) -> Tuple[Dict[str, object], bytes]:
        self._ensure_running_locked()
        proc = self._proc_get()
        rid = next(self._seq)
        header: Dict[str, object] = {"op": op, "id": rid}
        if expires_in_s is not None:
            header["expires_in_s"] = round(float(expires_in_s), 3)
        # the parent's trace id rides the header only while tracing is on
        # (its presence asks for the child's spans), and the bound tenant
        # only when there is one: otherwise the header gains no key
        if TRACER.enabled:
            header["trace"] = TRACER.current_trace_id() or ""
        tenant = reqctx.current_tenant()
        if tenant is not None:
            header["tenant"] = tenant
        try:
            _write_frame(proc.stdin, header, body)
        except (OSError, ValueError) as e:
            rc = proc.poll()
            self._kill_locked("crashed", f"write failed ({e}), rc={rc}")
            raise SolverUnavailableError(f"solver host crashed before dispatch (rc={rc})") from e
        # the injected crash (chaos `solver.host.crash`): SIGKILL the
        # child's group mid-dispatch, so that the real death path runs (EOF,
        # respawn, the typed error)
        try:
            chaos.maybe_fail(chaos.SOLVER_HOST_CRASH)
        except Exception:  # noqa: BLE001 — any armed kind crashes the child
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        budget = timeout if timeout is not None else self.solve_timeout
        deadline = time.monotonic() + budget
        with self._meta_mu:
            hb_path = self._hb_path
        hb = supervise.Heartbeat(hb_path)
        dispatch_start = time.monotonic()

        def tick():
            if proc.poll() is not None:
                raise EOFError(f"rc={proc.poll()}")
            now = time.monotonic()
            if watch_heartbeat and self.stale_after is not None:
                age = hb.age()
                # the child touches its heartbeat when the frame arrives,
                # so the silence counts from the later of the two
                silent = min(age, now - dispatch_start) if age is not None \
                    else now - dispatch_start
                if silent >= self.stale_after:
                    raise _Wedge(silent)
            if now >= deadline:
                raise _Overrun(budget)

        try:
            while True:
                rheader, rbody = self._reader.read_frame(on_tick=tick, poll_s=self.poll_s)
                if rheader.get("op") == "ready":
                    continue  # a respawn raced this call
                if rheader.get("id") == rid:
                    self._fold_response_locked(rheader)
                    return rheader, rbody
                # a stale response of a request before a kill: dropped
        except _Wedge as w:
            phase = hb.read_label()
            self._kill_locked(
                "wedged",
                f"dispatch heartbeat stale for {w.age:.1f}s (threshold "
                f"{self.stale_after:.1f}s)" + (f" during {phase}" if phase else ""),
                salvage=True)
            raise SolverWedgedError(
                f"solver host dispatch heartbeat stale for {w.age:.0f}s (threshold "
                f"{self.stale_after:.0f}s)" + (f" during {phase}" if phase else "")
                + ": host process group killed and respawned "
                f"(generation {self._generation_get()})") from None
        except _Overrun as o:
            self._kill_locked(
                "timeout",
                f"dispatch exceeded {o.budget:.1f}s budget (heartbeat fresh: slow, not wedged)",
                salvage=True)
            raise TimeoutError(
                f"solver host dispatch exceeded {o.budget:.0f}s budget: host process group "
                f"killed and respawned (generation {self._generation_get()})") from None
        except (EOFError, OSError) as e:
            tail = self._stderr_tail()
            self._kill_locked("crashed", f"died mid-dispatch: {e}", salvage=True)
            raise SolverUnavailableError(
                f"solver host crashed mid-dispatch ({e}); respawned as generation "
                f"{self._generation_get()}" + (f"; stderr tail: {tail[-500:]}" if tail else "")
            ) from e

    def _fold_response_locked(self, rheader: Dict[str, object]) -> None:
        """A response frame's observability into the parent: the child's
        span delta grafted under the calling thread's live span, its
        cumulative metrics, programs and launch counts into the
        per-generation mergers (each key absent-tolerant)."""
        gen = self._generation_get()
        spans = rheader.get("spans")
        if spans:
            try:
                TRACER.graft(spans, generation=gen)
            except Exception:  # noqa: BLE001 — observability never fails a solve
                pass
        families = rheader.get("metrics")
        if families:
            try:
                if not self._metrics_registered:
                    REGISTRY.add_external(self.metrics)
                    self._metrics_registered = True
                self.metrics.ingest(gen, families)
            except Exception:  # noqa: BLE001
                pass
        programs = rheader.get("programs")
        if programs:
            try:
                if not self._programs_registered:
                    proghealth.add_source("solver-host", self.programs.snapshot)
                    proghealth.ensure_exposition_registered()
                    self._programs_registered = True
                self.programs.ingest(gen, programs)
            except Exception:  # noqa: BLE001
                pass
        launches = rheader.get("launches")
        if isinstance(launches, dict):
            self.launches.ingest(gen, launches)

    def _generation_get(self) -> int:
        with self._meta_mu:
            return self.generation

    def probe(self, timeout: Optional[float] = None) -> Dict[str, object]:
        """The health round trip, the breaker's half-open trial: respawn
        the child if needed, exchange a health frame, raise on anything
        unhealthy. While a dispatch is in flight a fresh heartbeat is the
        proof of life: busy but progressing reports healthy without
        waiting for the device."""
        timeout = timeout if timeout is not None else self.probe_timeout
        if not self._mu.acquire(timeout=min(timeout, 1.0)):
            age = self.heartbeat_age()
            with self._meta_mu:
                hb_path = self._hb_path
            phase = supervise.Heartbeat(hb_path).read_label() if hb_path else ""
            if self.stale_after is not None and age is not None and age >= self.stale_after:
                raise SolverUnavailableError(
                    f"solver host busy with a dispatch whose heartbeat is stale ({age:.0f}s)"
                    + (f" during {phase}" if phase else ""))
            return {"status": "busy", "heartbeat_age_s": age, "heartbeat_phase": phase}
        try:
            # the whole probe under this one bounded acquire: call() would
            # wait on the lock unbounded
            header, body = self._call_locked("health", b"", None, timeout, False)
        finally:
            self._mu.release()
        if not header.get("ok"):
            raise SolverUnavailableError(f"solver host health failed: {header.get('error')}")
        info = json.loads(body.decode()) if body else {}
        if info.get("status", "") != "ok":
            raise SolverUnavailableError(f"solver host unhealthy: {info.get('status', '')}")
        return info

    def stats(self) -> Dict[str, object]:
        header, body = self.call("stats", timeout=self.probe_timeout, watch_heartbeat=False)
        if not header.get("ok"):
            raise SolverUnavailableError(f"solver host stats failed: {header.get('error')}")
        return json.loads(body.decode()) if body else {}

    def report(self) -> Dict[str, object]:
        """The /debug/health payload: pid, generation, liveness, respawns,
        the last kill. Reads only: no frame exchange, never a wait on the
        dispatch lock."""
        with self._meta_mu:
            proc = self._proc
            generation = self.generation
            ready = self._ready
            respawns = self.respawns
            recovery = self.last_recovery_s
            last_kill = self.last_kill
            hb_path = self._hb_path
        hb = supervise.Heartbeat(hb_path) if hb_path else None
        age = hb.age() if hb is not None else None
        return {
            "pid": proc.pid if proc is not None else None,
            "generation": generation,
            "alive": proc is not None and proc.poll() is None,
            "ready": ready,
            "device": self.device,
            "respawn_total": respawns,
            "last_recovery_s": round(recovery, 3) if recovery is not None else None,
            "last_boot_s": round(self.last_boot_s, 3) if self.last_boot_s is not None else None,
            "heartbeat_age_s": round(age, 3) if age is not None else None,
            "heartbeat_phase": hb.read_label() if hb is not None else "",
            "stale_after_s": self.stale_after,
            "solve_timeout_s": self.solve_timeout,
            "last_kill": last_kill,
            "launches": self.launches.totals(),
        }


class _Wedge(Exception):
    def __init__(self, age: float):
        self.age = age


class _Overrun(Exception):
    def __init__(self, budget: float):
        self.budget = budget


# ---------------------------------------------------------------------------
# the Solver facade


class HostSolver:
    """The Solver interface over the supervised child: encode on the host,
    solve in the child on `device` (the card by default; the child raises
    without one), decode on the host: RemoteSolver's shape, with the pipe,
    the heartbeat watchdog and the admission gate where the channel and
    the breaker would be. ResilientSolver wraps it as it wraps a
    RemoteSolver (``health`` is callable, so the entry turns off its own
    in-process wedge watchdog: the watchdog lives here, where it can
    kill)."""

    supports_batched_replan = True

    def __init__(self, max_nodes: int = 1024, max_relax_rounds: Optional[int] = None,
                 solve_timeout: float = 600.0, stale_after: Optional[float] = 600.0,
                 spawn_timeout: float = 180.0, max_queue: int = 8,
                 brownout_at: Optional[int] = None, queue_deadline_s: Optional[float] = None,
                 tenant_quota: Optional[int] = None,
                 weights: Optional[Dict[str, float]] = None,
                 child_env: Optional[Dict[str, str]] = None,
                 admission: Optional[AdmissionGate] = None,
                 host: Optional[SolverHost] = None, device: str = "cuda"):
        from karpenter_core_tpu_torch.solver.encode import EncodeReuse

        self.max_nodes = max_nodes
        self.max_relax_rounds = (DEFAULT_MAX_RELAX_ROUNDS if max_relax_rounds is None
                                 else max_relax_rounds)
        self.queue_deadline_s = queue_deadline_s
        self.host = host or SolverHost(stale_after=stale_after, solve_timeout=solve_timeout,
                                       spawn_timeout=spawn_timeout, child_env=child_env,
                                       device=device)
        self.device = self.host.device
        self.admission = admission or AdmissionGate(
            name="host", max_queue=max_queue, brownout_at=brownout_at,
            tenant_quota=tenant_quota, weights=weights)
        self._encode_reuse = EncodeReuse()
        # the last solve's phases in ms: this process's (encode, args, the
        # request's round trip, decode) and the child's (upload, prescreen,
        # device, fetch); the request and response bytes
        self.last_phase_ms: Dict[str, float] = {}
        self.last_child_phase_ms: Dict[str, float] = {}
        self.last_bytes: Tuple[int, int] = (0, 0)

    # -- health and reports --------------------------------------------------

    def health(self, timeout: float = 30.0) -> Dict[str, object]:
        """The ResilientSolver prober's entry: respawn the child if it is
        dead, probe it, raise on failure."""
        return self.host.probe(timeout=timeout)

    def host_report(self) -> Dict[str, object]:
        report = self.host.report()
        report["admission"] = self.admission.stats()
        return report

    def launch_counts(self) -> Dict[str, int]:
        """The child's kernel launches (by kernel and by form), summed over
        its generations since the last reset_launches()."""
        return self.host.launches.totals()

    def reset_launches(self) -> None:
        self.host.launches.reset()

    def close(self) -> None:
        self.host.close()

    # -- the Solver interface ------------------------------------------------

    def encode(self, pods, provisioners, instance_types, daemonset_pods=None,
               state_nodes=None, kube_client=None, cluster=None):
        from karpenter_core_tpu_torch.solver.encode import encode_snapshot

        return encode_snapshot(pods, provisioners, instance_types, daemonset_pods,
                               state_nodes, kube_client=kube_client, cluster=cluster,
                               max_nodes=self.max_nodes, reuse=self._encode_reuse)

    def _response(self, op: str, request) -> pb.SolveResponse:
        body = request.SerializeToString()
        with self.admission.admitted(self.queue_deadline_s) as remaining:
            header, rbody = self.host.call(op, body, expires_in_s=remaining)
        self.last_bytes = (len(body), len(rbody))
        if op == "solve":
            self.last_child_phase_ms = dict(header.get("phase_ms") or {})
        if not header.get("ok") and header.get("error"):
            return pb.SolveResponse(error=str(header["error"]))
        return pb.SolveResponse.FromString(rbody)

    def solve(self, pods, provisioners, instance_types, daemonset_pods=None,
              state_nodes=None, kube_client=None, cluster=None, encoded=None) -> SolveResult:
        if encoded is not None and (
            len(encoded.pods) != len(pods)
            or {id(p) for p in encoded.pods} != {id(p) for p in pods}
        ):
            raise ValueError("encoded snapshot was built from a different pod batch")
        relax_ctx = {"encoded": encoded}
        return solve_with_relaxation(
            lambda p: self._solve_once(p, provisioners, instance_types, daemonset_pods,
                                       state_nodes, kube_client, cluster, relax_ctx),
            pods, provisioners, instance_types, self.max_relax_rounds)

    def _solve_once(self, pods, provisioners, instance_types, daemonset_pods, state_nodes,
                    kube_client, cluster, relax_ctx) -> SolveResult:
        phases = self.last_phase_ms = {}
        t = time.perf_counter()

        def mark(name):
            nonlocal t
            now = time.perf_counter()
            phases[name] = round((now - t) * 1e3, 3)
            t = now

        snap = relax_ctx.pop("encoded", None)
        if snap is None:
            with TRACER.span("solver.phase.encode", pods=len(pods)):
                snap = self.encode(pods, provisioners, instance_types, daemonset_pods,
                                   state_nodes, kube_client, cluster)
        mark("encode")
        with TRACER.span("solver.phase.args"):
            request = solve_request(snap, provisioners)
        mark("args")
        with TRACER.span("solver.host.request"):
            response = self._response("solve", request)
        mark("request")
        with TRACER.span("solver.phase.decode"):
            result = decode_response(snap, response)
        mark("decode")
        return result

    def prewarm_snapshot(self, snap, provisioners) -> str:
        """The startup prewarm (solver/prewarm.py) in the child: its screen
        library's load and the geometry's prescreen, no scan. "compiled"
        when the child paid the cold costs, "cached" otherwise."""
        body = solve_request(snap, provisioners).SerializeToString()
        with self.admission.admitted(self.queue_deadline_s) as remaining:
            header, _body = self.host.call("prewarm", body, expires_in_s=remaining)
        if not header.get("ok"):
            raise error_from_string(str(header.get("error") or "INTERNAL: prewarm failed"))
        return str(header["outcome"])

    def replan_screen(self, snap, provisioners, count_rows, exist_open, uninitialized=None,
                      cluster=None, want_slots: bool = False):
        """TorchSolver.replan_screen's contract through the child, one
        Replan request."""
        with TRACER.span("solver.phase.replan.args"):
            request = replan_request(snap, provisioners, count_rows, exist_open,
                                     uninitialized, want_slots)
        with TRACER.span("solver.host.replan_request"):
            response = self._response("replan", request)
        return replan_response(response, want_slots)


# ---------------------------------------------------------------------------
# the child


def _counter_by_label(counter, label: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for labels, value in counter.series():
        key = labels.get(label, "")
        out[key] = out.get(key, 0.0) + value
    return out


def _observability(header: Dict[str, object]) -> None:
    """What every response and stats frame carries: the cumulative metric
    snapshot, the kernel launch counts, and the program inventory (absent
    when the ledger is off or empty)."""
    from karpenter_core_tpu_torch.ops import screen

    header["metrics"] = snapshot_families(REGISTRY)
    header["launches"] = screen.launch_counts()
    progs = proghealth.LEDGER.snapshot()
    if progs["programs"] or progs["totals"]:
        header["programs"] = progs


def host_main(argv=None) -> int:
    """`python -m karpenter_core_tpu_torch.solver.host --heartbeat PATH
    [--device cuda|cpu]`: serve solve, replan, prewarm, health and stats
    frames on stdin/stdout until EOF or shutdown."""
    import argparse

    parser = argparse.ArgumentParser(description="karpenter solver host (PyTorch port)")
    parser.add_argument("--heartbeat", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    start = time.monotonic()
    # the frame pipe owns fd 1: anything else that writes to stdout goes to
    # stderr, so a stray print never corrupts a frame
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    from karpenter_core_tpu_torch.obs import enable_tracing_from_env
    from karpenter_core_tpu_torch.obs.log import configure_logging_from_env
    from karpenter_core_tpu_torch.solver.incremental import OUTCOMES
    from karpenter_core_tpu_torch.solver.service import SolverService, classify_exception
    from karpenter_core_tpu_torch.utils.compilecache import enable_persistent_cache

    configure_logging_from_env(default_level="info")
    enable_tracing_from_env(default_on=False)
    enable_persistent_cache()
    # the process heartbeat: every phase mark of a dispatch touches this
    # file, whose mtime the parent's watchdog reads and whose label names
    # the phase a wedge verdict reports
    hb = supervise.Heartbeat(args.heartbeat)
    supervise.set_process_heartbeat(hb)
    hb.touch()
    if TRACER.enabled:
        # finished solver.* spans spill beside the heartbeat, for the
        # parent to graft after a mid-dispatch kill
        TRACER.set_spill(f"{args.heartbeat}.spans")
    # the device the parent named (the card raises here when there is none,
    # before the ready frame: the parent reports the stderr tail); on the
    # card, its context and the screen library are made before the ready
    # frame too, so a dispatch's watchdog never waits on them
    # a child that sees several devices serves over their grid (reference
    # host.py:1758-1769): KARPENTER_SOLVER_MODE=single pins the one
    # device; auto degrades to it when detection fails; sharded fails the
    # start without a grid, as solver/factory.build_solver does
    from karpenter_core_tpu_torch.solver.factory import detect_mesh, refuse_spanning

    mode = envflags.raw("KARPENTER_SOLVER_MODE", "auto").lower()
    mesh = None
    if mode != "single":
        refuse_spanning("the solver host's child")
        try:
            mesh = detect_mesh(device=args.device)
        except Exception:  # noqa: BLE001 — auto serves the single device
            if mode == "sharded":
                raise
        if mesh is None and mode == "sharded":
            raise RuntimeError("KARPENTER_SOLVER_MODE=sharded but only one device is visible")
    service = SolverService(device=args.device, mesh=mesh)
    if service.device.type == "cuda":
        import torch

        from karpenter_core_tpu_torch.solver.torch_solver import load_screen_library

        torch.empty(1, device=service.device)
        load_screen_library(service.device)
    _write_frame(out, {"op": "ready", "id": 0, "pid": os.getpid(),
                       "startup_s": round(time.monotonic() - start, 3),
                       "sent_at": time.monotonic()})
    LOG.info("solver host worker ready", pid=os.getpid(), device=str(service.device),
             startup_s=round(time.monotonic() - start, 3))
    stdin = sys.stdin.buffer
    while True:
        try:
            header, body = _read_frame(stdin)
        except EOFError:
            return 0
        op = header.get("op")
        rid = header.get("id", 0)
        if op == "shutdown":
            return 0
        hb.touch()
        try:
            if op in ("solve", "replan", "prewarm"):
                expires = header.get("expires_in_s")
                if expires is not None and float(expires) <= 0:
                    # a request that arrives expired is never dispatched
                    _write_frame(out, {"op": "result", "id": rid, "ok": False,
                                       "error": "DEADLINE_EXCEEDED: deadline expired before "
                                                "host dispatch"})
                    continue
                request = pb.SolveRequest.FromString(body)
                # the parent's trace id joins the child's spans to its
                # trace; the span delta since this mark rides back. The
                # parent's tenant is bound again here
                trace_id = header.get("trace")
                want_spans = trace_id is not None and TRACER.enabled
                tenant = header.get("tenant")
                rheader: Dict[str, object] = {"op": "result", "id": rid}
                with contextlib.ExitStack() as dispatch_ctx:
                    if tenant is not None:
                        dispatch_ctx.enter_context(reqctx.bind(
                            reqctx.RequestContext(tenant=str(tenant))))
                    if want_spans:
                        TRACER.reset_spill()
                        mark = TRACER.mark()
                        dispatch_ctx.enter_context(TRACER.span(
                            "solver.host.dispatch", trace_id=str(trace_id) or None, op=op))
                    if op == "prewarm":
                        rheader.update(ok=True, error="", outcome=service.prewarm(request))
                        response_body = b""
                    else:
                        handler = service.solve if op == "solve" else service.replan
                        response = handler(request, context=None)
                        rheader.update(ok=not bool(response.error), error=response.error or "")
                        if op == "solve":
                            rheader["phase_ms"] = {k: round(v, 3) for k, v in
                                                   service.phase_ms().items()}
                        response_body = response.SerializeToString()
                if want_spans:
                    rheader["spans"] = export_spans(TRACER.spans_since(mark))
                _observability(rheader)
                _write_frame(out, rheader, response_body)
                # the spill holds only an unanswered dispatch's spans
                TRACER.reset_spill()
            elif op == "health":
                age = service._stalest_dispatch_age()
                if age is not None and age >= service.wedge_stale_after:
                    info = {"status": f"wedged: dispatch heartbeat stale for {age:.0f}s",
                            "solves": service.solves}
                else:
                    info = {"status": "ok", "platform": service.device.type,
                            "device": service.device_name(), "solves": service.solves,
                            "replans": service.replans, "pid": os.getpid()}
                _write_frame(out, {"op": "result", "id": rid, "ok": True},
                             json.dumps(info, sort_keys=True).encode())
            elif op == "stats":
                from karpenter_core_tpu_torch.ops import screen

                from karpenter_core_tpu_torch.utils.compilecache import (
                    CACHE_HITS,
                    CACHE_MISSES,
                    COMPILE_SECONDS,
                )

                _buckets, n_compiles, compile_s = COMPILE_SECONDS.snapshot()
                info = {"pid": os.getpid(), "solves": service.solves,
                        "replans": service.replans,
                        "incremental": _counter_by_label(OUTCOMES, "outcome"),
                        "compile_cache_hits": _counter_by_label(CACHE_HITS, "site"),
                        "compile_cache_misses": _counter_by_label(CACHE_MISSES, "site"),
                        "compile_seconds": {"count": n_compiles, "sum": compile_s},
                        "launches": screen.launch_counts(),
                        "entries": len(service._compiled)}
                sheader: Dict[str, object] = {"op": "result", "id": rid, "ok": True}
                _observability(sheader)
                _write_frame(out, sheader, json.dumps(info, sort_keys=True).encode())
            else:
                _write_frame(out, {"op": "result", "id": rid, "ok": False,
                                   "error": f"INVALID_ARGUMENT: unknown op {op!r}"})
        except Exception as e:  # noqa: BLE001 — classified, never fatal
            code, msg = classify_exception(e)
            LOG.error("solver host request failed", op=op, error=type(e).__name__,
                      error_detail=str(e))
            try:
                _write_frame(out, {"op": "result", "id": rid, "ok": False,
                                   "error": f"{code}: {msg}"})
            except OSError:
                return 1


if __name__ == "__main__":
    sys.exit(host_main() or 0)
