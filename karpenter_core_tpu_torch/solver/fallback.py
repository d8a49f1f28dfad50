"""ResilientSolver: the card's solver with a health-gated host fallback.

A device stack can hang or fail to initialize rather than raise, and the
control plane must go on provisioning through it (reference analog: the
level-triggered reconcile, operator.go:154-169: the solver degrades, it
never stalls the loop). This module wraps the primary solver (TorchSolver on
the card) and a fallback (GreedySolver, the host scheduler):

  - the card's health is probed OUT OF PROCESS with a timeout
    (probe_backend: a subprocess that initializes CUDA, runs one small op
    and synchronizes), so a wedged driver cannot poison the control-plane
    process; a primary with a health() call is asked that instead
    (probe_for);
  - the verdict is re-checked on a TTL in both directions: an unhealthy
    card is re-probed for recovery, a healthy verdict expires so a wedge
    between solves is caught;
  - with solve_timeout set, each primary solve runs on a worker thread
    under a watchdog that reads a HEARTBEAT (utils/supervise.
    ThreadHeartbeat) the solver's phase marks touch: a dispatch whose
    heartbeat goes stale is WEDGED and abandoned at once, one that keeps
    touching it but runs past the budget is abandoned as a timeout. The
    abandoned thread leaks with its call; it is named
    (`primary-solve-abandoned-N-<kind>`), counted
    (karpenter_solver_abandoned_total), inventoried in health_report() and
    marked `reaped` once it exits;
  - abandonment opens the device circuit breaker at once and bumps
    karpenter_solver_wedged_total for a wedge; re-admission goes through
    the breaker's half-open trial, which is the out-of-band probe, never a
    live solve;
  - while the card is unhealthy, solve() routes to the fallback, publishes
    a deduplicated event and bumps karpenter_solver_fallback_total; batches
    under the small-batch work product go to the fallback too, counted on
    their own series.

Every live solve is flight-recorded here (obs/flightrec): a solve the
primary served as "primary" with the "torch" replayer, a fallback solve as
"host.<reason>" with the "greedy" replayer, and a fallback that raises
through finish_error.
"""
from __future__ import annotations

import contextlib
import itertools
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Optional

import torch

from karpenter_core_tpu_torch.events import Event
from karpenter_core_tpu_torch.metrics.registry import NAMESPACE, REGISTRY
from karpenter_core_tpu_torch.obs import reqctx
from karpenter_core_tpu_torch.obs.flightrec import FLIGHTREC, recording_suppressed
from karpenter_core_tpu_torch.obs.log import get_logger
from karpenter_core_tpu_torch.obs.tracer import TRACER
from karpenter_core_tpu_torch.utils import supervise

LOG = get_logger("karpenter.solver.fallback")

SOLVER_FALLBACK_TOTAL = REGISTRY.counter(
    f"{NAMESPACE}_solver_fallback_total",
    "Solves routed to the fallback solver because the accelerator backend "
    "was unavailable or the primary solver failed",
)
# routine routing is not a failure: it has its own counter, so an alert on
# karpenter_solver_fallback_total keeps meaning that something is wrong
SOLVER_SMALL_BATCH_TOTAL = REGISTRY.counter(
    f"{NAMESPACE}_solver_small_batch_routed_total",
    "Solves routed to the host FFD because the batch was below the "
    "small-batch work product (the device path's fixed cost would dominate)",
)
BREAKER_TRANSITIONS = REGISTRY.counter(
    f"{NAMESPACE}_circuit_breaker_transitions_total",
    "Circuit-breaker state transitions, by breaker name and target state",
)
BREAKER_OPEN = REGISTRY.gauge(
    f"{NAMESPACE}_circuit_breaker_open",
    "1 while the named circuit breaker is open (fast-failing), else 0",
)
SOLVER_WEDGED_TOTAL = REGISTRY.counter(
    f"{NAMESPACE}_solver_wedged_total",
    "Device dispatches abandoned because their heartbeat went stale (the "
    "backend wedged mid-dispatch, distinct from slow-but-alive timeouts)",
)
SOLVER_ABANDONED_TOTAL = REGISTRY.counter(
    f"{NAMESPACE}_solver_abandoned_total",
    "Primary-solve worker threads abandoned by the dispatch watchdog, by "
    "kind (wedged = heartbeat stale, timeout = budget exceeded while alive)",
)

# the probe's program: CUDA initialized, one small op on the card, a
# synchronize. It imports torch alone and builds no kernel, so it fits the
# probe's budget on a cold machine.
PROBE_CODE = (
    "import torch\n"
    "if not torch.cuda.is_available():\n"
    "    raise SystemExit('no CUDA device is available')\n"
    "x = torch.arange(1024, device='cuda', dtype=torch.float32)\n"
    "s = float((x * 2).sum())\n"
    "torch.cuda.synchronize()\n"
    "if s != 1047552.0:\n"
    "    raise SystemExit(f'card computed {s}, expected 1047552.0')\n"
    "print(torch.cuda.get_device_name(0))\n"
)


class SolverWedgedError(TimeoutError):
    """The in-flight device dispatch stopped making progress (its heartbeat
    went stale), as opposed to running past its budget while alive."""


class CircuitBreaker:
    """Consecutive-failure circuit breaker with a half-open TTL.

    After `failure_threshold` consecutive failures the breaker OPENS and
    callers fail fast; after `reset_timeout` it HALF-OPENS and lets exactly
    one trial through: success closes it, failure re-opens it and restarts
    the TTL. Thread-safe: solves and background probes share one breaker."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, name: str = "solver.rpc", failure_threshold: int = 3,
                 reset_timeout: float = 30.0, clock=time.time):
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.clock = clock
        self._mu = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0

    def _transition(self, state: str) -> None:
        if state != self._state:
            was = self._state
            self._state = state
            BREAKER_TRANSITIONS.inc({"breaker": self.name, "to": state})
            BREAKER_OPEN.set(1.0 if state == self.OPEN else 0.0, {"breaker": self.name})
            # an instant on the solve timeline, beside the dispatch it
            # interrupted
            TRACER.instant(f"breaker.{self.name}", to=state, from_state=was,
                           failures=self._failures)
            LOG.info("circuit breaker transition", breaker=self.name,
                     from_state=was, to_state=state, failures=self._failures)

    @property
    def state(self) -> str:
        with self._mu:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if (self._state == self.OPEN
                and self.clock() - self._opened_at >= self.reset_timeout):
            self._transition(self.HALF_OPEN)

    def allow(self) -> bool:
        """May a call proceed? Half-open admits ONE trial; later callers
        stay fast-failed until the trial reports."""
        with self._mu:
            self._maybe_half_open()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN:
                # the trial takes the slot: re-open the TTL window so a hung
                # trial does not let callers pile on
                self._transition(self.OPEN)
                self._opened_at = self.clock()
                return True
            return False

    def record_success(self) -> None:
        with self._mu:
            self._failures = 0
            self._transition(self.CLOSED)

    def record_failure(self) -> None:
        with self._mu:
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._transition(self.OPEN)
                self._opened_at = self.clock()

    def trip(self) -> None:
        """Open at once, whatever the failure count: a wedged dispatch is
        definitive evidence, not one vote of three."""
        with self._mu:
            self._failures = max(self._failures, self.failure_threshold)
            self._transition(self.OPEN)
            self._opened_at = self.clock()


def probe_backend(timeout: float = 60.0) -> Optional[str]:
    """Probe the card in a subprocess (PROBE_CODE). Returns None when
    healthy, else a one-line reason. A hung initialization becomes a
    timeout instead of wedging the caller."""
    try:
        proc = subprocess.run([sys.executable, "-c", PROBE_CODE],
                              capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return f"backend probe timed out after {timeout:.0f}s"
    except OSError as e:
        return f"backend probe failed to launch: {e}"
    if proc.returncode != 0:
        err = (proc.stderr or "").strip().splitlines()
        return err[-1] if err else "backend probe exited nonzero"
    return None


def probe_for(primary, timeout: float = 60.0) -> Optional[str]:
    """The probe that matches the primary: one with a health() call (a
    remote solver, whose process may have no card) is asked that; an
    in-process solver probes the local card."""
    health = getattr(primary, "health", None)
    if callable(health):
        try:
            health(timeout=timeout)
            return None
        except Exception as e:  # noqa: BLE001 — any failure is unhealthy
            return f"solver service health check failed: {type(e).__name__}: {e}"
    return probe_backend(timeout)


def _cuda_context():
    """The caller's current CUDA device and stream, to re-enter on the
    watchdog's worker thread (both are per thread in torch); None while
    CUDA is not initialized in this process."""
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_device(), torch.cuda.current_stream()


class ResilientSolver:
    """Solver decorator: the primary with a health-gated fallback, plus
    small-batch routing: a batch whose pods x instance types work product
    is at most small_batch_work_max goes straight to the fallback, where
    the device path's fixed cost would dominate.

    The default of 20,000 is the reference's, sized on its accelerator's
    fixed cost; the card's is measured by chip_smoke.py's phase 12c
    (PERF.md). prober is injectable for tests (default probe_for(primary))."""

    def __init__(self, primary, fallback, recorder=None, clock=time.time,
                 probe_timeout: float = 60.0, reprobe_interval: float = 300.0,
                 healthy_recheck_interval: float = 600.0,
                 solve_timeout: Optional[float] = None, prober=None,
                 small_batch_work_max: int = 20_000,
                 wedge_stale_after: Optional[float] = None,
                 watchdog_poll: float = 1.0):
        self.primary = primary
        self.fallback = fallback
        self.recorder = recorder
        self.clock = clock
        self.probe_timeout = probe_timeout
        self.reprobe_interval = reprobe_interval
        self.healthy_recheck_interval = healthy_recheck_interval
        self.solve_timeout = solve_timeout
        # the heartbeat staleness threshold: the phase marks touch the
        # heartbeat, so the longest legitimate silent stretch is the
        # longest phase (a first kernel build, a full-width scan)
        self.wedge_stale_after = wedge_stale_after
        self.watchdog_poll = watchdog_poll
        self.prober = prober or (lambda: probe_for(primary, probe_timeout))
        self.small_batch_work_max = small_batch_work_max
        self._healthy: Optional[bool] = None
        self._last_probe = 0.0
        self._reason = ""
        # the device breaker: tripped open on a wedge or an abandonment,
        # re-admitted only through the prober (its half-open trial)
        self.breaker = CircuitBreaker(name="solver.device", reset_timeout=reprobe_interval,
                                      clock=clock)
        self.wedge_history: deque = deque(maxlen=32)
        # the abandoned-thread inventory: a record reaches `reaped` when its
        # thread exits (checked by health_report); only reaped records are
        # ever trimmed, a live zombie is never dropped
        self._abandoned: list = []
        self._abandon_count = 0
        self._reaped_count = 0
        self._abandon_seq = itertools.count(1)
        self._last_hb: Optional[supervise.ThreadHeartbeat] = None
        # serializes the probe and the verdict write (concurrent callers
        # share one probe) and guards the inventories; it can be held for a
        # whole probe, so fast paths read the verdict under _state_mu. The
        # order is always _verdict_lock, then _state_mu.
        self._verdict_lock = threading.Lock()
        self._state_mu = threading.Lock()
        # held while a background probe is scheduled or running: acquired on
        # the solve path and released by the probe thread, hence a semaphore
        self._probe_gate = threading.BoundedSemaphore(1)

    # -- health ------------------------------------------------------------

    def _stale(self) -> bool:
        now = self.clock()
        with self._state_mu:
            healthy, last_probe = self._healthy, self._last_probe
        return (healthy is None
                or (not healthy and now - last_probe >= self.reprobe_interval)
                or (healthy and now - last_probe >= self.healthy_recheck_interval))

    def healthy(self) -> bool:
        with self._verdict_lock:
            # while the breaker is OPEN every caller fails fast to the
            # fallback, no probe; when it half-opens, the one admitted trial
            # is the prober, never a live solve
            state = self.breaker.state
            if state == CircuitBreaker.OPEN:
                return False
            if state == CircuitBreaker.HALF_OPEN:
                if not self.breaker.allow():
                    return False  # another thread holds the trial slot
                with self._state_mu:
                    self._last_probe = self.clock()
                reason = self.prober()
                ok = reason is None
                with self._state_mu:
                    self._healthy = ok
                    self._reason = reason or ""
                if ok:
                    self.breaker.record_success()
                    LOG.info("solver recovered from wedge", probe="backend")
                    self._event("SolverRecovered", "Normal",
                                "accelerator backend recovered after wedge")
                else:
                    # allow() re-opened the TTL window; count the failed trial
                    self.breaker.record_failure()
                    LOG.warning("wedge re-admission probe failed", reason=reason,
                                probe="backend")
                return ok
            # re-check under the lock: another caller may have refreshed the
            # verdict while this one waited
            if self._stale():
                with self._state_mu:
                    self._last_probe = self.clock()
                    was = self._healthy
                reason = self.prober()
                ok = reason is None
                with self._state_mu:
                    self._healthy = ok
                    self._reason = reason or ""
                if was is not False and not ok:
                    LOG.warning("solver degraded", reason=reason, probe="backend")
                    self._event("SolverDegraded", "Warning",
                                f"accelerator backend unavailable ({reason}); "
                                "falling back to the host solver")
                elif was is False and ok:
                    LOG.info("solver recovered", probe="backend")
                    self._event("SolverRecovered", "Normal",
                                "accelerator backend recovered")
            with self._state_mu:
                return bool(self._healthy)

    def _maybe_bg_probe(self) -> None:
        """Refresh a stale verdict without blocking the caller: the
        small-batch path never waits on a probe, but a cluster whose solves
        are all small must still establish health, catch a wedge on the
        healthy TTL and re-probe a dead card."""
        if not self._stale():
            return
        if not self._probe_gate.acquire(blocking=False):
            return  # a probe is already scheduled or running

        def run():
            try:
                self.healthy()
            finally:
                self._probe_gate.release()

        # a failed start must not leak the gate, or no background probe
        # would run again
        try:
            threading.Thread(target=run, daemon=True, name="solver-probe").start()
        except Exception:  # noqa: BLE001 — best-effort probe
            self._probe_gate.release()
        except BaseException:
            self._probe_gate.release()
            raise

    def _mark_wedged(self, reason: str, kind: str = "wedged") -> None:
        """The abandonment path (a wedge or a timeout): mark the card dead
        and trip the breaker at once, so re-admission runs through the
        prober's trial and no live solve is handed a wedged card."""
        with self._verdict_lock:
            with self._state_mu:
                self._healthy = False
                self._last_probe = self.clock()
                self._reason = reason
                hb = self._last_hb
            if kind == "wedged":
                SOLVER_WEDGED_TOTAL.inc()
            self.breaker.trip()
            phase = hb.label() if hb is not None else ""
            self.wedge_history.append({
                "ts": self.clock(),
                "kind": kind,
                "reason": reason[:200],
                "phase": phase,
                "heartbeat_age_s": (round(hb.age(), 1)
                                    if hb is not None and hb.age() is not None else None),
            })
            TRACER.instant("solver.wedge", kind=kind, phase=phase)
        LOG.warning("solver wedged", reason=reason, kind=kind, probe="solve")
        self._event("SolverWedged", "Warning",
                    f"device dispatch {kind} ({reason}); breaker open, "
                    "falling back to the host solver until a probe passes")

    MAX_REAPED_RECORDS = 48

    def _reap_abandoned_locked(self) -> None:
        """Move exited abandoned threads to `reaped` (dropping the thread)
        and trim old reaped records; live zombies are never dropped."""
        for rec in self._abandoned:
            t = rec.get("thread")
            if t is not None and not t.is_alive():
                rec["reaped"] = True
                rec["thread"] = None
                self._reaped_count += 1
        if len(self._abandoned) > self.MAX_REAPED_RECORDS:
            keep = []
            excess = len(self._abandoned) - self.MAX_REAPED_RECORDS
            for rec in self._abandoned:
                if excess > 0 and rec["reaped"]:
                    excess -= 1
                    continue
                keep.append(rec)
            self._abandoned = keep

    def health_report(self) -> dict:
        """The health payload: the heartbeat age of the last dispatch, the
        breaker, the wedge history and the abandoned-thread inventory (live
        and reaped). Reads only; no probe."""
        with self._state_mu:
            hb = self._last_hb
        age = hb.age() if hb is not None else None
        host_report = None
        hr = getattr(self.primary, "host_report", None)
        if callable(hr):
            try:
                host_report = hr()
            except Exception as e:  # noqa: BLE001 — report, don't fail health
                host_report = {"error": f"{type(e).__name__}: {e}"}
        retry_budget = None
        rb = getattr(self.primary, "retry_budget", None)
        if rb is not None:
            try:
                retry_budget = rb.stats()
            except Exception as e:  # noqa: BLE001 — report, don't fail health
                retry_budget = {"error": f"{type(e).__name__}: {e}"}
        with self._state_mu:
            healthy, reason = self._healthy, self._reason
        with self._verdict_lock:
            self._reap_abandoned_locked()
            live = sum(1 for r in self._abandoned if not r["reaped"])
            return {
                "healthy": healthy,
                "reason": reason,
                "breaker": self.breaker.state,
                "heartbeat_age_s": round(age, 3) if age is not None else None,
                "heartbeat_phase": hb.label() if hb is not None else "",
                "solve_timeout_s": self.solve_timeout,
                "wedge_stale_after_s": self.wedge_stale_after,
                "wedge_history": list(self.wedge_history),
                "abandoned_total": self._abandon_count,
                "abandoned_live": live,
                "abandoned_reaped": self._reaped_count,
                "abandoned_threads": [
                    {
                        "name": r["name"],
                        "kind": r["kind"],
                        "alive": r["thread"].is_alive() if r["thread"] is not None else False,
                        "reaped": r["reaped"],
                    }
                    for r in self._abandoned
                ],
                "host": host_report,
                "retry_budget": retry_budget,
            }

    def _mark_dead(self, reason: str) -> None:
        # under the verdict lock: a background probe finishing after the
        # failure must not overwrite the dead verdict with its healthy one;
        # stamping _last_probe makes the verdict fresh, so the next
        # healthy() waits out the reprobe TTL
        with self._verdict_lock:
            with self._state_mu:
                self._healthy = False
                self._last_probe = self.clock()
                self._reason = reason
        LOG.warning("solver degraded", reason=reason, probe="solve")
        self._event("SolverDegraded", "Warning",
                    f"primary solver failed ({reason}); falling back to the host solver")

    def _event(self, reason: str, etype: str, message: str) -> None:
        if self.recorder is not None:
            self.recorder.publish(Event("Solver", "solver", etype, reason, message,
                                        dedupe_values=(reason,)))

    # -- Solver interface --------------------------------------------------

    @property
    def supports_batched_replan(self) -> bool:
        # the cached verdict only: read every deprovisioning pass, never
        # blocking on a probe; until the first solve has established
        # health, the sequential replan path is used
        with self._state_mu:
            healthy = self._healthy
        return healthy is True and getattr(self.primary, "supports_batched_replan", False)

    @property
    def backend(self):
        return getattr(self.primary, "backend", None)

    @property
    def max_nodes(self):
        # consolidation sizes its ladder screen off the solver's budget
        return getattr(self.primary, "max_nodes", 1024)

    def encode(self, *args, **kwargs):
        """Pass-through of the pipelined surface (solve(encoded=snap)); the
        primary owns the snapshot format. A fallback solve ignores the
        snapshot (the host scheduler reads the objects)."""
        return self.primary.encode(*args, **kwargs)

    def replan_screen(self, *args, **kwargs):
        """Pass-through of the batched consolidation replan: reachable only
        while supports_batched_replan reads True, so a replan never goes to
        a dead card (the consolidation driver takes the sequential path)."""
        return self.primary.replan_screen(*args, **kwargs)

    def _primary_solve(self, *args, **kwargs):
        if self.solve_timeout is None:
            return self.primary.solve(*args, **kwargs)
        box = {}
        done = threading.Event()
        hb = supervise.ThreadHeartbeat()
        # the request context, the trace and the CUDA device and stream are
        # per thread: the worker re-enters the caller's, or attribution
        # (and the stream the solve's work is ordered on) ends here
        ctx = reqctx.current()
        caller_trace = TRACER.current_trace_id() if TRACER.enabled else None
        cuda_ctx = _cuda_context()
        with self._state_mu:
            self._last_hb = hb

        def run():
            # the heartbeat the solver's phase marks touch
            supervise.bind_heartbeat(hb)
            hb.touch()
            try:
                with contextlib.ExitStack() as stack:
                    if ctx is not None:
                        stack.enter_context(reqctx.bind(ctx))
                    if cuda_ctx is not None:
                        stack.enter_context(torch.cuda.device(cuda_ctx[0]))
                        stack.enter_context(torch.cuda.stream(cuda_ctx[1]))
                    if caller_trace is not None:
                        stack.enter_context(TRACER.span("solver.watchdog.dispatch",
                                                        trace_id=caller_trace))
                    box["result"] = self.primary.solve(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — surfaced below
                box["error"] = e
            finally:
                done.set()

        t = threading.Thread(target=run, daemon=True, name="primary-solve")
        t.start()
        deadline = time.monotonic() + self.solve_timeout
        while True:
            remaining = deadline - time.monotonic()
            if done.wait(min(self.watchdog_poll, max(0.02, remaining))):
                break
            age = hb.age()
            if (self.wedge_stale_after is not None and age is not None
                    and age >= self.wedge_stale_after):
                # the dispatch stopped making progress: a wedge, abandoned
                # before the budget burns down; the label names the phase
                phase = hb.label()
                self._abandon(t, "wedged", age)
                raise SolverWedgedError(
                    f"primary solve heartbeat stale for {age:.0f}s "
                    f"(threshold {self.wedge_stale_after:.0f}s)"
                    + (f" during {phase}" if phase else "")
                    + ": backend wedged mid-dispatch"
                )
            if time.monotonic() >= deadline:
                # alive but over budget: slow, not wedged; the thread leaks
                # with the running call all the same
                self._abandon(t, "timeout", age)
                raise TimeoutError(f"primary solve exceeded {self.solve_timeout:.0f}s watchdog")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _abandon(self, t: threading.Thread, kind: str,
                 heartbeat_age: Optional[float]) -> None:
        """Account for the thread the watchdog leaks: name it, keep it in the
        inventory, count it."""
        n = next(self._abandon_seq)
        t.name = f"primary-solve-abandoned-{n}-{kind}"
        # under the verdict lock: health_report's reap rebuilds the list
        # under the same lock, and a racing append would be lost
        with self._verdict_lock:
            self._abandon_count = n
            self._abandoned.append({"name": t.name, "kind": kind, "thread": t,
                                    "reaped": False})
        SOLVER_ABANDONED_TOTAL.inc(reqctx.tenant_labels(kind=kind))
        LOG.warning("primary solve thread abandoned", kind=kind, thread=t.name,
                    heartbeat_age_s=(round(heartbeat_age, 1)
                                     if heartbeat_age is not None else None))

    def _small_batch(self, pods, instance_types) -> bool:
        if self.small_batch_work_max <= 0:
            return False
        n_types = sum(len(v) for v in instance_types.values())
        return len(pods) * max(n_types, 1) <= self.small_batch_work_max

    def _recorded_fallback(self, rec, backend, dump, pods, provisioners, instance_types,
                           daemonset_pods, state_nodes, kube_client, cluster):
        """The fallback solve with its flight record closed on every exit: a
        fallback that raises finishes the record (and dumps it) before the
        exception propagates."""
        try:
            result = self.fallback.solve(pods, provisioners, instance_types, daemonset_pods,
                                         state_nodes, kube_client=kube_client,
                                         cluster=cluster)
        except Exception as e:
            if rec is not None:
                rec.finish_error(backend, e, replayer="greedy")
            raise
        if rec is not None:
            rec.finish(backend, result, replayer="greedy", dump=dump)
        return result

    def solve(self, pods, provisioners, instance_types, daemonset_pods=None,
              state_nodes=None, kube_client=None, cluster=None, encoded=None):
        # the flight record of this solve's exact inputs (obs/flightrec);
        # disarmed, one flag check. Deprovisioning simulations are not
        # recorded (flightrec.suppress_recording): they re-enter every pass
        # and would churn the ring past the provisioning records.
        rec = None
        if FLIGHTREC.enabled and not recording_suppressed():
            rec = FLIGHTREC.begin(pods, provisioners, instance_types, daemonset_pods,
                                  state_nodes, kube_client=kube_client,
                                  max_nodes=self.max_nodes)
        # small batches: the host FFD beats the device path's fixed cost;
        # routed without waiting on health, while _maybe_bg_probe keeps the
        # verdict fresh on the normal TTLs
        if self._small_batch(pods, instance_types):
            SOLVER_SMALL_BATCH_TOTAL.inc(reqctx.tenant_labels())
            self._maybe_bg_probe()
            return self._recorded_fallback(rec, "host.small_batch", False, pods, provisioners,
                                           instance_types, daemonset_pods, state_nodes,
                                           kube_client, cluster)
        if not self.healthy():
            SOLVER_FALLBACK_TOTAL.inc(reqctx.tenant_labels(reason="backend_unavailable"))
            # a fallback trip is an incident: dump the record to disk
            return self._recorded_fallback(rec, "host.backend_unavailable", True, pods,
                                           provisioners, instance_types, daemonset_pods,
                                           state_nodes, kube_client, cluster)
        try:
            kwargs = {"encoded": encoded} if encoded is not None else {}
            result = self._primary_solve(pods, provisioners, instance_types, daemonset_pods,
                                         state_nodes, kube_client=kube_client,
                                         cluster=cluster, **kwargs)
            if rec is not None:
                rec.finish("primary", result, replayer="torch")
            return result
        except Exception as e:  # noqa: BLE001 — degrade, never stall
            # a typed error classifies itself: an admission shed or a
            # request defect is no evidence against the card; everything
            # untyped marks it dead
            if rec is not None:
                rec.note_primary_error(e)
            LOG.error("primary solve failed, routing to fallback",
                      error=type(e).__name__, error_detail=str(e), pods=len(pods))
            if isinstance(e, SolverWedgedError):
                # the breaker opens now; the prober gates re-admission
                self._mark_wedged(f"{type(e).__name__}: {e}", kind="wedged")
                SOLVER_FALLBACK_TOTAL.inc(reqctx.tenant_labels(reason="wedged"))
            elif isinstance(e, TimeoutError):
                # a slow abandonment leaks its thread all the same
                self._mark_wedged(f"{type(e).__name__}: {e}", kind="timeout")
                SOLVER_FALLBACK_TOTAL.inc(reqctx.tenant_labels(reason="primary_error"))
            elif getattr(e, "shed_reason", None) is not None:
                SOLVER_FALLBACK_TOTAL.inc(reqctx.tenant_labels(reason="admission_shed"))
            elif getattr(e, "marks_unhealthy", True):
                self._mark_dead(f"{type(e).__name__}: {e}")
                SOLVER_FALLBACK_TOTAL.inc(reqctx.tenant_labels(reason="primary_error"))
            else:
                SOLVER_FALLBACK_TOTAL.inc(reqctx.tenant_labels(reason="request_rejected"))
            # note_primary_error makes the record dump on finish; a fallback
            # that raises too finishes it through finish_error
            return self._recorded_fallback(rec, "host.primary_error", False, pods,
                                           provisioners, instance_types, daemonset_pods,
                                           state_nodes, kube_client, cluster)
