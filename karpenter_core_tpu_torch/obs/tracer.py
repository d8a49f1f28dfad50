"""Solve-path tracing: nested spans, a bounded ring buffer, Chrome
trace-event export (loadable in Perfetto / chrome://tracing), and a metrics
bridge into the in-process registry.

Design constraints (the reasons this is not an OpenTelemetry dependency):

  * the disabled path must be near-zero — Tracer.span()/add_span() on a
    disabled tracer is ONE attribute check returning a shared no-op object,
    no allocation — so the instrumentation lives permanently on the
    production hot path (provisioner reconcile -> batcher window ->
    TorchSolver phases -> launch);
  * spans must be recordable retroactively (add_span with explicit
    timestamps) because the solver's phase boundaries are sequential marks
    inside one function, not lexically nested blocks. On the card each
    phase mark follows the device synchronize the solver already issues,
    so a phase span covers the phase's device work; the tracer itself
    never synchronizes;
  * everything is process-local and thread-safe: solver phases run on the
    reconcile thread and machine launches fan out over a pool.

This tracer covers the host-side pipeline; device_profiler below wraps a
solve in torch.profiler (CPU and CUDA activities) when
KARPENTER_TPU_PROFILE names a directory, and the two traces load side by
side in Perfetto.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

from karpenter_core_tpu_torch.metrics.registry import NAMESPACE, REGISTRY
from karpenter_core_tpu_torch.obs import reqctx

# -- instruments fed by the span bridge (the reference's names) -------------

SOLVER_PHASE_DURATION = REGISTRY.histogram(
    f"{NAMESPACE}_solver_phase_duration_seconds",
    "Duration of each TPU solver phase (encode/args/pack/upload/device/"
    "fetch/bind), fed by solver.phase.* spans",
)
SOLVER_SOLVE_DURATION = REGISTRY.histogram(
    f"{NAMESPACE}_solver_solve_duration_seconds",
    "End-to-end Solve() duration including relaxation rounds",
)
SOLVER_BATCH_SIZE = REGISTRY.gauge(
    f"{NAMESPACE}_solver_batch_size",
    "Pod count of the most recent Solve() batch",
)

_PHASE_PREFIX = "solver.phase."

# gRPC metadata key carrying the trace id across the solver-service
# boundary (client stub attaches, server handler adopts)
TRACE_HEADER = "x-karpenter-trace-id"


def _bridge(span: "Span") -> None:
    """Span completion -> metrics registry. Called with the tracer enabled
    only; controller reconcile histograms are observed at their own sites
    (operator/controller.py) so they are never double-counted here."""
    name = span.name
    # the span's tenant attr (stamped by span() from the bound request
    # context) fans the phase/solve histograms out per tenant — through the
    # cardinality guard, so a label flood collapses into "other"
    tenant = span.attrs.get("tenant")
    if name.startswith(_PHASE_PREFIX):
        labels = {"phase": name[len(_PHASE_PREFIX):]}
        if tenant is not None:
            labels["tenant"] = reqctx.TENANTS.admit(str(tenant))
        SOLVER_PHASE_DURATION.observe(span.duration_s, labels)
    elif name == "solver.solve":
        # deprovisioning simulations re-enter the same solver: keep their
        # solves out of the provisioning-latency series (context label /
        # batch-size gauge) or consolidation-heavy clusters would report
        # simulation numbers as provisioning SLO data
        ctx = str(span.attrs.get("context", "provisioning"))
        labels = {"context": ctx}
        if tenant is not None:
            labels["tenant"] = reqctx.TENANTS.admit(str(tenant))
        SOLVER_SOLVE_DURATION.observe(
            span.duration_s, labels,
            # the exemplar links a bad latency bucket to its trace — and,
            # through the trace id, to the flight record of the same solve
            exemplar={"trace_id": span.trace_id} if span.trace_id else None,
        )
        pods = span.attrs.get("pods")
        if pods is not None and ctx == "provisioning":
            SOLVER_BATCH_SIZE.set(float(pods))


# ---------------------------------------------------------------------------


class Span:
    """One finished (or live) span. Timestamps are perf_counter_ns."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start_ns", "end_ns",
        "attrs", "tid", "_tracer",
    )

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: int, parent_id: Optional[int],
                 attrs: Dict[str, object]):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.tid = threading.get_ident()
        self.start_ns = 0
        self.end_ns = 0

    @property
    def duration_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def duration_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def set(self, **attrs) -> "Span":
        """Attach attributes to a live span (e.g. rounds known at exit)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end_ns = time.perf_counter_ns()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._pop(self)
        return False


class _NoopSpan:
    """Shared do-nothing span for the disabled path: span() returns THIS
    object without allocating, so a disabled tracer costs one flag check."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Thread-safe tracer with a bounded ring-buffer span store.

    Spans nest via a thread-local stack: a span opened while another is
    live on the same thread becomes its child and inherits its trace id.
    Roots mint a fresh trace id unless one is passed explicitly (the gRPC
    service passes the client's, the solver host's child the parent's).
    Finished spans land in a deque(maxlen=capacity); `dropped` counts
    ring-buffer evictions so truncation is always visible in exports.
    """

    # per-graft span budget: a chatty child can never push more than this
    # many spans into the parent's ring per exchange (the frame side caps
    # the export alike: MAX_EXPORT_SPANS/BYTES)
    MAX_GRAFT_SPANS = 256

    def __init__(self, capacity: int = 65536):
        self.enabled = False
        self.capacity = capacity
        self._mu = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        self._finished = 0  # total spans ever recorded (monotonic)
        self._ids = itertools.count(1)
        self._trace_ids = itertools.count(1)
        self._tls = threading.local()
        self._t0_ns = time.perf_counter_ns()
        self._pid = os.getpid()
        # graft accounting: spans a child exported that this tracer refused
        # (the per-graft cap) plus those the child dropped at export
        self._graft_dropped = 0
        self._grafted = 0
        # the span spill of a solver host's child: finished spans with a
        # spilled prefix are mirrored into a small ring, rewritten to
        # `spill_path` per span, so the parent can salvage the last phases
        # of a child it killed. None (the default) costs one attribute read
        # per recorded span.
        self._spill_path: Optional[str] = None
        self._spill_prefix: Tuple[str, ...] = ()
        self._spill_ring: deque = deque(maxlen=64)

    # -- lifecycle ---------------------------------------------------------

    def enable(self) -> "Tracer":
        # the write latches under _mu; the hot-path `enabled` read stays
        # lock-free by contract (same posture as FlightRecorder.enabled)
        with self._mu:
            self.enabled = True
        return self

    def disable(self) -> "Tracer":
        with self._mu:
            self.enabled = False
        return self

    def clear(self) -> None:
        with self._mu:
            self._spans.clear()
            self._finished = 0

    # -- recording ---------------------------------------------------------

    def span(self, name: str, trace_id: Optional[str] = None, **attrs):
        """Context manager for a live span. Disabled -> shared no-op."""
        if not self.enabled:
            return NOOP_SPAN
        return self._make(name, trace_id, attrs)

    def add_span(self, name: str, start_ns: int, end_ns: int,
                 trace_id: Optional[str] = None, **attrs) -> None:
        """Record an already-finished region (phase marks inside one
        function body); parented to the calling thread's current span."""
        if not self.enabled:
            return
        span = self._make(name, trace_id, attrs)
        span.start_ns = start_ns
        span.end_ns = end_ns
        self._record(span)

    def instant(self, name: str, trace_id: Optional[str] = None,
                **attrs) -> None:
        """Record a zero-duration instant event (a breaker transition, a
        wedge verdict), drawn as an instant ('i') marker in chrome_trace().
        Disabled -> one flag check."""
        if not self.enabled:
            return
        now = time.perf_counter_ns()
        attrs["instant"] = True
        self.add_span(name, now, now, trace_id=trace_id, **attrs)

    def _make(self, name, trace_id, attrs) -> Span:
        # a bound request context stamps its tenant onto every span (the
        # raw tenant, not the guarded label: span attrs are not metric
        # labels — the _bridge routes through the guard before labeling)
        if "tenant" not in attrs:
            tenant = reqctx.current_tenant()
            if tenant is not None:
                attrs["tenant"] = tenant
        parent = self._current()
        if trace_id is None:
            trace_id = (
                parent.trace_id if parent is not None
                else f"t{next(self._trace_ids):08x}"
            )
        return Span(
            self, name, trace_id, next(self._ids),
            parent.span_id if parent is not None else None, attrs,
        )

    # -- nesting (thread-local stack) --------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _current(self) -> Optional[Span]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def current_trace_id(self) -> Optional[str]:
        """Trace id of the calling thread's active span (propagation)."""
        cur = self._current()
        return cur.trace_id if cur is not None else None

    def current_span_name(self) -> Optional[str]:
        """Name of the calling thread's active span (e.g. to tell a
        provisioning solve from a deprovisioning-simulation solve)."""
        cur = self._current()
        return cur.name if cur is not None else None

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:  # mispaired exit: drop it and everything above
            del stack[stack.index(span):]
        self._record(span)

    def _record(self, span: Span) -> None:
        with self._mu:
            self._spans.append(span)
            self._finished += 1
        try:
            _bridge(span)
        except Exception:  # noqa: BLE001 — metrics must never break a solve
            pass
        if self._spill_path is not None and span.name.startswith(self._spill_prefix):
            self._spill(span)

    # -- the killed child's span spill ---------------------------------------

    def set_spill(self, path: Optional[str],
                  prefixes: Tuple[str, ...] = ("solver.",)) -> None:
        """Arm (path) or disarm (None) the span spill: finished spans whose
        name starts with one of `prefixes` are mirrored to `path` as an
        export payload, rewritten atomically per span. The solver host's
        child arms it beside its heartbeat file, so the parent can graft
        the last phases of a dispatch that never answered (the child was
        killed mid-solve)."""
        with self._mu:
            self._spill_ring.clear()
            self._spill_prefix = tuple(prefixes)
            self._spill_path = path

    def reset_spill(self) -> None:
        """Clear the spill ring and file: the child calls it when a
        dispatch starts and once its answer is sent, so a later kill never
        salvages spans an earlier response already delivered."""
        with self._mu:
            self._spill_ring.clear()
            path = self._spill_path
        if path is not None:
            try:
                os.unlink(path)
            except OSError:
                pass

    def _spill(self, span: Span) -> None:
        try:
            from karpenter_core_tpu_torch.utils import supervise

            with self._mu:
                self._spill_ring.append(span)
                payload = export_spans(list(self._spill_ring))
                path = self._spill_path
            if path is not None:
                supervise.atomic_write_json(path, payload)
        except Exception:  # noqa: BLE001 — salvage is best-effort by design
            pass

    # -- reading -----------------------------------------------------------

    @property
    def dropped(self) -> int:
        """Spans evicted from the ring buffer (truncation accounting)."""
        with self._mu:
            return self._finished - len(self._spans)

    @property
    def graft_dropped(self) -> int:
        """Spans a child exported that were not grafted: the per-graft cap
        here plus the export cap on the child's side."""
        with self._mu:
            return self._graft_dropped

    @property
    def grafted(self) -> int:
        with self._mu:
            return self._grafted

    # -- the cross-process graft ----------------------------------------------

    def graft(self, payload: Optional[Dict[str, object]], *,
              pid: Optional[int] = None, generation: Optional[int] = None,
              trace_id: Optional[str] = None, **extra_attrs) -> int:
        """Fold a child process's exported span delta (an `export_spans`
        payload, off a solver host response or stats frame or a salvaged
        spill file) into this tracer's ring, under the calling thread's
        current span (`solver.host.request` on the dispatch path).

          * timestamps move onto this process's perf_counter clock through
            the payload's `now_ns` anchor (the skew is one pipe hop: fine
            for a timeline, never used for arithmetic);
          * the child's span and parent ids are remapped to fresh ids with
            its own nesting kept; a span whose parent is not in the payload
            goes under the current span;
          * every grafted span is tagged {pid, generation} (+extra_attrs)
            and joins the graft's trace id, so /debug/trace and the phase
            breakdowns see the child's solver.phase.* spans as part of the
            one solve;
          * at most MAX_GRAFT_SPANS per call land in the ring (itself
            bounded); refused and child-dropped spans count in
            `graft_dropped`;
          * grafted spans never reach the metrics bridge: the child
            observed its own instruments, which arrive through the metrics
            merge instead.

        Returns the number of spans grafted."""
        if not self.enabled or not payload:
            return 0
        entries = list(payload.get("spans") or ())
        child_dropped = int(payload.get("dropped", 0) or 0)
        refused = max(0, len(entries) - self.MAX_GRAFT_SPANS)
        if refused:
            # keep the newest spans: the tail names the phase closest to
            # the outcome (or the kill)
            entries = entries[-self.MAX_GRAFT_SPANS:]
        parent = self._current()
        if trace_id is None:
            trace_id = (parent.trace_id if parent is not None
                        else f"t{next(self._trace_ids):08x}")
        now_ns = payload.get("now_ns")
        offset = (time.perf_counter_ns() - int(now_ns)
                  if isinstance(now_ns, (int, float)) and now_ns else 0)
        if pid is None:
            p = payload.get("pid")
            pid = int(p) if isinstance(p, (int, float)) else None
        id_map: Dict[int, int] = {}
        for entry in entries:
            old = entry.get("i")
            if isinstance(old, int):
                id_map[old] = next(self._ids)
        grafted: List[Span] = []
        for entry in entries:
            try:
                attrs = dict(entry.get("a") or {})
                if pid is not None:
                    attrs["pid"] = pid
                if generation is not None:
                    attrs["generation"] = generation
                attrs.update(extra_attrs)
                old_parent = entry.get("p")
                span = Span(
                    self, str(entry["n"]), trace_id,
                    id_map.get(entry.get("i"), next(self._ids)),
                    id_map.get(old_parent) if old_parent in id_map
                    else (parent.span_id if parent is not None else None),
                    attrs,
                )
                span.tid = int(entry.get("d", 0) or 0)
                span.start_ns = int(entry["s"]) + offset
                span.end_ns = int(entry["e"]) + offset
                grafted.append(span)
            except (KeyError, TypeError, ValueError):
                refused += 1
        with self._mu:
            for span in grafted:
                self._spans.append(span)
                self._finished += 1
            self._grafted += len(grafted)
            self._graft_dropped += refused + child_dropped
        return len(grafted)

    def mark(self) -> int:
        """Sequence checkpoint; pass to spans_since()/phase_ms_since()."""
        with self._mu:
            return self._finished

    def spans(self) -> List[Span]:
        with self._mu:
            return list(self._spans)

    def spans_since(self, seq: int) -> List[Span]:
        """Spans recorded after mark() returned `seq` (ring-aware: spans
        evicted since the mark are simply gone from the result)."""
        with self._mu:
            newer = self._finished - seq
            if newer <= 0:
                return []
            return list(self._spans)[-min(newer, len(self._spans)):]

    def phase_ms_since(self, seq: int, prefix: str = _PHASE_PREFIX,
                       last_only: bool = False) -> Dict[str, float]:
        """Per-phase milliseconds for solver.phase.* spans recorded after
        `seq`. Default sums every occurrence (all relaxation rounds);
        last_only=True keeps only the final occurrence per phase, as the
        solver's last_phase_ms does."""
        out: Dict[str, float] = {}
        for span in self.spans_since(seq):
            if span.name.startswith(prefix):
                key = span.name[len(prefix):]
                prev = 0.0 if last_only else out.get(key, 0.0)
                out[key] = round(prev + span.duration_ms, 1)
        return out

    # -- export ------------------------------------------------------------

    def chrome_trace(self) -> Dict[str, object]:
        """Chrome trace-event JSON (dict): complete ('X') events with
        microsecond ts/dur, loadable in Perfetto and chrome://tracing.
        Grafted child-process spans render under their own pid (a process
        track of its own, named by a metadata event), instant events (a
        kill, a respawn, a breaker transition) as 'i' markers: the solve's
        timeline across processes."""
        events = []
        proc_names: Dict[int, str] = {self._pid: f"operator pid {self._pid}"}
        for span in self.spans():
            args = {"trace_id": span.trace_id, "span_id": span.span_id}
            if span.parent_id is not None:
                args["parent_id"] = span.parent_id
            for k, v in span.attrs.items():
                args[k] = v if isinstance(v, (int, float, bool)) else str(v)
            pid = span.attrs.get("pid")
            pid = pid if isinstance(pid, int) else self._pid
            if pid not in proc_names:
                gen = span.attrs.get("generation")
                proc_names[pid] = (f"solver-host gen {gen} pid {pid}"
                                   if isinstance(gen, int) else f"pid {pid}")
            event = {
                "name": span.name,
                "cat": "karpenter",
                "ph": "X",
                "ts": (span.start_ns - self._t0_ns) / 1e3,
                "pid": pid,
                "tid": span.tid % 2**31,  # chrome wants a small int
                "args": args,
            }
            if span.attrs.get("instant") and span.start_ns == span.end_ns:
                event["ph"] = "i"
                event["s"] = "p"  # process-scoped marker line
            else:
                event["dur"] = max(span.end_ns - span.start_ns, 0) / 1e3
            events.append(event)
        for pid, label in sorted(proc_names.items()):
            events.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                           "args": {"name": label}})
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": self.dropped, "grafted_spans": self.grafted,
                          "graft_dropped": self.graft_dropped},
        }

    def summary(self) -> str:
        """A text table per span name: count, total, mean and max ms."""
        agg: Dict[str, List[float]] = {}
        for span in self.spans():
            agg.setdefault(span.name, []).append(span.duration_ms)
        lines = [f"{'span':<40} {'count':>6} {'total_ms':>10} {'mean_ms':>9} {'max_ms':>9}"]
        for name in sorted(agg):
            ds = agg[name]
            lines.append(f"{name:<40} {len(ds):>6} {sum(ds):>10.1f} "
                         f"{sum(ds) / len(ds):>9.1f} {max(ds):>9.1f}")
        if self.dropped:
            lines.append(f"(dropped {self.dropped} spans: ring buffer full)")
        return "\n".join(lines)

    def export_chrome_trace(self, path: str) -> str:
        # write-temp + atomic rename: a Perfetto/chrome tab polling the
        # trace file mid-export must never load a JSON prefix
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(), f)
        os.replace(tmp, path)
        return path


# export caps: a span delta serialized for another process is bounded in
# both count and bytes, with the overflow counted in the payload's `dropped`
MAX_EXPORT_SPANS = 256
MAX_EXPORT_BYTES = 131072


def _json_safe(value):
    return value if isinstance(value, (int, float, bool, str)) else str(value)


def export_spans(spans: List[Span], max_spans: int = MAX_EXPORT_SPANS,
                 max_bytes: int = MAX_EXPORT_BYTES) -> Dict[str, object]:
    """Serialize finished spans into the reference's cross-process payload:

        {"pid": …, "now_ns": perf_counter_ns at export (the receiver's
         clock-rebase anchor), "spans": [{n,i,p,t,s,e,d,a}, …],
         "dropped": count NOT exported (count/byte cap overflow)}

    Newest spans win under the caps — the tail names the phases closest
    to the outcome. The payload is pure JSON (it rides the solver host's
    frame header and the salvage spill file)."""
    window = spans[-max_spans:] if max_spans else []
    kept_rev: List[Dict[str, object]] = []
    size = 0
    dropped = len(spans) - len(window)
    for span in reversed(window):
        entry = {
            "n": span.name,
            "i": span.span_id,
            "t": span.trace_id,
            "s": span.start_ns,
            "e": span.end_ns,
            "d": span.tid,
        }
        if span.parent_id is not None:
            entry["p"] = span.parent_id
        if span.attrs:
            entry["a"] = {k: _json_safe(v) for k, v in span.attrs.items()}
        # cheap size proxy: the serialized entry's length
        entry_size = len(json.dumps(entry, separators=(",", ":")))
        if size + entry_size > max_bytes:
            # everything older than the first overflow drops too (newest
            # spans win; counting them keeps truncation visible)
            dropped += len(window) - len(kept_rev)
            break
        size += entry_size
        kept_rev.append(entry)
    entries = list(reversed(kept_rev))
    return {
        "pid": os.getpid(),
        "now_ns": time.perf_counter_ns(),
        "spans": entries,
        "dropped": dropped,
    }


# the process-wide tracer
TRACER = Tracer()

from karpenter_core_tpu_torch.obs import envflags  # noqa: E402
from karpenter_core_tpu_torch.obs.envflags import FALSY as _FALSY, TRUTHY as _TRUTHY  # noqa: E402


def enable_tracing_from_env(default_on: bool = False) -> bool:
    """Arm/disarm TRACER from KARPENTER_TPU_TRACE — the ONE parser of that
    variable, shared by the import-time hook (default off) and the
    entry points (default on), so truthy spellings like 'true'/'on' behave
    identically everywhere. Returns the resulting enabled state."""
    raw = envflags.raw("KARPENTER_TPU_TRACE").strip().lower()
    if raw in _FALSY:
        TRACER.disable()
    elif default_on or raw in _TRUTHY:
        TRACER.enable()
    return TRACER.enabled


# KARPENTER_TPU_TRACE set truthy arms tracing at import, so any entrypoint
# (the smoke, tests, one-off scripts) opts in uniformly
enable_tracing_from_env(default_on=False)


def profile_dir() -> str:
    """The device-profiling output directory, "" when profiling is off.
    The ONE place the KARPENTER_TPU_PROFILE variable is interpreted."""
    return envflags.raw("KARPENTER_TPU_PROFILE")


class _TorchProfile:
    """One torch.profiler capture (CPU and CUDA activities) exported as a
    Chrome trace into `trace_dir` on exit."""

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self.path: Optional[str] = None
        self._prof = None

    def __enter__(self):
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(self.trace_dir, exist_ok=True)
        # profiling was asked for: a profiler that cannot start raises
        # here, so a trace that never covered the card cannot pass for one
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._prof.__exit__(exc_type, exc, tb)
        self.path = os.path.join(
            self.trace_dir,
            f"solve-{os.getpid()}-{time.perf_counter_ns()}.pt.trace.json",
        )
        self._prof.export_chrome_trace(self.path)
        return False


def device_profiler():
    """Context manager wrapping a device solve in torch.profiler when
    profile_dir() names a directory (a Chrome trace per solve, written
    there); a no-op otherwise. Unlike the reference's jax.profiler hook,
    a profiler that cannot start raises: profiling is opt-in, and a quiet
    no-op would hide that the card was never traced."""
    trace_dir = profile_dir()
    if trace_dir:
        return _TorchProfile(trace_dir)
    return nullcontext()
