"""The process entry: `python -m karpenter_core_tpu_torch.operator`.

A vendor embeds the control plane by building a CloudProvider and a kube
client (any object with the InMemoryKubeClient surface) and calling run();
run with no arguments, the module wires the fake provider and an
in-memory client, a self-contained control plane for smoke tests and
chart checks (operator.go:68 assembles the reference binary the same way).

It reads the flags of operator/options.py, each with its environment
fallback (flags > environment > defaults), and these variables:

  KARPENTER_LOG_LEVEL            stdlib logging level (default INFO)
  KARPENTER_LOGGING_CONFIG       a logging dictConfig as JSON (wins)
  KARPENTER_BATCH_IDLE_SECONDS   the batcher's idle window (default 1)
  KARPENTER_BATCH_MAX_SECONDS    the batcher's max window (default 10)
  KARPENTER_METRICS_PORT         /metrics, /healthz, /readyz and /debug/*
                                 (default 8000)
  KARPENTER_PREWARM              the startup prewarm (default on)
  KARPENTER_PREWARM_TIERS        the ladder's tiers to prewarm (S,M,...)
  KARPENTER_TPU_TRACE, KARPENTER_TPU_FLIGHTREC   on by default here
  KARPENTER_SOLVER_ENDPOINT      a solver service's address (as
                                 --solver-endpoint): the primary is a
                                 RemoteSolver
  KARPENTER_SOLVER_HOST          the solver host (default on here; off
                                 solves in this process)
  KARPENTER_SLO_BROWNOUT         arms the admission gate's SLO loop
  KARPENTER_CHAOS                a fault-injection spec (chaos/): armed at
                                 import and by run(); unset in production
  KARPENTER_CHAOS_SEED           the spec's default per-point seed
  KARPENTER_SOLVER_MODE          auto (default), single or sharded: see
                                 below
  KARPENTER_MESH_TP              the device grid's tp (solver/factory.py)
  KARPENTER_MESH_LOGICAL_DEVICES a test and smoke hook: N logical devices
                                 on one card (or the CPU); unset in
                                 production

The karpenter-global-settings ConfigMap, when the client holds one,
overrides the flags' settings (settings.go:53-68).

The primary is the reference entry's: a RemoteSolver for a solver
endpoint, else the solver host (solver/host.py), whose supervised child
process solves on the CUDA card, a wedge killing and respawning it;
KARPENTER_SOLVER_HOST=off restores the in-process TorchSolver. Either way
ResilientSolver wraps it with the greedy fallback. The card is required
(run() raises without one) unless the caller passes device="cpu" (the
tests), the port's counterpart of the reference's JAX_PLATFORMS.
KARPENTER_SOLVER_MODE picks the solve path as solver/factory.build_solver
does: auto (the default) solves over a grid of the visible devices when
there are two or more (parallel/sharded.ShardedSolver, in the solver
host's child or in process), single on one device, and sharded fails the
start with one device.
"""
from __future__ import annotations

import json
import signal
import threading
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from karpenter_core_tpu_torch import chaos
from karpenter_core_tpu_torch.api.settings import Settings
from karpenter_core_tpu_torch.metrics.registry import REGISTRY
from karpenter_core_tpu_torch.obs import envflags
from karpenter_core_tpu_torch.obs.log import get_logger
from karpenter_core_tpu_torch.operator import new_operator
from karpenter_core_tpu_torch.webhooks import SETTINGS_CONFIG_MAP_NAME

LOG = get_logger("karpenter.operator")

def solver_from_env():
    """KARPENTER_SOLVER_ENDPOINT -> a RemoteSolver, else None."""
    endpoint = envflags.raw("KARPENTER_SOLVER_ENDPOINT")
    if not endpoint:
        return None
    from karpenter_core_tpu_torch.solver.service import RemoteSolver

    return RemoteSolver(endpoint)


def settings_from_env() -> Settings:
    return Settings(
        batch_idle_duration=float(envflags.raw("KARPENTER_BATCH_IDLE_SECONDS", "1")),
        batch_max_duration=float(envflags.raw("KARPENTER_BATCH_MAX_SECONDS", "10")),
    )


def resolve_settings(kube_client, options=None) -> Settings:
    """The karpenter-global-settings ConfigMap wins over the flags and the
    environment (injection.go:116-127 bootstraps the settings from it)."""
    if kube_client is not None:
        for cm in kube_client.list("ConfigMap"):
            if cm.metadata.name == SETTINGS_CONFIG_MAP_NAME:
                return Settings.from_config_map(cm.data)
    if options is not None:
        return Settings(batch_idle_duration=options.batch_idle_seconds,
                        batch_max_duration=options.batch_max_seconds)
    return settings_from_env()


class _ControllerContextFilter:
    """Stamps every stdlib record with the controller name the context
    carries (operator/injection.py), as the reference's
    logger.WithValues(controller) lines are."""

    def filter(self, record):
        from karpenter_core_tpu_torch.operator.injection import controller_name

        record.controller = controller_name() or "-"
        return True


def configure_logging() -> None:
    """Arm the structured log (obs/log) from KARPENTER_TPU_LOG, at info by
    default in the control plane, and the stdlib path for libraries:
    KARPENTER_LOGGING_CONFIG (a dictConfig JSON, the config-logging
    ConfigMap's counterpart, operator.go:95-100) wins, else basicConfig at
    KARPENTER_LOG_LEVEL. Either way stdlib records carry the controller
    name."""
    import logging
    import logging.config

    from karpenter_core_tpu_torch.obs.log import configure_logging_from_env

    configure_logging_from_env(default_level="info")
    raw = envflags.raw("KARPENTER_LOGGING_CONFIG")
    configured = False
    if raw:
        try:
            logging.config.dictConfig(json.loads(raw))
            configured = True
        except (ValueError, TypeError, AttributeError, ImportError) as exc:
            LOG.warning("invalid KARPENTER_LOGGING_CONFIG, using basicConfig",
                        error_detail=str(exc))
    if not configured:
        level = envflags.raw("KARPENTER_LOG_LEVEL", "INFO").upper()
        logging.basicConfig(
            level=getattr(logging, level, logging.INFO),
            format="%(asctime)s %(levelname)s %(name)s [%(controller)s] %(message)s",
        )
    for handler in logging.getLogger().handlers:
        if not any(isinstance(f, _ControllerContextFilter) for f in handler.filters):
            handler.addFilter(_ControllerContextFilter())


def build_slo_engine(admission=None):
    """The operator's SLOs (obs/slo): admission-to-bind and solve-duration
    objectives, as multi-window burn rates per tenant, exposed on every
    scrape as karpenter_slo_error_budget_remaining{slo[,tenant]}. With the
    solver host's admission gate, a third ratio objective reads the gate's
    own dispatched and shed accounting (AdmissionGate.admission_totals):
    the burn the brownout ladder acts on, so a tenant flooding the gate
    burns its budget even when its requests never reach a histogram."""
    from karpenter_core_tpu_torch.controllers.provisioning.provisioner import (
        ADMISSION_TO_BIND,
    )
    from karpenter_core_tpu_torch.obs.slo import Objective, SloEngine
    from karpenter_core_tpu_torch.obs.tracer import SOLVER_SOLVE_DURATION

    objectives = [
        Objective(name="admission-to-bind", histogram=ADMISSION_TO_BIND,
                  threshold_s=30.0, target=0.99,
                  description="99% of pods get a capacity decision within 30s "
                              "of admission"),
        Objective(name="solve-duration", histogram=SOLVER_SOLVE_DURATION,
                  threshold_s=30.0, target=0.99,
                  base_labels={"context": "provisioning"},
                  description="99% of provisioning solves finish inside the 30s "
                              "dispatch deadline"),
    ]
    if admission is not None:
        objectives.append(Objective(
            name="gate-admission", histogram=None, threshold_s=0.0, target=0.95,
            collect=admission.admission_totals,
            description="95% of admission-gate entries dispatch (capacity sheds and "
                        "in-queue deadline expiries burn; ladder brownout sheds are "
                        "excluded so a demoted tenant can drain its burn and "
                        "re-promote)"))
    return SloEngine(objectives)


# every endpoint the health server answers: (path, profiling-gated, what).
# /debug/ lists them; the handler below serves exactly these.
DEBUG_ENDPOINTS = (
    ("/metrics", False, "Prometheus exposition (openmetrics negotiable)"),
    ("/healthz", False, "liveness probe"),
    ("/readyz", False, "readiness probe"),
    ("/debug/health", False, "solver health: breaker, wedges, abandoned threads"),
    ("/debug/slo", True, "SLO burn rates + error budgets, per tenant"),
    ("/debug/tenants", True, "per-tenant latency/shed/device/program digest"),
    ("/debug/trace", True, "Chrome trace-event JSON of the solve-path ring"),
    ("/debug/trace/summary", True, "human span summary"),
    ("/debug/timeline", True, "cross-process solve timeline + flight-record index"),
    ("/debug/logs", True, "structured-log ring (logfmt)"),
    ("/debug/logs.json", True, "structured-log ring (JSON)"),
    ("/debug/solves", True, "solve flight-record ring (replayable)"),
    ("/debug/consolidations", True, "consolidation decision ring"),
    ("/debug/events", True, "events recorder ring"),
    ("/debug/threads", True, "all thread stacks (goroutine-dump analog)"),
    ("/debug/backend", True, "torch, the card and the built CUDA kernels"),
    ("/debug/programs", True, "device-path program inventory, all processes"),
    ("/debug/config", True, "context-injected options + settings"),
)


def _debug_index(profiling: bool) -> dict:
    """The /debug/ page: every endpoint served, whether it is live in this
    process (a gated one answers 404 without profiling), what it serves."""
    return {
        "profiling_enabled": profiling,
        "endpoints": [
            {"path": path, "profiling_gated": gated, "enabled": profiling or not gated,
             "description": desc}
            for path, gated, desc in DEBUG_ENDPOINTS
        ],
    }


def _tenants_digest(slo=None) -> dict:
    """The /debug/tenants payload: who burned the budget. Per tenant: the
    latency percentiles, the shed and fallback breakdowns, the device
    time, the admission gate's depth and deadline expiries, the ladder's
    demotions, the warm-up misses and their seconds (utils/compilecache)
    and the flight-record index, read off the live series the tenant
    labels mark (this process's; the solver host's child series arrive
    merged in /metrics)."""
    from karpenter_core_tpu_torch.controllers.provisioning.provisioner import (
        ADMISSION_TO_BIND,
    )
    from karpenter_core_tpu_torch.obs.flightrec import FLIGHTREC
    from karpenter_core_tpu_torch.obs.reqctx import TENANTS
    from karpenter_core_tpu_torch.obs.tracer import SOLVER_PHASE_DURATION, SOLVER_SOLVE_DURATION
    from karpenter_core_tpu_torch.solver.fallback import SOLVER_FALLBACK_TOTAL
    from karpenter_core_tpu_torch.solver.host import (
        DEADLINE_VIOLATIONS_TOTAL,
        GATE_DEMOTIONS_TOTAL,
        SOLVER_QUEUE_DEPTH,
        SOLVER_QUEUE_WAIT,
        SOLVER_SHED_TOTAL,
    )
    from karpenter_core_tpu_torch.utils.compilecache import CACHE_MISSES, COMPILE_SECONDS

    tenants: dict = {}

    def entry(tenant: str) -> dict:
        return tenants.setdefault(tenant, {
            "admission_to_bind_s": {}, "solve_duration_s": {}, "queue_wait_s": {},
            "shed": {}, "fallback": {}, "device_ms": 0.0, "compile_misses": 0,
            "compile_seconds": 0.0, "gate_depth": {}, "expired_in_queue": 0,
            "demotions": {}, "flight_records": [],
        })

    def percentiles(hist, labels, data):
        return {"count": int(data["count"]), "p50": hist.percentile(0.50, labels),
                "p99": hist.percentile(0.99, labels)}

    for field, hist in (("admission_to_bind_s", ADMISSION_TO_BIND),
                        ("solve_duration_s", SOLVER_SOLVE_DURATION),
                        ("queue_wait_s", SOLVER_QUEUE_WAIT)):
        for labels, data in hist.series():
            t = labels.get("tenant")
            if t is not None:
                entry(t)[field] = percentiles(hist, labels, data)
    for field, counter in (("shed", SOLVER_SHED_TOTAL), ("fallback", SOLVER_FALLBACK_TOTAL),
                           ("demotions", GATE_DEMOTIONS_TOTAL)):
        for labels, value in counter.series():
            t = labels.get("tenant")
            if t is not None:
                by = entry(t)[field]
                reason = labels.get("reason", "")
                by[reason] = by.get(reason, 0) + int(value)
    for labels, value in DEADLINE_VIOLATIONS_TOTAL.series():
        t = labels.get("tenant")
        # stage=queue: expired while waiting and shed, billed to the tenant
        if t is not None and labels.get("stage") == "queue":
            entry(t)["expired_in_queue"] += int(value)
    for labels, data in SOLVER_PHASE_DURATION.series():
        t = labels.get("tenant")
        if t is not None and labels.get("phase") == "device":
            entry(t)["device_ms"] += round(float(data["sum"]) * 1e3, 1)
    for labels, value in CACHE_MISSES.series():
        t = labels.get("tenant")
        if t is not None:
            entry(t)["compile_misses"] += int(value)
    for labels, data in COMPILE_SECONDS.series():
        t = labels.get("tenant")
        if t is not None:
            entry(t)["compile_seconds"] += round(float(data["sum"]), 3)
    for labels, value in list(SOLVER_QUEUE_DEPTH.values.items()):
        d = dict(labels)
        t = d.get("tenant")
        if t is not None:
            entry(t)["gate_depth"][d.get("gate", "")] = value
    for tenant, records in FLIGHTREC.tenant_index().items():
        if tenant:
            entry(tenant)["flight_records"] = records
    digest = {"guard": TENANTS.stats(), "tenants": tenants}
    if slo is not None:
        digest["budget_exhausted"] = sorted(t for t in tenants if slo.budget_exhausted(t))
    return digest


def _debug_threads() -> str:
    """Every thread's stack (operator/profiling.go:25's goroutine dump)."""
    import sys
    import traceback

    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out) + "\n"


def _debug_backend() -> str:
    """torch's version, the card's name and compute capability, and the
    CUDA kernels' build directory and the libraries built and loaded."""
    try:
        import torch

        from karpenter_core_tpu_torch.ops import cuda_build

        info = {"torch": torch.__version__, "cuda": torch.version.cuda,
                "cuda_available": torch.cuda.is_available(),
                "build_dir": cuda_build.BUILD_DIR,
                "build_seconds": dict(cuda_build.BUILD_SECONDS),
                "loaded": cuda_build.loaded_names()}
        if info["cuda_available"]:
            info.update(device_name=torch.cuda.get_device_name(0),
                        compute_capability=".".join(
                            map(str, torch.cuda.get_device_capability(0))),
                        device_count=torch.cuda.device_count())
    except Exception as exc:  # report, do not fail the handler
        info = {"error": f"{type(exc).__name__}: {exc}"}
    return json.dumps(info) + "\n"


class _HealthHandler(BaseHTTPRequestHandler):
    operator = None  # set by serve_health
    solver = None  # the ResilientSolver, when the wiring passes it
    slo = None  # the SloEngine, when the wiring passes it
    profiling_enabled = False

    def _body(self):
        """(body, content type) of self.path, or None for a 404."""
        path = self.path
        if path == "/metrics":
            # exemplars are legal only under the negotiated OpenMetrics
            # type: the 0.0.4 parser reads the suffix as a bad timestamp
            if "application/openmetrics-text" in self.headers.get("Accept", ""):
                return (REGISTRY.expose(exemplars=True).encode() + b"\n# EOF\n",
                        "application/openmetrics-text; version=1.0.0; charset=utf-8")
            return REGISTRY.expose().encode() + b"\n", "text/plain; version=0.0.4"
        if path in ("/healthz", "/readyz"):
            return json.dumps({"status": "ok"}).encode(), "application/json"
        if path == "/debug/health":
            # not gated: the first thing an operator reads when provisioning
            # degrades
            solver = self.solver
            report = solver.health_report() if hasattr(solver, "health_report") else None
            status = "degraded" if report is not None and report.get("healthy") is False \
                else "ok"
            return (json.dumps({"status": status, "solver": report}, sort_keys=True).encode()
                    + b"\n", "application/json")
        if path in ("/debug", "/debug/"):
            return (json.dumps(_debug_index(self.profiling_enabled), sort_keys=True).encode()
                    + b"\n", "application/json")
        if not self.profiling_enabled:
            return None
        if path == "/debug/slo":
            payload = self.slo.digest() if self.slo is not None else {
                "error": "slo engine not wired"}
            return json.dumps(payload, sort_keys=True).encode() + b"\n", "application/json"
        if path == "/debug/tenants":
            return (json.dumps(_tenants_digest(self.slo), sort_keys=True).encode() + b"\n",
                    "application/json")
        if path == "/debug/timeline":
            # the trace with the solver host's grafted spans on their own
            # process track, and the trace id -> flight-record digest index
            from karpenter_core_tpu_torch.obs import TRACER
            from karpenter_core_tpu_torch.obs.flightrec import FLIGHTREC

            timeline = TRACER.chrome_trace()
            timeline["otherData"]["flight_records"] = {
                r["trace_id"]: r.get("digest", "")
                for r in FLIGHTREC.records() if r.get("trace_id")
            }
            return json.dumps(timeline).encode(), "application/json"
        if path == "/debug/programs":
            from karpenter_core_tpu_torch.obs import proghealth

            return (json.dumps(proghealth.full_snapshot(), sort_keys=True).encode(),
                    "application/json")
        if path == "/debug/trace":
            from karpenter_core_tpu_torch.obs import TRACER

            return json.dumps(TRACER.chrome_trace()).encode(), "application/json"
        if path == "/debug/trace/summary":
            from karpenter_core_tpu_torch.obs import TRACER

            return TRACER.summary().encode() + b"\n", "text/plain"
        if path == "/debug/logs":
            from karpenter_core_tpu_torch.obs.log import SINK

            return SINK.lines().encode(), "text/plain"
        if path == "/debug/logs.json":
            from karpenter_core_tpu_torch.obs.log import SINK, format_json

            return ("[" + ",".join(format_json(r) for r in SINK.records()) + "]").encode(), \
                "application/json"
        if path == "/debug/solves":
            from karpenter_core_tpu_torch.obs.flightrec import FLIGHTREC

            return FLIGHTREC.to_json().encode(), "application/json"
        if path == "/debug/consolidations":
            from karpenter_core_tpu_torch.obs.flightrec import FLIGHTREC

            return FLIGHTREC.consolidations_json().encode(), "application/json"
        if path == "/debug/events":
            recorder = getattr(self.operator, "recorder", None)
            return json.dumps(recorder.export() if recorder is not None else []).encode(), \
                "application/json"
        if path == "/debug/threads":
            return _debug_threads().encode(), "text/plain"
        if path == "/debug/backend":
            return _debug_backend().encode(), "application/json"
        if path == "/debug/config":
            from dataclasses import asdict, is_dataclass

            from karpenter_core_tpu_torch.operator import injection

            opts, settings = injection.get_options(), injection.get_settings()
            return json.dumps({
                "options": asdict(opts) if is_dataclass(opts) else repr(opts),
                "settings": asdict(settings) if is_dataclass(settings) else repr(settings),
            }).encode(), "application/json"
        return None

    def do_GET(self):  # noqa: N802 (http.server API)
        answer = self._body()
        if answer is None:
            self.send_response(404)
            self.end_headers()
            return
        body, ctype = answer
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # no probe spam
        pass


def serve_health(operator, port: int, profiling: bool = False, solver=None,
                 slo=None) -> ThreadingHTTPServer:
    """The health, metrics and debug server on a daemon thread; `port` 0
    binds an ephemeral port (server.server_address[1]). The /debug
    endpoints but the index and /debug/health need `profiling`
    (--enable-profiling, operator.go:124-126)."""
    _HealthHandler.operator = operator
    _HealthHandler.solver = solver
    _HealthHandler.slo = slo
    _HealthHandler.profiling_enabled = profiling
    server = ThreadingHTTPServer(("0.0.0.0", port), _HealthHandler)
    server.thread = threading.Thread(target=server.serve_forever, daemon=True,
                                     name="health-metrics-http")
    server.thread.start()
    return server


@dataclass
class Process:
    """What run() wired, handed to its `on_start` callback."""

    operator: object
    solver: object  # the ResilientSolver the operator solves through
    primary: object  # inside it: the HostSolver, a RemoteSolver or a TorchSolver
    settings: Settings
    health: ThreadingHTTPServer
    elector: object = None
    webhook: object = None
    prewarm: Optional[threading.Thread] = None
    # the names of the operator's threads still alive after the stop
    # (empty when all joined)
    alive: Optional[List[str]] = None

    @property
    def health_port(self) -> int:
        return self.health.server_address[1]


def _check_device(device: Optional[str]) -> str:
    import torch

    device = device or "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("karpenter_core_tpu_torch.operator: no CUDA card is available; "
                           "the entry solves on the card (run(device='cpu') solves on the "
                           "CPU)")
    return device


def run(cloud_provider, kube_client=None, stop_event=None, options=None,
        device: Optional[str] = None, on_start: Optional[Callable[[Process], None]] = None):
    """Assemble the control plane and run it until `stop_event` is set (or
    a signal arrives, on the main thread); returns the operator.

    With leader election (the default, operator.go:108-110) the controllers
    start only once the lease is held, and a lost lease stops the process.
    `device` is the solver's, the CUDA card by default (raises without
    one). `on_start`, when given, is called with the wired Process once the
    controllers run. On stop, the parts stop in the reverse order: the
    controllers, the webhook server, the lease, the prewarm, the primary
    (the solver host's child is killed), the health server."""
    from karpenter_core_tpu_torch.operator.options import parse_options
    from karpenter_core_tpu_torch.solver.factory import (
        build_primary,
        describe,
        host_mode_enabled,
    )

    # KARPENTER_CHAOS, armed when chaos was imported; a spec set since (an
    # embedding that sets it before run()) arms its points now, and a
    # malformed spec fails the start
    chaos.arm_from_env(keep_armed=True)
    # the embedded path resolves the environment through the same flags
    # (flags > environment > defaults)
    opts = options or parse_options([])
    device = _check_device(device)
    configure_logging()
    opts.apply_memory_limit()
    # tracing and the flight recorder are on in the control plane (a bad
    # placement can only be debugged from its captured inputs);
    # KARPENTER_TPU_TRACE / KARPENTER_TPU_FLIGHTREC = 0 turn them off
    from karpenter_core_tpu_torch.obs import enable_flightrec_from_env, enable_tracing_from_env

    enable_tracing_from_env(default_on=True)
    enable_flightrec_from_env(default_on=True)
    # the kernels' libraries outlive a restart (utils/compilecache): a
    # rebooted control plane loads them instead of running nvcc again
    from karpenter_core_tpu_torch.utils.compilecache import enable_persistent_cache

    enable_persistent_cache()
    if kube_client is None:
        from karpenter_core_tpu_torch.kube.client import InMemoryKubeClient

        kube_client = InMemoryKubeClient()
    if opts.solver_endpoint:
        from karpenter_core_tpu_torch.solver.service import RemoteSolver

        primary = RemoteSolver(opts.solver_endpoint)
    else:
        primary = solver_from_env()
    if primary is None:
        # the solver host is the default: the device dispatch runs in a
        # supervised child process a wedge gets killed in, so no hung
        # dispatch keeps the card or a lock of this process;
        # KARPENTER_SOLVER_HOST=off solves in this process
        primary = build_primary(host_default=True, device=device)
        LOG.info("solver host enabled" if host_mode_enabled(True) else "in-process solver",
                 solver=describe(primary))
    # the card's failure defense: the greedy path while the primary is down
    # or wedged, re-admission through the probe (solver/fallback.py). An
    # in-process primary's wedge is watched here (its phase marks feed the
    # heartbeat) and its card probed in a subprocess; an out-of-process one
    # (the host, a remote service) is asked health(), and its own watchdog
    # watches its dispatch
    from karpenter_core_tpu_torch.solver.fallback import ResilientSolver
    from karpenter_core_tpu_torch.solver.torch_solver import GreedySolver

    is_remote = callable(getattr(primary, "health", None))
    solver = ResilientSolver(primary, GreedySolver(), solve_timeout=900.0,
                             wedge_stale_after=None if is_remote else 600.0,
                             # an in-process primary on the CPU has no card
                             # to probe
                             prober=(lambda: None) if device == "cpu" and not is_remote
                             else None)
    settings = resolve_settings(kube_client, opts)
    from karpenter_core_tpu_torch.operator.injection import inject_defaults

    inject_defaults(options=opts, settings=settings)
    operator = new_operator(cloud_provider, kube_client=kube_client, settings=settings,
                            solver=solver, with_webhooks=not opts.disable_webhook)
    solver.recorder = operator.recorder
    # the wrapper is the fallback layer: the provisioner's own fallback
    # points at it, so the two do not stack
    operator.provisioning.fallback_solver = solver
    # the long-lived server's collector posture (utils/gctuning.py): the
    # wired baseline frozen out of the scans, gen-2 widened
    from karpenter_core_tpu_torch.utils.gctuning import apply_server_gc_tuning

    apply_server_gc_tuning()
    # the SLO plane, with a ratio objective over the admission gate of an
    # out-of-process primary
    gate = getattr(primary, "admission", None)
    slo_engine = build_slo_engine(admission=gate)
    REGISTRY.add_external(slo_engine)
    # the program inventory's families on every scrape (this process's
    # ledger and the solver host's merged one)
    from karpenter_core_tpu_torch.obs import proghealth

    proghealth.ensure_exposition_registered()
    # KARPENTER_SLO_BROWNOUT arms the closed SLO -> admission loop: in the
    # brownout band the gate sheds only tenants whose error budget is
    # spent, and the per-tenant ladder demotes a fast-burning tenant
    # device -> greedy -> shed while every other keeps the device path
    if envflags.get_bool("KARPENTER_SLO_BROWNOUT", False) and gate is not None:
        from karpenter_core_tpu_torch.solver.host import BrownoutLadder

        gate.brownout_prefer = slo_engine.budget_exhausted
        gate.ladder = BrownoutLadder(burn=slo_engine.fast_burn)
        LOG.info("slo brownout loop armed", gate=gate.name)
    health = serve_health(operator, opts.metrics_port, profiling=opts.enable_profiling,
                          solver=solver, slo=slo_engine)
    stop = stop_event or threading.Event()
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: stop.set())
    except ValueError:
        pass  # not the main thread (an embedding, a test)
    proc = Process(operator=operator, solver=solver, primary=primary, settings=settings,
                   health=health)
    started = False
    try:
        # the startup prewarm (solver/prewarm.py) on its own thread,
        # overlapped with the watch sync; KARPENTER_PREWARM=0 turns it off,
        # KARPENTER_PREWARM_TIERS=S,M picks the rungs
        if envflags.get_bool("KARPENTER_PREWARM", True):
            from karpenter_core_tpu_torch.solver.prewarm import start_prewarm_thread

            tier_env = envflags.raw("KARPENTER_PREWARM_TIERS")
            proc.prewarm = start_prewarm_thread(
                primary,
                provisioners_fn=lambda: kube_client.list("Provisioner"),
                instance_types_fn=lambda provs: {
                    p.name: cloud_provider.get_instance_types(p) for p in provs},
                settings=settings,
                tiers=[t.strip() for t in tier_env.split(",") if t.strip()]
                if tier_env else None,
                stop=stop,
            )
        if opts.enable_leader_election:
            from karpenter_core_tpu_torch.operator.leaderelection import LeaderElector

            proc.elector = LeaderElector(kube_client)
            if not proc.elector.acquire_blocking(stop):
                return operator  # stopped before it led
            proc.elector.start_renewing(stop)
        # HTTPS admission over the in-process admission (webhooks.go:17-63),
        # after the election so that only the leader rotates the shared
        # certificate; a failure to start leaves in-process admission only
        if not opts.disable_webhook and opts.webhook_port:
            from karpenter_core_tpu_torch.webhooks.server import WebhookServer

            proc.webhook = WebhookServer(operator.kube_client, host="0.0.0.0",
                                         port=opts.webhook_port)
            try:
                proc.webhook.start()
            except Exception as exc:  # a port conflict, an apiserver 4xx, no cryptography
                LOG.warning("webhook server disabled", error_detail=str(exc))
                proc.webhook = None
        operator.start()
        started = True
        LOG.info("controller running", metrics_port=proc.health_port)
        if on_start is not None:
            on_start(proc)
        stop.wait()
    finally:
        stop.set()
        if started:
            proc.alive = [t.name for t in operator.stop()]
            if not operator.recorder.close():
                proc.alive.append("event-poster")
        if proc.alive:
            # a loop still in its pass may yet write to the cluster or
            # solve: the lease is left to lapse and the primary open
            LOG.error("threads alive after the stop: the lease is not released",
                      threads=proc.alive)
        if proc.webhook is not None:
            proc.webhook.stop()
        if proc.elector is not None:
            proc.elector.join()
            if not proc.alive:
                proc.elector.release()
        if proc.prewarm is not None:
            proc.prewarm.join(timeout=600.0)
        # the solver host's child (its process group killed) or the
        # remote solver's channel
        close = getattr(primary, "close", None)
        if callable(close) and not proc.alive:
            close()
        REGISTRY.remove_external(slo_engine)
        health.shutdown()
        health.server_close()
        health.thread.join(timeout=5.0)
    return operator


def main(argv=None):
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_core_tpu_torch.operator.options import parse_options

    run(FakeCloudProvider(), options=parse_options(argv))


if __name__ == "__main__":
    main()
