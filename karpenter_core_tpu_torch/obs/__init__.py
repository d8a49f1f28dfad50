"""Observability of the port: end-to-end solve-path tracing, structured
logging, and the solve flight recorder.

The hot path (provisioner reconcile -> batcher window -> TorchSolver
phases -> launch -> bind decision) is instrumented with the process-wide
TRACER from obs.tracer; log lines join spans through obs.log's trace-id
correlation, and obs.flightrec captures replayable per-solve input and
outcome records in the reference package's format. Import the singletons
from here:

    from karpenter_core_tpu_torch.obs import TRACER, FLIGHTREC, get_logger
"""
from karpenter_core_tpu_torch.obs.flightrec import (
    FLIGHTREC,
    FlightRecorder,
    enable_flightrec_from_env,
)
from karpenter_core_tpu_torch.obs.log import (
    SINK as LOG_SINK,
    bound as log_bound,
    configure_logging_from_env,
    get_logger,
)
from karpenter_core_tpu_torch.obs.reqctx import (
    TENANTS,
    TENANT_HEADER,
    RequestContext,
    TenantGuard,
    bind as bind_request,
    current as current_request,
    current_tenant,
    tenant_labels,
)
from karpenter_core_tpu_torch.obs.tracer import (
    TRACER,
    TRACE_HEADER,
    Span,
    Tracer,
    device_profiler,
    enable_tracing_from_env,
    export_spans,
    profile_dir,
)

__all__ = [
    "TRACER", "TRACE_HEADER", "Span", "Tracer", "device_profiler",
    "enable_tracing_from_env", "export_spans", "profile_dir",
    "LOG_SINK", "log_bound", "configure_logging_from_env", "get_logger",
    "FLIGHTREC", "FlightRecorder", "enable_flightrec_from_env",
    "TENANTS", "TENANT_HEADER", "RequestContext", "TenantGuard",
    "bind_request", "current_request", "current_tenant", "tenant_labels",
]
