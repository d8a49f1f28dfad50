"""The solver service: the device path behind a process boundary (the
reference's solver/service.py, with its wire format message for message).

Server: `SolverService` receives a solve's encoded tensors (device_args, by
name) and its static geometry, runs the device path on its device (the
card by default: `make_device_run`, the prescreen through ops/screen.py's
kernels, the resident verdict tensor, the batched replan of
solver/replan.py) and returns the commit log and the final slot state. It
calls the same dispatch functions TorchSolver does
(torch_solver.dispatch_prescreen / dispatch_solve / dispatch_replan), so a
wire solve and an in-process solve run one code path from device_args on.
Its entries are keyed by the wire geometry, the screen mode and the device
grid's key (None: the single device), LRU-bounded
(MAX_COMPILED 32 solve entries, MAX_REFRESH 16 refresh and MAX_REPLAN 16
replan entries), each a program of obs/proghealth's ledger. Every Solve and
Replan binds a ThreadHeartbeat its phase marks touch; Health reports
"wedged" when an in-flight dispatch's heartbeat went stale.

`SolverService(mesh=...)` (a parallel/specs.DeviceGrid, or True to detect
one with solver/factory.detect_mesh) serves every Solve whose batch clears
the routing floor (parallel/sharded.route_to_mesh) on the grid: the upload
is pre-split (SpecLayout.put_args), the precomputes run as the grid's
tiles and the scan on its lead device, byte-identical to the single
device's; those entries count at the "service_sharded" compile-cache site
and Health names the grid, "x4(dp=2,tp=2)". Replans run on the lead
device, as the reference's.

`serve()` puts it behind gRPC (with the AdmissionGate of solver/host.py in
front); `RemoteSolver` is the Solver-interface client: encode locally, ship
the tensors, decode locally, with deadlines, retries under a per-tenant
RetryBudget, retry-after hints and a circuit breaker. The solver host
(solver/host.py) runs the same service in a child process behind frames.

The messages are solver/codec.py's, byte for byte those of the generated
service_pb2, so that nothing but serve(), RemoteSolver and main() needs
`grpc` or `google.protobuf`; those three import them when called, and
raise ImportError naming the package when it is missing. The gRPC server
and channel take messages up to MAX_MESSAGE_BYTES: a full-width solve's
request and response pass gRPC's default 4 MiB limit (ROADMAP Queue C).
"""
from __future__ import annotations

import contextlib
import json
import re
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from karpenter_core_tpu_torch import chaos
from karpenter_core_tpu_torch.metrics.registry import NAMESPACE, REGISTRY
from karpenter_core_tpu_torch.obs import TRACE_HEADER, TRACER, envflags, proghealth, reqctx
from karpenter_core_tpu_torch.obs.log import get_logger
from karpenter_core_tpu_torch.solver import codec as pb
from karpenter_core_tpu_torch.solver.encode import EncodeReuse, encode_snapshot
from karpenter_core_tpu_torch.solver.torch_solver import (
    DEFAULT_MAX_RELAX_ROUNDS,
    RUN_ARG_NAMES as _ARG_NAMES,
    SolveResult,
    args_to_torch,
    decode_solve,
    device_args,
    dispatch_prescreen,
    dispatch_replan,
    dispatch_solve,
    fetch_log,
    fetch_replan,
    fetch_state,
    load_solve_libraries,
    make_device_run,
    solve_geometry,
    solve_with_relaxation,
)
from karpenter_core_tpu_torch.utils import supervise
from karpenter_core_tpu_torch.utils.compilecache import record_compile_seconds, record_lookup

LOG = get_logger("karpenter.solver.service")

SERVICE = "karpenter.solver.v1.Solver"

# the largest message the gRPC server and channel take (gRPC's default is
# 4 MiB, below a full-width solve's request and response)
MAX_MESSAGE_BYTES = 2**31 - 1

SOLVER_RPC_RETRIES = REGISTRY.counter(
    f"{NAMESPACE}_solver_rpc_retries_total",
    "Solver RPCs retried after a transient failure (UNAVAILABLE/"
    "DEADLINE_EXCEEDED)",
)
SOLVER_RETRY_BUDGET_EXHAUSTED = REGISTRY.counter(
    f"{NAMESPACE}_solver_retry_budget_exhausted_total",
    "Solver RPC retries DENIED by the per-tenant retry budget (token "
    "bucket): the original error is raised immediately instead of "
    "retried, so a shed tenant cannot convert rejection into a retry "
    "storm; by tenant when a request context is bound",
)


def _import_grpc():
    try:
        import grpc
    except ImportError as e:
        raise ImportError("the solver service's gRPC transport needs the `grpc` package "
                          "(grpcio); the solver host needs neither it nor protobuf") from e
    return grpc


def _import_pb2():
    try:
        from karpenter_core_tpu_torch.solver import service_pb2
    except ImportError as e:
        raise ImportError("the solver service's gRPC transport needs the `protobuf` "
                          "package (google.protobuf)") from e
    return service_pb2


# -- typed errors: what a client raises and ResilientSolver classifies ------


class SolverRpcError(RuntimeError):
    """A typed solver-service failure. `transient` drives the client's
    retry and its circuit breaker (the same request may succeed on a
    healthy channel); `marks_unhealthy` drives ResilientSolver (a request
    defect must not condemn a healthy backend); `retry_after_s` is the
    admission gate's load-shedding hint."""

    code_name = "UNKNOWN"
    transient = False
    marks_unhealthy = True
    retry_after_s: Optional[float] = None
    shed_reason: Optional[str] = None


class SolverUnavailableError(SolverRpcError):
    code_name = "UNAVAILABLE"
    transient = True


class SolverDeadlineExceededError(SolverRpcError):
    code_name = "DEADLINE_EXCEEDED"
    transient = True


class SolverInvalidArgumentError(SolverRpcError):
    code_name = "INVALID_ARGUMENT"
    marks_unhealthy = False


class SolverResourceExhaustedError(SolverRpcError):
    code_name = "RESOURCE_EXHAUSTED"
    marks_unhealthy = False


class SolverInternalError(SolverRpcError):
    code_name = "INTERNAL"


_ERROR_BY_CODE = {
    cls.code_name: cls
    for cls in (SolverUnavailableError, SolverDeadlineExceededError,
                SolverInvalidArgumentError, SolverResourceExhaustedError,
                SolverInternalError)
}


def classify_exception(e: Exception) -> Tuple[str, str]:
    """Server side: exception -> (gRPC status-code name, detail). Request
    defects (malformed geometry or tensors) are INVALID_ARGUMENT, memory
    exhaustion (the card's out-of-memory included) RESOURCE_EXHAUSTED,
    everything else (a failed kernel build or launch among them)
    INTERNAL."""
    msg = f"{type(e).__name__}: {e}"
    if isinstance(e, (ValueError, KeyError, TypeError, IndexError)):
        return "INVALID_ARGUMENT", msg
    if (isinstance(e, (MemoryError, torch.cuda.OutOfMemoryError))
            or "RESOURCE_EXHAUSTED" in str(e)):
        return "RESOURCE_EXHAUSTED", msg
    return "INTERNAL", msg


# metadata key of the server's retry-after hint on an admission shed
# (lowercase, as gRPC metadata keys must be); the detail carries the same
# hint as `retry_after_ms=N` for the error-field path
RETRY_AFTER_METADATA_KEY = "karpenter-retry-after-ms"


def _parse_retry_after(detail: str) -> Optional[float]:
    m = re.search(r"retry_after_ms=(\d+)", detail or "")
    return int(m.group(1)) / 1000.0 if m else None


def error_from_string(error: str) -> SolverRpcError:
    """Client side: the response's error field ('CODE: detail', written
    when the handler runs without a gRPC context: the solver host's child,
    a direct call) -> the typed error."""
    code = error.split(":", 1)[0].strip()
    err = _ERROR_BY_CODE.get(code, SolverInternalError)(error)
    err.retry_after_s = _parse_retry_after(error)
    return err


# -- tensors on the wire ------------------------------------------------------


def tensor_to_pb(name: str, array: np.ndarray) -> pb.Tensor:
    array = np.ascontiguousarray(array)
    return pb.Tensor(name=name, dtype=str(array.dtype), shape=list(array.shape),
                     data=array.tobytes())


def tensor_from_pb(t) -> np.ndarray:
    """A Tensor message (the codec's or service_pb2's) -> a read-only
    numpy view of its bytes."""
    return np.frombuffer(t.data, dtype=np.dtype(t.dtype)).reshape(tuple(t.shape))


def _flatten_args(args) -> List[Tuple[str, np.ndarray]]:
    """device_args tuple -> named tensors (dicts flattened with / paths),
    in RUN_ARG_NAMES order: the wire schema."""
    out = []

    def walk(prefix, value):
        if isinstance(value, dict):
            for k in sorted(value):
                walk(f"{prefix}/{k}", value[k])
        else:
            out.append((prefix, np.asarray(value)))

    for name, value in zip(_ARG_NAMES, args):
        walk(name, value)
    return out


def _unflatten_args(tensors: Dict[str, np.ndarray]):
    def gather(prefix):
        sub = {}
        plain = None
        for name, arr in tensors.items():
            if name == prefix:
                plain = arr
            elif name.startswith(prefix + "/"):
                sub[name[len(prefix) + 1:]] = arr
        return sub if sub else plain

    return tuple(gather(n) for n in _ARG_NAMES)


def geometry_json(snap) -> str:
    """The solve's static geometry as the wire carries it."""
    topo = None
    if snap.topo_meta is not None:
        topo = [
            {
                "gtype": g.gtype,
                "seg": list(g.seg),
                "key_k": g.key_k,
                "max_skew": g.max_skew,
                "is_hostname": g.is_hostname,
                "is_inverse": g.is_inverse,
                "filter_term_rows": list(g.filter_term_rows),
            }
            for g in snap.topo_meta.groups
        ]
    return json.dumps(
        {
            "segments": [list(snap.dictionary.segment(k)) for k in snap.dictionary.keys],
            "zone_seg": list(snap.zone_seg),
            "ct_seg": list(snap.ct_seg),
            "n_slots": snap.n_slots,
            "screen_v": snap.screen_v or snap.dictionary.V,
            # index 12 of solve_geometry is the commit log's length
            "log_len": solve_geometry(snap, 0)[12],
            "topo_groups": topo,
        }
    )


def solve_request(snap, provisioners) -> pb.SolveRequest:
    """The Solve request of one encoded snapshot."""
    args = device_args(snap, provisioners)
    return pb.SolveRequest(geometry=geometry_json(snap),
                           tensors=[tensor_to_pb(n, a) for n, a in _flatten_args(args)])


def replan_request(snap, provisioners, count_rows, exist_open, uninitialized=None,
                   want_slots: bool = False) -> pb.SolveRequest:
    """The Replan request: the union snapshot's tensors plus the [K, ...]
    subset planes, the uninitialized mask padded to the snapshot's
    existing axis (the service binds its width from exist_open's)."""
    request = solve_request(snap, provisioners)
    E = snap.exist_used.shape[0]
    uninit = np.zeros(E, dtype=bool)
    if uninitialized is not None:
        src = np.asarray(uninitialized, dtype=bool)
        uninit[: min(len(src), E)] = src[:E]
    request.tensors += [
        tensor_to_pb("replan/count_rows", np.asarray(count_rows, dtype=np.int32)),
        tensor_to_pb("replan/exist_open", np.asarray(exist_open)),
        tensor_to_pb("replan/uninitialized", np.asarray(uninit)),
        tensor_to_pb("replan/want_slots", np.asarray([1 if want_slots else 0], dtype=np.int32)),
    ]
    return request


class _StateView:
    """Attribute access over the returned state tensors."""

    def __init__(self, tensors: Dict[str, np.ndarray]):
        self._tensors = tensors

    def __getattr__(self, name):
        try:
            return self._tensors[name]
        except KeyError:
            raise AttributeError(name)


def decode_response(snap, response) -> SolveResult:
    """A Solve response -> the SolveResult of `snap` (raises the typed
    error the response carries)."""
    if response.error:
        raise error_from_string(response.error)
    tensors = {t.name: tensor_from_pb(t) for t in response.tensors}
    log = {k[len("log/"):]: v for k, v in tensors.items() if k.startswith("log/")}
    state = _StateView({k[len("state/"):]: v for k, v in tensors.items()
                        if k.startswith("state/")})
    ptr = int(np.asarray(tensors["ptr"]).reshape(-1)[0])
    # "bind": the reference's span over the decode (expand_log's inside)
    with TRACER.span("solver.phase.bind"):
        return decode_solve(snap, (log, ptr), state)


def replan_response(response, want_slots: bool):
    """A Replan response -> (verdicts [K, 4], pods per slot [K, N] or None)."""
    if response.error:
        raise error_from_string(response.error)
    tensors = {t.name: tensor_from_pb(t) for t in response.tensors}
    verdicts = np.asarray(tensors["verdicts"])
    pods = np.asarray(tensors["pods"]) if want_slots and "pods" in tensors else None
    return verdicts, pods


def _request_metadata(trace_id: Optional[str]):
    """Outbound gRPC metadata of a solver RPC: the trace id and the calling
    thread's bound tenant; neither set -> None (no metadata at all)."""
    metadata = []
    if trace_id:
        metadata.append((TRACE_HEADER, trace_id))
    tenant = reqctx.current_tenant()
    if tenant is not None:
        metadata.append((reqctx.TENANT_HEADER, tenant))
    return tuple(metadata) if metadata else None


# -- the server ----------------------------------------------------------------


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("SolverService: no CUDA device is available; pass "
                               "device='cpu' to serve on the CPU")
    elif device.type != "cpu":
        raise ValueError(f"SolverService: unsupported device {device}")
    return device


@dataclass
class _Entry:
    """One wire geometry's solve entry: its parsed geometry and the solve
    program (make_device_run's closure); the replan kernel is built at the
    first replan, when the existing axis's width is known."""

    segments: list
    zone_seg: tuple
    ct_seg: tuple
    topo_meta: object
    n_slots: int
    log_len: int
    screen_v: Optional[int]
    screen_mode: str
    run: object
    replan: object = None
    layout: object = None


class SolverService:
    """The device path keyed by wire geometry, on `device` (the CUDA card
    by default: without one it raises, and it never solves on the CPU
    unless told "cpu"). Stateless for correctness: a restarted service
    answers every request alike; consecutive same-geometry solves keep the
    [N, C] verdict tensor resident and refresh only the plane delta (the
    plane fingerprints alone decide it: there is no change feed at the
    RPC boundary).

    `admission` (solver/host.AdmissionGate), when set, gates every Solve
    and Replan: the client's gRPC deadline propagates in, a request whose
    deadline expires while queued is never dispatched, and a full queue
    sheds with RESOURCE_EXHAUSTED and a retry-after hint. None (a direct
    construction, the solver host's child) skips it: the caller gates."""

    MAX_COMPILED = 32
    MAX_REFRESH = 16
    MAX_REPLAN = 16

    def __init__(self, device=None, admission=None, mesh=None):
        from karpenter_core_tpu_torch.solver.factory import detect_mesh, refuse_spanning

        if mesh is not None:
            # a request reaches one process; the other ranks of a grid
            # over processes would never join its collectives
            refuse_spanning("the solver service", None if mesh is True else mesh)
        if mesh is True:
            mesh = detect_mesh(device=device)
        self.mesh = mesh
        # a grid's solves gather on its lead device, which is the service's
        self.device = mesh.lead if mesh is not None else _check_device(device or "cuda")
        self.admission = admission
        self._mu = threading.Lock()
        self._compiled: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._programs = proghealth.ProgramBook("service")
        self.solves = 0
        self.replans = 0
        # the resident verdict tensors, one (lock, IncrementalScreen) per
        # solve entry, and the refresh entries by (key, rows, cols budget)
        self._inc_mu = threading.Lock()
        self._inc_screens: Dict[tuple, tuple] = {}
        self._refresh_compiled: "OrderedDict[tuple, None]" = OrderedDict()
        # the batched replan entries by (key, candidate-axis bucket)
        self._replan_compiled: "OrderedDict[tuple, object]" = OrderedDict()
        # the last dispatch's prescreen ("full" | "refresh" | None) and the
        # last solve's phases (upload, prescreen, device, fetch), in ms;
        # written under _mu, as concurrent RPCs each write them
        self.last_prescreen_mode: Optional[str] = None
        self.last_phase_ms: Dict[str, float] = {}
        # in-flight dispatch heartbeats: Health reads the stalest
        self.wedge_stale_after = 600.0
        self._inflight_mu = threading.Lock()
        self._inflight: Dict[int, supervise.ThreadHeartbeat] = {}
        self._inflight_seq = 0

    def _sync(self) -> None:
        for dev in self.mesh.distinct() if self.mesh is not None else (self.device,):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def phase_ms(self) -> Dict[str, float]:
        """The last solve's phases, read under the lock they are written
        under."""
        with self._mu:
            return dict(self.last_phase_ms)

    def device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    @contextlib.contextmanager
    def _dispatch_heartbeat(self):
        """A heartbeat for the calling RPC thread's dispatch: the phase
        marks touch it, health() reads the inventory; unregistered on every
        exit."""
        hb = supervise.ThreadHeartbeat()
        hb.touch()
        with self._inflight_mu:
            self._inflight_seq += 1
            token = self._inflight_seq
            self._inflight[token] = hb
        supervise.bind_heartbeat(hb)
        try:
            yield hb
        finally:
            supervise.bind_heartbeat(None)
            with self._inflight_mu:
                self._inflight.pop(token, None)

    def _stalest_dispatch_age(self) -> Optional[float]:
        with self._inflight_mu:
            ages = [hb.age() for hb in self._inflight.values()]
        ages = [a for a in ages if a is not None]
        return max(ages) if ages else None

    # -- admission and status codes ----------------------------------------

    @staticmethod
    def _context_deadline(context) -> Optional[float]:
        """The caller's remaining gRPC deadline in seconds (None: none, or
        no context)."""
        if context is None:
            return None
        tr = getattr(context, "time_remaining", None)
        if not callable(tr):
            return None
        try:
            return tr()
        except Exception:  # noqa: BLE001 — a deadline read must never fail a solve
            return None

    def _abort_shed(self, e: SolverRpcError, context) -> pb.SolveResponse:
        """An admission shed -> RESOURCE_EXHAUSTED or DEADLINE_EXCEEDED on
        the wire, the retry-after hint in the trailing metadata (and in the
        detail as retry_after_ms=N)."""
        retry_ms = int((getattr(e, "retry_after_s", None) or 0) * 1000)
        msg = str(e)
        if context is not None:
            grpc = _import_grpc()
            if retry_ms:
                try:
                    context.set_trailing_metadata(((RETRY_AFTER_METADATA_KEY, str(retry_ms)),))
                except Exception:  # noqa: BLE001 — the abort still sheds
                    pass
            context.abort(getattr(grpc.StatusCode, e.code_name), msg)
        return pb.SolveResponse(error=f"{e.code_name}: {msg}")

    def _gated(self, request, context, traced) -> pb.SolveResponse:
        if self.admission is None:
            return self._dispatch_mapped(request, context, traced)
        try:
            gate = self.admission.admitted(self._context_deadline(context))
            gate.__enter__()
        except (SolverResourceExhaustedError, SolverDeadlineExceededError) as e:
            return self._abort_shed(e, context)
        try:
            return self._dispatch_mapped(request, context, traced)
        finally:
            gate.__exit__(None, None, None)

    def _dispatch_mapped(self, request, context, traced) -> pb.SolveResponse:
        try:
            with self._dispatch_heartbeat():
                return traced(request)
        except Exception as e:  # noqa: BLE001 — mapped to a status code
            code_name, msg = classify_exception(e)
            if context is not None:
                # a status code on the wire, which the client maps back to
                # the typed error; abort() raises
                context.abort(getattr(_import_grpc().StatusCode, code_name), msg)
            # no context (the solver host's child, a direct call): the
            # error field carries the same classification
            return pb.SolveResponse(error=f"{code_name}: {msg}")

    @staticmethod
    def _metadata(context) -> Tuple[Optional[str], Optional[str]]:
        """(trace id, tenant) from the RPC's metadata."""
        trace_id = tenant = None
        if context is not None:
            try:
                for k, v in context.invocation_metadata() or ():
                    if k == TRACE_HEADER:
                        trace_id = v
                    elif k == reqctx.TENANT_HEADER:
                        tenant = v
            except Exception:  # noqa: BLE001 — tracing must never fail a solve
                pass
        return trace_id, tenant

    def _rpc(self, span: str, request, context, traced) -> pb.SolveResponse:
        # the client's tenant is bound before the span opens, so the span
        # and everything under the gate attribute to it; the client's trace
        # id makes this span part of the caller's trace
        trace_id, tenant = self._metadata(context)
        with contextlib.ExitStack() as stack:
            if tenant is not None:
                stack.enter_context(reqctx.bind(reqctx.RequestContext(tenant=str(tenant))))
            stack.enter_context(TRACER.span(span, trace_id=trace_id,
                                            tensors=len(request.tensors)))
            return self._gated(request, context, traced)

    def solve(self, request, context=None) -> pb.SolveResponse:
        return self._rpc("solver.service.solve", request, context, self._solve_traced)

    def replan(self, request, context=None) -> pb.SolveResponse:
        """Batched candidate-subset evaluation: the union snapshot's
        tensors plus the [K, ...] subset planes -> [K, 4] verdicts (and
        the [K, N] slot plane on request), through the solve entry's
        prescreen and residency, as TorchSolver.replan_screen."""
        return self._rpc("solver.service.replan", request, context, self._replan_traced)

    # -- entries -------------------------------------------------------------

    def _layout_for(self, args):
        """The device grid's layout of this request: the service's grid
        for batches that clear the routing floor (route_to_mesh on the
        wire's item counts), None on a single device or for a small
        batch."""
        if self.mesh is None:
            return None
        from karpenter_core_tpu_torch.parallel import sharded
        from karpenter_core_tpu_torch.parallel.specs import layout_for

        total = int(np.asarray(args[0]["count"]).sum())
        if not sharded.route_to_mesh(total, self.mesh.shape["dp"]):
            return None
        return layout_for(self.mesh)

    def _entry(self, geom_str: str, screen_mode: str, family: str = "service",
               origin: str = "live", layout=None) -> Tuple[tuple, _Entry, bool]:
        """(key, entry, hit) of one wire geometry on the single device or
        on `layout`'s grid: made at first sight, LRU-bounded, shared by
        Solve and Replan (a replan reuses the single-device entry's
        prescreen and residency, as the in-process solver's does). The
        lookup is a compile-cache hit or miss at `family`'s site."""
        key = (geom_str, screen_mode, None if layout is None else layout.key)
        with self._mu:
            entry = self._compiled.get(key)
            if entry is not None:
                self._compiled.move_to_end(key)
        record_lookup(family, entry is not None)
        if entry is not None:
            return key, entry, True
        geometry = json.loads(geom_str)
        segments = [tuple(s) for s in geometry["segments"]]
        topo_meta = _topo_meta(geometry.get("topo_groups"))
        n_slots, log_len = int(geometry["n_slots"]), int(geometry["log_len"])
        screen_v = geometry.get("screen_v")
        zone_seg, ct_seg = tuple(geometry["zone_seg"]), tuple(geometry["ct_seg"])
        entry = _Entry(segments, zone_seg, ct_seg, topo_meta, n_slots, log_len, screen_v,
                       screen_mode,
                       make_device_run(segments, zone_seg, ct_seg, topo_meta, n_slots, log_len,
                                       screen_v=screen_v, screen_mode=screen_mode,
                                       spec_layout=layout),
                       layout=layout)
        retired = []
        with self._mu:
            entry = self._compiled.setdefault(key, entry)
            self._compiled.move_to_end(key)
            while len(self._compiled) > self.MAX_COMPILED:
                old_key, _ = self._compiled.popitem(last=False)
                retired.append(("solve", old_key))
                retired.extend(self._drop_incremental(old_key))
        self._programs.mint("solve", key, origin=origin,
                            meta={"tier": f"{n_slots}slots", "mode": screen_mode})
        for family, old in retired:
            self._programs.retire(family, old)
        return key, entry, False

    def _drop_incremental(self, key) -> list:
        """An evicted solve entry takes its resident tensor and its refresh
        and replan entries with it; returns the (family, key) pairs dropped
        for the ledger. The caller holds _mu (it guards _replan_compiled)."""
        dropped = []
        with self._inc_mu:
            self._inc_screens.pop(key, None)
            for rkey in [k for k in self._refresh_compiled if k[0] == key]:
                del self._refresh_compiled[rkey]
                dropped.append(("refresh", rkey))
        for rkey in [k for k in self._replan_compiled if k[0] == key]:
            del self._replan_compiled[rkey]
            dropped.append(("replan", rkey))
        return dropped

    def _bounded(self, lru: OrderedDict, lock, rkey, value, family: str):
        """Insert or refresh `rkey` in an LRU of this service (its bound by
        family), retiring what falls out."""
        bound = self.MAX_REFRESH if family == "refresh" else self.MAX_REPLAN
        evicted = []
        with lock:
            value = lru.setdefault(rkey, value)
            lru.move_to_end(rkey)
            while len(lru) > bound:
                evicted.append(lru.popitem(last=False)[0])
        for old in evicted:
            self._programs.retire(family, old)
        return value

    # -- the device path ---------------------------------------------------------

    def _upload(self, args, layout=None):
        """The wire's arrays onto the device (read-only views copied); on
        a grid pre-split, each on the lead device and the tiled families
        also as tiles on their devices (SpecLayout.put_args)."""
        if layout is not None:
            return layout.put_args(_ARG_NAMES, args)
        return args_to_torch(args, self.device)

    def _prescreen(self, key, entry: _Entry, host_args, targs):
        """(the verdict tensor, the class planes) of this dispatch:
        dispatch_prescreen at the entry's residency, under the key's own
        lock (plan and adopt pair against one resident tensor; other
        geometries never wait on it). KCT_INCREMENTAL=off runs the full
        precompute."""
        from karpenter_core_tpu_torch.ops import compat as ops_compat
        from karpenter_core_tpu_torch.solver.incremental import IncrementalScreen

        if ops_compat.resolve_incremental_mode() == "off":
            screen0, mode, _d, items_pl, _e = dispatch_prescreen(
                entry.segments, entry.screen_v, entry.n_slots, host_args, targs,
                spec_layout=entry.layout)
            with self._mu:
                self.last_prescreen_mode = mode
            return screen0, items_pl, mode
        with self._inc_mu:
            lock, inc = self._inc_screens.setdefault(key, (threading.Lock(),
                                                           IncrementalScreen()))
        with lock:
            screen0, mode, delta, items_pl, _error = dispatch_prescreen(
                entry.segments, entry.screen_v, entry.n_slots, host_args, targs, inc=inc,
                key=key, spec_layout=entry.layout)
        with self._mu:
            self.last_prescreen_mode = mode
        if mode == "refresh":
            rkey = (key, delta.rb, delta.cb)
            self._bounded(self._refresh_compiled, self._inc_mu, rkey, None, "refresh")
            self._programs.dispatch("refresh", rkey,
                                    meta={"tier": f"rb{delta.rb}xcb{delta.cb}"})
        return screen0, items_pl, mode

    def _solve_traced(self, request) -> pb.SolveResponse:
        # dispatch-start heartbeat, labelled with the device phase: the
        # staleness window starts here
        supervise.touch_heartbeat("solver.phase.device")
        # the device edge's chaos points, once per request, as the
        # in-process TorchSolver consults them: an injected error routes to
        # the caller's fallback; a hang (error:none and a latency past the
        # watchdog) goes heartbeat-silent, which wedges a solver host's child
        chaos.maybe_fail(chaos.SOLVER_DEVICE)
        chaos.maybe_fail(chaos.SOLVER_DEVICE_HANG)
        phases: Dict[str, float] = {}
        try:
            return self._solve_phases(request, phases)
        finally:
            # published once filled: a reader on another thread sees the
            # last solve's phases or this one's, never a dict being written
            with self._mu:
                self.last_phase_ms = phases

    def _solve_phases(self, request, phases) -> pb.SolveResponse:
        from karpenter_core_tpu_torch.ops import compat as ops_compat

        t_phase = time.perf_counter_ns()

        def mark(name, **attrs):
            # the same solver.phase.* spans the in-process TorchSolver
            # records, after the same device synchronize; each labels the
            # heartbeat
            nonlocal t_phase
            self._sync()
            now = time.perf_counter_ns()
            TRACER.add_span(f"solver.phase.{name}", t_phase, now, **attrs)
            elapsed_ms = phases[name] = (now - t_phase) / 1e6
            t_phase = now
            supervise.touch_heartbeat(f"solver.phase.{name}")
            return elapsed_ms

        tensors = {t.name: tensor_from_pb(t) for t in request.tensors}
        args = _unflatten_args(tensors)
        # "pack": the wire geometry's entry lookup, a span at the head of
        # the upload phase (the in-process solver's)
        t_pack = time.perf_counter_ns()
        layout = self._layout_for(args)
        key, entry, hit = self._entry(
            request.geometry, ops_compat.resolve_screen_mode(), layout=layout,
            family="service" if layout is None else "service_sharded")
        TRACER.add_span("solver.phase.pack", t_pack, time.perf_counter_ns())
        targs = self._upload(args, layout)
        mark("upload", tensors=len(request.tensors))
        screen0 = items_pl = None
        cold_ms = 0.0
        if entry.screen_mode == "prescreen":
            screen0, items_pl, mode = self._prescreen(key, entry, args, targs)
            cold_ms = mark("prescreen", mode=mode)
        # re-label for the long silent stretch ahead
        supervise.touch_heartbeat("solver.phase.device")
        log, ptr, state = dispatch_solve(entry.run, screen0, targs, items_pl, sync=self._sync)
        device_ms = mark("device", compile_cache="hit" if hit else "miss")
        self._programs.dispatch("solve", key, device_ms=cold_ms + device_ms)
        if not hit:
            # a miss's first dispatch pays the geometry's warm-up
            record_compile_seconds((cold_ms + device_ms) / 1e3)
        log = fetch_log(log, whole=True)
        out = [tensor_to_pb("ptr", np.asarray(ptr, dtype=np.int32))]
        for name in sorted(log):
            out.append(tensor_to_pb(f"log/{name}", np.asarray(log[name])))
        for field, value in fetch_state(state).items():
            out.append(tensor_to_pb(f"state/{field}", value))
        mark("fetch")
        with self._mu:
            self.solves += 1
        return pb.SolveResponse(tensors=out)

    def _replan_traced(self, request) -> pb.SolveResponse:
        from karpenter_core_tpu_torch.ops import compat as ops_compat
        from karpenter_core_tpu_torch.ops.pack import make_batched_replan_kernel

        supervise.touch_heartbeat("solver.phase.replan.device")
        chaos.maybe_fail(chaos.SOLVER_DEVICE)
        chaos.maybe_fail(chaos.SOLVER_DEVICE_HANG)
        tensors = {t.name: tensor_from_pb(t) for t in request.tensors}
        count_rows = np.ascontiguousarray(tensors.pop("replan/count_rows"))
        exist_open = np.ascontiguousarray(tensors.pop("replan/exist_open").astype(bool))
        # the replan binds its existing axis from exist_open's width: an
        # unpadded uninitialized mask is padded to it, never a broadcast
        # error
        E = int(exist_open.shape[1]) if exist_open.ndim == 2 else 0
        raw_uninit = tensors.pop("replan/uninitialized").astype(bool)
        uninit = np.zeros(E, dtype=bool)
        uninit[: min(len(raw_uninit), E)] = raw_uninit[:E]
        want_slots = bool(int(np.asarray(tensors.pop("replan/want_slots")).reshape(-1)[0]))
        args = _unflatten_args(tensors)
        key, entry, _hit = self._entry(request.geometry, ops_compat.resolve_screen_mode(),
                                       family="service_replan_entry")
        targs = self._upload(args)
        uninit_t = torch.from_numpy(uninit).to(self.device)
        screen0 = items_pl = None
        if entry.screen_mode == "prescreen":
            screen0, items_pl, _mode = self._prescreen(key, entry, args, targs)
        with self._mu:
            replan = entry.replan
        if replan is None or replan.n_exist != E:
            rung_run = make_device_run(entry.segments, entry.zone_seg, entry.ct_seg,
                                       entry.topo_meta, entry.n_slots, entry.log_len,
                                       screen_v=entry.screen_v, screen_mode=entry.screen_mode,
                                       rung_mode=True)
            replan = make_batched_replan_kernel(rung_run, E)
            replan.n_exist = E
            with self._mu:
                entry.replan = replan

        def on_chunk(kp, ms):
            # each finished chunk is a proof of life for the dispatch
            # watchdogs (a K-chunked sweep is many device calls)
            supervise.touch_heartbeat()
            rkey = (key, kp)
            with self._mu:
                hit = rkey in self._replan_compiled
                self._replan_compiled[rkey] = replan
                self._replan_compiled.move_to_end(rkey)
                evicted = []
                while len(self._replan_compiled) > self.MAX_REPLAN:
                    evicted.append(self._replan_compiled.popitem(last=False)[0])
            record_lookup("service_replan", hit)
            for old in evicted:
                self._programs.retire("replan", old)
            self._programs.dispatch("replan", rkey, device_ms=ms,
                                    meta={"tier": f"K{kp}", "mode": entry.screen_mode})

        verdict_parts, pods_parts, _chunks, _scans = dispatch_replan(
            replan, count_rows, exist_open, uninit_t, screen0, targs, items_pl, want_slots,
            on_chunk=on_chunk, sync=self._sync)
        verdicts, pods = fetch_replan(verdict_parts, pods_parts, want_slots)
        out = [tensor_to_pb("verdicts", verdicts)]
        if pods is not None:
            out.append(tensor_to_pb("pods", pods))
        with self._mu:
            self.replans += 1
        return pb.SolveResponse(tensors=out)

    def prewarm(self, request) -> str:
        """A geometry's cold costs without a scan (TorchSolver's
        prewarm_snapshot, at the wire's geometry): "compiled" when this
        call loaded the screen or pack scan library or minted the
        geometry's entry, "cached" otherwise."""
        from karpenter_core_tpu_torch.ops import compat as ops_compat

        t0 = time.perf_counter()
        fresh = load_solve_libraries(self.device)
        screen_mode = ops_compat.resolve_screen_mode()
        args = _unflatten_args({t.name: tensor_from_pb(t) for t in request.tensors})
        layout = self._layout_for(args)
        key, entry, hit = self._entry(
            request.geometry, screen_mode, origin="prewarm", layout=layout,
            family="service" if layout is None else "service_sharded")
        fresh = fresh or not hit
        # the prescreen at this geometry, with no resident tensor
        dispatch_prescreen(entry.segments, entry.screen_v, entry.n_slots, None,
                           self._upload(args, layout), spec_layout=layout)
        self._sync()
        seconds = time.perf_counter() - t0
        self._programs.mint("solve", key, origin="prewarm", seconds=seconds)
        if fresh:
            record_compile_seconds(seconds)
        return "compiled" if fresh else "cached"

    def health(self, request=None, context=None) -> pb.HealthResponse:
        # the wedge gate first, before anything touches the device: a
        # dispatch whose heartbeat went stale hung mid-call, and a device
        # query from this thread could hang the Health RPC too
        with self._mu:
            solves = self.solves
        age = self._stalest_dispatch_age()
        if age is not None and age >= self.wedge_stale_after:
            return pb.HealthResponse(
                status=(f"wedged: dispatch heartbeat stale for {age:.0f}s "
                        f"(threshold {self.wedge_stale_after:.0f}s)"),
                device="", solves=solves)
        device = self.device_name()
        if self.mesh is not None:
            device += (f" x{self.mesh.size}"
                       f"(dp={self.mesh.shape['dp']},tp={self.mesh.shape['tp']})")
        return pb.HealthResponse(status="ok", device=device, solves=solves)


def _topo_meta(groups):
    """The wire's topology groups -> the port's TopoMeta (None: none)."""
    if not groups:
        return None
    from karpenter_core_tpu_torch.ops.topology import TopoGroupMeta, TopoMeta

    return TopoMeta(groups=[
        TopoGroupMeta(gtype=g["gtype"], seg=tuple(g["seg"]), key_k=g["key_k"],
                      max_skew=g["max_skew"], is_hostname=g["is_hostname"],
                      is_inverse=g["is_inverse"],
                      filter_term_rows=list(g["filter_term_rows"]))
        for g in groups
    ])


def _serialize(message) -> bytes:
    """A message of either implementation, or its bytes already made."""
    return message if isinstance(message, bytes) else message.SerializeToString()


def serve(address: str = "127.0.0.1:0", max_workers: int = 4, mesh=None,
          maximum_concurrent_rpcs: Optional[int] = None,
          max_queue: Optional[int] = 8, brownout_at: Optional[int] = None,
          tenant_quota: Optional[int] = None,
          weights: Optional[Dict[str, float]] = None, device=None):
    """Start the gRPC server on `device` (the card by default), or on a
    device grid: `mesh` a parallel/specs.DeviceGrid, or True to detect
    one over `device`'s kind (solver/factory.detect_mesh; none below two
    devices). Returns (server, bound port, service).

    Overload control has two bounded layers: `maximum_concurrent_rpcs`
    caps what gRPC accepts (excess RPCs are refused RESOURCE_EXHAUSTED at
    the transport; default workers + queue + 4), and the deadline-aware
    AdmissionGate (`max_queue`, `brownout_at`; max_queue=None disables it)
    queues at most max_queue dispatches, sheds with a retry-after hint,
    and never dispatches a request whose deadline expired in the queue.
    Messages up to MAX_MESSAGE_BYTES pass both ways."""
    grpc = _import_grpc()
    pb2 = _import_pb2()
    admission = None
    if max_queue is not None:
        from karpenter_core_tpu_torch.solver.host import AdmissionGate

        admission = AdmissionGate(name="service", max_queue=max_queue, brownout_at=brownout_at,
                                  tenant_quota=tenant_quota, weights=weights)
        # the executor must hold every gate waiter, the dispatching handler
        # and health-probe headroom, or excess RPCs queue unwatched in the
        # executor's own queue: max_workers is a floor
        max_workers = max(max_workers, max_queue + 1 + 2)
    if maximum_concurrent_rpcs is None:
        maximum_concurrent_rpcs = max_workers + (max_queue or 0) + 4
    service = SolverService(device=device, admission=admission, mesh=mesh)
    handlers = {
        "Solve": grpc.unary_unary_rpc_method_handler(
            service.solve, request_deserializer=pb2.SolveRequest.FromString,
            response_serializer=_serialize),
        "Replan": grpc.unary_unary_rpc_method_handler(
            service.replan, request_deserializer=pb2.SolveRequest.FromString,
            response_serializer=_serialize),
        "Health": grpc.unary_unary_rpc_method_handler(
            service.health, request_deserializer=pb2.HealthRequest.FromString,
            response_serializer=_serialize),
    }
    from concurrent import futures

    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        maximum_concurrent_rpcs=maximum_concurrent_rpcs,
        options=[("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
                 ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES)],
    )
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(SERVICE, handlers),))
    port = server.add_insecure_port(address)
    server.start()
    return server, port, service


# -- the client ------------------------------------------------------------------


class RemoteSolver:
    """Solver-interface client: encode locally, solve remotely, decode
    locally.

    Every RPC carries a deadline (`timeout`); transient failures
    (UNAVAILABLE, DEADLINE_EXCEEDED) retry `rpc_retries` times with
    exponential backoff and full jitter, each retry first paid from the
    tenant's RetryBudget; an admission shed with a retry-after hint waits
    it out within the same budget; and a consecutive-failure circuit
    breaker fails fast while the service is down, so the ResilientSolver
    around this client degrades at once instead of waiting out a dead
    channel's timeout. health() bypasses the breaker and closes it on
    success (the half-open probe)."""

    # the consolidation search screens its subsets through one Replan RPC
    supports_batched_replan = True

    def __init__(self, target: str, max_nodes: int = 1024,
                 max_relax_rounds: Optional[int] = None, timeout: float = 120.0,
                 rpc_retries: int = 2, rpc_retry_base: float = 0.05, breaker=None,
                 retry_budget=None):
        grpc = _import_grpc()
        pb2 = _import_pb2()
        from karpenter_core_tpu_torch.solver.fallback import CircuitBreaker
        from karpenter_core_tpu_torch.utils.backoff import RetryBudget

        self.target = target
        self.channel = grpc.insecure_channel(target, options=[
            ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
            ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES)])
        self.timeout = timeout
        self.rpc_retries = rpc_retries
        self.rpc_retry_base = rpc_retry_base
        self.breaker = breaker or CircuitBreaker(name="solver.rpc")
        self.retry_budget = retry_budget if retry_budget is not None else RetryBudget()
        self.max_nodes = max_nodes
        self.max_relax_rounds = (DEFAULT_MAX_RELAX_ROUNDS if max_relax_rounds is None
                                 else max_relax_rounds)
        self._encode_reuse = EncodeReuse()
        self._solve = self.channel.unary_unary(
            f"/{SERVICE}/Solve", request_serializer=_serialize,
            response_deserializer=pb2.SolveResponse.FromString)
        self._replan = self.channel.unary_unary(
            f"/{SERVICE}/Replan", request_serializer=_serialize,
            response_deserializer=pb2.SolveResponse.FromString)
        self._health = self.channel.unary_unary(
            f"/{SERVICE}/Health", request_serializer=_serialize,
            response_deserializer=pb2.HealthResponse.FromString)
        # the byte counts of the last Solve or Replan exchange
        self.last_request_bytes: Optional[int] = None
        self.last_response_bytes: Optional[int] = None

    def close(self) -> None:
        self.channel.close()

    def health(self, timeout: float = 30.0):
        """The Health RPC, not gated by the breaker: this is the half-open
        recovery probe, and a success closes the breaker. A service that
        answers "wedged" raises SolverUnavailableError."""
        try:
            response = self._health(pb.HealthRequest(), timeout=timeout)
        except Exception:
            self.breaker.record_failure()
            raise
        if response.status != "ok":
            self.breaker.record_failure()
            raise SolverUnavailableError(f"solver service unhealthy: {response.status}")
        self.breaker.record_success()
        return response

    def _map_rpc_error(self, e) -> SolverRpcError:
        """grpc.RpcError -> the typed error of its status code, with the
        server's retry-after hint (trailing metadata, or retry_after_ms=N
        in the detail)."""
        grpc = _import_grpc()
        code = e.code() if hasattr(e, "code") else None
        details = e.details() if hasattr(e, "details") else str(e)
        name = code.name if isinstance(code, grpc.StatusCode) else "UNKNOWN"
        err = _ERROR_BY_CODE.get(name, SolverInternalError)(f"solver service {name}: {details}")
        err.__cause__ = e
        retry_after = None
        tm = getattr(e, "trailing_metadata", None)
        if callable(tm):
            try:
                for k, v in tm() or ():
                    if k == RETRY_AFTER_METADATA_KEY:
                        retry_after = int(v) / 1000.0
            except Exception:  # noqa: BLE001 — the hint is best-effort
                retry_after = None
        if retry_after is None:
            retry_after = _parse_retry_after(details or "")
        err.retry_after_s = retry_after
        return err

    def _retry_allowed(self, err) -> bool:
        """One more attempt from the tenant's retry budget; a denial counts
        and the caller raises `err` as it is."""
        key = reqctx.TENANTS.admit(reqctx.current_tenant())
        if self.retry_budget.try_spend(key):
            return True
        SOLVER_RETRY_BUDGET_EXHAUSTED.inc(reqctx.tenant_labels())
        LOG.warning("solver rpc retry budget exhausted, not retrying", target=self.target,
                    error=type(err).__name__)
        return False

    def _invoke_solve(self, request, metadata, stub=None):
        """One Solve (or Replan) RPC through the breaker and the bounded
        retry."""
        from karpenter_core_tpu_torch.utils.backoff import full_jitter

        grpc = _import_grpc()
        stub = stub or self._solve
        attempt = 0
        while True:
            if not self.breaker.allow():
                raise SolverUnavailableError(
                    f"solver circuit breaker open (service at {self.target})")
            try:
                # inside the try: an injected typed error takes the same
                # classification as a wire error
                chaos.maybe_fail(chaos.SOLVER_RPC)
                response = stub(request, timeout=self.timeout, metadata=metadata)
            except grpc.RpcError as e:
                err = self._map_rpc_error(e)
            except SolverRpcError as e:
                err = e
            else:
                self.breaker.record_success()
                return response
            if not err.transient and not isinstance(err, SolverInternalError):
                # INVALID_ARGUMENT / RESOURCE_EXHAUSTED: the server processed
                # the request, so the channel is up
                self.breaker.record_success()
            if err.transient:
                self.breaker.record_failure()
                if attempt < self.rpc_retries and self._retry_allowed(err):
                    SOLVER_RPC_RETRIES.inc()
                    LOG.warning("solver rpc retrying", target=self.target,
                                attempt=attempt + 1, error=type(err).__name__)
                    time.sleep(full_jitter(attempt, self.rpc_retry_base, cap=2.0))
                    attempt += 1
                    continue
            elif isinstance(err, SolverInternalError):
                # a crash-looping service fails fast
                self.breaker.record_failure()
            if (isinstance(err, SolverResourceExhaustedError)
                    and getattr(err, "retry_after_s", None)
                    and attempt < self.rpc_retries and self._retry_allowed(err)):
                # an admission shed with a hint: the server is up but busy
                SOLVER_RPC_RETRIES.inc()
                LOG.warning("solver rpc shed, honoring retry-after", target=self.target,
                            attempt=attempt + 1, retry_after_s=err.retry_after_s)
                time.sleep(min(5.0, err.retry_after_s)
                           + full_jitter(attempt, self.rpc_retry_base, cap=0.5))
                attempt += 1
                continue
            raise err

    def _exchange(self, span: str, request, stub=None):
        with TRACER.span(span) as sp:
            trace_id = getattr(sp, "trace_id", None) or TRACER.current_trace_id()
            body = request.SerializeToString()
            self.last_request_bytes = len(body)
            response = self._invoke_solve(body, _request_metadata(trace_id), stub=stub)
            self.last_response_bytes = response.ByteSize()
        return response

    def encode(self, pods, provisioners, instance_types, daemonset_pods=None,
               state_nodes=None, kube_client=None, cluster=None):
        """Encode off the Solve's critical path (TorchSolver.encode's
        contract)."""
        return encode_snapshot(pods, provisioners, instance_types, daemonset_pods,
                               state_nodes, kube_client=kube_client, cluster=cluster,
                               max_nodes=self.max_nodes, reuse=self._encode_reuse)

    def replan_screen(self, snap, provisioners, count_rows, exist_open, uninitialized=None,
                      cluster=None, want_slots: bool = False):
        """TorchSolver.replan_screen's contract over one Replan RPC."""
        with TRACER.span("solver.phase.replan.args"):
            request = replan_request(snap, provisioners, count_rows, exist_open,
                                     uninitialized, want_slots)
        response = self._exchange("solver.service.replan_request", request, self._replan)
        return replan_response(response, want_slots)

    def solve(self, pods, provisioners, instance_types, daemonset_pods=None,
              state_nodes=None, kube_client=None, cluster=None,
              encoded=None) -> SolveResult:
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
        snap = relax_ctx.pop("encoded", None)
        if snap is None:
            with TRACER.span("solver.phase.encode", pods=len(pods)):
                snap = self.encode(pods, provisioners, instance_types, daemonset_pods,
                                   state_nodes, kube_client, cluster)
        with TRACER.span("solver.phase.args"):
            request = solve_request(snap, provisioners)
        response = self._exchange("solver.service.request", request)
        with TRACER.span("solver.phase.decode"):
            return decode_response(snap, response)


def main(argv: Optional[List[str]] = None) -> None:
    """The solver service's container entry:
    `python -m karpenter_core_tpu_torch.solver.service [--port N]
    [--host H] [--max-workers N] [--device cuda|cpu]`."""
    import argparse
    import signal

    parser = argparse.ArgumentParser(description="karpenter solver service (PyTorch port)")
    parser.add_argument("--port", type=int, default=8980)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--max-workers", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    _import_grpc()
    _import_pb2()
    from karpenter_core_tpu_torch.obs import enable_tracing_from_env
    from karpenter_core_tpu_torch.obs.log import configure_logging_from_env
    from karpenter_core_tpu_torch.utils.compilecache import enable_persistent_cache

    # the kernels' libraries outlive a container restart (utils/compilecache)
    enable_persistent_cache()
    # server-side tracing and logging, on by default as the operator's
    enable_tracing_from_env(default_on=True)
    configure_logging_from_env(default_level="info")
    # a container that sees several devices serves every Solve over their
    # grid; KARPENTER_SOLVER_MODE=single pins the one device, and sharded
    # fails the start with one device (factory.build_solver's contract)
    from karpenter_core_tpu_torch.solver.factory import detect_mesh, refuse_spanning

    mode = envflags.raw("KARPENTER_SOLVER_MODE", "auto").lower()
    mesh = None
    if mode != "single":
        refuse_spanning("the solver service")
        mesh = detect_mesh(device=args.device)
        if mesh is None and mode == "sharded":
            raise RuntimeError("KARPENTER_SOLVER_MODE=sharded but only one device is visible")
    # a boot warmup before the port binds (before readiness): the screen
    # library's load and a small solve's first allocations
    if envflags.raw("KARPENTER_SOLVER_WARMUP", "1") != "0":
        t0 = time.perf_counter()
        try:  # best-effort: a flake must not crash-loop the container
            from karpenter_core_tpu_torch.cloudprovider import fake as _fake
            from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver
            from karpenter_core_tpu_torch.testing import make_pod, make_provisioner

            TorchSolver(max_nodes=64, device=args.device).solve(
                [make_pod(requests={"cpu": "1"}) for _ in range(32)],
                [make_provisioner(name="default")],
                {"default": _fake.instance_types(4)})
            LOG.info("solver warmup done", seconds=round(time.perf_counter() - t0, 1))
        except Exception as exc:  # noqa: BLE001 — serve anyway
            LOG.warning("solver warmup failed, serving anyway", error=type(exc).__name__,
                        error_detail=str(exc))
    server, port, _service = serve(f"{args.host}:{args.port}", max_workers=args.max_workers,
                                   device=args.device, mesh=mesh)
    from karpenter_core_tpu_torch.utils.gctuning import apply_server_gc_tuning

    apply_server_gc_tuning()
    LOG.info("solver service listening", host=args.host, port=port)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    server.stop(grace=5)


if __name__ == "__main__":
    main()
