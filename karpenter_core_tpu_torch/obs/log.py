"""Structured logging: logfmt/JSON lines with per-thread bound context,
trace-id correlation, and a bounded in-memory ring served at /debug/logs.

The reference controller logs through zap with key=value context
(logger.WithValues(controller, request)). This module, the port's copy of
the reference package's, is the one logging surface of the port:

  * the DISABLED path is near-zero — same discipline as obs/tracer.py: a
    log call on a disabled sink is ONE level
    comparison returning immediately, so log sites live permanently on
    production hot paths (the provisioning pass, launch failures, watch
    pump faults);
  * context BINDS per thread: `with log.bound(controller=..., reconcile=...)`
    stamps every record emitted inside the scope (the WithValues analog),
    and the active obs.tracer trace id is attached automatically so log
    lines join spans — grep one trace id across /debug/logs and
    /debug/trace and you see the same solve;
  * records land in a bounded ring (the /debug/logs surface)
    AND stream to stderr as logfmt or JSON lines, selected by
    KARPENTER_TPU_LOG (e.g. `info`, `debug:json`) — parsed in exactly one
    place, configure_logging_from_env.
"""
from __future__ import annotations

import io
import json
import sys
import threading
import time
import traceback
from collections import deque
from typing import Dict, List, Optional

from karpenter_core_tpu_torch.obs import envflags
from karpenter_core_tpu_torch.obs.envflags import FALSY as _FALSY, TRUTHY as _TRUTHY
from karpenter_core_tpu_torch.obs.tracer import TRACER

DEBUG, INFO, WARNING, ERROR = 10, 20, 30, 40
OFF = 100  # disabled: no named level reaches it

LEVEL_NAMES = {DEBUG: "debug", INFO: "info", WARNING: "warning", ERROR: "error"}
LEVELS = {name: num for num, name in LEVEL_NAMES.items()}
LEVELS["warn"] = WARNING


# ---------------------------------------------------------------------------
# formatting


def _fmt_ts(ts: float) -> str:
    whole = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(ts))
    return f"{whole}.{int((ts % 1) * 1e3):03d}Z"


def _logfmt_value(value: object) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return f"{value:g}" if isinstance(value, float) else str(value)
    s = str(value)
    if s and not any(c in s for c in ' "=\n\t'):
        return s
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n") + '"'


def format_logfmt(record: Dict[str, object]) -> str:
    """One logfmt line; ts/level/logger/msg lead, then bound+call fields."""
    parts = [f"ts={_fmt_ts(record['ts'])}"]
    for key in ("level", "logger", "msg"):
        parts.append(f"{key}={_logfmt_value(record[key])}")
    for key, value in record.items():
        if key in ("ts", "level", "logger", "msg"):
            continue
        parts.append(f"{key}={_logfmt_value(value)}")
    return " ".join(parts)


def format_json(record: Dict[str, object]) -> str:
    out = dict(record)
    out["ts"] = _fmt_ts(record["ts"])
    return json.dumps(out, default=str, separators=(",", ":"))


# ---------------------------------------------------------------------------
# per-thread bound context


class _Tls(threading.local):
    def __init__(self):
        self.stack: List[Dict[str, object]] = [{}]


_tls = _Tls()


class bound:
    """Context manager stamping every record emitted in-scope (and in
    nested scopes) with the given fields — the WithValues analog. Nests:
    inner scopes merge over outer ones."""

    __slots__ = ("ctx",)

    def __init__(self, **ctx):
        self.ctx = ctx

    def __enter__(self):
        stack = _tls.stack
        stack.append({**stack[-1], **self.ctx})
        return self

    def __exit__(self, exc_type, exc, tb):
        _tls.stack.pop()
        return False


def bound_context() -> Dict[str, object]:
    """The calling thread's current bound fields (read-only view)."""
    return dict(_tls.stack[-1])


# ---------------------------------------------------------------------------
# sink


class LogSink:
    """Level-gated fan-out: bounded in-memory ring + a line stream.

    `level` is the one hot-path gate: Logger methods compare against it
    before building anything, so a disabled sink (level=OFF) costs one
    comparison per call site."""

    def __init__(self, capacity: int = 4096):
        self.level = OFF
        self.fmt = "logfmt"
        self.stream = None  # line sink; None = ring only
        self.capacity = capacity
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._emitted = 0

    @property
    def enabled(self) -> bool:
        return self.level < OFF

    def configure(self, level: int = INFO, fmt: str = "logfmt",
                  stream=...) -> "LogSink":
        # under _mu so concurrent configures (operator boot vs embedder)
        # can't tear fmt/stream across generations; the HOT-PATH reads of
        # these latches stay lock-free by design (one comparison per call
        # site)
        with self._mu:
            self.level = level
            self.fmt = fmt
            if stream is not ...:
                self.stream = stream
        return self

    def disable(self) -> "LogSink":
        with self._mu:
            self.level = OFF
        return self

    def emit(self, record: Dict[str, object]) -> None:
        with self._mu:
            self._ring.append(record)
            self._emitted += 1
        stream = self.stream
        if stream is None and record.get("level") == "error":
            # last-resort semantics (stdlib logging's lastResort handler):
            # error records from a process that never configured the sink
            # (embedding, one-off scripts) still reach stderr — a crashing
            # watch pump must never be invisible
            stream = sys.stderr
        if stream is not None:
            line = (
                format_json(record) if self.fmt == "json"
                else format_logfmt(record)
            )
            try:
                stream.write(line + "\n")
            except Exception:  # noqa: BLE001 — a dead stream must not break a solve
                pass

    # -- reading (the /debug/logs surface) ---------------------------------

    @property
    def dropped(self) -> int:
        with self._mu:
            return self._emitted - len(self._ring)

    def records(self) -> List[Dict[str, object]]:
        with self._mu:
            return list(self._ring)

    def lines(self, fmt: Optional[str] = None) -> str:
        formatter = format_json if (fmt or self.fmt) == "json" else format_logfmt
        out = [formatter(r) for r in self.records()]
        if self.dropped:
            out.append(f"# dropped={self.dropped} (ring full)")
        return "\n".join(out) + "\n" if out else ""

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()
            self._emitted = 0


SINK = LogSink()


# ---------------------------------------------------------------------------
# loggers


class Logger:
    """Named logger. Every method is gated on SINK.level FIRST — the
    disabled path is one comparison, mirroring TRACER.span()'s contract."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def debug(self, event: str, **fields) -> None:
        if DEBUG >= SINK.level:
            self._emit(DEBUG, event, fields)

    def info(self, event: str, **fields) -> None:
        if INFO >= SINK.level:
            self._emit(INFO, event, fields)

    def warning(self, event: str, **fields) -> None:
        if WARNING >= SINK.level:
            self._emit(WARNING, event, fields)

    def error(self, event: str, **fields) -> None:
        # errors bypass the level gate: an unconfigured sink still rings
        # them and LogSink.emit last-resorts them to stderr (the stdlib
        # lastResort analog) — error paths are cold, the gate is for the
        # hot debug/info sites
        self._emit(ERROR, event, fields)

    def exception(self, event: str, **fields) -> None:
        """error() + the active exception's type/message/stack."""
        exc_type, exc, tb = sys.exc_info()
        if exc_type is not None:
            fields.setdefault("error", exc_type.__name__)
            fields.setdefault("error_detail", str(exc))
            buf = io.StringIO()
            traceback.print_exception(exc_type, exc, tb, file=buf)
            fields.setdefault("stack", buf.getvalue())
        self._emit(ERROR, event, fields)

    def _emit(self, level: int, event: str, fields: Dict[str, object]) -> None:
        record: Dict[str, object] = {
            "ts": time.time(),
            "level": LEVEL_NAMES[level],
            "logger": self.name,
            "msg": event,
        }
        ctx = _tls.stack[-1]
        if ctx:
            record.update(ctx)
        # span correlation: log lines inside an active span carry its trace
        # id so /debug/logs joins /debug/trace on one key
        if TRACER.enabled:
            trace_id = TRACER.current_trace_id()
            if trace_id is not None:
                record["trace_id"] = trace_id
        if fields:
            record.update(fields)
        SINK.emit(record)


_loggers: Dict[str, Logger] = {}
_loggers_mu = threading.Lock()


def get_logger(name: str) -> Logger:
    with _loggers_mu:
        logger = _loggers.get(name)
        if logger is None:
            logger = _loggers[name] = Logger(name)
        return logger


# ---------------------------------------------------------------------------
# KARPENTER_TPU_LOG


def parse_log_spec(raw: str) -> Optional[tuple]:
    """`level[:format]` -> (level, fmt), None for off/unset. Truthy
    spellings mean info; unknown levels fall back to info so a typo'd spec
    still logs rather than silently disabling."""
    raw = raw.strip().lower()
    if not raw or raw in _FALSY:
        return None
    level_part, _, fmt_part = raw.partition(":")
    if level_part in ("json", "logfmt"):  # bare format: `KARPENTER_TPU_LOG=json`
        level_part, fmt_part = "info", level_part
    if level_part in _TRUTHY:
        level_part = "info"
    level = LEVELS.get(level_part, INFO)
    fmt = "json" if fmt_part == "json" else "logfmt"
    return level, fmt


def configure_logging_from_env(default_level: str = "") -> bool:
    """Arm/disarm SINK from KARPENTER_TPU_LOG — the ONE parser of that
    variable, shared by the import-time hook (default off) and the
    operator / solver-service entrypoints (default info). Returns the
    resulting enabled state."""
    spec = parse_log_spec(
        envflags.raw("KARPENTER_TPU_LOG") or default_level
    )
    if spec is None:
        SINK.disable()
    else:
        level, fmt = spec
        SINK.configure(level=level, fmt=fmt, stream=sys.stderr)
    return SINK.enabled


# KARPENTER_TPU_LOG set arms logging at import, so any entrypoint (the
# smoke, tests, one-off scripts) opts in uniformly — same hook as KARPENTER_TPU_TRACE
configure_logging_from_env()
