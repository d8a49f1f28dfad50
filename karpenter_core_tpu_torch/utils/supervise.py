"""Heartbeats, the process-group runner, resumable artifacts and health
verdicts.

A device dispatch that has hung is told apart from one that is merely slow
by its heartbeat: a worker that keeps touching it is alive and gets its
whole budget; one that stopped touching it is wedged and is abandoned now
(solver/fallback.ResilientSolver).

  * ``Heartbeat``: a file a supervised worker process touches as it makes
    progress; its mtime is the signal, its content the last phase label.
  * ``ThreadHeartbeat``: the in-process twin (monotonic clock, no file)
    that the ResilientSolver watchdog reads while the primary solve runs on
    a worker thread.
  * ``bind_heartbeat`` / ``touch_heartbeat`` / ``bound_heartbeat``: the
    thread-local binding. The watchdog binds a heartbeat into the thread it
    spawns, and the solver's phase marks (TorchSolver) touch it without
    the object being passed through every signature. An unbound thread's
    touch is one thread-local read. ``touch_progress`` is the rate-limited
    touch of a long loop between two phase marks (the pack scan's items).
  * ``set_process_heartbeat`` / ``process_heartbeat``: the process-wide
    heartbeat of a supervised worker process (the solver host's child):
    every ``touch_heartbeat`` from any thread also touches it, so the
    parent's file watchdog sees the same phase marks.
  * ``redact_env_text`` / ``tail_bytes_of`` / ``atomic_write_json``: a
    worker's stderr tail with the secrets of the environment scrubbed, and
    the all-or-nothing file write its span spill uses.
  * ``run_supervised``: a command in its own process group under a
    hard-kill watchdog (SIGKILL to the whole group, so a grandchild holding
    a pipe cannot outlive the kill), told slow (``timed_out``: the wall
    budget ran out, the heartbeat fresh) from wedged (``wedged``: the
    heartbeat file went stale, killed early), restarted with backoff, its
    output tails kept for the post-mortem (``SuperviseResult.wedge_log``).
  * ``ArtifactStore`` / ``config_digest``: one JSON artifact per unit of
    work, written atomically and keyed by the digest of its configuration,
    so an interrupted run resumes: a fresh artifact of the same digest is
    done; a missing, degraded or other-config one runs again.
  * ``write_verdict`` / ``read_verdict``: the TTL'd health verdict file a
    health daemon publishes; a verdict past its TTL reads as none.

Stdlib only: the supervisor must keep working when the device stack is
wedged.
"""
from __future__ import annotations

import hashlib
import json
import os
import signal
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


class Heartbeat:
    """File heartbeat: the worker calls touch() at progress points, the
    supervisor reads age(). The file's mtime is the signal (wall clock:
    worker and supervisor are different processes). A labelled touch
    writes the phase name as the file's content, so a wedge verdict can
    name the phase the worker died in; a touch without a label keeps the
    previous one."""

    def __init__(self, path: str):
        self.path = path

    def touch(self, label: Optional[str] = None) -> None:
        if label is not None:
            # a plain overwrite: the label is one short line, and a reader
            # that catches the torn window reads "no label"
            with open(self.path, "w") as f:
                f.write(label[:256])
            return
        with open(self.path, "a"):
            os.utime(self.path, None)

    def read_label(self) -> str:
        """The last labelled touch's phase name ('' when none or unreadable)."""
        try:
            with open(self.path, "rb") as f:
                return f.read(512).decode("utf-8", errors="replace").strip()
        except OSError:
            return ""

    def age(self) -> Optional[float]:
        """Seconds since the last touch, or None when never touched."""
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            return None
        return max(0.0, time.time() - mtime)


class ThreadHeartbeat:
    """In-process heartbeat of a thread watchdog: the dispatch thread
    touches it at phase boundaries, the watchdog reads the age. Monotonic
    by default; `clock` is injectable for tests. It carries the same
    optional phase label as the file Heartbeat."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._clock = clock or time.monotonic
        self._mu = threading.Lock()
        self._last: Optional[float] = None
        self._label = ""

    def touch(self, label: Optional[str] = None) -> None:
        with self._mu:
            self._last = self._clock()
            if label is not None:
                self._label = label

    def label(self) -> str:
        with self._mu:
            return self._label

    def age(self) -> Optional[float]:
        with self._mu:
            if self._last is None:
                return None
            return max(0.0, self._clock() - self._last)


# the thread-local binding: the watchdog binds a heartbeat into its worker
# thread, deep call sites touch it; unbound threads touch nothing
_TLS = threading.local()

# the process heartbeat of a supervised worker process (solver/host.py's
# child), registered once at boot; None (the default) costs one global read
_PROCESS_HB = None


def set_process_heartbeat(hb) -> None:
    """Register a process-wide heartbeat (anything with touch(label)) that
    every touch_heartbeat() also touches; None unregisters."""
    global _PROCESS_HB
    _PROCESS_HB = hb


def process_heartbeat():
    return _PROCESS_HB


def bind_heartbeat(hb: Optional[ThreadHeartbeat]) -> None:
    _TLS.heartbeat = hb


def touch_heartbeat(label: Optional[str] = None) -> None:
    hb = getattr(_TLS, "heartbeat", None)
    if hb is not None:
        hb.touch(label)
    if _PROCESS_HB is not None:
        _PROCESS_HB.touch(label)


def bound_heartbeat() -> Optional[ThreadHeartbeat]:
    return getattr(_TLS, "heartbeat", None)


# the least seconds between two progress touches of one thread
PROGRESS_EVERY_S = 0.5


def touch_progress() -> None:
    """A long loop's proof of life between two phase marks (the pack
    scan's items): touch the heartbeats, label kept, at most every
    PROGRESS_EVERY_S on this thread. A scan slowed by a loaded host keeps
    its heartbeat fresh; a stopped one goes stale at the watchdog's
    threshold as before. Costs one monotonic read between touches."""
    now = time.monotonic()
    if now - getattr(_TLS, "progress_at", 0.0) >= PROGRESS_EVERY_S:
        _TLS.progress_at = now
        touch_heartbeat()


# -- a worker's output: redaction, tails, atomic writes ---------------------

_SENSITIVE_MARKERS = ("KEY", "TOKEN", "SECRET", "PASSWORD", "CREDENTIAL", "AUTH",
                      "COOKIE")


def redact_env_text(text: str, environ: Optional[Dict[str, str]] = None) -> str:
    """Scrub environment values out of a worker's captured output: the
    value of every variable whose name looks sensitive becomes
    ``<redacted:NAME>``. Values under 6 characters are kept (too short to
    be a secret, too likely to match ordinary text)."""
    if environ is None:
        from karpenter_core_tpu_torch.obs import envflags

        environ = envflags.environ()
    for name, value in environ.items():
        if not value or len(value) < 6:
            continue
        if any(marker in name.upper() for marker in _SENSITIVE_MARKERS):
            text = text.replace(value, f"<redacted:{name}>")
    return text


def tail_bytes_of(path: str, n: int = 8192) -> str:
    """The last n bytes of a file, decoded leniently ('' when unreadable)."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            if size > n:
                f.seek(size - n)
            return f.read(n).decode("utf-8", errors="replace")
    except OSError:
        return ""


def atomic_write_json(path: str, payload: Dict[str, object]) -> None:
    """Write-temp, fsync, rename in the destination's directory: a reader
    never sees a partial file, and a crash leaves the previous one."""
    directory = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-", suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# -- the process-group runner ---------------------------------------------------


@dataclass
class SuperviseResult:
    """One supervised command's outcome, after any restarts. `wedged` (the
    heartbeat went stale: killed early) and `timed_out` (the wall budget
    ran out while the heartbeat was fresh: slow, not hung) are distinct;
    `phase` is the heartbeat's last label at the kill, `attempts` each
    attempt's note, `environ` the worker's environment (the redaction's
    source: a secret only the worker had must not leak through the
    tails)."""

    ok: bool = False
    rc: Optional[int] = None
    wedged: bool = False
    timed_out: bool = False
    restarts: int = 0
    duration_s: float = 0.0
    stdout: str = ""
    stdout_tail: str = ""
    stderr_tail: str = ""
    note: str = ""
    phase: str = ""
    attempts: List[str] = field(default_factory=list)
    environ: Optional[Dict[str, str]] = None

    def wedge_log(self) -> Dict[str, object]:
        """The post-mortem a degraded artifact carries: the kill's
        classification and each stream's tail, redacted."""
        return {
            "note": self.note,
            "wedged": self.wedged,
            "timed_out": self.timed_out,
            "rc": self.rc,
            "restarts": self.restarts,
            "phase": self.phase,
            "stdout_tail": redact_env_text(self.stdout_tail, self.environ),
            "stderr_tail": redact_env_text(self.stderr_tail, self.environ),
        }


def _kill_group(proc: subprocess.Popen) -> None:
    """SIGKILL the child's whole process group: a grandchild that outlived
    the child dies with it."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    try:
        proc.wait(timeout=30)
    except (subprocess.TimeoutExpired, OSError):
        pass


def _run_once(cmd: Sequence[str], env: Optional[Dict[str, str]], timeout_s: float,
              heartbeat: Optional[Heartbeat], stale_after_s: Optional[float], poll_s: float,
              tail_n: int, workdir: str,
              on_output: Optional[Callable[[str], None]]) -> SuperviseResult:
    """One attempt: the command in a new session (its own process group),
    its streams into `workdir`, polled every `poll_s` until it exits, its
    heartbeat goes stale (a heartbeat never touched counts from the start)
    or `timeout_s` passes; the group killed on the way out."""
    out_path = os.path.join(workdir, "stdout")
    err_path = os.path.join(workdir, "stderr")
    res = SuperviseResult(environ=env)
    start = time.monotonic()
    with open(out_path, "wb") as out_f, open(err_path, "wb") as err_f:
        proc = subprocess.Popen(list(cmd), stdout=out_f, stderr=err_f, env=env,
                                start_new_session=True)
        deadline = start + timeout_s
        echoed = 0
        try:
            while True:
                try:
                    res.rc = proc.wait(timeout=poll_s)
                    res.ok = res.rc == 0
                    res.note = f"rc={res.rc}"
                    break
                except subprocess.TimeoutExpired:
                    pass
                if on_output is not None:
                    echoed = _echo_new(err_path, echoed, on_output)
                now = time.monotonic()
                hb_age = heartbeat.age() if heartbeat is not None else None
                stale = hb_age if hb_age is not None else now - start
                if stale_after_s is not None and heartbeat is not None \
                        and stale >= stale_after_s:
                    res.wedged = True
                    res.phase = heartbeat.read_label()
                    res.note = (f"wedged: heartbeat stale for {stale:.0f}s (threshold "
                                f"{stale_after_s:.0f}s)"
                                + (f" during {res.phase}" if res.phase else "")
                                + "; process group killed")
                    _kill_group(proc)
                    res.rc = proc.poll()
                    break
                if now >= deadline:
                    res.timed_out = True
                    if heartbeat is not None:
                        res.phase = heartbeat.read_label()
                    res.note = (f"timed out: still alive at {timeout_s:.0f}s budget "
                                "(heartbeat fresh: slow, not wedged); process group killed")
                    _kill_group(proc)
                    res.rc = proc.poll()
                    break
        finally:
            if proc.poll() is None:
                _kill_group(proc)
    if on_output is not None:
        _echo_new(err_path, echoed, on_output)
    res.duration_s = time.monotonic() - start
    res.stdout = _read_text(out_path)
    res.stdout_tail = res.stdout[-tail_n:]
    res.stderr_tail = tail_bytes_of(err_path, tail_n)
    return res


def _echo_new(path: str, offset: int, on_output: Callable[[str], None]) -> int:
    """Hand what was appended to `path` since `offset` to `on_output` (a
    worker's stderr, live); returns the new offset."""
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            chunk = f.read()
    except OSError:
        return offset
    if chunk:
        on_output(chunk.decode("utf-8", errors="replace"))
    return offset + len(chunk)


def _read_text(path: str) -> str:
    try:
        with open(path, "rb") as f:
            return f.read().decode("utf-8", errors="replace")
    except OSError:
        return ""


def run_supervised(cmd: Sequence[str], *, env: Optional[Dict[str, str]] = None,
                   timeout_s: float, heartbeat_path: Optional[str] = None,
                   stale_after_s: Optional[float] = None, poll_s: float = 0.25,
                   max_restarts: int = 0, backoff_base_s: float = 1.0,
                   backoff_max_s: float = 30.0, tail_n: int = 8192,
                   on_output: Optional[Callable[[str], None]] = None,
                   sleep: Callable[[float], None] = time.sleep) -> SuperviseResult:
    """Run `cmd` in its own process group under a hard-kill watchdog.

    `timeout_s` is the wall budget of all attempts together: a worker
    still alive at it is slow and killed (`timed_out`). With
    `heartbeat_path`, a heartbeat older than `stale_after_s`, or never
    touched within it, is a wedge and kills the group early (`wedged`).
    A failed attempt (non-zero rc, wedge, timeout) restarts up to
    `max_restarts` times after a backoff doubling from `backoff_base_s`,
    capped at `backoff_max_s`. Each attempt starts with its heartbeat file
    removed, so an earlier attempt's touches cannot hide a new wedge.
    Returns the last attempt's result, with `restarts` and every
    attempt's note."""
    attempts: List[str] = []
    total_start = time.monotonic()
    last: Optional[SuperviseResult] = None
    for attempt in range(max_restarts + 1):
        remaining = timeout_s - (time.monotonic() - total_start)
        if attempt > 0 and remaining <= 0:
            break
        hb = None
        if heartbeat_path is not None:
            try:
                os.unlink(heartbeat_path)
            except OSError:
                pass
            hb = Heartbeat(heartbeat_path)
        with tempfile.TemporaryDirectory(prefix="kct-supervise-") as workdir:
            last = _run_once(cmd, env, min(timeout_s, max(1.0, remaining)), hb,
                             stale_after_s, poll_s, tail_n, workdir, on_output)
        last.restarts = attempt
        attempts.append(f"attempt {attempt + 1}: {last.note}")
        last.attempts = list(attempts)
        if last.ok:
            break
        if attempt < max_restarts:
            sleep(min(backoff_max_s, backoff_base_s * (2 ** attempt)))
    assert last is not None  # max_restarts >= 0: one attempt at least
    last.duration_s = time.monotonic() - total_start
    return last


# -- resumable artifacts ----------------------------------------------------------


def config_digest(config: Dict[str, object]) -> str:
    """A unit of work's content key: the sha256 of its configuration's
    canonical JSON (16 hex digits). An artifact is fresh only for the
    configuration that made it."""
    canon = json.dumps(config, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


class ArtifactStore:
    """One JSON artifact per unit of work (a bench stage) under `root`,
    written atomically as the unit finishes and keyed by its config
    digest. A record:

        {"stage", "config_digest", "degraded", "fallback", "error",
         "wedge_log", "meta", "data"}

    `degraded`: the unit made no data (a wedge, a crash, the budget), and
    a resume runs it again. `fallback`: complete data, made on a fallback
    backend; the caller decides whether that will do."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def path(self, stage: str) -> str:
        return os.path.join(self.root, f"{stage}.json")

    def save(self, stage: str, config: Dict[str, object], data: Optional[Dict[str, object]],
             *, degraded: bool = False, fallback: bool = False, error: Optional[str] = None,
             wedge_log: Optional[Dict[str, object]] = None,
             meta: Optional[Dict[str, object]] = None) -> Dict[str, object]:
        record: Dict[str, object] = {
            "stage": stage,
            "config_digest": config_digest(config),
            "degraded": bool(degraded),
            "fallback": bool(fallback),
            "error": error,
            "wedge_log": wedge_log,
            "meta": meta or {},
            "data": data,
        }
        atomic_write_json(self.path(stage), record)
        return record

    def load(self, stage: str) -> Optional[Dict[str, object]]:
        """The stage's record; None when missing, unreadable or another
        stage's."""
        try:
            with open(self.path(stage)) as f:
                record = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(record, dict) or record.get("stage") != stage:
            return None
        return record

    def fresh(self, stage: str, config: Dict[str, object]) -> Optional[Dict[str, object]]:
        """The record when it was made for this config and is not
        degraded (a fallback record included)."""
        record = self.load(stage)
        if record is None or record.get("config_digest") != config_digest(config):
            return None
        if record.get("degraded"):
            return None
        return record

    def stages(self) -> List[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(n[:-len(".json")] for n in names
                      if n.endswith(".json") and not n.startswith("."))


# -- TTL'd health verdicts ----------------------------------------------------------


def write_verdict(path: str, ok: bool, note: str = "", ttl_s: float = 300.0,
                  extra: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    """Publish a health verdict atomically, stamped with the wall clock:
    its readers are other processes, and the filesystem's clock is the one
    they share."""
    verdict: Dict[str, object] = {"ok": bool(ok), "note": note, "ts": time.time(),
                                  "ttl_s": float(ttl_s)}
    if extra:
        verdict.update(extra)
    atomic_write_json(path, verdict)
    return verdict


def read_verdict(path: str) -> Optional[Dict[str, object]]:
    """The verdict; None when missing, unreadable or past its TTL (a stale
    verdict is none: its daemon may be wedged)."""
    try:
        with open(path) as f:
            verdict = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(verdict, dict):
        return None
    try:
        age = time.time() - float(verdict["ts"])
        ttl = float(verdict["ttl_s"])
    except (KeyError, TypeError, ValueError):
        return None
    if age > ttl:
        return None
    return verdict
