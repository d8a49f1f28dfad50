"""Heartbeats: the wedge signal of the dispatch watchdog.

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

Stdlib only: the supervisor must keep working when the device stack is
wedged.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Callable, Dict, Optional


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
