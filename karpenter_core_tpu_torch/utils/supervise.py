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
    touch is one thread-local read.

Stdlib only: the supervisor must keep working when the device stack is
wedged.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional


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


def bind_heartbeat(hb: Optional[ThreadHeartbeat]) -> None:
    _TLS.heartbeat = hb


def touch_heartbeat(label: Optional[str] = None) -> None:
    hb = getattr(_TLS, "heartbeat", None)
    if hb is not None:
        hb.touch(label)


def bound_heartbeat() -> Optional[ThreadHeartbeat]:
    return getattr(_TLS, "heartbeat", None)
