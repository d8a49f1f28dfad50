"""Cyclic-GC deferral for latency-critical windows (a Solve).

A gen-2 collection that lands inside a solve scans every live object of
the batch and the cluster (tens of thousands of pods) and stalls that
solve for a second or more. `gc_paused()` turns cyclic collection off for
the window; reference counting still frees acyclic garbage at once, and
cyclic garbage waits for the window to close.

Windows nest and may overlap across threads: a process-wide depth counter
re-enables collection only when the last window closes. The deferral is
bounded at both ends: a window that exits while others have kept
collection off for longer than MAX_DEFERRED_SPAN_S runs one collection,
and a window that OPENS while the open ones are older than that treats
them as abandoned (a solve thread that died inside its window would
otherwise leave collection off for good): it restores collection, runs a
collection, and starts a fresh span. The exit of an abandoned window
changes nothing.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time

# past this span of continuous deferral, a window's exit collects and a
# window's entry restarts the span
MAX_DEFERRED_SPAN_S = 30.0

_monotonic = time.monotonic  # the clock the span is measured on
_lock = threading.Lock()
_depth = 0
_epoch = 0  # bumped when open windows are abandoned
_reenable = False  # whether collection was on when the span began
_since = 0.0  # when the current span began


@contextlib.contextmanager
def gc_paused():
    """Defer cyclic garbage collection for the enclosed window."""
    global _depth, _epoch, _reenable, _since
    collect_now = False
    with _lock:
        now = _monotonic()
        if _depth > 0 and now - _since > MAX_DEFERRED_SPAN_S:
            # the open windows are stale: abandon them, restore collection
            # and collect before this window starts its own span
            _epoch += 1
            _depth = 0
            if _reenable:
                gc.enable()
            collect_now = True
        if _depth == 0:
            _reenable = gc.isenabled()
            _since = now
            gc.disable()
        _depth += 1
        epoch = _epoch
    if collect_now:
        # outside the lock, as on exit: a collection takes seconds over the
        # cluster, and a finalizer may open a window of its own
        gc.collect()
    try:
        yield
    finally:
        collect_now = False
        with _lock:
            if epoch == _epoch:
                _depth -= 1
                if _depth == 0:
                    if _reenable:
                        gc.enable()
                elif _monotonic() - _since > MAX_DEFERRED_SPAN_S:
                    # overlapping windows have kept collection off too long
                    _since = _monotonic()
                    collect_now = True
        if collect_now:
            gc.collect()


def depth() -> int:
    """The number of open windows (0 when collection is not deferred)."""
    with _lock:
        return _depth
