"""An Eraser lockset detector over the port's threads: a field that two
threads touch under no common lock (the reference package's
testing/racewatch.py; upstream's `go test -race`).

testing/lockwatch.py finds acquisition-order inversions; this module finds
the plain data race, with Eraser's algorithm (Savage et al., SOSP '97)
over the same proxies:

  * Discovery: every lock the port allocates while lockwatch is installed
    is a TrackedLock. An allocation hook looks at the allocating frame,
    and when it is a method of a class of the port (`self` among its
    locals), instruments that class: a class that owns a lock has state
    that threads share.
  * Instrumentation wraps the class's `__setattr__` and
    `__getattribute__`. A read is recorded only for names written on a
    tracked instance before, so a method lookup costs one set test.
  * Per (instance, field), Eraser's states:

        virgin -> exclusive (one thread so far: construction and
                  single-threaded use never report)
               -> shared (read by a second thread: the candidate lockset
                  starts as the reader's held locks and is intersected at
                  each access; empty here is no report, as sharing after
                  initialisation is read-only)
               -> shared-modified (written while shared, or by a second
                  thread: the first empty intersection is the race,
                  reported once with both accesses' stacks)

    The held sets are lockwatch's lock instances, so that two locks of
    one allocation site do not count as one.
  * Bounds: track every `sample`-th instance of a class, and record at
    most `access_cap` accesses per field (0: no cap).

The package filters take whole path components and dotted module
prefixes: the port's `karpenter_core_tpu_torch` is not a part of the
reference's `karpenter_core_tpu`, and the reference's looser substring
and prefix tests would claim it. `arm()` installs GLOBAL, which rides
lockwatch.GLOBAL and records accesses made from the port's own frames
only (a test reading a field after join() is ordered by the join, which
Eraser cannot see).

A benign race is suppressed by `suppress("Class.field", reason)`,
centrally and with its reason, never at the call site. The suppression
table below re-audits each of the reference's entries against the port's
class of that name.
"""
from __future__ import annotations

import os
import sys
import threading
import weakref
from typing import Dict, FrozenSet, List, Optional, Tuple

from karpenter_core_tpu_torch.testing import lockwatch

_allocate_lock = threading._allocate_lock

_PKG_NAME = "karpenter_core_tpu_torch"
_PKG_ROOT = os.path.dirname(lockwatch._PKG_DIR)

VIRGIN = 0  # implicit: no entry yet
EXCLUSIVE = 1
SHARED = 2
SHARED_MODIFIED = 3

_STATE_NAMES = {EXCLUSIVE: "exclusive", SHARED: "shared", SHARED_MODIFIED: "shared-modified"}


def in_package_module(module: str) -> bool:
    """Whether a module name is the port's package or one of its modules."""
    return module == _PKG_NAME or module.startswith(_PKG_NAME + ".")


def _is_watcher_file(filename: str) -> bool:
    base = os.path.basename(filename)
    return base in ("lockwatch.py", "racewatch.py")


def _pkg_stack(skip: int, limit: int = 4) -> Tuple[str, ...]:
    """Up to `limit` of the port's frames above `skip`, innermost first:
    the provenance a race report renders."""
    out: List[str] = []
    depth = skip
    while len(out) < limit:
        try:
            frame = sys._getframe(depth)
        except ValueError:
            break
        depth += 1
        filename = frame.f_code.co_filename
        if lockwatch.in_package(filename) and not _is_watcher_file(filename):
            rel = os.path.relpath(filename, _PKG_ROOT)
            out.append(f"{rel}:{frame.f_lineno} in {frame.f_code.co_name}")
        elif out:
            break  # out of the package: the suffix that matters is complete
        if depth > skip + 14:
            break
    return tuple(out)


class _Access:
    """One recorded access: which thread, where, holding what."""

    __slots__ = ("thread", "op", "stack", "held")

    def __init__(self, op: str, held: FrozenSet[int]) -> None:
        self.thread = threading.current_thread().name
        self.op = op
        self.stack = _pkg_stack(skip=4)
        self.held = held

    def render(self, watch: "RaceWatch") -> str:
        locks = ", ".join(sorted(watch._lockwatch.site_of_uid(u) for u in self.held)) or "no locks"
        where = " <- ".join(self.stack) or "<non-package frame>"
        return f"{self.op} by thread '{self.thread}' holding [{locks}] at {where}"


class _FieldState:
    __slots__ = ("state", "owner", "lockset", "accesses", "last_write", "last_access",
                 "reported")

    def __init__(self, owner_thread_id: int) -> None:
        self.state = EXCLUSIVE
        self.owner = owner_thread_id
        self.lockset: Optional[FrozenSet[int]] = None
        self.accesses = 0
        self.last_write: Optional[_Access] = None
        self.last_access: Optional[_Access] = None
        self.reported = False


class Race:
    """A candidate race: a field whose lockset emptied while
    shared-modified, with the two accesses that show it."""

    def __init__(self, cls_name: str, field: str, prior: Optional[_Access],
                 current: _Access, state: int) -> None:
        self.key = f"{cls_name}.{field}"
        self.cls_name = cls_name
        self.field = field
        self.prior = prior
        self.current = current
        self.state = state

    def render(self, watch: "RaceWatch") -> str:
        lines = [f"candidate race on {self.key} "
                 f"(state {_STATE_NAMES.get(self.state, self.state)}, "
                 "candidate lockset empty):"]
        if self.prior is not None:
            lines.append(f"    prior:   {self.prior.render(watch)}")
        lines.append(f"    current: {self.current.render(watch)}")
        return "\n".join(lines)


class RaceWatch:
    """The lockset detector over the lock-owning classes of the port."""

    def __init__(self, lock_watch: Optional[lockwatch.LockWatch] = None, sample: int = 1,
                 access_cap: int = 128, class_filter=None, access_filter=None) -> None:
        self._mu = _allocate_lock()
        self._lockwatch = lock_watch or lockwatch.LockWatch()
        self.sample = max(1, int(sample))
        self.access_cap = int(access_cap)  # <= 0: no cap
        self._class_filter = class_filter or _default_class_filter
        # fn(filename) -> whether an access from that frame is recorded;
        # None records every access (tests drive the states from their
        # own frames)
        self._access_filter = access_filter
        self._instrumented: Dict[type, Tuple[object, object]] = {}  # the originals
        self._alloc_counts: Dict[type, int] = {}  # for `sample`
        # id(obj) -> {field: _FieldState}; a weakref callback retires the
        # entry, so a recycled id does not inherit a dead object's states
        self._objects: Dict[int, Dict[str, _FieldState]] = {}
        self._object_refs: Dict[int, weakref.ref] = {}
        # a weakref callback can fire while this thread holds self._mu, so
        # it only appends here; _note drains under the lock
        self._dead: List[int] = []
        # per class, the names ever written on a tracked instance: the
        # read path records only these
        self._fields_of: Dict[type, set] = {}
        self._races: List[Race] = []
        self._suppressed_hits: Dict[str, int] = {}
        self.suppressions: Dict[str, str] = {}  # "Class.field" -> reason
        self._installed = False
        self.tracked_instances = 0
        self.recorded_accesses = 0

    # -- wiring --------------------------------------------------------------------

    def install(self) -> "RaceWatch":
        """Hook the lock allocations (idempotent). The LockWatch installs
        on its own, first."""
        with self._mu:
            if self._installed:
                return self
            self._installed = True
        self._lockwatch.add_allocation_hook(self._on_lock_allocated)
        return self

    def uninstall(self) -> None:
        """Unhook, restore every instrumented class's attribute protocol,
        and drop the tracked objects' states (a wrapper a subclass copied
        stays, inert over an empty table). The races found stay readable."""
        with self._mu:
            instrumented = dict(self._instrumented)
            self._instrumented.clear()
            self._objects.clear()
            self._object_refs.clear()
            self._installed = False
        self._lockwatch.remove_allocation_hook(self._on_lock_allocated)
        for cls, (orig_set, orig_get) in instrumented.items():
            cls.__setattr__ = orig_set
            cls.__getattribute__ = orig_get

    @property
    def installed(self) -> bool:
        return self._installed

    def suppress(self, key: str, reason: str) -> None:
        """Mark `Class.field` as an audited benign race."""
        self.suppressions[key] = reason

    # -- discovery -----------------------------------------------------------------

    def _on_lock_allocated(self, lock, frame) -> None:
        if frame is None:
            return
        owner = frame.f_locals.get("self")
        if owner is None:
            return
        cls = type(owner)
        if not self._class_filter(cls):
            return
        self._instrument_class(cls)
        with self._mu:
            n = self._alloc_counts.get(cls, 0)
            self._alloc_counts[cls] = n + 1
            if n % self.sample:
                return
        self.track_instance(owner)

    def track_instance(self, obj) -> None:
        """Track `obj` (tests seed interleavings so; the allocation hook is
        the usual way in), instrumenting its class if need be."""
        cls = type(obj)
        self._instrument_class(cls)
        oid = id(obj)
        dead = self._dead
        try:
            # the callback must not take self._mu (see _dead)
            ref = weakref.ref(obj, lambda _r, oid=oid: dead.append(oid))
        except TypeError:
            return  # no weakref: tracking would keep the object alive
        with self._mu:
            # retire the dead first: this very instance may have a dead
            # object's id, whose entry would swallow the registration
            if self._dead:
                self._drain_dead_locked()
            if oid in self._objects:
                return
            self._objects[oid] = {}
            self._object_refs[oid] = ref
            self.tracked_instances += 1

    def _drain_dead_locked(self) -> None:
        while self._dead:
            oid = self._dead.pop()
            self._objects.pop(oid, None)
            self._object_refs.pop(oid, None)

    def _instrument_class(self, cls: type) -> None:
        with self._mu:
            if cls in self._instrumented:
                return
            orig_set = cls.__setattr__
            orig_get = cls.__getattribute__
            if (getattr(orig_set, "__racewatch__", None) is self
                    or getattr(orig_get, "__racewatch__", None) is self):
                # a subclass inherits an instrumented base's wrappers: a
                # second wrap would record each access twice
                return
            self._instrumented[cls] = (orig_set, orig_get)
            fields = self._fields_of.setdefault(cls, set())
        watch = self
        objects = self._objects

        def __setattr__(obj, name, value, _orig=orig_set):
            _orig(obj, name, value)
            states = objects.get(id(obj))
            if states is not None:
                fields.add(name)
                watch._note(obj, states, name, "write")

        def __getattribute__(obj, name, _orig=orig_get):
            value = _orig(obj, name)
            if name in fields:
                states = objects.get(id(obj))
                if states is not None:
                    watch._note(obj, states, name, "read")
            return value

        __setattr__.__racewatch__ = watch
        __getattribute__.__racewatch__ = watch
        cls.__setattr__ = __setattr__
        cls.__getattribute__ = __getattribute__

    # -- the state machine ---------------------------------------------------------

    def _note(self, obj, states: Dict[str, _FieldState], field: str, op: str) -> None:
        if self._access_filter is not None and not self._access_filter(
                sys._getframe(2).f_code.co_filename):
            return
        tid = threading.get_ident()
        with self._mu:
            if self._dead:
                self._drain_dead_locked()
            if self._objects.get(id(obj)) is not states:
                return  # raced a retirement, or a recycled id's stale entry
            st = states.get(field)
            if st is None:
                states[field] = st = _FieldState(tid)
            if st.reported or (self.access_cap > 0 and st.accesses >= self.access_cap):
                return
            st.accesses += 1
            self.recorded_accesses += 1
            held = self._lockwatch.held_lock_uids()
            acc = _Access(op, held)
            if st.state == EXCLUSIVE:
                if tid != st.owner:
                    st.state = SHARED if op == "read" else SHARED_MODIFIED
                    st.lockset = held
            else:
                st.lockset = held if st.lockset is None else st.lockset & held
                if op == "write" and st.state == SHARED:
                    st.state = SHARED_MODIFIED
            if (st.state == SHARED_MODIFIED and st.lockset is not None and not st.lockset
                    and not st.reported):
                st.reported = True
                self._report(obj, field, st, acc)
            if op == "write":
                st.last_write = acc
            st.last_access = acc

    def _report(self, obj, field: str, st: _FieldState, acc: _Access) -> None:
        cls_name = type(obj).__name__
        key = f"{cls_name}.{field}"
        if key in self.suppressions:
            self._suppressed_hits[key] = self._suppressed_hits.get(key, 0) + 1
            return
        if any(r.key == key for r in self._races):
            return  # one report per (class, field)
        prior = st.last_write if acc.op == "read" else (st.last_write or st.last_access)
        self._races.append(Race(cls_name, field, prior, acc, st.state))

    # -- reports -------------------------------------------------------------------

    def races(self) -> List[Race]:
        with self._mu:
            return list(self._races)

    def report(self) -> str:
        races = self.races()
        if not races:
            return "racewatch: no candidate data races"
        lines = [f"racewatch: {len(races)} candidate data race(s) — field(s) "
                 "accessed by multiple threads under no common lock:"]
        for race in races:
            lines.append("  " + race.render(self).replace("\n", "\n  "))
        return "\n".join(lines)

    def instrumented_classes(self) -> List[str]:
        """`module.Class` of every class instrumented now."""
        with self._mu:
            return sorted(f"{c.__module__}.{c.__qualname__}" for c in self._instrumented)

    def stats(self) -> Dict[str, object]:
        with self._mu:
            return {
                "tracked_classes": len(self._instrumented),
                "tracked_instances": self.tracked_instances,
                "recorded_accesses": self.recorded_accesses,
                "races": len(self._races),
                "suppressed_hits": dict(self._suppressed_hits),
                "sample": self.sample,
                "access_cap": self.access_cap,
            }

    def reset(self) -> None:
        with self._mu:
            self._races.clear()
            self._suppressed_hits.clear()
            for states in self._objects.values():
                states.clear()


def _default_class_filter(cls: type) -> bool:
    """The port's classes only, and never the watchers' own."""
    module = getattr(cls, "__module__", "") or ""
    if not in_package_module(module):
        return False
    return not module.endswith((".lockwatch", ".racewatch"))


def _pkg_access_filter(filename: str) -> bool:
    """Record the accesses made from the port's source only: a test's
    frames are often ordered by a thread's start or join, which Eraser
    cannot see."""
    return lockwatch.in_package(filename)


GLOBAL = RaceWatch(lock_watch=lockwatch.GLOBAL, access_filter=_pkg_access_filter)

# The audited benign races. Each reference entry was checked against the
# port's class of that name: in each, the field is a latch written under
# the owner's lock (configure/enable/disable) and read without it on a hot
# path where a lock per call would cost; an attribute load is atomic, and
# a stale read mis-gates one record, never corrupts state.
SUPPRESSIONS = {
    "LogSink.level": (
        "the hot-path gate compared at every log call before anything is built; "
        "configure() and disable() write it under LogSink._mu; a stale level "
        "mis-gates one record"),
    "LogSink.fmt": (
        "the render format, written under LogSink._mu by configure(), read "
        "without it in emit(); a stale read renders one record in the old format"),
    "LogSink.stream": (
        "the line sink, written under LogSink._mu by configure() and disable(); "
        "emit() reads it once into a local before use"),
    "FlightRecorder.enabled": (
        "the latch read once per solve (disabled costs one flag check); enable() "
        "and disable() write it under FlightRecorder._mu; a stale read records or "
        "skips one solve at the boundary"),
    "FlightRecorder.dump_dir": (
        "written under FlightRecorder._mu by enable(), read when a record is "
        "dumped; dumps are best-effort"),
    "Tracer.enabled": (
        "the tracer's one-flag gate, read at every span(), add_span() and "
        "instant() and per host dispatch; enable() and disable() write it under "
        "Tracer._mu; a stale read records or skips one span at the boundary"),
}
for _key, _reason in SUPPRESSIONS.items():
    GLOBAL.suppress(_key, _reason)


def arm(spec: str = "", default_on: bool = True, sample: str = "", cap: str = "") -> bool:
    """Install GLOBAL per a KARPENTER_RACEWATCH-style spec (lockwatch.arm's
    spellings); `sample` and `cap` are the raw strings of the sampling
    knob and the access cap. The caller reads the environment, and arms
    lockwatch.GLOBAL first."""
    spec = (spec or "").strip().lower()
    if spec in ("0", "false", "off", "no"):
        return False
    if not (spec in ("1", "true", "on", "yes") or default_on):
        return False
    try:
        GLOBAL.sample = max(1, int(sample)) if sample.strip() else GLOBAL.sample
    except ValueError:
        pass
    try:
        GLOBAL.access_cap = int(cap) if cap.strip() else GLOBAL.access_cap
    except ValueError:
        pass
    GLOBAL.install()
    return True
