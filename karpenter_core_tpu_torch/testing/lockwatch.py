"""The lock-order graph of the port's threads: a potential deadlock found
without having to hit it (the runtime half of the reference package's
concurrency checks, testing/lockwatch.py there; upstream gets it from its
`-race` presubmit).

`install()` replaces `threading.Lock` and `threading.RLock` with factories
that wrap each lock allocated from the port's own source in a TrackedLock
(the allocating frame's file decides, as a whole path component under
`karpenter_core_tpu_torch/`: the standard library's, torch's, the tests'
and the reference package's locks pass through as they are). Each proxy
records, per thread, the stack of lock sites held (a site is the
allocation's file:line, so the locks of one site pool); taking B while
holding A adds the edge A -> B with a witness. A cycle in the site graph
is an inversion: two paths that take the same locks in opposite orders,
and a deadlock under the right interleaving.

A watcher wraps whatever `threading.Lock` is when it installs, and
`uninstall()` puts exactly that back: installed over another watcher (the
reference's, which its test session arms), it must be uninstalled first,
and uninstall() refuses when a later patch sits on top of it. While one is
installed over the reference's, the reference's watcher sees every lock as
allocated from this module, so it tracks none.

A lock only becomes tracked if it is allocated after install(): the
port's module-level locks (the registry's, the tracer's, chaos's) exist
from import on, so a gate over the port arms in a fresh interpreter
before importing them (tests/test_torch_racegate.py). `arm()` installs
the module's GLOBAL watcher; standalone LockWatch instances can make
tracked locks with make_lock() without touching `threading`.

Reentrant acquisition never adds an edge, nor do two locks of one site
held together in either order: per-instance locks (one per watch, per
solver) have no global order, and flagging them would drown the real
inversions.
"""
from __future__ import annotations

import itertools
import os
import sys
import threading
from typing import Callable, Dict, FrozenSet, List, Optional, Set, Tuple

# the watcher's own lock must never be a proxy: the raw primitive
_allocate_lock = threading._allocate_lock

# a lock's identity for locksets: id() is recycled after a collection,
# a counter is not
_uid_counter = itertools.count(1)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF = os.path.abspath(__file__)


def in_package(filename: str) -> bool:
    """Whether `filename` lies under the port's package directory (a whole
    path component: the reference's `karpenter_core_tpu/` is a prefix of
    this package's name, not a parent of its files)."""
    return os.path.abspath(filename).startswith(_PKG_DIR + os.sep)


def _default_filter(filename: str) -> bool:
    """Track the locks allocated from the port's source, but this
    module's."""
    return in_package(filename) and os.path.abspath(filename) != _SELF


class _Acquisition:
    __slots__ = ("site", "count", "uids")

    def __init__(self, site: str, uid: int) -> None:
        self.site = site
        self.count = 1
        # the lock instances held under this site (siblings of one site
        # pool into one entry; racewatch's locksets need the instances)
        self.uids = [uid]


class TrackedLock:
    """A proxy over a real lock that records ordering edges."""

    def __init__(self, watch: "LockWatch", inner, site: str) -> None:
        self._watch = watch
        self._inner = inner
        self._site = site
        self._uid = next(_uid_counter)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._watch._note_acquire(self)
        return got

    __enter__ = acquire

    def release(self) -> None:
        self._inner.release()
        self._watch._note_release(self)

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # threading.Condition over a tracked RLock
    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        state = self._inner._release_save()
        self._watch._note_release(self, full=True)
        return state

    def _acquire_restore(self, state) -> None:
        self._inner._acquire_restore(state)
        self._watch._note_acquire(self)

    def _at_fork_reinit(self) -> None:
        self._inner._at_fork_reinit()

    def __repr__(self) -> str:
        return f"<TrackedLock site={self._site} inner={self._inner!r}>"


class LockWatch:
    """The acquisition-order graph over lock allocation sites."""

    def __init__(self, track_filter=None) -> None:
        self._mu = _allocate_lock()
        self._filter = track_filter or _default_filter
        self._local = threading.local()
        self._edges: Dict[str, Dict[str, str]] = {}  # site -> site -> witness
        self._sites: Set[str] = set()
        self._installed = False
        self._orig_lock = None
        self._orig_rlock = None
        self._factories: Tuple[object, object] = (None, None)
        self._uid_sites: Dict[int, str] = {}  # uid -> site, for reports
        # uids released on a thread that never took them (a lock handed
        # between threads like a semaphore): the taker's stack would keep
        # the entry forever and poison edges and locksets, so every thread
        # drops a tainted uid from its stack and it is never trusted again
        self._tainted_uids: Set[int] = set()
        # fn(lock, frame) for every tracked allocation: racewatch finds the
        # owning instance (the allocating frame's `self`) here
        self._alloc_hooks: List[Callable] = []

    # -- allocation ----------------------------------------------------------------

    def make_lock(self, site: Optional[str] = None, rlock: bool = False):
        """A tracked lock, allocated explicitly (tests, tools)."""
        inner = (self._orig_rlock or threading.RLock)() if rlock else (
            (self._orig_lock or threading.Lock)())
        if isinstance(inner, TrackedLock):  # the global patch is live
            inner = inner._inner
        site = site or self._caller_site(depth=2)
        lock = TrackedLock(self, inner, site)
        with self._mu:
            self._sites.add(site)
            self._uid_sites[lock._uid] = site
        self._run_alloc_hooks(lock, sys._getframe(1))
        return lock

    @staticmethod
    def _caller_site(depth: int) -> str:
        frame = sys._getframe(depth)
        return f"{frame.f_code.co_filename}:{frame.f_lineno}"

    def _factory(self, orig, kind: str):
        watch = self

        def allocate():
            inner = orig()
            frame = sys._getframe(1)
            if not watch._filter(frame.f_code.co_filename):
                return inner
            rel = os.path.relpath(frame.f_code.co_filename, os.path.dirname(_PKG_DIR))
            site = f"{rel}:{frame.f_lineno}"
            lock = TrackedLock(watch, inner, site)
            with watch._mu:
                watch._sites.add(site)
                watch._uid_sites[lock._uid] = site
            watch._run_alloc_hooks(lock, frame)
            return lock

        allocate.__name__ = kind
        return allocate

    def add_allocation_hook(self, hook: Callable) -> None:
        """Call fn(lock, frame) for every tracked allocation; `frame` is
        the allocating frame. Hooks run outside the watcher's lock and must
        not allocate tracked locks themselves."""
        with self._mu:
            self._alloc_hooks.append(hook)

    def remove_allocation_hook(self, hook: Callable) -> None:
        with self._mu:
            if hook in self._alloc_hooks:
                self._alloc_hooks.remove(hook)

    def _run_alloc_hooks(self, lock: TrackedLock, frame) -> None:
        with self._mu:
            hooks = list(self._alloc_hooks)
        for hook in hooks:
            hook(lock, frame)

    def install(self) -> "LockWatch":
        """Wrap the current threading.Lock and RLock factories, so that the
        port's allocations are tracked. Idempotent; returns self."""
        with self._mu:
            if self._installed:
                return self
            self._orig_lock = threading.Lock
            self._orig_rlock = threading.RLock
            self._factories = (self._factory(self._orig_lock, "Lock"),
                               self._factory(self._orig_rlock, "RLock"))
            self._installed = True
        threading.Lock, threading.RLock = self._factories
        return self

    def uninstall(self) -> None:
        """Put back the factories install() wrapped. Watchers come off in
        the reverse order they went on: with another patch over this
        one's, RuntimeError, and nothing changes."""
        with self._mu:
            if not self._installed:
                return
            if (threading.Lock, threading.RLock) != self._factories:
                raise RuntimeError(
                    "lockwatch: threading.Lock was patched again after this watcher "
                    "installed; uninstall the later patch first")
            self._installed = False
        threading.Lock = self._orig_lock
        threading.RLock = self._orig_rlock

    @property
    def installed(self) -> bool:
        return self._installed

    def sites(self) -> List[str]:
        """Every allocation site tracked so far."""
        with self._mu:
            return sorted(self._sites)

    # -- recording -----------------------------------------------------------------

    def _held(self) -> List[_Acquisition]:
        held = getattr(self._local, "held", None)
        if held is None:
            held = self._local.held = []
        if held and self._tainted_uids:
            with self._mu:
                tainted = set(self._tainted_uids)
            kept = []
            for acq in held:
                live = [u for u in acq.uids if u not in tainted]
                if not live:
                    continue  # a handed-off lock's leaked entry
                acq.uids = live
                kept.append(acq)
            if len(kept) != len(held):
                held[:] = kept
        return held

    def held_sites(self) -> List[str]:
        """The sites of the locks this thread holds, outer to inner."""
        return [acq.site for acq in self._held()]

    def held_lock_uids(self) -> FrozenSet[int]:
        """The uids of the lock instances this thread holds: the lockset
        racewatch intersects at each access."""
        out: Set[int] = set()
        for acq in self._held():
            out.update(acq.uids)
        return frozenset(out)

    def site_of_uid(self, uid: int) -> str:
        with self._mu:
            return self._uid_sites.get(uid, f"uid-{uid}")

    def _note_acquire(self, lock: TrackedLock) -> None:
        held = self._held()
        for acq in held:
            if acq.site == lock._site:
                # reentrant, or a sibling of one site: never an edge
                acq.count += 1
                if lock._uid not in acq.uids:
                    acq.uids.append(lock._uid)
                return
        if held:
            holder = held[-1].site
            if holder != lock._site:
                witness = (f"thread '{threading.current_thread().name}' acquired "
                           f"{lock._site} while holding {holder}")
                with self._mu:
                    self._edges.setdefault(holder, {}).setdefault(lock._site, witness)
        held.append(_Acquisition(lock._site, lock._uid))

    def _note_release(self, lock: TrackedLock, full: bool = False) -> None:
        held = getattr(self._local, "held", None)
        if held:
            # by identity first: a match by site alone could take a
            # sibling's entry, and a hand-off would corrupt this thread's
            # real holding instead of tainting the handed-off lock
            for i in range(len(held) - 1, -1, -1):
                if lock._uid in held[i].uids:
                    held[i].count -= 1
                    if full or held[i].count <= 0:
                        del held[i]
                    elif held[i].count < len(held[i].uids):
                        # a pooled sibling fully released: retire its uid
                        held[i].uids.remove(lock._uid)
                    return
            # an unknown uid, but an entry of its site holds more
            # acquisitions than instances: the release belongs there
            for i in range(len(held) - 1, -1, -1):
                if held[i].site == lock._site and held[i].count > len(held[i].uids):
                    held[i].count -= 1
                    if full or held[i].count <= 0:
                        del held[i]
                    return
        # released on a thread that never took it: a hand-off
        with self._mu:
            self._tainted_uids.add(lock._uid)

    # -- analysis ------------------------------------------------------------------

    def edges(self) -> Dict[str, Dict[str, str]]:
        with self._mu:
            return {a: dict(bs) for a, bs in self._edges.items()}

    def cycles(self) -> List[List[str]]:
        """The site cycles of the graph, each sorted (report() gives the
        witnesses)."""
        graph = self.edges()
        sccs = _sccs({a: list(bs) for a, bs in graph.items()})
        return [sorted(s) for s in sccs if len(s) > 1]

    def report(self) -> str:
        cycles = self.cycles()
        if not cycles:
            return "lockwatch: no acquisition-order cycles"
        graph = self.edges()
        lines = [f"lockwatch: {len(cycles)} potential deadlock(s) — lock "
                 "acquisition-order cycle(s) detected:"]
        for cycle in cycles:
            lines.append("  cycle: " + " <-> ".join(cycle))
            members = set(cycle)
            for a in cycle:
                for b, witness in sorted(graph.get(a, {}).items()):
                    if b in members:
                        lines.append(f"    {witness}")
        return "\n".join(lines)

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()


def _sccs(graph: Dict[str, List[str]]) -> List[Set[str]]:
    """Tarjan's strongly connected components, iteratively."""
    index: Dict[str, int] = {}
    lowlink: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[Set[str]] = []
    counter = [0]
    nodes = set(graph)
    for targets in graph.values():
        nodes.update(targets)
    full = {n: list(graph.get(n, [])) for n in nodes}

    for root in full:
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            node, ei = work[-1]
            if ei == 0:
                index[node] = lowlink[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            advanced = False
            targets = full[node]
            while ei < len(targets):
                target = targets[ei]
                ei += 1
                if target not in index:
                    work[-1] = (node, ei)
                    work.append((target, 0))
                    advanced = True
                    break
                if target in on_stack:
                    lowlink[node] = min(lowlink[node], index[target])
            if advanced:
                continue
            work.pop()
            if lowlink[node] == index[node]:
                scc: Set[str] = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.add(w)
                    if w == node:
                        break
                out.append(scc)
            if work:
                parent, _ = work[-1]
                lowlink[parent] = min(lowlink[parent], lowlink[node])
    return out


GLOBAL = LockWatch()


def arm(spec: str = "", default_on: bool = True) -> bool:
    """Install GLOBAL per a KARPENTER_LOCKWATCH-style spec (obs/envflags'
    truthy and falsy spellings; empty means `default_on`). The caller
    reads the environment; arm before the port's lock-owning modules
    load."""
    spec = (spec or "").strip().lower()
    if spec in ("0", "false", "off", "no"):
        return False
    if spec in ("1", "true", "on", "yes") or default_on:
        GLOBAL.install()
        return True
    return False
