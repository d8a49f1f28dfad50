"""The device path's program inventory: where the device milliseconds live.

In the port a "program" is a geometry entry of the device path: the solve
program (`make_device_run`'s closure) with its prescreen and its resident
verdict tensor, the delta refresh at a (row, column) budget, and the
batched consolidation replan at a candidate-axis bucket, each keyed as
`TorchSolver` keys its geometries (`_warm_keys`) and `SolverService` its
entries. There is no compiler: a program's "compile" is its first dispatch
(the screen library's load, the caching allocator's first allocations at
that shape), booked as that dispatch's seconds. Cost fields the port
cannot know (the flop and byte estimates, the peak device memory of a
compiled executable) stay "unavailable", as `normalize_cost_analysis`
allows for any backend without them.

Three pieces, all stdlib (no torch import: the inventory must keep working
when the device stack is wedged):

  * ``ProgramLedger``: the per-process inventory every mint, dispatch and
    eviction reports into. Bounded (MAX_RECORDS), under a lock, and free
    when disabled: each record_* funnel is one flag check first.
  * ``normalize_cost_analysis`` / ``analyze_compiled``: the shim over a
    duck-typed executable's ``cost_analysis()`` and ``memory_analysis()``
    (a list of dicts or a dict); the shape is probed once per ledger, and
    every fallback returns ``"unavailable"``, never raises.
  * ``ProgramInventoryMerger``: the generation contract of
    ``metrics/registry.ProcessSeriesMerger`` for the program snapshots
    that ride the solver host's response and stats frames: ``ingest``
    replaces a generation's live view, a generation bump or ``retire``
    folds its cumulative totals into the base exactly once (respawns are
    idempotent), and every entry carries the ``process`` label.

The operator's gated ``/debug/programs`` serves ``full_snapshot()`` (the
local ledger plus every registered source, the solver host's merger
among them), and ``EXPOSITION`` renders ``karpenter_program_count`` /
``_compile_seconds_total`` / ``_hbm_peak_bytes`` as a registry external
source.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Callable, Dict, Optional

from karpenter_core_tpu_torch.obs import envflags

# live records per ledger; eviction-retired records fold into totals, so
# the bound is on live-program cardinality (itself LRU-bounded upstream)
MAX_RECORDS = 256
# entries served per /debug/programs snapshot (deterministic order)
MAX_SNAPSHOT_PROGRAMS = 128
# EMA smoothing for per-record device milliseconds
EMA_ALPHA = 0.2

FAMILIES = ("solve", "refresh", "replan", "segment")

_TOTAL_FIELDS = ("minted", "retired", "exec_total", "compile_seconds_total")


def _key_digest(key) -> str:
    """Stable short digest of a program key (its repr is stable within a
    process: good enough for a debugging identity, never for equality)."""
    return hashlib.blake2s(repr(key).encode(), digest_size=6).hexdigest()


def normalize_cost_analysis(raw) -> Optional[Dict[str, float]]:
    """Normalize a ``compiled.cost_analysis()`` return to one schema: a
    backend may return a list of dicts (one per device or computation) or
    a bare dict, and downstream must never care. Returns ``{"flops": float, "bytes_accessed": float}`` (keys present
    only when the backend reported them) or None when the shape is
    unrecognized or empty.
    """
    if isinstance(raw, (list, tuple)):
        raw = raw[0] if raw else None
    if not isinstance(raw, dict):
        return None
    out: Dict[str, float] = {}
    flops = raw.get("flops")
    if isinstance(flops, (int, float)):
        out["flops"] = float(flops)
    acc = raw.get("bytes accessed", raw.get("bytes_accessed"))
    if isinstance(acc, (int, float)):
        out["bytes_accessed"] = float(acc)
    return out or None


def _memory_peak_bytes(mem) -> Optional[int]:
    """Peak memory estimate from a ``memory_analysis()`` return: the explicit
    peak when the backend reports one, else the sum of the sized sections
    (arguments + outputs + temps + generated code)."""
    if mem is None:
        return None
    peak = getattr(mem, "peak_memory_in_bytes", None)
    if isinstance(peak, (int, float)) and peak > 0:
        return int(peak)
    total = 0
    seen = False
    for attr in ("argument_size_in_bytes", "output_size_in_bytes",
                 "temp_size_in_bytes", "generated_code_size_in_bytes"):
        v = getattr(mem, attr, None)
        if isinstance(v, (int, float)):
            total += int(v)
            seen = True
    return total if seen else None


class ProgramLedger:
    """Per-process program inventory (mint / dispatch / retire).

    Per-key records carry the geometry tier, the screen mode, the origin
    (live or prewarm), the first dispatch's seconds, the exec count, the
    last and EMA device ms and, where an executable reports one, the
    normalized cost and memory analysis. Family
    totals (minted/retired/exec/compile-seconds) are cumulative and
    monotone: eviction retires the record but never the seconds it cost.
    """

    def __init__(self, enabled: Optional[bool] = None):
        self.enabled = (
            envflags.get_bool("KARPENTER_PROGHEALTH", True)
            if enabled is None else bool(enabled)
        )
        self._mu = threading.Lock()
        self._records: Dict[tuple, dict] = {}
        self._totals: Dict[str, Dict[str, float]] = {}
        # cost_analysis API shape, probed once on the first successful
        # call this ledger sees: "list" | "dict" | "unavailable" | None
        self._cost_shape: Optional[str] = None

    # -- analysis ----------------------------------------------------------

    def analyze_compiled(self, compiled) -> Dict[str, object]:
        """Bounded, never-raising cost and memory probe of one executable.
        The first successful cost_analysis records the API's shape (list
        or dict, probed once)."""
        out: Dict[str, object] = {"cost": "unavailable",
                                  "memory": "unavailable"}
        if compiled is None:
            return out
        try:
            raw = compiled.cost_analysis()
            with self._mu:
                if self._cost_shape is None:
                    self._cost_shape = (
                        "list" if isinstance(raw, (list, tuple)) else
                        "dict" if isinstance(raw, dict) else "unavailable"
                    )
            cost = normalize_cost_analysis(raw)
            if cost is not None:
                out["cost"] = cost
        except Exception:  # noqa: BLE001 — observability never raises
            with self._mu:
                if self._cost_shape is None:
                    self._cost_shape = "unavailable"
        try:
            peak = _memory_peak_bytes(compiled.memory_analysis())
            if peak is not None:
                out["memory"] = {"hbm_peak_bytes": int(peak)}
        except Exception:  # noqa: BLE001
            pass
        return out

    # -- totals ------------------------------------------------------------

    def _bump_locked(self, family: str, field: str, delta: float) -> None:
        fam = self._totals.setdefault(
            family, {f: 0 for f in _TOTAL_FIELDS}
        )
        fam[field] = fam.get(field, 0) + delta

    # -- record funnels ----------------------------------------------------

    def record_mint(self, family: str, key, origin: str = "live",
                    compile_s: float = 0.0, compiled=None,
                    meta: Optional[dict] = None) -> None:
        """A program was first met at `key`. `compiled` is an inspectable
        executable when one exists (the port's device path has none)."""
        if not self.enabled:
            return
        rec = {
            "family": family,
            "key": _key_digest(key),
            "origin": origin,
            "compile_seconds": round(float(compile_s), 6),
            "exec_count": 0,
            "last_device_ms": None,
            "ema_device_ms": None,
        }
        if meta:
            rec.update(meta)
        rec.update(self.analyze_compiled(compiled))
        with self._mu:
            fresh = (family, rec["key"]) not in self._records
            self._records[(family, rec["key"])] = rec
            if fresh:
                self._bump_locked(family, "minted", 1)
            if compile_s:
                self._bump_locked(
                    family, "compile_seconds_total", float(compile_s)
                )
            while len(self._records) > MAX_RECORDS:
                old = next(iter(self._records))
                del self._records[old]
                self._bump_locked(old[0], "retired", 1)

    def record_compile(self, family: str, key, seconds: float,
                       compiled=None) -> None:
        """Attribute seconds found after the mint: the program's first
        dispatch pays its cold costs."""
        if not self.enabled:
            return
        digest = _key_digest(key)
        with self._mu:
            rec = self._records.get((family, digest))
            if rec is not None:
                rec["compile_seconds"] = round(
                    rec.get("compile_seconds", 0.0) + float(seconds), 6
                )
            self._bump_locked(
                family, "compile_seconds_total", float(seconds)
            )
        if compiled is not None and rec is not None:
            analysis = self.analyze_compiled(compiled)
            with self._mu:
                rec.update(analysis)

    def record_dispatch(self, family: str, key, device_ms=None) -> None:
        """One execution of the program at `key`. Hot path: the disabled
        gate above is the whole cost when the ledger is off."""
        if not self.enabled:
            return
        digest = _key_digest(key)
        with self._mu:
            rec = self._records.get((family, digest))
            if rec is None:
                # dispatch observed for a program minted before this
                # ledger existed (or already evicted): count it under a
                # synthetic record so exec totals stay truthful
                rec = {
                    "family": family, "key": digest, "origin": "unknown",
                    "compile_seconds": 0.0, "exec_count": 0,
                    "last_device_ms": None, "ema_device_ms": None,
                    "cost": "unavailable", "memory": "unavailable",
                }
                self._records[(family, digest)] = rec
                self._bump_locked(family, "minted", 1)
            rec["exec_count"] += 1
            self._bump_locked(family, "exec_total", 1)
            if device_ms is not None:
                ms = float(device_ms)
                rec["last_device_ms"] = round(ms, 3)
                prev = rec["ema_device_ms"]
                rec["ema_device_ms"] = round(
                    ms if prev is None
                    else EMA_ALPHA * ms + (1.0 - EMA_ALPHA) * prev, 3
                )

    def retire(self, family: str, key) -> None:
        """The LRU evicted `key`: drop the live record, keep its cumulative
        contribution in the family totals (exactly-once per record)."""
        if not self.enabled:
            return
        digest = _key_digest(key)
        with self._mu:
            if self._records.pop((family, digest), None) is not None:
                self._bump_locked(family, "retired", 1)

    def clear(self) -> None:
        with self._mu:
            self._records = {}
            self._totals = {}
            self._cost_shape = None

    # -- views -------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able inventory: bounded program list (deterministic family,
        key order) and the cumulative family totals. It rides the solver
        host's frames, so it stays small and sort-stable."""
        with self._mu:
            records = [dict(r) for r in self._records.values()]
            totals = {f: dict(t) for f, t in self._totals.items()}
            shape = self._cost_shape
        records.sort(key=lambda r: (r["family"], r["key"]))
        dropped = max(0, len(records) - MAX_SNAPSHOT_PROGRAMS)
        out = {
            "programs": records[:MAX_SNAPSHOT_PROGRAMS],
            "totals": totals,
            "cost_shape": shape,
        }
        if dropped:
            out["dropped"] = dropped
        return out


class ProgramInventoryMerger:
    """Merged view over one child process's program snapshots, the
    ProcessSeriesMerger contract (metrics/registry.py) on the program
    plane: ingest replaces a generation's live view, a generation bump or
    retire folds that generation's cumulative totals into the committed
    base exactly once, and a dead child's live entries drop (its records
    died with the process; its seconds did not).
    """

    def __init__(self, process: str = "solver-host"):
        self.process = process
        self._mu = threading.Lock()
        self._live: dict = {}
        self._live_gen: Optional[int] = None
        self._base_totals: Dict[str, Dict[str, float]] = {}

    def _fold_live_locked(self) -> None:
        for fam, tot in (self._live.get("totals") or {}).items():
            base = self._base_totals.setdefault(fam, {})
            for field, value in tot.items():
                if isinstance(value, (int, float)):
                    base[field] = base.get(field, 0) + value
        self._live = {}
        self._live_gen = None

    def ingest(self, generation: int, snap: dict) -> None:
        if not isinstance(snap, dict):
            return
        with self._mu:
            if self._live_gen is not None and generation != self._live_gen:
                self._fold_live_locked()
            self._live_gen = generation
            self._live = snap

    def retire(self, generation: int) -> None:
        with self._mu:
            if self._live_gen == generation:
                self._fold_live_locked()

    def clear(self) -> None:
        with self._mu:
            self._live = {}
            self._live_gen = None
            self._base_totals = {}

    def snapshot(self) -> dict:
        with self._mu:
            gen = self._live_gen
            programs = [
                dict(r, process=self.process, generation=gen)
                for r in (self._live.get("programs") or ())
            ]
            totals: Dict[str, Dict[str, float]] = {
                f: dict(t) for f, t in self._base_totals.items()
            }
            for fam, tot in (self._live.get("totals") or {}).items():
                base = totals.setdefault(fam, {})
                for field, value in tot.items():
                    if isinstance(value, (int, float)):
                        base[field] = base.get(field, 0) + value
            out = {"programs": programs, "totals": totals,
                   "process": self.process}
            shape = self._live.get("cost_shape")
            if shape is not None:
                out["cost_shape"] = shape
            return out


# -- module singletons -------------------------------------------------------

LEDGER = ProgramLedger()

# extra inventory sources for the unified /debug/programs view, by process
# name ("solver-host": the HostSolver merger's snapshot); the latest
# registration per name wins
_SOURCES: Dict[str, Callable[[], dict]] = {}
_sources_mu = threading.Lock()


def reset(enabled: Optional[bool] = None) -> ProgramLedger:
    """Replace the process ledger (tests + entrypoints re-arming after an
    env change). Returns the new ledger."""
    global LEDGER
    LEDGER = ProgramLedger(enabled=enabled)
    return LEDGER


def add_source(name: str, fn: Callable[[], dict]) -> None:
    with _sources_mu:
        _SOURCES[name] = fn


def remove_source(name: str, fn: Optional[Callable] = None) -> None:
    with _sources_mu:
        if fn is None or _SOURCES.get(name) is fn:
            _SOURCES.pop(name, None)


# thin module-level funnels: call sites stay one import away from the
# live singleton (reset() swaps it atomically), and the disabled path is
# one attribute load + one flag check before any work
def record_mint(family, key, origin="live", compile_s=0.0, compiled=None,
                meta=None):
    led = LEDGER
    if led.enabled:
        led.record_mint(family, key, origin=origin, compile_s=compile_s,
                        compiled=compiled, meta=meta)


def record_compile(family, key, seconds, compiled=None):
    led = LEDGER
    if led.enabled:
        led.record_compile(family, key, seconds, compiled=compiled)


def record_dispatch(family, key, device_ms=None):
    led = LEDGER
    if led.enabled:
        led.record_dispatch(family, key, device_ms)


def retire(family, key):
    led = LEDGER
    if led.enabled:
        led.retire(family, key)


class ProgramBook:
    """First-sight and first-dispatch accounting of one device path's
    programs (a TorchSolver's, a SolverService's), over the module
    funnels: the first sight of a key mints its record, its first dispatch
    books that dispatch's seconds as the program's cold cost, and every
    dispatch counts. `surface` names the path in each record's meta."""

    def __init__(self, surface: str):
        self.surface = surface
        self._mu = threading.Lock()
        self._minted: set = set()
        self._dispatched: set = set()

    def mint(self, family: str, key, origin: str = "live", meta: Optional[dict] = None,
             seconds: float = 0.0) -> bool:
        """Record `key`'s first sight (True) or nothing (False)."""
        with self._mu:
            fresh = (family, key) not in self._minted
            self._minted.add((family, key))
        if fresh:
            record_mint(family, key, origin=origin, compile_s=seconds,
                        meta=dict(meta or {}, surface=self.surface))
        elif seconds:
            record_compile(family, key, seconds)
        return fresh

    def dispatch(self, family: str, key, device_ms: Optional[float] = None,
                 meta: Optional[dict] = None) -> bool:
        """One dispatch of `key` (minted on first sight); True on its first."""
        self.mint(family, key, meta=meta)
        with self._mu:
            first = (family, key) not in self._dispatched
            self._dispatched.add((family, key))
        record_dispatch(family, key, device_ms)
        if first and device_ms is not None:
            record_compile(family, key, device_ms / 1e3)
        return first

    def retire(self, family: str, key) -> None:
        """`key` left its path's cache: the next sight mints it again."""
        with self._mu:
            self._minted.discard((family, key))
            self._dispatched.discard((family, key))
        retire(family, key)


def full_snapshot() -> dict:
    """The unified inventory: the local ledger's programs (process="main")
    plus every registered source's (already process-labeled). Served at
    /debug/programs and summarized by EXPOSITION."""
    local = LEDGER.snapshot()
    programs = [dict(r, process="main") for r in local["programs"]]
    totals: Dict[str, dict] = {"main": local["totals"]}
    with _sources_mu:
        sources = dict(_SOURCES)
    for name, fn in sorted(sources.items()):
        try:
            snap = fn()
        except Exception:  # noqa: BLE001 — a sick source must not kill the view
            continue
        if not isinstance(snap, dict):
            continue
        programs.extend(snap.get("programs") or ())
        totals[name] = snap.get("totals") or {}
    out = {
        "enabled": LEDGER.enabled,
        "programs": programs,
        "totals": totals,
    }
    if local.get("cost_shape") is not None:
        out["cost_shape"] = local["cost_shape"]
    return out


class ProgramExposition:
    """Registry external source summarizing the unified inventory into the
    karpenter_program_* families: the live program count and the largest
    peak device memory as gauges, the cumulative first-dispatch seconds as
    a counter, per (process, family), so a child paying its cold costs
    again on every respawn is one /metrics scrape away."""

    def families(self) -> Dict[str, dict]:
        snap = full_snapshot()
        count: Dict[tuple, int] = {}
        hbm: Dict[tuple, int] = {}
        for rec in snap["programs"]:
            lk = (rec.get("process", "main"), rec.get("family", "?"))
            count[lk] = count.get(lk, 0) + 1
            mem = rec.get("memory")
            if isinstance(mem, dict):
                peak = mem.get("hbm_peak_bytes")
                if isinstance(peak, (int, float)):
                    hbm[lk] = max(hbm.get(lk, 0), int(peak))
        compile_s: Dict[tuple, float] = {}
        for process, fams in snap["totals"].items():
            for fam, tot in (fams or {}).items():
                sec = tot.get("compile_seconds_total")
                if isinstance(sec, (int, float)) and sec:
                    compile_s[(process, fam)] = float(sec)

        def _series(data):
            return [
                [{"process": p, "family": f}, v]
                for (p, f), v in sorted(data.items())
            ]

        out: Dict[str, dict] = {}
        if count:
            out["karpenter_program_count"] = {
                "kind": "gauge",
                "help": "Live compiled programs by process and family.",
                "series": _series(count),
            }
        if compile_s:
            out["karpenter_program_compile_seconds_total"] = {
                "kind": "counter",
                "help": "Cumulative first-dispatch (cold) seconds by process "
                        "and family (eviction never subtracts).",
                "series": _series(compile_s),
            }
        if hbm:
            out["karpenter_program_hbm_peak_bytes"] = {
                "kind": "gauge",
                "help": "Max peak device-memory estimate among live programs "
                        "by process and family (memory_analysis).",
                "series": _series(hbm),
            }
        return out


EXPOSITION = ProgramExposition()


def ensure_exposition_registered() -> None:
    """Idempotently attach EXPOSITION to the process metrics registry
    (add_external dedupes by identity)."""
    from karpenter_core_tpu_torch.metrics.registry import REGISTRY

    REGISTRY.add_external(EXPOSITION)
