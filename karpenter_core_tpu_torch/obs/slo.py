"""Declarative SLOs evaluated as multi-window burn rates.

An `Objective` names a latency histogram, a good/bad threshold and a
target fraction ("admission-to-bind p99 < 30 s": 99% of observations land
in a bucket <= 30 s). The `SloEngine` samples the histogram's cumulative
series (`Histogram.series()`: cumulative bucket counts and the count),
diffs the samples across sliding windows, and reports the burn rate per
window:

    error_rate(window) / (1 - target)

A burn rate of 1.0 spends the error budget exactly at the sustainable
pace; 14.4 over 5 minutes is the usual page threshold. The budget left is
computed over the longest window (`SloEngine.budget_window_s`) and exposed
as `karpenter_slo_error_budget_remaining{slo[,tenant]}`.

The engine is an external exposition source (the registry's `families()`
protocol): `REGISTRY.add_external(engine)` makes every scrape compute fresh
burn rates, with no evaluation thread, and the gauge family exists only
where an engine is wired (the process entry). Tenant series come from the
tenant labels the histograms already carry; the engine invents no label
value, so it inherits the `reqctx.TENANTS` cardinality cap.

`SloEngine.budget_exhausted` and `fast_burn` are the hooks an admission
gate reads; the port has no gate yet, so the entry builds the engine
without one.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from karpenter_core_tpu_torch.metrics.registry import NAMESPACE, Histogram

__all__ = [
    "BUDGET_GAUGE_NAME",
    "DEFAULT_BURN_WINDOWS",
    "Objective",
    "SloEngine",
]

BUDGET_GAUGE_NAME = f"{NAMESPACE}_slo_error_budget_remaining"

# the (label, seconds) sliding windows burn rates are reported over; short
# by SRE-book standards, since a soak run lasts minutes, and the arithmetic
# does not depend on the window's length
DEFAULT_BURN_WINDOWS: Tuple[Tuple[str, float], ...] = (
    ("1m", 60.0),
    ("5m", 300.0),
    ("1h", 3600.0),
)


@dataclass(frozen=True)
class Objective:
    """One SLO: `target` fraction of `histogram` observations ≤ `threshold_s`.

    ``base_labels`` narrows which series of the histogram belong to the
    objective (e.g. ``{"context": "provisioning"}`` on the solve-duration
    histogram); series are then grouped by their ``tenant`` label, with the
    tenant-less aggregate summed across all matching series.

    ``collect`` replaces the histogram read entirely: a callable returning
    ``{tenant-or-None: (good, total)}`` cumulative counts (the ``None`` key
    is the aggregate). This is how non-latency ratio objectives plug in —
    e.g. ``AdmissionGate.admission_totals``, where good = dispatched and
    bad = capacity sheds. With ``collect`` set, ``histogram`` may be None
    and ``threshold_s`` is ignored.
    """

    name: str
    histogram: Optional[Histogram]
    threshold_s: float
    target: float  # e.g. 0.99 — good fraction the SLO promises
    base_labels: Dict[str, str] = field(default_factory=dict)
    description: str = ""
    collect: Optional[Callable[[], Dict[Optional[str], Tuple[int, int]]]] = None


class _Sample:
    """One (timestamp, good-count, total-count) point for a series."""

    __slots__ = ("t", "good", "total")

    def __init__(self, t: float, good: int, total: int) -> None:
        self.t = t
        self.good = good
        self.total = total


class SloEngine:
    """Evaluates objectives as multi-window burn rates over histogram diffs."""

    def __init__(
        self,
        objectives: Sequence[Objective],
        windows: Tuple[Tuple[str, float], ...] = DEFAULT_BURN_WINDOWS,
        clock=time.monotonic,
        max_samples: int = 1024,
    ) -> None:
        self.objectives = tuple(objectives)
        self.windows = tuple(windows)
        self.budget_window_s = max(w for _, w in self.windows)
        self._clock = clock
        self._max_samples = int(max_samples)
        self._mu = threading.Lock()
        # (objective name, tenant-or-None) -> deque of _Sample, oldest first
        self._samples: Dict[Tuple[str, Optional[str]], Deque[_Sample]] = {}

    # -- sampling ----------------------------------------------------------

    def _good_index(self, obj: Objective) -> int:
        """Index of the largest bucket bound ≤ threshold (cumulative counts
        at that index == the good count). -1 when the threshold sits below
        every bucket (everything counts as bad)."""
        return bisect.bisect_right(obj.histogram.buckets, obj.threshold_s) - 1

    def _collect(self, obj: Objective) -> Dict[Optional[str], Tuple[int, int]]:
        """Current (good, total) per tenant for one objective. The None key
        is the aggregate: the sum over every matching series, so per-tenant
        observations still count toward the global objective."""
        if obj.collect is not None:
            try:
                collected = obj.collect()
            except Exception:  # noqa: BLE001 — a sick source reports nothing
                return {None: (0, 0)}
            out: Dict[Optional[str], Tuple[int, int]] = {}
            for tenant, pair in collected.items():
                good, total = pair
                out[tenant] = (int(good), int(total))
            out.setdefault(None, (0, 0))
            return out
        gi = self._good_index(obj)
        out: Dict[Optional[str], List[int]] = {None: [0, 0]}
        for labels, data in obj.histogram.series():
            if any(labels.get(k) != v for k, v in obj.base_labels.items()):
                continue
            extra = set(labels) - set(obj.base_labels)
            if extra - {"tenant"}:
                continue  # differently-shaped series (e.g. another context)
            counts = list(data.get("buckets", ()))
            total = int(data.get("count", 0))
            good = int(counts[gi]) if 0 <= gi < len(counts) else 0
            tenant = labels.get("tenant")
            agg = out[None]
            agg[0] += good
            agg[1] += total
            if tenant is not None:
                cur = out.setdefault(tenant, [0, 0])
                cur[0] += good
                cur[1] += total
        return {k: (v[0], v[1]) for k, v in out.items()}

    def sample(self) -> None:
        """Record one sample point per (objective, tenant) series."""
        now = self._clock()
        with self._mu:
            for obj in self.objectives:
                for tenant, (good, total) in self._collect(obj).items():
                    dq = self._samples.setdefault((obj.name, tenant), deque())
                    if not dq:
                        # zero baseline for a first-seen series: a tenant
                        # that appears mid-run burns from its first window
                        # instead of hiding behind a missing baseline
                        dq.append(_Sample(now, 0, 0))
                    dq.append(_Sample(now, good, total))
                    while len(dq) > self._max_samples:
                        dq.popleft()
                    horizon = now - 2 * self.budget_window_s
                    while len(dq) > 1 and dq[0].t < horizon:
                        dq.popleft()

    # -- evaluation --------------------------------------------------------

    @staticmethod
    def _window_rates(dq: Deque[_Sample], now: float, window_s: float,
                      target: float) -> Tuple[Optional[float], int]:
        """(burn rate, window traffic) for one series over one window.
        Clamps to observed history: the baseline is the newest sample at
        least `window_s` old, else the oldest we have. None when the window
        saw no traffic."""
        if not dq:
            return None, 0
        newest = dq[-1]
        base = dq[0]
        for s in reversed(dq):
            if now - s.t >= window_s:
                base = s
                break
        total = newest.total - base.total
        if total <= 0:
            return None, 0
        good = newest.good - base.good
        error_rate = 1.0 - (good / total)
        allowed = 1.0 - target
        burn = error_rate / allowed if allowed > 0 else (0.0 if error_rate == 0 else float("inf"))
        return burn, total

    def evaluate(self) -> List[dict]:
        """Sample, then report every (objective, tenant) series: burn rate
        per window plus budget remaining over the longest window (1.0 =
        untouched, 0.0 = spent, negative = overdrawn)."""
        self.sample()
        now = self._clock()
        out: List[dict] = []
        with self._mu:
            for obj in self.objectives:
                for (name, tenant), dq in sorted(
                    self._samples.items(),
                    key=lambda kv: (kv[0][0], kv[0][1] or ""),
                ):
                    if name != obj.name:
                        continue
                    burns = {}
                    for wname, wsec in self.windows:
                        burn, traffic = self._window_rates(dq, now, wsec, obj.target)
                        burns[wname] = {"burn_rate": burn, "traffic": traffic}
                    budget_burn, traffic = self._window_rates(
                        dq, now, self.budget_window_s, obj.target
                    )
                    remaining = 1.0 if budget_burn is None else 1.0 - budget_burn
                    out.append({
                        "slo": obj.name,
                        "tenant": tenant,
                        "target": obj.target,
                        "threshold_s": obj.threshold_s,
                        "description": obj.description,
                        "windows": burns,
                        "budget_window_s": self.budget_window_s,
                        "budget_remaining": remaining,
                        "traffic": traffic,
                    })
        return out

    def fast_burn(self, tenant: Optional[str]) -> float:
        """Max burn rate for *tenant* over the SHORTEST window, across all
        objectives — the brownout ladder's demotion signal (the fast window
        reacts in seconds where the budget window takes its full span to
        drain). Takes a fresh sample, so callers should rate-limit (the
        ladder's ``eval_interval_s`` does). 0.0 for unknown tenants or
        windows with no traffic."""
        self.sample()
        if tenant is None:
            return 0.0
        now = self._clock()
        fast_s = min(w for _, w in self.windows)
        worst = 0.0
        with self._mu:
            for obj in self.objectives:
                dq = self._samples.get((obj.name, tenant))
                if not dq:
                    continue
                burn, _ = self._window_rates(dq, now, fast_s, obj.target)
                if burn is not None and burn > worst:
                    worst = burn
        return worst

    def budget_exhausted(self, tenant: Optional[str]) -> bool:
        """True when any objective's budget for *tenant* is spent (≤ 0) over
        the budget window. Unknown tenants have burned nothing. This is the
        signal the admission gate's brownout-preference hook consumes."""
        if tenant is None:
            return False
        now = self._clock()
        with self._mu:
            for obj in self.objectives:
                dq = self._samples.get((obj.name, tenant))
                if not dq:
                    continue
                burn, _ = self._window_rates(dq, now, self.budget_window_s, obj.target)
                if burn is not None and burn >= 1.0:
                    return True
        return False

    # -- exposition (the registry's external-source protocol) ---------------

    def families(self) -> Dict[str, dict]:
        """Gauge family for the registry's external-source hook. Tenant-less
        aggregates carry only the `slo` label — a run that never bound a
        tenant exposes no `tenant` label here either."""
        series: List[Tuple[Dict[str, str], float]] = []
        for row in self.evaluate():
            labels = {"slo": row["slo"]}
            if row["tenant"] is not None:
                labels["tenant"] = row["tenant"]
            series.append((labels, row["budget_remaining"]))
        return {
            BUDGET_GAUGE_NAME: {
                "kind": "gauge",
                "help": "SLO error budget remaining over the budget window "
                        "(1 = untouched, <=0 = exhausted)",
                "series": series,
            }
        }

    def digest(self) -> dict:
        """JSON digest for /debug/slo."""
        return {
            "windows": [{"name": n, "seconds": s} for n, s in self.windows],
            "budget_window_s": self.budget_window_s,
            "objectives": [
                {
                    "name": o.name,
                    "target": o.target,
                    "threshold_s": o.threshold_s,
                    "histogram": (
                        o.histogram.name if o.histogram is not None
                        else None
                    ),
                    "source": (
                        "collect" if o.collect is not None else "histogram"
                    ),
                    "base_labels": dict(o.base_labels),
                    "description": o.description,
                }
                for o in self.objectives
            ],
            "series": self.evaluate(),
        }
