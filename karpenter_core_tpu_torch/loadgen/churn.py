"""Deterministic churn schedules: seeded arrival/termination/resize point
processes over a bounded horizon (the reference's loadgen/churn.py: the
same config gives the same event list in both packages).

The grammar: three independent Poisson processes — ARRIVE
(rate `arrival_rate` pods/s, each event carrying a scenario drawn from the
weighted `mix` and a replica count), TERMINATE (rate `termination_rate`,
each event deleting one bound pod), RESIZE (rate `resize_rate`, each event
replacing one bound pod with a re-sized replica, i.e. a simultaneous
free + arrive). Rates are modulated sinusoidally — lambda(t) = base *
(1 + burst_amplitude * sin(2*pi*t / burst_period_s)) — and sampled by
thinning against lambda_max, so the whole schedule is a pure function of
(config, seed): the soak, the parity suite, and a field repro of a soak
incident all see byte-identical event streams.

The generator emits WHAT happens and WHEN, never to WHOM: target selection
(which bound pod a termination kills) needs cluster state the generator
must not know, so the driver resolves targets with its own seeded rng.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterator, List

import numpy as np

ARRIVE = "arrive"
TERMINATE = "terminate"
RESIZE = "resize"

DEFAULT_MIX: Dict[str, float] = {
    "generic": 0.45,
    "bulk": 0.25,
    "spread": 0.2,
    "anti": 0.1,
}


@dataclass(frozen=True)
class ChurnEvent:
    at: float  # seconds from soak start
    kind: str  # ARRIVE | TERMINATE | RESIZE
    scenario: str = ""  # ARRIVE only: scenarios.SCENARIOS key
    count: int = 1  # ARRIVE only: replicas created together


@dataclass
class ChurnConfig:
    seed: int = 0
    duration_s: float = 60.0
    arrival_rate: float = 6.0  # mean pod-arrival events/s
    termination_rate: float = 4.0  # mean deletions/s (no-ops while unbound)
    resize_rate: float = 0.4  # mean replace-with-resized/s
    burst_period_s: float = 12.0
    burst_amplitude: float = 0.6  # 0 = flat; 1 = rate swings 0..2x
    mix: Dict[str, float] = field(default_factory=lambda: dict(DEFAULT_MIX))
    bulk_max: int = 10  # bulk arrivals carry 3..bulk_max replicas
    initial_pods: int = 24  # warm-up batch at t=0 (generic)
    # pre-existing cluster nodes: a soak measures STEADY-STATE churn over a
    # running cluster, not genesis — and seeding the existing axis inside a
    # stable pow2 encode bucket keeps the solve geometry (and with it the
    # incremental path's residency) from re-minting on every early launch
    initial_nodes: int = 12

    def __post_init__(self):
        if not 0.0 <= self.burst_amplitude <= 1.0:
            raise ValueError("burst_amplitude must be in [0, 1]")
        if self.duration_s <= 0:
            raise ValueError("duration_s must be positive")
        if any(w < 0 for w in self.mix.values()) or not any(self.mix.values()):
            raise ValueError("mix weights must be >= 0 with a positive sum")


class ChurnGenerator:
    def __init__(self, config: ChurnConfig):
        self.config = config

    def rate_at(self, t: float, base: float) -> float:
        c = self.config
        return base * (
            1.0 + c.burst_amplitude * math.sin(2.0 * math.pi * t / c.burst_period_s)
        )

    def _thinned_times(self, rng: np.random.Generator, base: float) -> List[float]:
        """Inhomogeneous-Poisson event times by thinning: candidates at
        lambda_max, kept with probability lambda(t)/lambda_max."""
        c = self.config
        out: List[float] = []
        if base <= 0:
            return out
        lam_max = base * (1.0 + c.burst_amplitude)
        t = 0.0
        while True:
            t += rng.exponential(1.0 / lam_max)
            if t >= c.duration_s:
                return out
            if rng.uniform() * lam_max <= self.rate_at(t, base):
                out.append(t)

    def events(self) -> List[ChurnEvent]:
        """The full schedule, sorted by time (stable tie-break on kind so
        equal-time events replay in one deterministic order)."""
        c = self.config
        # one child stream per process: adding resize events must not
        # reshuffle the arrival times a previous soak run recorded
        arr_rng, term_rng, rsz_rng, mix_rng = (
            np.random.default_rng(s)
            for s in np.random.SeedSequence(c.seed).spawn(4)
        )
        events: List[ChurnEvent] = []
        if c.initial_pods:
            events.append(ChurnEvent(0.0, ARRIVE, "generic", c.initial_pods))
        names = sorted(c.mix)
        weights = np.array([c.mix[k] for k in names], dtype=float)
        weights /= weights.sum()
        for t in self._thinned_times(arr_rng, c.arrival_rate):
            scenario = names[int(mix_rng.choice(len(names), p=weights))]
            count = (
                int(mix_rng.integers(3, max(c.bulk_max, 3) + 1))
                if scenario == "bulk"
                else 1
            )
            events.append(ChurnEvent(t, ARRIVE, scenario, count))
        events.extend(
            ChurnEvent(t, TERMINATE) for t in self._thinned_times(term_rng, c.termination_rate)
        )
        events.extend(
            ChurnEvent(t, RESIZE) for t in self._thinned_times(rsz_rng, c.resize_rate)
        )
        events.sort(key=lambda e: (e.at, e.kind))
        return events

    def __iter__(self) -> Iterator[ChurnEvent]:
        return iter(self.events())
