"""The jittered backoff shapes every retry site of the port uses (the
singleton loops' error backoff, the launch re-trigger):

  * full_jitter: U(0, min(cap, base * 2^attempt)), for bounded retries;
  * decorrelated_jitter: U(base, 3 * prev), capped, for long-lived loops,
    each failure's sleep drawn from the loop's own last sleep so that
    loops failing together do not retry in lockstep;

and RetryBudget, the per-key token bucket consulted before a retry is
attempted at all (the solver RPC client's): jitter spreads a retry storm
out, the budget stops it.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Dict, Optional

_MODULE_RNG = random.Random()


class RetryBudget:
    """Per-key token-bucket retry budget (key: a guarded tenant label,
    "" for an unbound request).

    Each key starts with `capacity` tokens, refilled continuously at
    `refill_per_s`; every retry spends one. A key out of tokens gets no
    retry: the caller raises the original error at once, so a shed tenant
    cannot turn rejection into a retry storm, while every other tenant
    keeps its own full budget. It gates only whether a retry happens; the
    sleep's shape (full jitter, retry-after hints) is the caller's."""

    def __init__(self, capacity: float = 10.0, refill_per_s: float = 0.5,
                 clock=time.monotonic):
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._clock = clock
        self._mu = threading.Lock()
        # key -> (tokens, the time of the last refill)
        self._buckets: Dict[str, tuple] = {}
        self.spent_total = 0
        self.denied_total = 0

    def try_spend(self, key: Optional[str], cost: float = 1.0) -> bool:
        """Spend `cost` tokens of `key`'s bucket; False: the budget is
        spent, do not retry."""
        key = key or ""
        with self._mu:
            now = self._clock()
            tokens, last = self._buckets.get(key, (self.capacity, now))
            tokens = min(self.capacity, tokens + (now - last) * self.refill_per_s)
            if tokens >= cost:
                self._buckets[key] = (tokens - cost, now)
                self.spent_total += 1
                return True
            self._buckets[key] = (tokens, now)
            self.denied_total += 1
            return False

    def stats(self) -> Dict[str, object]:
        with self._mu:
            now = self._clock()
            return {
                "capacity": self.capacity,
                "refill_per_s": self.refill_per_s,
                "spent_total": self.spent_total,
                "denied_total": self.denied_total,
                "tokens": {
                    key: round(min(self.capacity, tokens + (now - last) * self.refill_per_s), 2)
                    for key, (tokens, last) in self._buckets.items()
                },
            }


def full_jitter(attempt: int, base: float, cap: float,
                rng: Optional[random.Random] = None) -> float:
    """U(0, min(cap, base * 2^attempt)); `attempt` counts from 0."""
    rng = rng or _MODULE_RNG
    return rng.uniform(0.0, min(cap, base * (2 ** attempt)))


def decorrelated_jitter(prev: float, base: float, cap: float,
                        rng: Optional[random.Random] = None) -> float:
    """U(base, 3 * prev), capped; feed the result back as `prev` on the
    next failure, and reset `prev` to `base` on success."""
    rng = rng or _MODULE_RNG
    return min(rng.uniform(base, max(prev, base) * 3), cap)
