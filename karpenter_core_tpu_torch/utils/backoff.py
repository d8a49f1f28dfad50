"""The jittered backoff shapes every retry site of the port uses (the
singleton loops' error backoff, the launch re-trigger):

  * full_jitter: U(0, min(cap, base * 2^attempt)), for bounded retries;
  * decorrelated_jitter: U(base, 3 * prev), capped, for long-lived loops,
    each failure's sleep drawn from the loop's own last sleep so that
    loops failing together do not retry in lockstep.
"""
from __future__ import annotations

import random
from typing import Optional

_MODULE_RNG = random.Random()


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
