"""The insufficient-capacity (ICE) cache: offerings a launch found
exhausted, masked out of the instance-type universe of the solves that
follow until their entry expires (the reference provider's
unavailable-offerings cache).

A launch that fails with InsufficientCapacityError records its offering
key (instance type, zone, capacity type); the next solve sees those
offerings unavailable, so the pods that were to go there are placed
elsewhere. Entries expire after a TTL on the injected clock, because zonal
exhaustion passes. An empty key component matches any value; an error
with no key at all masks nothing. ICE_CACHE_ENTRIES, ICE_CACHE_RECORDED_TOTAL
and ICE_CACHE_MASKED_TOTAL are the reference's series of the cache.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from karpenter_core_tpu_torch.cloudprovider.types import (
    InstanceType,
    InsufficientCapacityError,
    Offering,
    Offerings,
    offering_pool_matches,
)
from karpenter_core_tpu_torch.metrics.registry import NAMESPACE, REGISTRY

ICE_CACHE_ENTRIES = REGISTRY.gauge(
    f"{NAMESPACE}_ice_cache_entries",
    "Offerings currently masked by the insufficient-capacity cache",
)
ICE_CACHE_RECORDED_TOTAL = REGISTRY.counter(
    f"{NAMESPACE}_ice_cache_recorded_total",
    "InsufficientCapacityErrors recorded into the ICE cache",
)
ICE_CACHE_MASKED_TOTAL = REGISTRY.counter(
    f"{NAMESPACE}_ice_cache_masked_offerings_total",
    "Offerings masked out of a Solve's instance-type universe by the ICE cache",
)

Key = Tuple[str, str, str]  # (instance_type, zone, capacity_type)

# the reference provider keeps an exhausted offering for 3 minutes
DEFAULT_TTL = 180.0


class ICECache:
    """Thread-safe: launches run in parallel and record concurrently."""

    def __init__(self, ttl: float = DEFAULT_TTL, clock=None):
        self.ttl = ttl
        self.clock = clock if clock is not None else time.time
        self._mu = threading.Lock()
        self._entries: Dict[Key, float] = {}  # key -> expiry

    def record(self, err: InsufficientCapacityError) -> bool:
        """Record the error's offering; False when it names none."""
        key = err.offering_key()
        if not any(key):
            return False
        with self._mu:
            self._entries[key] = self.clock() + self.ttl
            ICE_CACHE_ENTRIES.set(float(len(self._entries)))
        ICE_CACHE_RECORDED_TOTAL.inc()
        return True

    def _expire_locked(self, now: float) -> None:
        dead = [k for k, exp in self._entries.items() if exp <= now]
        for k in dead:
            del self._entries[k]
        if dead:
            ICE_CACHE_ENTRIES.set(float(len(self._entries)))

    def next_expiry_in(self) -> Optional[float]:
        """Seconds until the earliest entry expires; None when empty."""
        now = self.clock()
        with self._mu:
            self._expire_locked(now)
            if not self._entries:
                return None
            return max(0.0, min(self._entries.values()) - now)

    def __len__(self) -> int:
        with self._mu:
            self._expire_locked(self.clock())
            return len(self._entries)

    def keys(self) -> List[Key]:
        with self._mu:
            self._expire_locked(self.clock())
            return list(self._entries)

    def mask(self, instance_types: List[InstanceType]) -> List[InstanceType]:
        """The universe with the cached offerings made unavailable: only the
        types that lose an offering are rebuilt; with no entries the input
        list itself comes back."""
        entries = self.keys()
        if not entries:
            return instance_types
        out: List[InstanceType] = []
        masked = 0
        for it in instance_types:
            hit = [o for o in it.offerings
                   if o.available and any(offering_pool_matches(key, it.name, o.zone,
                                                                o.capacity_type)
                                          for key in entries)]
            if not hit:
                out.append(it)
                continue
            masked += len(hit)
            offerings = Offerings(
                Offering(o.capacity_type, o.zone, o.price, available=False) if o in hit else o
                for o in it.offerings)
            out.append(InstanceType(name=it.name, requirements=it.requirements,
                                    offerings=offerings, capacity=it.capacity,
                                    overhead=it.overhead))
        if masked:
            ICE_CACHE_MASKED_TOTAL.inc(value=float(masked))
        return out
