"""Global settings (settings.go:32-85) and the solver's geometry bucket
ladder.

Every batch axis the solve is shaped by (items, instance types, existing
nodes) pads up to a tier value, so the padded shapes, and with them the
commit log and slot state, match the reference solver's for the same batch.
The provisioning batcher reads the batch windows, and caps a pass at the
ladder's top rung (`effective_batch_max_pods`). `current()` is the
process-wide Settings; `set_current()` replaces it; `from_config_map`
parses and validates the settings ConfigMap's data.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class GeometryTier:
    """One rung of the ladder: the padded width of each batch axis."""

    name: str
    pods: int
    items: int
    instance_types: int
    existing_nodes: int


DEFAULT_BUCKET_LADDER: Tuple[GeometryTier, ...] = (
    GeometryTier("S", pods=128, items=32, instance_types=8, existing_nodes=8),
    GeometryTier("M", pods=1024, items=128, instance_types=32, existing_nodes=32),
    GeometryTier("L", pods=8192, items=512, instance_types=128, existing_nodes=256),
    GeometryTier("XL", pods=65536, items=2048, instance_types=512,
                 existing_nodes=1024),
)


def parse_bucket_ladder(raw: str) -> Tuple[GeometryTier, ...]:
    """Parse `name:pods:items:types:existing[,name:...]`; the tiers must
    grow strictly on every axis (ValueError otherwise)."""
    tiers = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) != 5:
            raise ValueError(
                f"bucketLadder tier {part!r}: want name:pods:items:types:existing")
        name, *dims = fields
        try:
            pods, items, types, existing = (int(d) for d in dims)
        except ValueError:
            raise ValueError(f"bucketLadder tier {part!r}: non-integer axis")
        if min(pods, items, types, existing) <= 0:
            raise ValueError(f"bucketLadder tier {part!r}: axes must be positive")
        tiers.append(GeometryTier(name, pods, items, types, existing))
    if not tiers:
        raise ValueError("bucketLadder: no tiers")
    for a, b in zip(tiers, tiers[1:]):
        if not (a.pods < b.pods and a.items < b.items
                and a.instance_types < b.instance_types
                and a.existing_nodes < b.existing_nodes):
            raise ValueError(f"bucketLadder: tier {b.name!r} does not strictly grow every "
                             f"axis over {a.name!r}")
    return tuple(tiers)


@dataclass
class Settings:
    # the provisioning batch window's upper bound, seconds; a node
    # nominated for a pod stays nominated for twice this (at least 10 s)
    batch_max_duration: float = 10.0
    # the window closes once no pod has arrived for this long, seconds
    batch_idle_duration: float = 1.0
    # a machine whose node has not registered after this many seconds is
    # deleted (None turns the reaper off)
    ttl_after_not_registered: Optional[float] = 15 * 60.0
    # the Drift deprovisioner's feature gate (settings.go:44)
    drift_enabled: bool = False
    # pods one provisioning pass solves, oldest first (0: up to the
    # ladder's top rung); the rest re-enter the next window at once
    batch_max_pods: int = 0
    bucket_ladder: Tuple[GeometryTier, ...] = DEFAULT_BUCKET_LADDER
    # victims per consolidation pass; 0 is unbounded
    consolidation_disruption_budget: int = 0

    def effective_batch_max_pods(self) -> int:
        """The pass cap enforced: batch_max_pods clamped to the ladder's
        top rung, or the top rung when batch_max_pods is 0."""
        top = self.bucket_ladder[-1].pods if self.bucket_ladder else 0
        if self.batch_max_pods and top:
            return min(self.batch_max_pods, top)
        return self.batch_max_pods or top

    def steady_state_tier(self) -> Optional[GeometryTier]:
        """The tier a steady-state pass lands on: the smallest that holds
        batch_max_pods, else the top rung."""
        if not self.bucket_ladder:
            return None
        if self.batch_max_pods:
            for tier in self.bucket_ladder:
                if self.batch_max_pods <= tier.pods:
                    return tier
        return self.bucket_ladder[-1]

    @classmethod
    def from_config_map(cls, data: Dict[str, str]) -> "Settings":
        """The settings ConfigMap's data (settings.go:53-85): durations in
        Go's syntax, the drift gate as a boolean; ValueError on a malformed
        value or one that fails validation (the batch windows must be
        positive, the registration TTL empty or positive, the counts not
        negative)."""
        s = cls()
        if "batchMaxDuration" in data:
            s.batch_max_duration = _parse_duration(data["batchMaxDuration"])
        if "batchIdleDuration" in data:
            s.batch_idle_duration = _parse_duration(data["batchIdleDuration"])
        if "ttlAfterNotRegistered" in data:
            raw = data["ttlAfterNotRegistered"]
            s.ttl_after_not_registered = None if raw == "" else _parse_duration(raw)
        if "featureGates.driftEnabled" in data:
            raw = data["featureGates.driftEnabled"].lower()
            if raw not in ("true", "false"):
                raise ValueError(f"featureGates.driftEnabled: not a boolean: {raw!r}")
            s.drift_enabled = raw == "true"
        if "batchMaxPods" in data:
            s.batch_max_pods = int(data["batchMaxPods"])
        if "bucketLadder" in data:
            s.bucket_ladder = parse_bucket_ladder(data["bucketLadder"])
        if "consolidationDisruptionBudget" in data:
            s.consolidation_disruption_budget = int(data["consolidationDisruptionBudget"])
        if s.consolidation_disruption_budget < 0:
            raise ValueError("consolidationDisruptionBudget cannot be negative")
        if s.batch_max_pods < 0:
            raise ValueError("batchMaxPods cannot be negative")
        if s.batch_max_duration <= 0:
            raise ValueError("batchMaxDuration cannot be negative")
        if s.batch_idle_duration <= 0:
            raise ValueError("batchIdleDuration cannot be negative")
        if s.ttl_after_not_registered is not None and s.ttl_after_not_registered <= 0:
            raise ValueError("ttlAfterNotRegistered cannot be negative")
        return s


_UNIT_SECONDS = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}
_DURATION_PART = r"([0-9]+(?:\.[0-9]*)?)(h|m(?!s)|s|ms|us|ns)"


def _parse_duration(value: str) -> float:
    """A Go duration ("10s", "1m30s", "500ms") in seconds; ValueError on
    anything time.ParseDuration refuses."""
    value = value.strip()
    if not re.fullmatch(f"(?:{_DURATION_PART})+", value):
        raise ValueError(f"cannot parse duration {value!r}")
    return sum(float(n) * _UNIT_SECONDS[u] for n, u in re.findall(_DURATION_PART, value))


_current = Settings()


def current() -> Settings:
    return _current


def set_current(settings: Settings) -> None:
    global _current
    _current = settings
