"""Global settings (settings.go:32-68) as far as the port reads them, and
the solver's geometry bucket ladder.

Every batch axis the solve is shaped by (items, instance types, existing
nodes) pads up to a tier value, so the padded shapes, and with them the
commit log and slot state, match the reference solver's for the same batch.
`current()` is the process-wide Settings; `set_current()` replaces it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


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


@dataclass
class Settings:
    # the provisioning batch window's upper bound, seconds; a node
    # nominated for a pod stays nominated for twice this (at least 10 s)
    batch_max_duration: float = 10.0
    # victims per consolidation pass; 0 is unbounded
    consolidation_disruption_budget: int = 0
    # a machine whose node has not registered after this many seconds is
    # deleted (None turns the reaper off)
    ttl_after_not_registered: Optional[float] = 15 * 60.0
    # the Drift deprovisioner's feature gate (settings.go:44)
    drift_enabled: bool = False


_current = Settings()


def current() -> Settings:
    return _current


def set_current(settings: Settings) -> None:
    global _current
    _current = settings
