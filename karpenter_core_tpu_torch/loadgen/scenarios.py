"""Scenario pod builders over a BOUNDED vocabulary (the reference's
loadgen/scenarios.py: the same rng gives pods with equal specs).

The solver's residency key embeds the label dictionary and the
pow2-bucketed axis widths, and the incremental delta re-solve only replays
when consecutive solves land on the SAME key, so churn pods draw every
label key/value, request size, and constraint shape from small fixed pools.
A generator that minted fresh label values per pod would make every batch a
full precompute, which is a different benchmark.

Scenario families mirror the fuzz geometries the parity suites cover:

  generic  independent pods: app label + stepped cpu/memory requests
  bulk     one deployment-shaped replica group (shared class: exercises
           encode's class dedup + the pack kernel's bulk commits)
  spread   hostname topology spread over a shared app (skew counters)
  anti     required hostname anti-affinity on a dedicated app pool (the
           per-pod item expansion path)
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from karpenter_core_tpu_torch.kube.objects import (
    LabelSelector,
    PodAffinityTerm,
    TopologySpreadConstraint,
)
from karpenter_core_tpu_torch.api.labels import TENANT_LABEL_KEY
from karpenter_core_tpu_torch.testing import make_pod

HOSTNAME_KEY = "kubernetes.io/hostname"

APPS = tuple(f"churn-app-{i}" for i in range(8))
# tenants the churn bills its load to: a SMALL FIXED pool for the same
# reason as APPS (the tenant label rides in the pod label dict, so fresh
# tenant values per pod would churn the residency keys).
# The pool also stays under the cardinality guard's slot cap so loadgen
# runs never exercise the "other" overflow by accident.
TENANT_POOL = ("tenant-blue", "tenant-green", "tenant-red")
# ONE spread pool and ONE anti pool, not several: every distinct multiset
# of topology/anti-affinity groups in a batch is part of the solve
# geometry (its topology signature), so pools multiply the geometries
# combinatorially; the bounded-vocabulary rule applies to constraint
# GROUPS exactly as it does to label values
SPREAD_APPS = ("churn-spread-0",)
ANTI_APPS = ("churn-anti-0",)
CPU_STEPS = (0.25, 0.5, 1.0, 1.5)
MEM_STEPS = ("256Mi", "512Mi", "1Gi")


class ScenarioMixer:
    """Builds scenario pods deterministically from a seeded rng; pod names
    are unique per mixer instance (one mixer per soak run)."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng
        self._n = 0
        self._groups = 0

    def _name(self, scenario: str) -> str:
        self._n += 1
        return f"{scenario}-{self._n}"

    def _tenant(self) -> str:
        """One tenant per scenario GROUP, round-robin off a plain counter:
        deterministic and rng-stream-neutral (pre-tenant replays draw the
        identical app/request sequences), and group-level — a bulk
        deployment stays one encode class instead of splitting per pod."""
        tenant = TENANT_POOL[self._groups % len(TENANT_POOL)]
        self._groups += 1
        return tenant

    def _requests(self) -> Dict[str, str]:
        return {
            "cpu": str(CPU_STEPS[int(self.rng.integers(len(CPU_STEPS)))]),
            "memory": MEM_STEPS[int(self.rng.integers(len(MEM_STEPS)))],
        }

    def generic(self, count: int) -> List:
        tenant = self._tenant()
        return [
            make_pod(
                name=self._name("generic"),
                labels={
                    "app": APPS[int(self.rng.integers(len(APPS)))],
                    TENANT_LABEL_KEY: tenant,
                },
                requests=self._requests(),
            )
            for _ in range(count)
        ]

    def bulk(self, count: int) -> List:
        app = APPS[int(self.rng.integers(len(APPS)))]
        requests = self._requests()
        labels = {"app": app, TENANT_LABEL_KEY: self._tenant()}
        return [
            make_pod(name=self._name("bulk"), labels=dict(labels), requests=requests)
            for _ in range(count)
        ]

    def spread(self, count: int) -> List:
        app = SPREAD_APPS[int(self.rng.integers(len(SPREAD_APPS)))]
        tenant = self._tenant()
        requests = self._requests()
        constraint = TopologySpreadConstraint(
            max_skew=2,
            topology_key=HOSTNAME_KEY,
            when_unsatisfiable="DoNotSchedule",
            label_selector=LabelSelector(match_labels={"app": app}),
        )
        return [
            make_pod(
                name=self._name("spread"),
                labels={"app": app, TENANT_LABEL_KEY: tenant},
                requests=requests,
                topology_spread=[constraint],
            )
            for _ in range(count)
        ]

    def anti(self, count: int) -> List:
        app = ANTI_APPS[int(self.rng.integers(len(ANTI_APPS)))]
        tenant = self._tenant()
        term = PodAffinityTerm(
            topology_key=HOSTNAME_KEY,
            label_selector=LabelSelector(match_labels={"app": app}),
        )
        return [
            make_pod(
                name=self._name("anti"),
                labels={"app": app, TENANT_LABEL_KEY: tenant},
                requests={"cpu": "0.5"},
                pod_anti_affinity_required=[term],
            )
            for _ in range(count)
        ]

    def make(self, scenario: str, count: int) -> List:
        return SCENARIOS[scenario](self, count)


SCENARIOS: Dict[str, Callable[[ScenarioMixer, int], List]] = {
    "generic": ScenarioMixer.generic,
    "bulk": ScenarioMixer.bulk,
    "spread": ScenarioMixer.spread,
    "anti": ScenarioMixer.anti,
}
