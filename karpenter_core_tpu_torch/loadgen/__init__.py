"""Churn load generation (the reference's loadgen/): seeded,
deterministic sustained-traffic processes that drive the REAL operator loop
(batcher -> provisioner -> solver -> bind), not the solver directly.

Three pieces:

  * churn.ChurnGenerator: a deterministic event schedule (pod arrivals,
    terminations, resizes) from seeded Poisson processes with sinusoidal
    burst modulation and a weighted scenario mix;
  * scenarios: pod builders over a BOUNDED label vocabulary, so the
    solver's dictionary geometry stabilizes and steady-state churn exercises
    the incremental delta re-solve path (solver/incremental.py) instead of
    a full precompute per batch;
  * driver.SoakDriver: applies the schedule to a full operator (fake cloud
    provider + in-memory apiserver), plays kubelet for nominated pods via
    the provisioner bind feed, and reports SLOs (admission->bind p50/p99,
    queue depth, incremental-solve hit ratio) from real metrics exposition.

Layering: loadgen may depend on controllers/solver/operator; nothing else
in the package depends on loadgen.
"""
from karpenter_core_tpu_torch.loadgen.churn import ChurnConfig, ChurnEvent, ChurnGenerator
from karpenter_core_tpu_torch.loadgen.driver import SoakDriver, SoakReport
from karpenter_core_tpu_torch.loadgen.scenarios import SCENARIOS, ScenarioMixer

__all__ = [
    "ChurnConfig",
    "ChurnEvent",
    "ChurnGenerator",
    "ScenarioMixer",
    "SCENARIOS",
    "SoakDriver",
    "SoakReport",
]
