"""SoakDriver: applies a churn schedule to a FULL operator and reports SLOs.

The driver is the world around the control plane: it is the workload
(creating, deleting, and resizing pods on the in-memory apiserver at the
generator's pace) and the kubelet/kube-scheduler (binding pods the
provisioning loop nominated, via ProvisioningController.bind_listeners —
the reference leaves binding to the real scheduler, and without it every
pod would stay pending forever and the admission->bind SLO would measure
nothing). Everything in between — watch pumps, batcher windows, solves,
launches — is the REAL operator loop.

Two run modes mirror the operator's:

  run()       realtime: op.start() background pumps + singletons, events
              applied on the wall clock (the soak on the card)
  run_steps() virtual time: a FakeClock advanced event-to-event with
              synchronous op.step() passes — deterministic, fast, what the
              test suite uses

SLOs come from real metrics exposition (the provisioner's
karpenter_admission_to_bind_seconds histogram and karpenter_pending_pods
gauge), baseline-diffed so a soak reports ONLY its own window; the
incremental-solve hit ratio comes from karpenter_incremental_screen_total;
per-mode prescreen device timings come from solver.phase.prescreen tracer
spans. The reference's solver needs profile_phases=True for its spans to
cover the device execution; the port's TorchSolver synchronizes the device
at every phase mark, so its solver.phase.prescreen span covers the screen
kernels' work with no option.

The default solver is TorchSolver(max_nodes, screen_mode="prescreen") on
the CUDA card (it raises without one); pass `solver=` to run elsewhere.
"""
from __future__ import annotations

import statistics
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from karpenter_core_tpu_torch.api.labels import (
    LABEL_CAPACITY_TYPE,
    LABEL_NODE_INITIALIZED,
    PROVISIONER_NAME_LABEL_KEY,
)
from karpenter_core_tpu_torch.api.settings import Settings
from karpenter_core_tpu_torch.chaos import CHAOS_INJECTED_TOTAL
from karpenter_core_tpu_torch.cloudprovider import fake
from karpenter_core_tpu_torch.controllers.provisioning.provisioner import (
    ADMISSION_TO_BIND,
    PENDING_PODS,
)
from karpenter_core_tpu_torch.loadgen.churn import ARRIVE, RESIZE, TERMINATE, ChurnConfig, ChurnGenerator
from karpenter_core_tpu_torch.loadgen.scenarios import CPU_STEPS, ScenarioMixer
from karpenter_core_tpu_torch.kube.objects import (
    LABEL_INSTANCE_TYPE_STABLE,
    LABEL_TOPOLOGY_ZONE,
)
from karpenter_core_tpu_torch.obs import TRACER
from karpenter_core_tpu_torch.obs.log import get_logger
from karpenter_core_tpu_torch.operator import new_operator
from karpenter_core_tpu_torch.solver.incremental import OUTCOMES as INCREMENTAL_SCREEN_TOTAL
from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver
from karpenter_core_tpu_torch.testing import make_node, make_pod, make_provisioner

LOG = get_logger("karpenter.loadgen")

INC_OUTCOMES = (
    "refresh", "full_miss", "full_wide", "full_shape", "full_gated", "full_deg",
)
_PRESCREEN_SPAN = "solver.phase.prescreen"


@dataclass
class SoakReport:
    duration_s: float = 0.0
    pods_created: int = 0
    pods_terminated: int = 0
    resizes: int = 0
    binds: int = 0
    unbound_at_end: int = 0
    machines_launched: int = 0
    admission_count: int = 0
    admission_p50_s: Optional[float] = None
    admission_p99_s: Optional[float] = None
    pending_max: float = 0.0
    pending_mean: float = 0.0
    inc_outcomes: Dict[str, int] = field(default_factory=dict)
    resolve_ratio: Optional[float] = None  # refresh / all prescreen solves
    prescreen_refresh_med_ms: Optional[float] = None
    prescreen_full_med_ms: Optional[float] = None
    prescreen_cold: int = 0  # first dispatches of a geometry, excluded from medians
    device_med_ms: Optional[float] = None
    chaos_injected: int = 0
    loops_alive: bool = True

    def as_columns(self, prefix: str = "churn_") -> Dict[str, object]:
        """Flat columns under the reference's names (its bench's churn
        columns)."""
        cols = {
            f"{prefix}duration_s": round(self.duration_s, 1),
            f"{prefix}pods_created": self.pods_created,
            f"{prefix}pods_terminated": self.pods_terminated,
            f"{prefix}resizes": self.resizes,
            f"{prefix}binds": self.binds,
            f"{prefix}unbound_at_end": self.unbound_at_end,
            f"{prefix}machines": self.machines_launched,
            f"{prefix}admission_count": self.admission_count,
            f"{prefix}admission_p50_s": self.admission_p50_s,
            f"{prefix}admission_p99_s": self.admission_p99_s,
            f"{prefix}pending_max": self.pending_max,
            f"{prefix}pending_mean": round(self.pending_mean, 1),
            f"{prefix}resolve_ratio": (
                round(self.resolve_ratio, 3) if self.resolve_ratio is not None else None
            ),
            f"{prefix}prescreen_refresh_med_ms": self.prescreen_refresh_med_ms,
            f"{prefix}prescreen_full_med_ms": self.prescreen_full_med_ms,
            f"{prefix}prescreen_cold": self.prescreen_cold,
            f"{prefix}device_med_ms": self.device_med_ms,
            f"{prefix}chaos_injected": self.chaos_injected,
            f"{prefix}loops_alive": self.loops_alive,
        }
        for outcome in INC_OUTCOMES:
            cols[f"{prefix}inc_{outcome}"] = self.inc_outcomes.get(outcome, 0)
        return cols


class SoakDriver:
    def __init__(
        self,
        config: ChurnConfig,
        instance_type_count: int = 8,
        solver=None,
        settings: Optional[Settings] = None,
        clock=None,
        max_nodes: int = 256,
        tail_timeout_s: float = 10.0,
    ):
        self.config = config
        self.clock = clock or time.time
        self.tail_timeout_s = tail_timeout_s
        self.generator = ChurnGenerator(config)
        # independent child streams: target selection must not perturb the
        # generator's schedule, and the mixer's pod shapes must not depend
        # on how many terminations found a target
        mix_rng, self._target_rng = (
            np.random.default_rng(s)
            for s in np.random.SeedSequence((config.seed << 8) ^ 0x50AC).spawn(2)
        )
        self.mixer = ScenarioMixer(mix_rng)
        self.solver = solver or TorchSolver(max_nodes=max_nodes, screen_mode="prescreen")
        self.cloud = fake.FakeCloudProvider(fake.instance_types(instance_type_count))
        self.op = new_operator(
            self.cloud,
            # capped batches: steady-state passes stay in ONE solve geometry
            # (stable pow2 item bucket), so a slow pass can't inflate the
            # next batch into a fresh geometry (and a full precompute); the
            # cap of 16 was sized to the reference's compile buckets
            settings=settings
            or Settings(
                batch_idle_duration=0.05, batch_max_duration=0.5,
                batch_max_pods=16,
            ),
            solver=self.solver,
            clock=self.clock,
        )
        self.op.provisioning.bind_listeners.append(self._on_bind)
        # the report's per-mode prescreen medians and device median read
        # solver.phase.* spans
        TRACER.enable()
        self._bind_q: deque = deque()  # (ns, name, node) from the reconcile thread
        self.report = SoakReport()
        self._pending_samples: List[float] = []
        self._prescreen_ms: Dict[str, List[float]] = {"refresh": [], "full": []}
        self._device_ms: List[float] = []
        self._trace_mark = 0

    # -- kubelet analog ----------------------------------------------------

    def _on_bind(self, pod, node_name: str) -> None:
        self._bind_q.append((pod.metadata.namespace, pod.metadata.name, node_name))

    def drain_binds(self) -> int:
        """Apply queued nominations as bindings (set spec.node_name), the
        way the kube-scheduler + kubelet would. Best-effort per pod: a pod
        deleted between nomination and bind is simply gone."""
        bound = 0
        while self._bind_q:
            ns, name, node = self._bind_q.popleft()
            try:
                pod = self.op.kube_client.get("Pod", ns, name)
                if pod is None or pod.spec.node_name:
                    continue
                pod.spec.node_name = node
                self.op.kube_client.update(pod)
                bound += 1
            except Exception:  # noqa: BLE001 — chaos may sit on the client
                # put it back for the next drain: nominations are precious
                self._bind_q.append((ns, name, node))
                break
        self.report.binds += bound
        return bound

    # -- steady-state seed -------------------------------------------------

    def _seed_cluster(self) -> None:
        """Provisioner + `initial_nodes` pre-existing READY nodes, created
        before the first event: a soak measures steady-state churn over a
        RUNNING cluster, not genesis. Seeding also pins the solve geometry:
        the encoder buckets the existing-node axis pow2, so a cluster grown
        one launch at a time crosses bucket edges (8 -> 16 -> 32) during the
        measured window, and each crossing mints a fresh geometry and
        evicts the incremental path's resident verdict tensor. Starting
        inside a stable bucket turns those into warmup-covered geometries."""
        self.op.kube_client.create(make_provisioner(name="default"))
        universe = self.cloud.instance_types
        zones = ("test-zone-1", "test-zone-2", "test-zone-3")
        for i in range(self.config.initial_nodes):
            # cycle the BIGGER half of the ladder: seed capacity is the
            # churn's landing zone, and 1-cpu seeds would just be noise rows
            it = universe[len(universe) // 2 + i % max(len(universe) - len(universe) // 2, 1)]
            node = make_node(
                name=f"seed-node-{i}",
                labels={
                    PROVISIONER_NAME_LABEL_KEY: "default",
                    LABEL_NODE_INITIALIZED: "true",
                    LABEL_INSTANCE_TYPE_STABLE: it.name,
                    LABEL_TOPOLOGY_ZONE: zones[i % len(zones)],
                    LABEL_CAPACITY_TYPE: "on-demand",
                },
                capacity=dict(it.capacity),
                provider_id=f"fake:///seed-node-{i}",
            )
            self.op.kube_client.create(node)

    # -- event application -------------------------------------------------

    def _bound_pods(self) -> List:
        # shared references: the driver only reads a victim's name and
        # labels (and copies the labels), so the list clones nothing, which
        # at a real cluster's pod count would cost the loop it measures
        return self.op.kube_client.list(
            "Pod", field_filter=lambda p: bool(p.spec.node_name), copy_objects=False
        )

    def apply_event(self, event) -> None:
        if event.kind == ARRIVE:
            for pod in self.mixer.make(event.scenario, event.count):
                pod.metadata.creation_timestamp = self.clock()
                self.op.kube_client.create(pod)
                self.report.pods_created += 1
        elif event.kind == TERMINATE:
            bound = self._bound_pods()
            if bound:
                victim = bound[int(self._target_rng.integers(len(bound)))]
                self.op.kube_client.delete(
                    "Pod", victim.metadata.namespace, victim.metadata.name
                )
                self.report.pods_terminated += 1
        elif event.kind == RESIZE:
            bound = self._bound_pods()
            if bound:
                victim = bound[int(self._target_rng.integers(len(bound)))]
                self.op.kube_client.delete(
                    "Pod", victim.metadata.namespace, victim.metadata.name
                )
                replacement = make_pod(
                    name=f"{victim.metadata.name}-r",
                    labels=dict(victim.metadata.labels),
                    requests={
                        "cpu": str(CPU_STEPS[int(self._target_rng.integers(len(CPU_STEPS)))]),
                        "memory": "512Mi",
                    },
                )
                replacement.metadata.creation_timestamp = self.clock()
                self.op.kube_client.create(replacement)
                self.report.pods_terminated += 1
                self.report.pods_created += 1
                self.report.resizes += 1

    # -- sampling ----------------------------------------------------------

    def _sample(self) -> None:
        depth = PENDING_PODS.get()
        if depth is not None:
            self._pending_samples.append(depth)
        for span in TRACER.spans_since(self._trace_mark):
            if span.name == _PRESCREEN_SPAN:
                # cold dispatches pay one-time costs (a geometry's first
                # allocations, the kernels' load); the churn medians compare
                # STEADY-STATE device time, so they go in their own bucket
                # (still counted, reported separately)
                mode = str(span.attrs.get("mode", "full"))
                if span.attrs.get("cold"):
                    mode += "_cold"
                self._prescreen_ms.setdefault(mode, []).append(span.duration_ms)
            elif span.name == "solver.phase.device":
                self._device_ms.append(span.duration_ms)
        self._trace_mark = TRACER.mark()

    def _unbound(self) -> int:
        return len(
            self.op.kube_client.list(
                "Pod", field_filter=lambda p: not p.spec.node_name, copy_objects=False
            )
        )

    # -- runs --------------------------------------------------------------

    def _baselines(self) -> dict:
        return {
            # merged across the per-tenant series the attribution plane
            # splits binds into: the soak SLO is whole-stream
            "admission": ADMISSION_TO_BIND.merged_snapshot(),
            "inc": {
                o: INCREMENTAL_SCREEN_TOTAL.get({"outcome": o})
                for o in INC_OUTCOMES
            },
            "chaos": sum(CHAOS_INJECTED_TOTAL.values.values()),
            "machines": len(self.op.kube_client.list("Machine")),
        }

    def _finish(self, base: dict, started_monotonic: Optional[float],
                virtual_elapsed: Optional[float] = None) -> SoakReport:
        self._sample()
        r = self.report
        r.duration_s = (
            virtual_elapsed
            if virtual_elapsed is not None
            else time.monotonic() - started_monotonic
        )
        r.unbound_at_end = self._unbound()
        r.machines_launched = (
            len(self.op.kube_client.list("Machine")) - base["machines"]
        )
        r.admission_count = (
            ADMISSION_TO_BIND.merged_snapshot()[1] - base["admission"][1]
        )
        r.admission_p50_s = ADMISSION_TO_BIND.merged_percentile(0.5, baseline=base["admission"])
        r.admission_p99_s = ADMISSION_TO_BIND.merged_percentile(0.99, baseline=base["admission"])
        if self._pending_samples:
            r.pending_max = max(self._pending_samples)
            r.pending_mean = statistics.fmean(self._pending_samples)
        r.inc_outcomes = {
            o: int(INCREMENTAL_SCREEN_TOTAL.get({"outcome": o}) - base["inc"][o])
            for o in INC_OUTCOMES
        }
        total = sum(r.inc_outcomes.values())
        if total:
            r.resolve_ratio = r.inc_outcomes.get("refresh", 0) / total
        if self._prescreen_ms.get("refresh"):
            r.prescreen_refresh_med_ms = round(
                statistics.median(self._prescreen_ms["refresh"]), 1
            )
        if self._prescreen_ms.get("full"):
            r.prescreen_full_med_ms = round(
                statistics.median(self._prescreen_ms["full"]), 1
            )
        r.prescreen_cold = sum(
            len(v) for k, v in self._prescreen_ms.items() if k.endswith("_cold")
        )
        if self._device_ms:
            r.device_med_ms = round(statistics.median(self._device_ms), 1)
        r.chaos_injected = int(
            sum(CHAOS_INJECTED_TOTAL.values.values()) - base["chaos"]
        )
        return r

    def run(self, on_progress=None) -> SoakReport:
        """Realtime soak: background operator, wall-clock pacing. The event
        schedule's `at` offsets are honored best-effort (a slow solve delays
        later events rather than dropping them — queueing is the signal the
        pending-depth SLO exists to catch)."""
        self._seed_cluster()
        base = self._baselines()
        self._trace_mark = TRACER.mark()
        self.op.start()
        t0 = time.monotonic()
        next_sample = 0.0
        try:
            for event in self.generator.events():
                while True:
                    now = time.monotonic() - t0
                    if now >= next_sample:
                        self._sample()
                        if on_progress is not None:
                            on_progress(now, self.report)
                        next_sample = now + 0.25
                    self.drain_binds()
                    dt = event.at - now
                    if dt <= 0:
                        break
                    time.sleep(min(dt, 0.05))
                self.apply_event(event)
            # tail: let the loop place + bind what the schedule left behind
            deadline = time.monotonic() + self.tail_timeout_s
            while time.monotonic() < deadline:
                self.drain_binds()
                self._sample()
                if self._unbound() == 0 and not self._bind_q:
                    break
                time.sleep(0.05)
            self.report.loops_alive = all(t.is_alive() for t in self.op._threads)
        finally:
            self.op.stop()
        return self._finish(base, t0)

    def run_steps(self) -> SoakReport:
        """Virtual-time soak: FakeClock advanced event-to-event, one
        synchronous op.step() per distinct event time. Deterministic: the
        test-suite harness."""
        clock = self.clock
        if not hasattr(clock, "advance"):
            raise TypeError("run_steps needs a steppable clock (testing.FakeClock)")
        self._seed_cluster()
        base = self._baselines()
        self._trace_mark = TRACER.mark()
        events = self.generator.events()
        virtual = 0.0
        i = 0
        while i < len(events):
            at = events[i].at
            clock.advance(at - virtual)
            virtual = at
            while i < len(events) and events[i].at == at:
                self.apply_event(events[i])
                i += 1
            self.op.step()
            self.drain_binds()
            self._sample()
        # tail: steps until everything bound (bounded — each pass both
        # nominates and, via drain, binds)
        for _ in range(10):
            if self._unbound() == 0 and not self._bind_q:
                break
            clock.advance(1.0)
            virtual += 1.0
            self.op.step()
            self.drain_binds()
        return self._finish(base, None, virtual_elapsed=max(virtual, 1e-9))
