"""The startup prewarm: pay the bucket ladder's cold costs before the
pods arrive.

The geometry bucket ladder (api/settings.py GeometryTier) makes the
geometries a process can meet enumerable: every batch axis pads to a tier
value. This module makes a vocabulary-neutral synthetic workload per tier,
against the cluster's real provisioners and instance types, and hands its
snapshot to `TorchSolver.prewarm_snapshot`, which loads the CUDA screen
library (nvcc builds it when the source is newer than the built one),
uploads the snapshot and runs the prescreen at its geometry: the first
kernel launches and the caching allocator's first allocations there. The
first live Solve() after a restart then finds all of that done.

The reference compiles XLA programs here; the port has no program to
compile, and its built library already persists on disk
(ops/cuda_build.py), so the outcome "compiled" means this tier's call
loaded the library or first met its geometry, "cached" that a live solve
or an earlier tier got there first.

On a device grid (parallel/sharded.ShardedSolver) each tier routes as a
live solve at its geometry would: a tier that clears the routing floor
prewarms the grid's tiles under the grid's key, one below it the single
device under its own, so the live solve at either counts a hit.

A live solve that arrives mid-prewarm waits for the one tier in flight
(the solver's lock), never for the ladder. A tier that fails is logged as
a warning and counted with outcome "error", `karpenter_prewarm_ready`
stays 0, and the operator runs on.

Order: the steady-state tier (Settings.steady_state_tier, the rung the
batcher's pass cap lands on) first, then the rest ascending. Metrics:
karpenter_prewarm_{total,seconds,ready}; a `solver.prewarm` span per tier.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

from karpenter_core_tpu_torch.metrics.registry import NAMESPACE, REGISTRY
from karpenter_core_tpu_torch.obs import TRACER
from karpenter_core_tpu_torch.obs.log import get_logger

LOG = get_logger("karpenter.solver.prewarm")

PREWARM_TOTAL = REGISTRY.counter(
    f"{NAMESPACE}_prewarm_total",
    "Bucket-ladder prewarm outcomes, by tier and outcome (compiled = this "
    "thread paid the tier's cold costs, cached = a live solve or an earlier "
    "tier got there first, error = the tier failed, skipped = stopped early)",
)
PREWARM_SECONDS = REGISTRY.histogram(
    f"{NAMESPACE}_prewarm_seconds",
    "Seconds one tier's prewarm took: the synthetic workload, its encode "
    "and the solver's prewarm_snapshot (a library load or build included)",
)
PREWARM_READY = REGISTRY.gauge(
    f"{NAMESPACE}_prewarm_ready",
    "1 once every requested tier finished prewarming (0 while in flight)",
)


def synthetic_workload(tier, provisioners, instance_types,
                       pods_count: Optional[int] = None):
    """A vocabulary-neutral (pods, state_nodes) pair that encodes to the
    tier's geometry against the REAL provisioner/type universe.

    Pods carry only distinct metadata labels (spec-equivalence classes
    WITHOUT touching the label dictionary — pod labels only enter the
    dictionary through topology selection, and these pods declare none) and
    uniform requests; nodes carry the standard provisioned-node label set
    with synthetic hostnames (hostname VALUES differ from the live
    cluster's, but the geometry key depends only on segment widths).

    pods_count overrides the default tier-top sizing: the pods-DERIVED
    axes (commit log, slot budget) are fine pow2 of the LIVE batch size,
    so the steady-state tier must prewarm at the batcher's actual pass cap
    — prewarm() passes batch_max_pods — or the live pass lands one pow2
    rung away from the warmed geometry and misses it."""
    from karpenter_core_tpu_torch.api import labels as api_labels
    from karpenter_core_tpu_torch.kube.objects import (
        LABEL_INSTANCE_TYPE_STABLE,
        LABEL_TOPOLOGY_ZONE,
        Condition,
        Container,
        Node,
        ObjectMeta,
        Pod,
        PodSpec,
        ResourceRequirements,
    )
    from karpenter_core_tpu_torch.state.node import StateNode

    # default: the top of the rung minus the commit-log headroom (so
    # log_len lands on the tier's own pow2), spread over tier.items
    # distinct spec classes
    n_pods = max(pods_count or (tier.pods - 64), 1)
    n_items = max(min(tier.items, n_pods), 1)
    pods: List[Pod] = []
    for i in range(n_pods):
        pods.append(
            Pod(
                metadata=ObjectMeta(
                    name=f"prewarm-{i}",
                    labels={"app": f"prewarm-{i % n_items}"},
                    creation_timestamp=0.0,
                ),
                spec=PodSpec(
                    containers=[
                        Container(
                            resources=ResourceRequirements(
                                requests={"cpu": 0.1, "memory": 128 * 2**20}
                            )
                        )
                    ]
                ),
            )
        )

    all_types = [it for its in instance_types.values() for it in its]
    prov_name = provisioners[0].name if provisioners else "default"
    nodes = []
    for e in range(tier.existing_nodes):
        it = all_types[e % len(all_types)] if all_types else None
        offering = it.offerings[0] if it is not None and it.offerings else None
        labels = {
            api_labels.PROVISIONER_NAME_LABEL_KEY: prov_name,
            api_labels.LABEL_NODE_INITIALIZED: "true",
        }
        if it is not None:
            labels[LABEL_INSTANCE_TYPE_STABLE] = it.name
        if offering is not None:
            labels[LABEL_TOPOLOGY_ZONE] = offering.zone
            labels[api_labels.LABEL_CAPACITY_TYPE] = offering.capacity_type
        node = Node(metadata=ObjectMeta(name=f"prewarm-node-{e}", labels=labels))
        node.spec.provider_id = f"prewarm:///{node.metadata.name}"
        if it is not None:
            node.status.capacity = dict(it.capacity)
            node.status.allocatable = dict(it.allocatable())
        node.status.conditions.append(Condition(type="Ready", status="True"))
        nodes.append(StateNode(node=node))
    return pods, nodes


def _order_tiers(ladder, settings) -> List:
    """Steady-state tier first, then the rest ascending."""
    tiers = list(ladder)
    steady = settings.steady_state_tier() if settings is not None else None
    if steady is not None and steady in tiers:
        tiers.remove(steady)
        tiers.insert(0, steady)
    return tiers


def prewarm(
    solver,
    provisioners: Sequence,
    instance_types: Dict[str, List],
    settings=None,
    tiers: Optional[Sequence[str]] = None,
    stop: Optional[threading.Event] = None,
) -> Dict[str, str]:
    """Prewarm the ladder's tiers on `solver` (one with prewarm_snapshot:
    TorchSolver; start_prewarm_thread skips any other). Returns {tier
    name: outcome}. `stop` is honored between tiers, so a shutdown never
    waits for a tier that has not started."""
    from karpenter_core_tpu_torch.api import settings as api_settings
    from karpenter_core_tpu_torch.solver.encode import encode_snapshot

    settings = settings or api_settings.current()
    ladder = tuple(settings.bucket_ladder or ())
    if tiers is not None:
        wanted = set(tiers)
        ladder = tuple(t for t in ladder if t.name in wanted)
    outcomes: Dict[str, str] = {}
    PREWARM_READY.set(0.0)
    if not ladder:
        # nothing selected (empty ladder, or KARPENTER_PREWARM_TIERS names
        # no configured tier): leave ready at 0 and say so — an empty
        # outcome set must never read as "fully warm"
        LOG.warning(
            "prewarm selected no tiers",
            requested=",".join(tiers) if tiers is not None else "",
        )
        return outcomes
    steady = settings.steady_state_tier()
    for tier in _order_tiers(ladder, settings):
        if stop is not None and stop.is_set():
            outcomes[tier.name] = "skipped"
            PREWARM_TOTAL.inc({"tier": tier.name, "outcome": "skipped"})
            continue
        t0 = time.perf_counter()
        try:
            with TRACER.span(
                "solver.prewarm", tier=tier.name, pods=tier.pods,
                items=tier.items, types=tier.instance_types,
                existing=tier.existing_nodes,
            ):
                pods, nodes = synthetic_workload(
                    tier, provisioners, instance_types,
                    # the steady-state tier warms at the batcher's REAL
                    # pass size: the pods-derived pow2 axes (commit log,
                    # slot budget) must match the live capped pass or the
                    # common case misses the warmed geometry
                    pods_count=(
                        settings.batch_max_pods
                        if tier is steady and settings.batch_max_pods
                        and settings.batch_max_pods <= tier.pods
                        else None
                    ),
                )
                snap = encode_snapshot(
                    list(pods), list(provisioners), instance_types,
                    state_nodes=nodes, max_nodes=solver.max_nodes,
                    ladder=ladder or None,
                )
                outcomes[tier.name] = solver.prewarm_snapshot(
                    snap, list(provisioners)
                )
        except Exception as exc:  # noqa: BLE001 — a prewarm never kills the operator
            outcomes[tier.name] = "error"
            LOG.warning(
                "prewarm tier failed", tier=tier.name,
                error=type(exc).__name__, error_detail=str(exc)[:200],
            )
        seconds = time.perf_counter() - t0
        PREWARM_TOTAL.inc({"tier": tier.name, "outcome": outcomes[tier.name]})
        PREWARM_SECONDS.observe(seconds)
        LOG.info(
            "prewarm tier done", tier=tier.name,
            outcome=outcomes[tier.name], seconds=round(seconds, 3),
        )
    if all(o in ("compiled", "cached") for o in outcomes.values()):
        PREWARM_READY.set(1.0)
    return outcomes


def start_prewarm_thread(
    solver,
    provisioners_fn,
    instance_types_fn,
    settings=None,
    tiers: Optional[Sequence[str]] = None,
    stop: Optional[threading.Event] = None,
    wait_seconds: float = 600.0,
) -> Optional[threading.Thread]:
    """Run prewarm on a named daemon thread, overlapped with the watch
    sync: provisioners_fn and instance_types_fn are polled until the
    cluster has a provisioner (nothing to prewarm against before), then
    the ladder warms in priority order. Returns the thread, or None when
    the solver has no prewarm_snapshot (the host greedy solver)."""
    if not hasattr(solver, "prewarm_snapshot"):
        LOG.info(
            "prewarm skipped: solver has no prewarm surface",
            solver=type(solver).__name__,
        )
        return None

    def _run():
        deadline = time.monotonic() + wait_seconds
        provisioners = []
        while time.monotonic() < deadline:
            if stop is not None and stop.is_set():
                return
            try:
                provisioners = list(provisioners_fn() or [])
            except Exception:  # noqa: BLE001 — watch cache still syncing
                provisioners = []
            if provisioners:
                break
            if stop is not None:
                stop.wait(3.0)
            else:
                time.sleep(3.0)
        if not provisioners:
            LOG.info("prewarm skipped: no provisioners appeared in time")
            return
        try:
            instance_types = instance_types_fn(provisioners) or {}
        except Exception as exc:  # noqa: BLE001
            LOG.warning(
                "prewarm skipped: instance types unavailable",
                error=type(exc).__name__, error_detail=str(exc)[:200],
            )
            return
        prewarm(
            solver, provisioners, instance_types,
            settings=settings, tiers=tiers, stop=stop,
        )

    thread = threading.Thread(target=_run, daemon=True, name="solver-prewarm")
    thread.start()
    return thread
