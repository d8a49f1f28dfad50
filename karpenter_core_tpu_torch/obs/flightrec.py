"""Solve flight recorder: capture the exact inputs of a production solve
and replay them offline, on the card or the CPU.

A bad placement in the field is only debuggable if the pod x instance-type
inputs that produced it can be re-run. Each record holds:

  * a compact, self-contained input snapshot — pods / provisioners /
    instance types / daemonset pods / state nodes (and, when a kube client
    was in scope, the bound cluster pods + nodes the topology counting
    reads) — serialized through kube/serialization's generic k8s-dict round
    trip plus small custom codecs for Requirements and StateNode
    bookkeeping;
  * a sha256 digest of the canonical snapshot (dedupe / provenance);
  * the chosen backend, per-phase timings from the tracer, the active
    trace id (joins /debug/trace and /debug/logs), and the canonicalized
    placements / per-pod failure reasons.

The record format is the reference package's (SCHEMA_VERSION 1, the same
keys, codecs and caps), so a record written by either package restores in
the other. Records land in a bounded ring, and are auto-dumped to
KARPENTER_TPU_FLIGHTREC_DIR on solver exceptions. replay() re-runs a record
through a TorchSolver (on the card unless the caller asks for the CPU) and
diff_placements() names what differs; replay_consolidation() re-runs every
screened subset of a consolidation decision through the exact solve.

Discipline (same as obs/tracer.py): begin() on a disabled recorder is ONE
flag check returning None, so the hook can live permanently on the solve
path. Recording must never break the solve it narrates: snapshot/commit
failures are swallowed (and counted) by design.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from karpenter_core_tpu_torch.obs import envflags
from karpenter_core_tpu_torch.obs.envflags import FALSY as _FALSY, TRUTHY as _TRUTHY

SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# codecs: the pieces kube/serialization's generic dataclass walk can't do


def _req_to_dict(req) -> dict:
    return {
        "key": req.key,
        "complement": bool(req.complement),
        "values": sorted(req.values),
        "greaterThan": req.greater_than,
        "lessThan": req.less_than,
    }


def _req_from_dict(d: dict):
    from karpenter_core_tpu_torch.scheduling.requirement import Requirement

    return Requirement._make(
        d["key"], d["complement"], set(d["values"]),
        d.get("greaterThan"), d.get("lessThan"),
    )


def _instance_type_to_dict(it) -> dict:
    return {
        "name": it.name,
        "capacity": dict(it.capacity),
        "overhead": {
            "kubeReserved": dict(it.overhead.kube_reserved),
            "systemReserved": dict(it.overhead.system_reserved),
            "evictionThreshold": dict(it.overhead.eviction_threshold),
        },
        "offerings": [
            {
                "capacityType": o.capacity_type,
                "zone": o.zone,
                "price": o.price,
                "available": o.available,
            }
            for o in it.offerings
        ],
        "requirements": [_req_to_dict(r) for r in it.requirements.values()],
    }


def _instance_type_from_dict(d: dict):
    from karpenter_core_tpu_torch.cloudprovider.types import (
        InstanceType,
        InstanceTypeOverhead,
        Offering,
        Offerings,
    )
    from karpenter_core_tpu_torch.scheduling.requirements import Requirements

    overhead = d.get("overhead", {})
    return InstanceType(
        name=d["name"],
        capacity=dict(d.get("capacity", {})),
        overhead=InstanceTypeOverhead(
            kube_reserved=dict(overhead.get("kubeReserved", {})),
            system_reserved=dict(overhead.get("systemReserved", {})),
            eviction_threshold=dict(overhead.get("evictionThreshold", {})),
        ),
        offerings=Offerings(
            Offering(
                capacity_type=o["capacityType"], zone=o["zone"],
                price=o["price"], available=o.get("available", True),
            )
            for o in d.get("offerings", [])
        ),
        requirements=Requirements(
            _req_from_dict(r) for r in d.get("requirements", [])
        ),
    )


def _nn_str(key) -> str:
    return f"{key.namespace}/{key.name}"


def _nn_from_str(s: str):
    from karpenter_core_tpu_torch.kube.objects import NamespacedName

    namespace, _, name = s.partition("/")
    return NamespacedName(namespace, name)


def _state_node_to_dict(sn) -> dict:
    from karpenter_core_tpu_torch.kube.serialization import to_k8s_dict

    return {
        "node": to_k8s_dict(sn.node),
        "machine": to_k8s_dict(sn.machine),
        "inflightAllocatable": dict(sn.inflight_allocatable),
        "inflightCapacity": dict(sn.inflight_capacity),
        "startupTaints": to_k8s_dict(sn.startup_taints) or [],
        "podRequests": {_nn_str(k): dict(v) for k, v in sn.pod_requests.items()},
        "podLimits": {_nn_str(k): dict(v) for k, v in sn.pod_limits.items()},
        "daemonsetRequests": {
            _nn_str(k): dict(v) for k, v in sn.daemonset_requests.items()
        },
        "daemonsetLimits": {
            _nn_str(k): dict(v) for k, v in sn.daemonset_limits.items()
        },
        "hostPorts": {
            _nn_str(k): [
                {"ip": e.ip, "port": e.port, "protocol": e.protocol}
                for e in entries
            ]
            for k, entries in sn.hostport_usage.reserved.items()
        },
        "volumes": {
            _nn_str(k): {drv: sorted(ids) for drv, ids in vols.items()}
            for k, vols in sn.volume_usage.pod_volumes.items()
        },
        "volumeLimits": dict(sn.volume_limits),
        "markedForDeletion": bool(sn.marked_for_deletion),
    }


def _state_node_from_dict(d: dict):
    from karpenter_core_tpu_torch.api.machine import Machine
    from karpenter_core_tpu_torch.kube.objects import Node, Taint
    from karpenter_core_tpu_torch.kube.serialization import from_k8s_dict
    from karpenter_core_tpu_torch.scheduling.hostportusage import HostPortEntry
    from karpenter_core_tpu_torch.scheduling.volumeusage import VolumeCount
    from karpenter_core_tpu_torch.state.node import StateNode

    sn = StateNode(
        node=from_k8s_dict(Node, d.get("node")),
        machine=from_k8s_dict(Machine, d.get("machine")),
    )
    sn.inflight_allocatable = dict(d.get("inflightAllocatable", {}))
    sn.inflight_capacity = dict(d.get("inflightCapacity", {}))
    sn.startup_taints = [
        from_k8s_dict(Taint, t) for t in d.get("startupTaints", [])
    ]
    sn.pod_requests = {
        _nn_from_str(k): dict(v) for k, v in d.get("podRequests", {}).items()
    }
    sn.pod_limits = {
        _nn_from_str(k): dict(v) for k, v in d.get("podLimits", {}).items()
    }
    sn.daemonset_requests = {
        _nn_from_str(k): dict(v)
        for k, v in d.get("daemonsetRequests", {}).items()
    }
    sn.daemonset_limits = {
        _nn_from_str(k): dict(v)
        for k, v in d.get("daemonsetLimits", {}).items()
    }
    sn.hostport_usage.reserved = {
        _nn_from_str(k): [
            HostPortEntry(ip=e["ip"], port=e["port"], protocol=e["protocol"])
            for e in entries
        ]
        for k, entries in d.get("hostPorts", {}).items()
    }
    sn.volume_usage.pod_volumes = {
        _nn_from_str(k): {drv: set(ids) for drv, ids in vols.items()}
        for k, vols in d.get("volumes", {}).items()
    }
    for vols in sn.volume_usage.pod_volumes.values():
        for drv, ids in vols.items():
            sn.volume_usage.volumes.setdefault(drv, set()).update(ids)
    sn.volume_limits = VolumeCount(d.get("volumeLimits", {}))
    sn.marked_for_deletion = bool(d.get("markedForDeletion", False))
    return sn


# ---------------------------------------------------------------------------
# input snapshot


# bound-cluster-context cap: above this many bound pods the snapshot skips
# clusterPods/clusterNodes (marked clusterOmitted) — serializing a 50k-pod
# cluster per solve would cost seconds on a path that must stay cheap; the
# solver-boundary inputs (the batch, state nodes) are always captured.
MAX_CLUSTER_SNAPSHOT_PODS = 4096
# state-node cap: stateNodes are essential replay inputs (unlike the
# optional cluster context), so a solve whose node snapshot would exceed
# this is not half-recorded — begin() skips it entirely and counts it
# (skipped_large in /debug/solves), keeping capture cost batch-proportional
# on mega-clusters.
MAX_SNAPSHOT_STATE_NODES = 2048


def snapshot_inputs(pods, provisioners, instance_types, daemonset_pods=None,
                    state_nodes=None, kube_client=None,
                    max_nodes: Optional[int] = None) -> dict:
    """Serialize one Solve()'s inputs into a self-contained JSON-able dict.

    When a kube client is in scope, the bound cluster pods and nodes ride
    along ("clusterPods"/"clusterNodes"): the host scheduler's topology
    counting reads already-bound pods through the client, so a faithful
    replay needs them. Namespace-selector topology terms (which list
    Namespace objects) and clusters past MAX_CLUSTER_SNAPSHOT_PODS (marked
    "clusterOmitted") are the documented fidelity gaps."""
    from karpenter_core_tpu_torch.kube.serialization import to_k8s_dict

    snap = {
        "pods": [to_k8s_dict(p) for p in pods],
        "provisioners": [to_k8s_dict(p) for p in provisioners],
        "instanceTypes": {
            name: [_instance_type_to_dict(it) for it in its]
            for name, its in instance_types.items()
        },
        "daemonsetPods": [to_k8s_dict(p) for p in daemonset_pods or []],
        "stateNodes": [_state_node_to_dict(sn) for sn in state_nodes or []],
    }
    if max_nodes is not None:
        snap["maxNodes"] = int(max_nodes)
    if kube_client is not None and _needs_cluster_context(pods):
        # gated exactly like the host scheduler's own topology counting:
        # only batches carrying spread/affinity constraints ever read bound
        # pods through the client, so snapshot cost mirrors solve cost —
        # constraint-free batches (the common case) never touch the client
        try:
            bound_pods = kube_client.list(
                "Pod", field_filter=lambda p: p.spec.node_name != ""
            )
            if len(bound_pods) > MAX_CLUSTER_SNAPSHOT_PODS:
                snap["clusterOmitted"] = len(bound_pods)
            else:
                snap["clusterPods"] = [to_k8s_dict(p) for p in bound_pods]
                snap["clusterNodes"] = [
                    to_k8s_dict(n) for n in kube_client.list("Node")
                ]
        except Exception:  # noqa: BLE001 — the solver-boundary snapshot stands alone
            pass
    return snap


def _needs_cluster_context(pods) -> bool:
    """True when the host scheduler's topology counting would read bound
    pods through the kube client for this batch: only topology-spread or
    pod-(anti-)affinity constraints consume cluster pods."""
    for p in pods:
        spec = p.spec
        if spec.topology_spread_constraints:
            return True
        affinity = spec.affinity
        if affinity is not None and (
            affinity.pod_affinity is not None
            or affinity.pod_anti_affinity is not None
        ):
            return True
    return False


class RestoredInputs:
    """restore_inputs() result: positional solver args + a rebuilt
    in-memory kube client when the record carried cluster objects, and a
    Cluster fed from that client's nodes and pods (the port's solve reads
    the bound pods' inverse anti-affinity from the Cluster; the reference's
    replay passes none)."""

    __slots__ = ("pods", "provisioners", "instance_types", "daemonset_pods",
                 "state_nodes", "kube_client", "max_nodes", "cluster")

    def __init__(self, pods, provisioners, instance_types, daemonset_pods,
                 state_nodes, kube_client, max_nodes, cluster=None):
        self.pods = pods
        self.provisioners = provisioners
        self.instance_types = instance_types
        self.daemonset_pods = daemonset_pods
        self.state_nodes = state_nodes
        self.kube_client = kube_client
        self.max_nodes = max_nodes
        self.cluster = cluster

    def solve_kwargs(self) -> dict:
        return {
            "daemonset_pods": self.daemonset_pods,
            "state_nodes": self.state_nodes,
            "kube_client": self.kube_client,
            "cluster": self.cluster,
        }


def restore_inputs(snapshot: dict) -> RestoredInputs:
    from karpenter_core_tpu_torch.api.provisioner import Provisioner
    from karpenter_core_tpu_torch.kube.objects import Node, Pod
    from karpenter_core_tpu_torch.kube.serialization import from_k8s_dict

    kube_client = cluster = None
    if snapshot.get("clusterPods") or snapshot.get("clusterNodes"):
        from karpenter_core_tpu_torch.kube.client import InMemoryKubeClient
        from karpenter_core_tpu_torch.state.cluster import Cluster

        kube_client = InMemoryKubeClient()
        for d in snapshot.get("clusterNodes", []):
            try:
                kube_client.create(from_k8s_dict(Node, d))
            except Exception:  # noqa: BLE001 — best-effort context
                pass
        for d in snapshot.get("clusterPods", []):
            try:
                kube_client.create(from_k8s_dict(Pod, d))
            except Exception:  # noqa: BLE001
                pass
        cluster = Cluster(kube_client)
        for node in kube_client.list("Node"):
            cluster.update_node(node)
        for pod in kube_client.list("Pod"):
            cluster.update_pod(pod)
    return RestoredInputs(
        pods=[from_k8s_dict(Pod, d) for d in snapshot.get("pods", [])],
        provisioners=[
            from_k8s_dict(Provisioner, d)
            for d in snapshot.get("provisioners", [])
        ],
        instance_types={
            name: [_instance_type_from_dict(d) for d in its]
            for name, its in snapshot.get("instanceTypes", {}).items()
        },
        daemonset_pods=[
            from_k8s_dict(Pod, d) for d in snapshot.get("daemonsetPods", [])
        ],
        state_nodes=[
            _state_node_from_dict(d) for d in snapshot.get("stateNodes", [])
        ],
        kube_client=kube_client,
        max_nodes=snapshot.get("maxNodes"),
        cluster=cluster,
    )


def input_digest(snapshot: dict) -> str:
    blob = json.dumps(snapshot, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# placements


def canonical_placements(result) -> dict:
    """SolveResult -> a canonical, order-independent dict: machines sorted
    by (provisioner, instance type, pod set), pods by ns/name. Two solves
    of the same inputs by the same algorithm serialize byte-identically
    (placements_json), which is the replay equivalence bar."""

    def pod_key(p) -> str:
        return f"{p.metadata.namespace}/{p.metadata.name}"

    machines = []
    for m in result.new_machines:
        # deliberately materializes a lazy instance_type_options thunk
        # (SolvedMachine defers it): skipping unmaterialized thunks would
        # make a record's content depend on what ELSE read the machine
        # first, breaking byte-identical replay. On the provisioning path
        # the launch fan-out reads the same (cached) materialization right
        # after, so the recorder adds no net cost there; simulation solves
        # are not recorded at all (suppress_recording skips them).
        options = list(m.instance_type_options)
        machines.append(
            {
                "provisioner": m.provisioner_name,
                "instanceType": options[0].name if options else "",
                "options": len(options),
                "requests": {k: v for k, v in sorted(m.requests.items())},
                "pods": sorted(pod_key(p) for p in m.pods),
            }
        )
    machines.sort(
        key=lambda d: (d["provisioner"], d["instanceType"], tuple(d["pods"]))
    )
    existing = sorted(
        (
            {"node": node.name(), "pods": sorted(pod_key(p) for p in pods)}
            for node, pods in result.existing_assignments
        ),
        key=lambda d: d["node"],
    )
    return {
        "machines": machines,
        "existing": existing,
        "failed": sorted(pod_key(p) for p in result.failed_pods),
    }


def placements_json(placements) -> str:
    """Canonical JSON bytes of canonical_placements() output (or a
    SolveResult) — the byte-identical comparison unit."""
    if not isinstance(placements, dict):
        placements = canonical_placements(placements)
    return json.dumps(placements, sort_keys=True, separators=(",", ":"))


# ---------------------------------------------------------------------------
# recorder


class _LiveRecord:
    """One in-flight capture: begin() -> solve -> finish()/finish_error()."""

    __slots__ = ("_recorder", "_snapshot", "_digest", "_trace_id", "_mark",
                 "_tid", "_t0", "_ts", "_primary_error", "_tenant")

    def __init__(self, recorder: "FlightRecorder", snapshot: dict):
        from karpenter_core_tpu_torch.obs import reqctx
        from karpenter_core_tpu_torch.obs.tracer import TRACER

        self._recorder = recorder
        self._snapshot = snapshot
        self._digest = input_digest(snapshot)
        self._trace_id = TRACER.current_trace_id() if TRACER.enabled else None
        self._mark = TRACER.mark() if TRACER.enabled else None
        self._tenant = reqctx.current_tenant()
        self._tid = threading.get_ident()
        self._t0 = time.perf_counter()
        self._ts = time.time()
        self._primary_error: Optional[str] = None

    def note_primary_error(self, error: BaseException) -> None:
        """Stamp the primary solver's exception before the fallback solve —
        the record then shows both the incident AND the degraded outcome."""
        self._primary_error = f"{type(error).__name__}: {error}"

    def _base(self, backend: str, replayer: str) -> dict:
        from karpenter_core_tpu_torch.obs.tracer import TRACER

        record = {
            "schema": SCHEMA_VERSION,
            "ts": self._ts,
            "backend": backend,
            "replayer": replayer,
            "digest": self._digest,
            "duration_ms": round((time.perf_counter() - self._t0) * 1e3, 2),
            "inputs": self._snapshot,
        }
        if self._trace_id is not None:
            record["trace_id"] = self._trace_id
        if self._tenant is not None:
            # raw tenant (records are bounded by the ring, not by label
            # cardinality); absent key when no request context was bound
            record["tenant"] = self._tenant
        if self._mark is not None and TRACER.enabled:
            record["phases_ms"] = self._own_phases(TRACER)
        if self._primary_error is not None:
            record["primary_error"] = self._primary_error
        return record

    def _own_phases(self, tracer) -> Dict[str, float]:
        """Per-phase ms for THIS solve only: concurrent solves (e.g. a
        deprovisioning simulation overlapping a provisioning pass) record
        phase spans into the same global ring, so the window since mark()
        is filtered to this record's trace — or, for a traceless begin
        (direct solver use outside any span), to the calling thread."""
        phases: Dict[str, float] = {}
        for span in tracer.spans_since(self._mark):
            if not span.name.startswith("solver.phase."):
                continue
            if self._trace_id is not None:
                if span.trace_id != self._trace_id:
                    continue
            elif span.tid != self._tid:
                continue
            key = span.name[len("solver.phase."):]
            phases[key] = round(phases.get(key, 0.0) + span.duration_ms, 1)
        return phases

    def finish(self, backend: str, result, replayer: str = "torch",
               dump: bool = False) -> None:
        try:
            record = self._base(backend, replayer)
            record["outcome"] = {
                "placements": canonical_placements(result),
                "rounds": getattr(result, "rounds", 1),
                "errors": dict(getattr(result, "errors", None) or {}),
            }
            self._recorder._commit(record, dump=dump or bool(self._primary_error))
        except Exception:  # noqa: BLE001 — recording must never break the solve
            self._recorder._note_failure()

    def finish_error(self, backend: str, error: BaseException,
                     replayer: str = "torch") -> None:
        """The solve itself raised (no fallback saved it): record + dump.
        A previously stamped primary error is preserved — the record then
        shows both failures (primary_error AND the terminal error)."""
        try:
            record = self._base(backend, replayer)
            record["error"] = f"{type(error).__name__}: {error}"
            self._recorder._commit(record, dump=True)
        except Exception:  # noqa: BLE001
            self._recorder._note_failure()


class FlightRecorder:
    """Bounded ring of solve records + best-effort disk dumps.

    enabled=False (the permanent default outside the operator runtime):
    begin() is one flag check returning None. Arming is programmatic
    (tests) or via KARPENTER_TPU_FLIGHTREC (enable_flightrec_from_env)."""

    def __init__(self, capacity: int = 64):
        self.enabled = False
        self.dump_dir = ""
        self.capacity = capacity
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._recorded = 0
        self._failures = 0  # snapshot/commit errors (recording is best-effort)
        self._skipped_large = 0  # solves over MAX_SNAPSHOT_STATE_NODES
        self._dumped: List[str] = []
        # consolidation decisions: candidate set + screened
        # subsets + chosen Command per deprovisioning pass, own ring so
        # solve records and replan decisions never evict each other
        self._cons_ring: deque = deque(maxlen=capacity)
        self._cons_recorded = 0

    # -- lifecycle ---------------------------------------------------------

    def enable(self, dump_dir: Optional[str] = None) -> "FlightRecorder":
        # under _mu so enable/disable can't tear dump_dir vs enabled; the
        # hot-path `FLIGHTREC.enabled` read per solve stays lock-free by
        # design
        with self._mu:
            if dump_dir is not None:
                self.dump_dir = dump_dir
            self.enabled = True
        return self

    def disable(self) -> "FlightRecorder":
        with self._mu:
            self.enabled = False
        return self

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()
            self._recorded = 0
            self._failures = 0
            self._skipped_large = 0
            self._dumped = []
            self._cons_ring.clear()
            self._cons_recorded = 0

    # -- recording ---------------------------------------------------------

    def begin(self, pods, provisioners, instance_types, daemonset_pods=None,
              state_nodes=None, kube_client=None,
              max_nodes: Optional[int] = None) -> Optional[_LiveRecord]:
        """Snapshot the solve inputs; None when disabled (one flag check),
        when the node snapshot would exceed MAX_SNAPSHOT_STATE_NODES
        (counted as skipped_large), or when the snapshot fails (recording
        never breaks a solve)."""
        if not self.enabled:
            return None
        if state_nodes is not None and len(state_nodes) > MAX_SNAPSHOT_STATE_NODES:
            with self._mu:
                self._skipped_large += 1
            return None
        try:
            snapshot = snapshot_inputs(
                pods, provisioners, instance_types, daemonset_pods,
                state_nodes, kube_client=kube_client, max_nodes=max_nodes,
            )
            return _LiveRecord(self, snapshot)
        except Exception:  # noqa: BLE001
            self._note_failure()
            return None

    def record_consolidation(self, deprovisioner: str, candidates, screens,
                             cmd, scenario=None) -> Optional[dict]:
        """Record one consolidation decision pass: the candidate set (with
        each candidate's price/disruption), every screened subset's device
        verdict + objective, and the chosen Command. When the union
        scenario rides along (and its node count is under the snapshot
        cap), the pass's full solver inputs are serialized too — which is
        what lets replay_consolidation() re-run every subset through the
        exact solve offline and diff the batched screen's decision
        against it. Disabled/oversized/failed captures return None;
        recording never breaks the pass."""
        if not self.enabled or recording_suppressed():
            return None
        try:
            record = {
                "schema": SCHEMA_VERSION,
                "kind": "consolidation",
                "ts": time.time(),
                "deprovisioner": deprovisioner,
                "candidates": [
                    {
                        "name": c.name,
                        "disruption": round(float(c.disruption_cost), 6),
                        "pods": [p.metadata.uid for p in c.pods],
                    }
                    for c in candidates
                ],
                "subsets": [
                    {
                        "members": [int(i) for i in s.subset],
                        "allScheduled": bool(s.all_scheduled),
                        "nNewMachines": int(s.n_new_machines),
                        "conclusive": bool(s.conclusive),
                        "price": round(float(s.price), 6),
                        "disruption": round(float(s.disruption), 6),
                        "savings": round(float(s.savings), 6),
                        "priceless": bool(s.priceless),
                    }
                    for s in screens
                ],
                "chosen": {
                    "action": cmd.action,
                    "nodes": [n.metadata.name for n in cmd.nodes_to_remove],
                    "fromScreen": bool(getattr(cmd, "from_screen", False)),
                    "replacements": len(cmd.replacement_machines or ()),
                },
            }
            if scenario is not None and scenario.snap is not None:
                all_nodes = list(scenario.state_nodes) + [
                    c.state_node for c in candidates
                ]
                if len(all_nodes) > MAX_SNAPSHOT_STATE_NODES:
                    with self._mu:
                        self._skipped_large += 1
                    record["inputsOmitted"] = len(all_nodes)
                else:
                    record["inputs"] = snapshot_inputs(
                        scenario.pods, scenario.provisioners,
                        scenario.instance_types, scenario.daemonset_pods,
                        all_nodes,
                    )
                    record["candOfPod"] = {
                        uid: ci
                        for uid, ci in scenario.cand_of_pod.items()
                        if ci >= 0
                    }
            with self._mu:
                self._cons_ring.append(record)
                self._cons_recorded += 1
            return record
        except Exception:  # noqa: BLE001 — recording is best-effort
            self._note_failure()
            return None

    def consolidations(self) -> List[dict]:
        with self._mu:
            return list(self._cons_ring)

    def last_consolidation(self) -> Optional[dict]:
        with self._mu:
            return self._cons_ring[-1] if self._cons_ring else None

    def consolidations_json(self) -> str:
        """The consolidation ring as the /debug/consolidations body."""
        with self._mu:
            body = {
                "records": list(self._cons_ring),
                "dropped": self._cons_recorded - len(self._cons_ring),
            }
        return json.dumps(body)

    def _commit(self, record: dict, dump: bool) -> None:
        with self._mu:
            self._ring.append(record)
            self._recorded += 1
        if dump and self.dump_dir:
            self.dump(record)

    def _note_failure(self) -> None:
        with self._mu:
            self._failures += 1

    # -- reading / dumping -------------------------------------------------

    @property
    def dropped(self) -> int:
        with self._mu:
            return self._recorded - len(self._ring)

    @property
    def failures(self) -> int:
        with self._mu:
            return self._failures

    def records(self) -> List[dict]:
        with self._mu:
            return list(self._ring)

    def record_for_trace(self, trace_id: str) -> Optional[dict]:
        """The newest record carrying `trace_id`: the end of a histogram
        exemplar's metric -> trace -> flight-record chain (an exemplar on a
        bad p99 bucket names the trace, /debug/trace shows it, and this is
        the replayable input). None when the trace left no record or it
        aged out."""
        if not trace_id:
            return None
        with self._mu:
            for record in reversed(self._ring):
                if record.get("trace_id") == trace_id:
                    return record
        return None

    def tenant_index(self) -> Dict[str, List[dict]]:
        """Per-tenant index of the ring's records for /debug/tenants:
        tenant -> [{ts, digest, backend, trace_id?, duration_ms}, ...],
        newest last; records without a tenant index under ""."""
        index: Dict[str, List[dict]] = {}
        with self._mu:
            for record in self._ring:
                entry = {
                    "ts": record.get("ts"),
                    "digest": record.get("digest"),
                    "backend": record.get("backend"),
                    "duration_ms": record.get("duration_ms"),
                }
                if "trace_id" in record:
                    entry["trace_id"] = record["trace_id"]
                index.setdefault(str(record.get("tenant", "")), []).append(entry)
        return index

    def last(self) -> Optional[dict]:
        with self._mu:
            return self._ring[-1] if self._ring else None

    def to_json(self) -> str:
        with self._mu:
            body = {
                "records": list(self._ring),
                "dropped": self._recorded - len(self._ring),
                "capture_failures": self._failures,
                "skipped_large": self._skipped_large,
                "dumped": list(self._dumped),
            }
        return json.dumps(body)

    def dump(self, record: dict, path: Optional[str] = None) -> Optional[str]:
        """Write one record to disk (auto-named under dump_dir when no path
        is given), retaining only the newest `capacity` auto-dumps — a
        backend wedged for hours dumps one record per solve, and unbounded
        files would fill the node's disk during exactly the incident the
        recorder exists for. Best-effort: a full disk must not break the
        solve."""
        try:
            prune_dir = None
            if path is None:
                os.makedirs(self.dump_dir, exist_ok=True)
                stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(record.get("ts", time.time())))
                path = os.path.join(
                    self.dump_dir,
                    f"solve-{stamp}-{record.get('digest', 'na')}.json",
                )
                prune_dir = self.dump_dir
            # write-temp + atomic rename: a replay (and a human mid-
            # incident) reads these dumps while the recorder is still
            # dumping — a torn read must see the previous dump or this
            # one, never a JSON prefix
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(record, f)
            os.replace(tmp, path)
            with self._mu:
                self._dumped.append(path)
                del self._dumped[:-self.capacity]
            if prune_dir is not None:
                self._prune_dumps(prune_dir)
            return path
        except Exception:  # noqa: BLE001
            self._note_failure()
            return None

    def _prune_dumps(self, dump_dir: str) -> None:
        """Keep only the newest `capacity` solve-*.json files on disk."""
        try:
            files = sorted(
                f for f in os.listdir(dump_dir)
                if f.startswith("solve-") and f.endswith(".json")
            )
            for stale in files[:-self.capacity]:
                try:
                    os.unlink(os.path.join(dump_dir, stale))
                except OSError:
                    pass
        except OSError:
            pass


FLIGHTREC = FlightRecorder()


# -- per-thread suppression (simulation solves) -----------------------------
# deprovisioning consolidation re-enters the production solver every pass;
# recording those simulations would churn the ring past the provisioning
# records an incident needs. The marker is its own thread-local (NOT the
# tracer's span stack) so the invariant holds with tracing disabled too.

_suppress_tls = threading.local()


class suppress_recording:
    """Context manager: solves entered in-scope on this thread skip the
    flight recorder (deprovisioning wraps its simulation re-entries)."""

    def __enter__(self):
        _suppress_tls.depth = getattr(_suppress_tls, "depth", 0) + 1
        return self

    def __exit__(self, exc_type, exc, tb):
        _suppress_tls.depth -= 1
        return False


def recording_suppressed() -> bool:
    return getattr(_suppress_tls, "depth", 0) > 0


def enable_flightrec_from_env(default_on: bool = False) -> bool:
    """Arm/disarm FLIGHTREC from KARPENTER_TPU_FLIGHTREC (+ the dump
    directory from KARPENTER_TPU_FLIGHTREC_DIR) — the ONE parser of those
    variables, shared by the import hook (default off) and the operator
    entrypoint (default on). Returns the resulting enabled state."""
    raw = envflags.raw("KARPENTER_TPU_FLIGHTREC").strip().lower()
    FLIGHTREC.dump_dir = envflags.raw(
        "KARPENTER_TPU_FLIGHTREC_DIR", FLIGHTREC.dump_dir
    ) or os.path.join(tempfile_dir(), "karpenter-flightrec")
    if raw in _FALSY:
        FLIGHTREC.disable()
    elif default_on or raw in _TRUTHY:
        FLIGHTREC.enable()
    return FLIGHTREC.enabled


def tempfile_dir() -> str:
    import tempfile

    return tempfile.gettempdir()


enable_flightrec_from_env(default_on=False)


# ---------------------------------------------------------------------------
# replay


REPLAY_KINDS = ("torch", "tpu", "greedy")


def build_replay_solver(kind: str, max_nodes: Optional[int] = None,
                        device: str = "cuda"):
    """The solver a replay runs on, by the record's replayer. "torch" is a
    TorchSolver on the card (device="cuda", raising without one) unless the
    caller passes device="cpu"; a reference record's "tpu" replays on the
    same TorchSolver. "greedy" is the host GreedySolver (no device): the
    replayer of every record a fallback solve wrote (solver/fallback.py)."""
    if kind in ("torch", "tpu"):
        from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

        return TorchSolver(max_nodes=max_nodes or 1024, device=device)
    if kind == "greedy":
        from karpenter_core_tpu_torch.solver.torch_solver import GreedySolver

        return GreedySolver()
    raise ValueError(f"unknown replay solver {kind!r}; one of {REPLAY_KINDS}")


def replay(record: dict, solver_kind: Optional[str] = None,
           device: str = "cuda") -> Tuple[dict, object]:
    """Re-run a record's inputs through a solver (default: the recorded
    replayer, the solver that served the live solve). Returns (canonical
    placements, SolveResult)."""
    inputs = restore_inputs(record["inputs"])
    kind = solver_kind or record.get("replayer", "greedy")
    solver = build_replay_solver(kind, inputs.max_nodes, device=device)
    result = solver.solve(
        inputs.pods, inputs.provisioners, inputs.instance_types,
        **inputs.solve_kwargs(),
    )
    return canonical_placements(result), result


def replay_consolidation(record: dict, solver_kind: str = "greedy",
                         device: str = "cuda") -> dict:
    """Re-run every subset of a recorded consolidation decision through the
    sequential simulator path offline (the same per-subset scenario
    simulate_scheduling builds: victims out of the snapshot, their pods
    back on the pending axis) and diff it against the recorded device
    verdicts and the chosen Command.

    Returns {"subsets": [per-subset dicts with recorded + sequential
    verdicts and an "agrees" flag], "chosen": ..., "chosen_feasible_seq":
    bool (the parity bar: the sequential simulator validates the executed
    command), "seq_pick": the member list the sequential verdicts + the
    recorded objective would have chosen}."""
    if record.get("kind") != "consolidation":
        raise ValueError("not a consolidation record")
    if "inputs" not in record:
        raise ValueError(
            "record carries no inputs snapshot "
            f"(inputsOmitted={record.get('inputsOmitted')})"
        )
    restored = restore_inputs(record["inputs"])
    cand_of = {
        uid: int(ci) for uid, ci in record.get("candOfPod", {}).items()
    }
    cand_names = [c["name"] for c in record["candidates"]]
    solver = build_replay_solver(solver_kind, restored.max_nodes, device=device)
    out_subsets = []
    seq_feasible = []
    for sub in record["subsets"]:
        members = set(int(i) for i in sub["members"])
        names = {cand_names[ci] for ci in members}
        pods = [
            p for p in restored.pods
            if cand_of.get(p.metadata.uid, -1) < 0
            or cand_of[p.metadata.uid] in members
        ]
        state_nodes = [
            sn for sn in restored.state_nodes if sn.name() not in names
        ]
        res = solver.solve(
            pods, restored.provisioners, restored.instance_types,
            daemonset_pods=restored.daemonset_pods, state_nodes=state_nodes,
            kube_client=restored.kube_client, cluster=restored.cluster,
        )
        seq_all = not res.failed_pods
        seq_new = len(res.new_machines)
        entry = dict(
            sub,
            seqAllScheduled=seq_all,
            seqNewMachines=seq_new,
            # the decision-relevant agreement: same feasibility verdict
            # (all scheduled, <= 1 new machine). The screen is the round-0
            # kernel while the simulator relaxes, so the simulator may be
            # MORE permissive — that direction is expected, not a bug.
            agrees=(
                (seq_all and seq_new <= 1)
                == (sub["allScheduled"] and sub["nNewMachines"] <= 1)
            ),
        )
        out_subsets.append(entry)
        if seq_all and seq_new <= 1:
            seq_feasible.append(entry)
    seq_pick = None
    if seq_feasible:
        seq_pick = max(
            seq_feasible,
            key=lambda s: (s["savings"], -s["disruption"], len(s["members"])),
        )["members"]
    chosen = record.get("chosen", {})
    chosen_feasible = True
    if chosen.get("action") in ("delete", "replace") and chosen.get("nodes"):
        chosen_members = {
            cand_names.index(n) for n in chosen["nodes"] if n in cand_names
        }
        match = next(
            (
                s for s in out_subsets
                if set(int(i) for i in s["members"]) == chosen_members
            ),
            None,
        )
        chosen_feasible = bool(
            match is not None
            and match["seqAllScheduled"]
            and match["seqNewMachines"] <= 1
        )
    return {
        "subsets": out_subsets,
        "chosen": chosen,
        "chosen_feasible_seq": chosen_feasible,
        "seq_pick": seq_pick,
    }


def diff_placements(a: dict, b: dict) -> List[str]:
    """Human-readable differences between two canonical placements."""
    out: List[str] = []
    if placements_json(a) == placements_json(b):
        return out
    for side, name in ((a, "left"), (b, "right")):
        out.append(
            f"{name}: {len(side['machines'])} machines, "
            f"{sum(len(m['pods']) for m in side['machines'])} pods on new, "
            f"{sum(len(e['pods']) for e in side['existing'])} on existing, "
            f"{len(side['failed'])} failed"
        )
    a_pods = {p for m in a["machines"] for p in m["pods"]}
    b_pods = {p for m in b["machines"] for p in m["pods"]}
    only_a = sorted(a_pods - b_pods)
    only_b = sorted(b_pods - a_pods)
    if only_a:
        out.append(f"pods on new machines only on left: {only_a[:10]}")
    if only_b:
        out.append(f"pods on new machines only on right: {only_b[:10]}")
    if a["failed"] != b["failed"]:
        out.append(f"failed left={a['failed'][:10]} right={b['failed'][:10]}")
    types_a = sorted(m["instanceType"] for m in a["machines"])
    types_b = sorted(m["instanceType"] for m in b["machines"])
    if types_a != types_b:
        out.append(f"instance types left={types_a[:10]} right={types_b[:10]}")
    # the summaries above can all tie while the placements still differ
    # (grouping, requests, option counts): always name concrete differing
    # entries so a divergence is actionable, never just asserted
    a_set = {json.dumps(m, sort_keys=True) for m in a["machines"]}
    b_set = {json.dumps(m, sort_keys=True) for m in b["machines"]}
    for only, name in ((sorted(a_set - b_set), "left"),
                       (sorted(b_set - a_set), "right")):
        for entry in only[:3]:
            out.append(f"machine only on {name}: {entry}")
    a_ex = {json.dumps(e, sort_keys=True) for e in a["existing"]}
    b_ex = {json.dumps(e, sort_keys=True) for e in b["existing"]}
    for only, name in ((sorted(a_ex - b_ex), "left"),
                       (sorted(b_ex - a_ex), "right")):
        for entry in only[:3]:
            out.append(f"existing assignment only on {name}: {entry}")
    return out
