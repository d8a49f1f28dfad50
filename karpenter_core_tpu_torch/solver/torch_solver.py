"""TorchSolver: Scheduler.Solve on PyTorch, on the CUDA card by default.

Pipeline per solve (the reference's TPUSolver, tpu_solver.py):
  1. encode_snapshot and device_args: objects -> dense numpy arrays (host);
  2. args_to_torch: the arrays onto the device;
  3. the prescreen: the [N, C] slot x class verdict tensor, whose existing
     block runs on the screen kernel (ops/screen.py, csrc/screen.cu);
  4. the solve program: feasibility_static [J, I, T], openable_mask, then
     the FFD pack scan (ops/pack.py);
  5. fetch and decode: the commit log replays into placements, followed by
     relaxation re-solves for failed pods (preferences.go order).

`last_phase_ms` holds the wall-clock milliseconds of each phase of the last
device solve; on the card every phase ends with a device synchronize, so
the phases partition the solve. A solve is a `solver.solve` span (context
"simulation" under a deprovisioning span, else "provisioning") and each
phase a `solver.phase.<name>` span recorded from the same timestamps as
`last_phase_ms`, after the same synchronize: the tracer adds no device
call of its own. The device run goes through obs.device_profiler, a
torch.profiler capture when KARPENTER_TPU_PROFILE names a directory.

A solver that solves batch after batch over one cluster (incremental="on",
the default under screen_mode="prescreen") keeps the prescreen tensor of
each geometry resident and replays only the rows and columns whose planes
changed (solver/incremental.py, ops/pack.screen_refresh),
carries its label dictionary so a churning cluster keeps one geometry,
and carries the instance-type planes (encode.EncodeReuse); the cluster's
change feed gates the residency. `last_prescreen_mode` ("full" or
"refresh") and `last_prescreen_delta` report the last dispatch.

One lock serializes a solver's solves, replans and prewarms: the
provisioning and deprovisioning loops share the operator's solver, and the
startup prewarm (`prewarm_snapshot`, solver/prewarm.py) runs on a thread
of its own while live solves arrive.

`replan_screen` screens K consolidation candidate subsets of one union
snapshot (solver/replan.py) through the same prescreen dispatch and
residency, then one rung-mode scan per subset; `last_replan_phase_ms`
holds its phases (args, upload, prescreen, device, fetch), each also a
`solver.phase.replan.<name>` span.

Each phase mark also touches the heartbeat the caller's thread has bound
(utils/supervise, the dispatch watchdog of solver/fallback.ResilientSolver)
under the span's name; with none bound a touch is one thread-local read.
GreedySolver, beside TorchSolver as the reference keeps it beside
TPUSolver, is the host fallback over the host scheduler.
"""
from __future__ import annotations

import contextlib
import copy
import threading
import time
import traceback
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from karpenter_core_tpu_torch import chaos
from karpenter_core_tpu_torch.api.labels import PROVISIONER_NAME_LABEL_KEY
from karpenter_core_tpu_torch.obs import TRACER, device_profiler, profile_dir, proghealth
from karpenter_core_tpu_torch.obs.flightrec import (  # noqa: F401 — re-exported
    canonical_placements,
    placements_json,
)
from karpenter_core_tpu_torch.ops import pack as pack_ops
from karpenter_core_tpu_torch.ops import screen as screen_ops
from karpenter_core_tpu_torch.ops.feasibility import feasibility_static, openable_mask
from karpenter_core_tpu_torch.ops.pack import (
    SCREEN_MODES,
    PackState,
    ScreenOps,
    class_planes,
    make_batched_replan_kernel,
    make_pack_kernel,
    screen_refresh,
)
from karpenter_core_tpu_torch.ops.topology import TopoGroupMeta, TopoMeta
from karpenter_core_tpu_torch.scheduling.preferences import Preferences
from karpenter_core_tpu_torch.scheduling.requirement import Requirement
from karpenter_core_tpu_torch.scheduling.requirements import Requirements
from karpenter_core_tpu_torch.solver.encode import (
    EncodedSnapshot,
    EncodeReuse,
    ReqSetArrays,
    bucket_pow2,
    encode_snapshot,
    replan_chunks,
)
from karpenter_core_tpu_torch.solver.incremental import DiffGate, IncrementalScreen
from karpenter_core_tpu_torch.utils import supervise
from karpenter_core_tpu_torch.utils.gctuning import gc_paused

# run()'s positional argument order, as device_args() produces it
RUN_ARG_NAMES = (
    "pod_arrays", "tmpl", "tmpl_daemon", "tmpl_type_mask", "types",
    "type_alloc", "type_capacity", "type_offering_ok", "pod_tol_all",
    "exist", "exist_used", "exist_cap", "well_known", "remaining0",
    "topo_counts0", "topo_hcounts0", "topo_doms0", "topo_terms",
    "exist_ports", "exist_vols", "exist_vol_limits", "vol_driver",
)

# safety cap on relaxation rounds, above the ~6 preference tiers
DEFAULT_MAX_RELAX_ROUNDS = 16


class SolvedMachine:
    """A new node computed by the solver. `instance_type_options` and
    `requirements` are built from the slot masks on first access; both
    may then be narrowed in place."""

    def __init__(self, provisioner_name, template, pods, requests,
                 options_fn, requirements_fn):
        self.provisioner_name = provisioner_name
        self.template = template
        self.pods = pods
        self.requests = requests
        self._options_fn = options_fn
        self._requirements_fn = requirements_fn
        self._options = None
        self._requirements = None

    @property
    def instance_type_options(self):
        if self._options is None:
            self._options = self._options_fn()
        return self._options

    @instance_type_options.setter
    def instance_type_options(self, options) -> None:
        """Narrow the options (the consolidation price filters do)."""
        self._options = list(options)

    @property
    def requirements(self) -> Requirements:
        if self._requirements is None:
            self._requirements = self._requirements_fn()
        return self._requirements


@dataclass
class SolveResult:
    new_machines: List[SolvedMachine] = field(default_factory=list)
    existing_assignments: List[Tuple[object, List]] = field(default_factory=list)
    failed_pods: List = field(default_factory=list)
    rounds: int = 1
    errors: Dict[str, str] = field(default_factory=dict)

    def pod_count_new(self) -> int:
        return sum(len(m.pods) for m in self.new_machines)

    def pod_count_existing(self) -> int:
        return sum(len(p) for _, p in self.existing_assignments)


def _reqset_to_dict(rs: ReqSetArrays) -> Dict[str, np.ndarray]:
    return {"allow": rs.allow, "out": rs.out, "defined": rs.defined, "escape": rs.escape}


def solve_with_relaxation(solve_once, pods, provisioners, instance_types,
                          max_relax_rounds: int) -> SolveResult:
    """Run solve_once, then relax every failed pod (preferences.go order)
    and re-solve until nothing relaxes further (scheduler.go:114-123).
    A failed pod is deep-copied on its first relaxation, so caller objects
    are never mutated."""
    if not pods:
        return SolveResult()
    if not provisioners or not any(instance_types.values()):
        return SolveResult(failed_pods=list(pods))
    # the solve's root span; a solve entered under a deprovisioning span is
    # a simulation, kept out of the provisioning latency series
    parent = TRACER.current_span_name() or ""
    context = "simulation" if parent.startswith("deprovisioning.") else "provisioning"
    with TRACER.span("solver.solve", pods=len(pods), context=context) as sp:
        result = _relax_rounds(solve_once, pods, provisioners, max_relax_rounds)
        sp.set(rounds=result.rounds, failed=len(result.failed_pods))
        return result


def _relax_rounds(solve_once, pods, provisioners, max_relax_rounds: int) -> SolveResult:
    pods = list(pods)
    indices_of: Dict[int, List[int]] = {}
    for i, p in enumerate(pods):
        indices_of.setdefault(id(p), []).append(i)
    is_copy = [False] * len(pods)
    preferences = Preferences(
        any(t.effect == "PreferNoSchedule" for p in provisioners for t in p.spec.taints)
    )
    result = solve_once(pods)
    rounds = 1
    while result.failed_pods and rounds < max_relax_rounds:
        relaxed_any = False
        for pod in result.failed_pods:
            idxs = indices_of.get(id(pod))
            if not idxs:
                continue
            if len(idxs) == 1 and is_copy[idxs[0]]:
                i = idxs[0]
            else:
                i = idxs.pop()
                pods[i] = copy.deepcopy(pod)
                indices_of[id(pods[i])] = [i]
                is_copy[i] = True
            relaxed_any |= preferences.relax(pods[i])
        if not relaxed_any:
            break
        result = solve_once(pods)
        rounds += 1
    result.rounds = rounds
    return result


def solve_geometry(snap: EncodedSnapshot, max_nodes: int):
    """The padded shapes of a snapshot's solve, in the reference's order:
    (P, J, T, E, R, K, V, N, segments, zone_seg, ct_seg, topo_sig, log_len,
    Q, W, D, screen_v)."""
    dictionary = snap.dictionary
    segments = [dictionary.segment(k) for k in dictionary.keys]
    I_real = len(snap.item_counts) if snap.item_counts is not None else len(snap.pods)
    P = snap.item_pad or bucket_pow2(max(I_real, 1), 32)
    J = len(snap.templates)
    T = snap.type_alloc.shape[0]
    E = snap.exist_used.shape[0]
    R = len(snap.resource_names)
    K, V = dictionary.K, dictionary.V
    N = snap.n_slots or (E + min(max_nodes, max(P, 1)))
    topo_sig = ()
    if snap.topo_meta is not None:
        topo_sig = tuple(
            (g.gtype, g.seg, g.key_k, g.max_skew, g.is_hostname, g.is_inverse,
             tuple(g.filter_term_rows))
            for g in snap.topo_meta.groups
        )
    # commit-log capacity: total pods rounded to a power of two
    log_len = 128
    while log_len < len(snap.pods) + 64:
        log_len *= 2
    Q = snap.pod_ports_u.shape[1]
    W = snap.pod_vols_u.shape[1]
    D = snap.exist_vol_limits.shape[1]
    return (
        P, J, T, E, R, K, V, N, tuple(segments), snap.zone_seg, snap.ct_seg,
        topo_sig, log_len, Q, W, D, snap.screen_v or V,
    )


def device_args(snap: EncodedSnapshot, provisioners=None):
    """Host arrays (numpy) in run()'s argument order. The work axis is the
    ITEM (pod equivalence class) axis: rows gather through snap.item_rep
    and each carries its replica count."""
    provisioners = provisioners or []
    J = len(snap.templates)
    rep = snap.item_rep
    counts = snap.item_counts
    I = len(rep)
    cls = snap.uidx[rep] if len(snap.pods) else rep
    u = snap.pod_reqs_u
    custom_deny_u = ~snap.well_known[None, :] & u.defined & ~u.escape
    pod_arrays = {
        "allow": u.allow[cls],
        "out": u.out[cls],
        "defined": u.defined[cls],
        "escape": u.escape[cls],
        "custom_deny": custom_deny_u[cls],
        "requests": snap.pod_requests_u[cls],
        "tol_tmpl": snap.pod_tol_u[cls],
        "valid": np.ones(I, dtype=bool),
        "count": counts.astype(np.int32),
        "scls": snap.item_scls.astype(np.int32),
    }
    if snap.topo_meta is not None:
        pod_arrays["topo_own"] = snap.topo_arrays.owner.T[rep].copy()  # [I, G]
        pod_arrays["topo_sel"] = snap.topo_arrays.sel.T[rep].copy()
    pod_arrays["ports"] = snap.pod_ports_u[cls]
    pod_arrays["port_conflict"] = snap.pod_port_conflict_u[cls]
    pod_arrays["vols"] = snap.pod_vols_u[cls]
    pod_tol_all = np.concatenate(
        [snap.pod_tol_u[cls],
         snap.tol_exist_us[cls[:, None], snap.sig_of_node[None, :]]],
        axis=1,
    )

    # pad the item axis to the snapshot's tier (valid=False, count=0 rows
    # never commit)
    I_pad = snap.item_pad or bucket_pow2(max(I, 1), 32)
    if I_pad > I:
        pad = I_pad - I

        def pad_rows(a):
            return np.concatenate(
                [a, np.zeros((pad,) + a.shape[1:], dtype=a.dtype)], axis=0
            )

        pod_arrays = {k: pad_rows(v) for k, v in pod_arrays.items()}
        pod_tol_all = pad_rows(pod_tol_all)

    # verdict-column -> item map, padded like the item axis (pad columns
    # alias item 0)
    scls_items = snap.scls_items.astype(np.int32)
    C_pad = snap.cls_pad or bucket_pow2(max(len(scls_items), 1), 32)
    pod_arrays["scls_first"] = np.pad(scls_items, (0, C_pad - len(scls_items)))

    # provisioner limits -> remaining resources [J, R] (scheduler.go:70-75)
    remaining0 = np.full((J, len(snap.resource_names)), np.float32(1e30))
    for j, template in enumerate(snap.templates):
        prov = next((p for p in provisioners if p.name == template.provisioner_name), None)
        if prov is not None and prov.spec.limits is not None:
            for r_i, rname in enumerate(snap.resource_names):
                if rname in prov.spec.limits.resources:
                    remaining0[j, r_i] = prov.spec.limits.resources[rname]
    # subtract existing owned capacity (scheduler.go:243-249)
    for node in snap.state_nodes:
        pname = node.labels().get(PROVISIONER_NAME_LABEL_KEY, "")
        for j, template in enumerate(snap.templates):
            if template.provisioner_name == pname:
                cap = node.capacity()
                for r_i, rname in enumerate(snap.resource_names):
                    if remaining0[j, r_i] < 1e29:
                        remaining0[j, r_i] -= cap.get(rname, 0.0)

    V, K = snap.dictionary.V, snap.dictionary.K
    if snap.topo_meta is not None:
        ta = snap.topo_arrays
        topo_counts0, topo_hcounts0, topo_doms0 = (
            ta.counts0, ta.hcounts0, ta.domain_mask0)
        topo_terms = {"allow": ta.term_allow, "out": ta.term_out,
                      "defined": ta.term_defined, "escape": ta.term_escape}
    else:
        topo_counts0 = np.zeros((0, V), np.float32)
        topo_hcounts0 = np.zeros((0, snap.n_slots or 1), np.float32)
        topo_doms0 = np.zeros((0, V), bool)
        topo_terms = {
            "allow": np.zeros((0, V), bool),
            "out": np.zeros((0, K), bool),
            "defined": np.zeros((0, K), bool),
            "escape": np.zeros((0, K), bool),
        }
    return (
        pod_arrays,
        _reqset_to_dict(snap.tmpl_reqs),
        snap.tmpl_daemon,
        snap.tmpl_type_mask,
        _reqset_to_dict(snap.type_reqs),
        snap.type_alloc,
        snap.type_capacity,
        snap.type_offering_ok,
        pod_tol_all,
        _reqset_to_dict(snap.exist_reqs),
        snap.exist_used,
        snap.exist_cap,
        snap.well_known,
        remaining0,
        topo_counts0,
        topo_hcounts0,
        topo_doms0,
        topo_terms,
        snap.exist_ports,
        snap.exist_vols,
        snap.exist_vol_limits,
        snap.vol_driver_onehot,
    )


def args_to_torch(args, device) -> tuple:
    """device_args() output (from either package: the layouts match, and
    so do the solver service's wire tensors) -> the same tuple with every
    array a tensor on `device`, dtypes kept. A read-only array (a wire
    tensor's view of its message) is copied first."""
    device = torch.device(device)

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:
            a = a.copy()
        return torch.from_numpy(a).to(device)

    return tuple(conv(a) for a in args)


def topo_meta_from(obj) -> Optional[TopoMeta]:
    """A TopoMeta of the port from any object with a TopoMeta's fields (the
    reference's included), read by attribute; None stays None."""
    if obj is None:
        return None
    return TopoMeta(groups=[
        TopoGroupMeta(
            gtype=int(g.gtype), seg=(int(g.seg[0]), int(g.seg[1])),
            key_k=int(g.key_k), max_skew=int(g.max_skew),
            is_hostname=bool(g.is_hostname), is_inverse=bool(g.is_inverse),
            filter_term_rows=[int(r) for r in g.filter_term_rows],
        )
        for g in obj.groups
    ])


def make_device_run(segments, zone_seg, ct_seg, topo_meta, n_slots: int,
                    log_len: int, screen_v: Optional[int] = None,
                    screen_mode: str = "prescreen", rung_mode: bool = False):
    """The solve program (make_device_run with an external prescreen):
    feasibility + openable + the pack scan, a function of args_to_torch's
    tensors and the prescreen tensor (None under screen_mode="tiered"),
    with the class planes the prescreen built (items_pl) reused by the
    scan. Returns (log, ptr, state).

    rung_mode=True is the consolidation replan's form
    (tpu_solver.py:345-370,558-570): run(count_row, exist_open, screen0,
    *args, items_pl=None, shared=None) replaces the replica counts with
    the host row count_row [I] and opens only the existing slots
    exist_open [E] leaves open (closed ones are neither open nor
    existing); no commit log is written. `shared` (a dict kept across
    the calls of one replan chunk) holds what does not depend on the
    subset: the feasibility planes, the openable mask and the scan's
    constants."""
    segments = [tuple(s) for s in segments]
    pack = make_pack_kernel(segments, zone_seg, ct_seg,
                            topo_meta=topo_meta_from(topo_meta), screen_v=screen_v,
                            screen_mode=screen_mode)

    def run_impl(count_row, exist_open, screen0, pod_arrays, tmpl, tmpl_daemon,
                 tmpl_type_mask, types, type_alloc, type_capacity, type_offering_ok,
                 pod_tol_all, exist, exist_used, exist_cap, well_known, remaining0,
                 topo_counts0, topo_hcounts0, topo_doms0, topo_terms, exist_ports,
                 exist_vols, exist_vol_limits, vol_driver, items_pl=None, shared=None):
        dev = exist_used.device
        E = exist_used.shape[0]
        N = n_slots
        T = type_alloc.shape[0]
        J = tmpl_daemon.shape[0]
        pre = shared if shared is not None else {}
        if "f_static" not in pre:
            pre["f_static"] = feasibility_static(
                {k: pod_arrays[k] for k in ("allow", "out", "defined", "escape")},
                tmpl, types, pod_arrays["tol_tmpl"], tmpl_type_mask,
                type_offering_ok, zone_seg, ct_seg, segments, well_known,
            )
            pre["openable"] = openable_mask(pre["f_static"], pod_arrays["requests"],
                                            tmpl_daemon, type_alloc)
        f_static, openable = pre["f_static"], pre["openable"]
        open0 = torch.arange(N, device=dev) < E
        if exist_open is not None:
            open0[:E] &= exist_open

        def prefix(fill, rows, dtype):
            out = torch.full((N,) + tuple(rows.shape[1:]), fill, dtype=dtype, device=dev)
            out[:E] = rows
            return out

        state = PackState(
            used=prefix(0.0, exist_used, torch.float32),
            open=open0,
            is_existing=open0.clone(),
            tmpl=torch.zeros(N, dtype=torch.int32, device=dev),
            tol_idx=torch.cat([
                J + torch.arange(E, dtype=torch.int32, device=dev),
                torch.zeros(N - E, dtype=torch.int32, device=dev),
            ]),
            pods=torch.zeros(N, dtype=torch.int32, device=dev),
            allow=prefix(True, exist["allow"], torch.bool),
            out=prefix(True, exist["out"], torch.bool),
            defined=prefix(False, exist["defined"], torch.bool),
            tmask=torch.zeros((N, T), dtype=torch.bool, device=dev),
            cap=prefix(0.0, exist_cap, torch.float32),
            nopen=torch.tensor(E, dtype=torch.int32, device=dev),
            remaining=remaining0.clone(),
            tcounts=topo_counts0.clone(),
            thost=topo_hcounts0.clone(),
            tdoms=topo_doms0.clone(),
            ports=prefix(False, exist_ports, torch.bool),
            vols=exist_vols.clone(),
        )
        item_arrays = dict(pod_arrays, tol=pod_tol_all)
        state, log, ptr = pack(
            state, item_arrays, f_static, openable,
            {k: tmpl[k] for k in ("allow", "out", "defined")},
            tmpl_daemon, tmpl_type_mask, types, type_alloc, type_capacity,
            type_offering_ok, well_known=well_known, topo_terms=topo_terms,
            log_len=log_len, n_exist=E, vol_limits=exist_vol_limits,
            vol_driver=vol_driver, screen0=screen0, items_pl=items_pl,
            log_commits=count_row is None, counts_host=count_row,
            shared=pre.setdefault("scan", {}),
        )
        return log, ptr, state

    if rung_mode:
        def rung_run(count_row, exist_open, screen0, *args, items_pl=None, shared=None):
            return run_impl(np.asarray(count_row), exist_open, screen0, *args,
                            items_pl=items_pl, shared=shared)

        rung_run.n_slots = n_slots
        return rung_run

    def run(screen0, *args, items_pl=None):
        return run_impl(None, None, screen0, *args, items_pl=items_pl)

    return run


def expand_log(snap: EncodedSnapshot, log, ptr: int) -> np.ndarray:
    """Replay the commit log into a per-pod slot assignment [P] (-1 =
    unscheduled). Entry e places ns slots from `slot`, k replicas each
    (k_last on the final slot), consuming item e.item's member pods in
    order; ns == -1 marks a bulk fill whose takes are bulk_take row k."""
    P = len(snap.pods)
    assigned = np.full(P, -1, dtype=np.int64)
    members = snap.item_members
    cursor = [0] * len(members)
    items, slots = np.asarray(log["item"]), np.asarray(log["slot"])
    nss, ks, k_lasts = np.asarray(log["ns"]), np.asarray(log["k"]), np.asarray(log["k_last"])
    bulk_take = np.asarray(log["bulk_take"])
    for e in range(int(ptr)):
        item = int(items[e])
        if item < 0:
            continue
        mem = members[item]
        ns, k, k_last = int(nss[e]), int(ks[e]), int(k_lasts[e])
        lo = cursor[item]
        avail = max(len(mem) - lo, 0)
        if ns == -1:
            row = bulk_take[k]
            nz = np.nonzero(row)[0]
            if len(nz) == 0:
                continue
            takes = row[nz].astype(np.int64)
            targets = nz
        elif ns <= 0:
            continue
        else:
            takes = np.full(ns, k, dtype=np.int64)
            takes[-1] = k_last
            targets = slots[e] + np.arange(ns, dtype=np.int64)
        csum = np.cumsum(takes)
        tot = int(min(csum[-1], avail))
        act = np.clip(tot - (csum - takes), 0, takes)
        assigned[np.asarray(mem[lo: lo + tot], dtype=np.int64)] = np.repeat(targets, act)
        cursor[item] = lo + tot
    return assigned


def slot_requirements(snap: EncodedSnapshot, state, slot) -> Requirements:
    """The machine's merged requirements, rebuilt from its slot masks."""
    dictionary = snap.dictionary
    allow, out, defined = state.allow[slot], state.out[slot], state.defined[slot]
    requirements = Requirements()
    for k, key in enumerate(dictionary.keys):
        if not defined[k]:
            continue
        lo, hi = dictionary.segment(key)
        vals = dictionary.values_of(key)
        if out[k]:
            requirements.add(Requirement(key, "NotIn",
                                         [v for v, a in zip(vals, allow[lo:hi]) if not a]))
        else:
            requirements.add(Requirement(key, "In",
                                         [v for v, a in zip(vals, allow[lo:hi]) if a]))
    return requirements


def decode_solve(snap: EncodedSnapshot, placements, state) -> SolveResult:
    """Placements + final slot state (host numpy) -> SolveResult.
    `placements` is a (commit log, ptr) pair from the scan, or a per-pod
    slot array [P] (the native packer)."""
    if isinstance(placements, tuple):
        log, ptr = placements
        with TRACER.span("solver.phase.expand", entries=int(ptr)):
            assigned = expand_log(snap, log, ptr)
    else:
        assigned = np.asarray(placements)
    E = len(snap.state_nodes)
    all_pods = snap.pods
    ok_idx = np.nonzero(assigned >= 0)[0]
    failed = [all_pods[i] for i in np.nonzero(assigned < 0)[0]]
    # group pods by slot; the stable sort keeps FFD order within a slot
    sorted_idx = ok_idx[np.argsort(assigned[ok_idx], kind="stable")]
    sorted_slots = assigned[sorted_idx]
    cuts = np.nonzero(np.diff(sorted_slots))[0] + 1
    starts = np.concatenate([[0], cuts]).astype(np.int64)
    ends = np.concatenate([cuts, [len(sorted_idx)]]).astype(np.int64)
    machines: List[SolvedMachine] = []
    existing: List[Tuple[object, List]] = []
    for s, e in zip(starts, ends):
        if e <= s:
            continue
        slot = int(sorted_slots[s])
        pods = [all_pods[i] for i in sorted_idx[s:e]]
        if slot < E:
            existing.append((snap.state_nodes[slot], pods))
            continue
        template = snap.templates[int(state.tmpl[slot])]
        requests = dict(zip(snap.resource_names, state.used[slot].tolist()))
        requests = {k: v for k, v in requests.items() if v}

        def options(slot=slot):
            return [
                snap.instance_types[t]
                for t in np.nonzero(state.tmask[slot])[0]
                if t < len(snap.instance_types)
            ]

        machines.append(SolvedMachine(
            provisioner_name=template.provisioner_name,
            template=template,
            pods=pods,
            requests=requests,
            options_fn=options,
            requirements_fn=lambda slot=slot: slot_requirements(snap, state, slot),
        ))
    return SolveResult(new_machines=machines, existing_assignments=existing,
                       failed_pods=failed)


class _HostState:
    """The fetched slot state: numpy copies of the rows [:nopen]."""

    FIELDS = ("tmpl", "used", "pods", "tmask", "allow", "out", "defined")

    def __init__(self, state: PackState, nopen: int):
        for f in self.FIELDS:
            setattr(self, f, getattr(state, f)[:nopen].cpu().numpy())


# -- the device path's dispatch, shared by TorchSolver and the solver
# service (solver/service.py), so that a wire solve and an in-process solve
# run the same code from device_args on


def dispatch_prescreen(segments, screen_v, n_slots: int, host_args, targs, inc=None,
                       key=None, gate_ok: bool = True):
    """The [N, C] verdict tensor of a solve or replan (_dispatch_prescreen,
    tpu_solver.py:1369-1458). With `inc` (an IncrementalScreen) the tensor
    resident at `key` is refreshed in its changed rows and columns when
    the delta is narrow; otherwise, and when planning or the refresh
    fails, the full precompute runs. `host_args` are device_args' numpy
    arrays (the fingerprints read them), `targs` their tensors.

    Returns (tensor, "full" | "refresh", the delta or None, the class
    planes the scan reuses, the traceback of a failed refresh or None)."""
    pod_arrays, exist = targs[0], targs[9]
    ops = ScreenOps(segments, pod_arrays["allow"].shape[1], screen_v)
    items_pl = class_planes(pod_arrays, ops)
    screen0, mode, delta, error = None, "full", None, None
    if inc is not None:
        try:
            delta = inc.plan(key, host_args[0], host_args[9], gate_ok=gate_ok)
        except Exception:
            inc.invalidate()
            delta = None
        prev = inc.resident(key) if delta is not None else None
        if prev is not None:
            try:
                screen0 = screen_refresh(prev, ops, items_pl, exist, delta.rows, delta.cols)
                mode = "refresh"
                inc.count_refresh()
            except Exception:
                # the resident tensor may be half written: drop it, keep
                # the staged fingerprints for the full tensor; counted as
                # full_deg, the traceback kept
                error = traceback.format_exc()
                inc.drop_resident()
                inc.count_degraded()
                screen0 = None
    if screen0 is None:
        screen0 = ops.initial_screen(items_pl, exist["allow"], exist["out"], exist["defined"],
                                     n_slots)
    if inc is not None:
        inc.adopt(key, screen0)
    return screen0, mode, delta, items_pl, error


def dispatch_solve(run, screen0, targs, items_pl, sync=None):
    """One solve program's run on its device (under obs.device_profiler):
    (log, ptr, PackState), still on the device."""
    with device_profiler():
        log, ptr, state = run(screen0, *targs, items_pl=items_pl)
        if profile_dir() and sync is not None:
            sync()  # keep the device work inside the capture
    return log, ptr, state


def fetch_log(log, whole: bool = False) -> Dict[str, object]:
    """The commit log on the host. The bulk take matrix is cut to its
    bulk_n written rows, or kept whole (with bulk_n) as the solver
    service's response carries it, as the reference's does."""
    out = dict(log)
    take = out["bulk_take"]
    if whole:
        out["bulk_take"] = take.cpu().numpy()
        out["bulk_n"] = np.asarray(out["bulk_n"], dtype=np.int32)
    else:
        out["bulk_take"] = take[: out["bulk_n"]].cpu().numpy()
    return out


def fetch_state(state: PackState) -> Dict[str, np.ndarray]:
    """Every field of the final slot state on the host, whole, in
    PackState's order (the solver service's response)."""
    return {name: value.cpu().numpy() for name, value in state._asdict().items()}


def dispatch_replan(replan, count_rows, exist_open, uninit_t, screen0, targs, items_pl,
                    want_slots: bool, on_chunk=None, sync=None):
    """The K candidate subsets through the batched replan kernel in the
    chunks of the K ladder (encode.replan_chunks). `on_chunk(k_pad, ms)`,
    when given, gets each chunk's bucket and milliseconds (after `sync`).

    Returns (the verdict parts, the pods-per-slot parts (empty unless
    want_slots), the chunks' buckets, the scans' counts by branch), the
    parts still on the device: fetch_replan gathers them."""
    verdict_parts, pods_parts, chunks = [], [], []
    scans = dict.fromkeys(pack_ops.LAST_REPLAN, 0)
    for k, kp, sub_counts, sub_open in replan_chunks(count_rows, exist_open):
        t0 = time.perf_counter()
        with device_profiler():
            pods_dev, verd_dev = replan(sub_counts, sub_open, uninit_t, screen0, *targs,
                                        items_pl=items_pl)
            if sync is not None and (profile_dir() or on_chunk is not None):
                sync()
        if on_chunk is not None:
            on_chunk(kp, (time.perf_counter() - t0) * 1e3)
        verdict_parts.append(verd_dev[:k])
        if want_slots:
            pods_parts.append(pods_dev[:k])
        chunks.append(kp)
        for name, v in pack_ops.LAST_REPLAN.items():
            scans[name] += v
    return verdict_parts, pods_parts, chunks, scans


def fetch_replan(verdict_parts, pods_parts, want_slots: bool):
    """(verdicts [K, 4] int32, pods per slot [K, N] int32 or None) on the
    host."""
    if verdict_parts:
        verdicts = torch.cat(verdict_parts).cpu().numpy()
    else:
        verdicts = np.zeros((0, 4), np.int32)
    pods = torch.cat(pods_parts).cpu().numpy() if want_slots and pods_parts else None
    return verdicts, pods


def load_screen_library(device) -> bool:
    """On the card, load the screen library (nvcc builds it when the
    source is newer than the built one); True when this call loaded it."""
    if torch.device(device).type != "cuda":
        return False
    from karpenter_core_tpu_torch.ops import cuda_build

    fresh = "screen" not in cuda_build.loaded_names()
    cuda_build.load("screen")
    return fresh


INCREMENTAL_MODES = ("on", "off")


# the planes the [N, C] verdict tensor is computed from (the prescreen's
# inputs), by run() argument
_SCREEN_PLANES = {
    "pod_arrays": ("allow", "out", "defined", "escape", "custom_deny", "scls_first"),
    "exist": ("allow", "out", "defined"),
}


def _residency_key(geom, args, screen_mode: str) -> tuple:
    """The key of a resident verdict tensor: what its shape and contents
    depend on besides the planes' values (which plan() fingerprints): N,
    the label segments, the screen width, the shape and dtype of every
    plane the prescreen reads, and the screen mode."""
    N, segments, screen_v = geom[7], geom[8], geom[16]
    named = dict(zip(RUN_ARG_NAMES, args))
    shapes = tuple((name, k, named[name][k].shape, str(named[name][k].dtype))
                   for name, keys in _SCREEN_PLANES.items() for k in keys)
    return (N, segments, screen_v, shapes, screen_mode)


class _Carried:
    """What one solve carries to the next: the type planes of the encode
    (EncodeReuse), the previous solve's label dictionary, the resident
    prescreen tensors by residency key (an LRU), the change-feed gate, and
    that gate's verdict for the solve under way. One holder at a time:
    TorchSolver hands it out under its lock, and a solve or replan that
    finds it held (by a dispatch a watchdog abandoned, or by another
    thread) takes a fresh one, so no resident tensor is ever shared with a
    dispatch that may still write it."""

    __slots__ = ("encode_reuse", "dictionary", "inc_screens", "diff_gate", "gate_ok", "held")

    def __init__(self):
        self.encode_reuse = EncodeReuse()
        self.dictionary = None
        self.inc_screens: "OrderedDict[tuple, IncrementalScreen]" = OrderedDict()
        self.diff_gate = DiffGate()
        self.gate_ok = True
        self.held = False


class TorchSolver:
    """The solver on one device: `device="cuda"` (the default) runs on the
    card and raises when there is none; `device="cpu"` runs the same
    program on the CPU, with each kernel's plain PyTorch version.

    screen_mode: "prescreen" (the default) computes the [N, C] verdict
    tensor before the scan; "tiered" screens the open slots against each
    item inside the scan. incremental: "on" (the default) keeps the
    prescreen tensor resident across solves and refreshes only what
    changed; "off" runs the full precompute every solve. It applies only
    under "prescreen", as the reference resolves it.

    Concurrent calls do not wait for each other: the state carried across
    solves (_Carried) has one holder, and a call that finds it held runs
    on a fresh one (a full precompute, counted as full_miss). So a solve
    that ResilientSolver abandoned as wedged, and that runs on in its
    thread, never holds up the next solve (nor does one in the reference's
    TPUSolver, which locks only its program cache)."""

    # resident tensors kept, least recently used first out
    MAX_INC_SCREENS = 8
    # the consolidation search screens its candidate subsets through
    # replan_screen (solver/replan.py)
    supports_batched_replan = True

    def __init__(self, max_nodes: int = 1024,
                 max_relax_rounds: int = DEFAULT_MAX_RELAX_ROUNDS,
                 device="cuda", screen_mode: str = "prescreen",
                 incremental: str = "on"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchSolver: no CUDA device is available; pass "
                    "device='cpu' to run on the CPU"
                )
        elif self.device.type != "cpu":
            raise ValueError(f"TorchSolver: unsupported device {self.device}")
        if screen_mode not in SCREEN_MODES:
            raise ValueError(f"TorchSolver: screen_mode must be one of {SCREEN_MODES}")
        if incremental not in INCREMENTAL_MODES:
            raise ValueError(f"TorchSolver: incremental must be one of {INCREMENTAL_MODES}")
        self.max_nodes = max_nodes
        self.max_relax_rounds = max_relax_rounds
        self.screen_mode = screen_mode
        self.incremental = incremental
        self.last_phase_ms: Dict[str, float] = {}
        # the last replan_screen's phases (args, upload, prescreen, device,
        # fetch), its K and chunks, and its screen launches by form
        self.last_replan_phase_ms: Dict[str, float] = {}
        self.last_replan_stats: Optional[Dict[str, object]] = None
        # the last prescreen dispatch: "full" or "refresh" (None under
        # tiered), and the refresh's delta sizes and budgets
        self.last_prescreen_mode: Optional[str] = None
        self.last_prescreen_delta: Optional[Dict[str, int]] = None
        # the screen kernels' launches of the last prescreen dispatch, by
        # kernel and form
        self.last_prescreen_launches: Optional[Dict[str, int]] = None
        # the traceback of the last refresh that failed (full_deg)
        self.last_refresh_error: Optional[str] = None
        # the state carried across solves, and the lock of its hand-over
        # (held only to take or return it, never across a dispatch); the
        # per-call results above and the warm keys below are written under
        # it too, since calls on several threads may run at once
        self._carried = _Carried()
        self._lock = threading.Lock()
        # the solve geometries (solve_geometry, screen mode) a solve or a
        # prewarm has met, in order (the counterpart of the reference's
        # compiled-program cache keys)
        self._warm_keys: Dict[tuple, None] = {}
        # the program ledger's view of them (obs/proghealth): the solve,
        # refresh and replan entries, each first dispatch booked as its
        # cold cost
        self._programs = proghealth.ProgramBook("torch")

    @property
    def _inc_screens(self) -> "OrderedDict[tuple, IncrementalScreen]":
        """The resident prescreen tensors of the carried state."""
        return self._carried.inc_screens

    @contextlib.contextmanager
    def _take_carried(self):
        """The carried state, held for one solve or replan; a fresh one
        when another call holds it (the held one is orphaned: its holder's
        late writes land there)."""
        with self._lock:
            carried = self._carried
            if carried.held:
                carried = self._carried = _Carried()
            carried.held = True
        try:
            yield carried
        finally:
            with self._lock:
                carried.held = False

    def _publish(self, **fields) -> None:
        """Set per-call results under the lock: an abandoned dispatch and
        the next solve may both be writing them."""
        with self._lock:
            for name, value in fields.items():
                setattr(self, name, value)

    def _warm(self, warm_key) -> bool:
        """Note a geometry met; whether it was new."""
        with self._lock:
            cold = warm_key not in self._warm_keys
            self._warm_keys[warm_key] = None
        return cold

    def _program_meta(self, geom) -> dict:
        return {"tier": f"{geom[7]}slots", "mode": self.screen_mode}

    def _inc_enabled(self) -> bool:
        """The delta re-solve applies only under prescreen: tiered keeps
        no tensor to refresh."""
        return self.screen_mode == "prescreen" and self.incremental == "on"

    def encode(self, pods, provisioners, instance_types, daemonset_pods=None,
               state_nodes=None, kube_client=None, cluster=None):
        return encode_snapshot(pods, provisioners, instance_types, daemonset_pods,
                               state_nodes, kube_client, cluster,
                               max_nodes=self.max_nodes, reuse=self._carried.encode_reuse)

    def solve(self, pods, provisioners, instance_types, daemonset_pods=None,
              state_nodes=None, kube_client=None, cluster=None,
              encoded=None) -> SolveResult:
        """Place `pods`. state_nodes are the existing nodes (for example
        cluster.nodes()); kube_client (get/list, e.g. kube/client.py's
        InMemoryKubeClient) resolves volume claims and CSINode limits and
        seeds topology counts with the scheduled pods it lists; cluster
        (state/cluster.Cluster) adds its bound pods' inverse
        anti-affinity, and its change feed gates the resident tensor.
        Every relaxation round re-encodes with both."""
        if encoded is not None and (
            len(encoded.pods) != len(pods)
            or {id(p) for p in encoded.pods} != {id(p) for p in pods}
        ):
            raise ValueError("encoded snapshot was built from a different pod batch")
        with self._take_carried() as carried:
            return self._solve_carried(pods, provisioners, instance_types, daemonset_pods,
                                       state_nodes, kube_client, cluster, encoded, carried)

    def _solve_carried(self, pods, provisioners, instance_types, daemonset_pods,
                       state_nodes, kube_client, cluster, encoded, carried) -> SolveResult:
        # the change feed is read once per solve (relaxation rounds see no
        # churn): a fault or a gap sends this solve's prescreen down the
        # full path and drops every resident tensor
        if self._inc_enabled():
            carried.gate_ok = carried.diff_gate.gate(cluster)
        ctx = {"dictionary": None, "encoded": encoded, "carried": carried}
        # cyclic GC waits for the window to close: a gen-2 collection over
        # the batch and the cluster would otherwise land inside the solve
        with gc_paused():
            return solve_with_relaxation(
                lambda p: self._solve_once(p, provisioners, instance_types,
                                           daemonset_pods, state_nodes, kube_client,
                                           cluster, ctx),
                pods, provisioners, instance_types, self.max_relax_rounds,
            )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dispatch_prescreen(self, key, geom, host_args, targs, carried):
        """dispatch_prescreen at the carried residency: the resident
        tensor at `key` (an LRU of MAX_INC_SCREENS), the change feed's
        verdict poisoning every key on a fault. Returns (tensor, "full" |
        "refresh", delta, the class planes)."""
        inc, gate_ok = None, True
        if self._inc_enabled():
            gate_ok, carried.gate_ok = carried.gate_ok, True
            screens = carried.inc_screens
            if not gate_ok:
                # a feed fault poisons every key's residency
                for other in screens.values():
                    other.invalidate()
            inc = screens.setdefault(key, IncrementalScreen())
            screens.move_to_end(key)
            while len(screens) > self.MAX_INC_SCREENS:
                screens.popitem(last=False)
        screen0, mode, delta, items_pl, error = dispatch_prescreen(
            geom[8], geom[16], geom[7], host_args, targs, inc=inc, key=key, gate_ok=gate_ok)
        if error is not None:
            self._publish(last_refresh_error=error)
        elif mode == "refresh":
            self._programs.dispatch("refresh", (key, delta.rb, delta.cb))
        return screen0, mode, delta, items_pl

    def _solve_once(self, pods, provisioners, instance_types, daemonset_pods,
                    state_nodes, kube_client, cluster, ctx) -> SolveResult:
        phases: Dict[str, float] = {}
        try:
            return self._solve_phases(phases, pods, provisioners, instance_types,
                                      daemonset_pods, state_nodes, kube_client, cluster, ctx)
        finally:
            # published once filled: a reader on another thread sees the
            # last solve's phases or this one's, never a dict being written
            self._publish(last_phase_ms=phases)

    def _solve_phases(self, phases, pods, provisioners, instance_types, daemonset_pods,
                      state_nodes, kube_client, cluster, ctx) -> SolveResult:
        t = time.perf_counter_ns()

        def mark(name, **attrs):
            # after the phase's synchronize, so that the span, like the
            # phase, covers the phase's device work
            nonlocal t
            self._sync()
            now = time.perf_counter_ns()
            phases[name] = (now - t) / 1e6
            TRACER.add_span(f"solver.phase.{name}", t, now, **attrs)
            t = now
            # progress proof for the dispatch watchdog (ResilientSolver): a
            # wedged dispatch stops marking; the label names the phase just
            # finished
            supervise.touch_heartbeat(f"solver.phase.{name}")

        carried = ctx["carried"]
        snap = ctx.pop("encoded", None)
        if snap is None:
            snap = encode_snapshot(
                pods, provisioners, instance_types, daemonset_pods, state_nodes,
                kube_client, cluster, max_nodes=self.max_nodes,
                reuse_dictionary=ctx["dictionary"], reuse=carried.encode_reuse,
                # offered, not trusted: adopted only when it covers the batch
                carry_dictionary=carried.dictionary if self._inc_enabled() else None,
            )
        # relaxation rounds reuse round 1's dictionary (a superset)
        ctx["dictionary"] = snap.dictionary
        carried.dictionary = snap.dictionary
        mark("encode")
        # dispatch-start heartbeat: staleness counts from the device
        # pipeline's start, labelled as the device phase until a later mark
        supervise.touch_heartbeat("solver.phase.device")
        # the device edge: an injected error routes the solve to
        # ResilientSolver's fallback; a hang (error:none and a latency past
        # the watchdog) is the wedge the watchdog abandons
        chaos.maybe_fail(chaos.SOLVER_DEVICE)
        chaos.maybe_fail(chaos.SOLVER_DEVICE_HANG)
        geom = solve_geometry(snap, self.max_nodes)
        warm_key = (geom, self.screen_mode)
        cold = self._warm(warm_key)
        self._programs.mint("solve", warm_key, meta=self._program_meta(geom))
        N, segments, zone_seg, ct_seg, log_len, screen_v = (
            geom[7], geom[8], geom[9], geom[10], geom[12], geom[16]
        )
        args = device_args(snap, provisioners)
        mark("args")
        targs = args_to_torch(args, self.device)
        mark("upload")
        self._publish(last_prescreen_mode=None, last_prescreen_delta=None,
                      last_prescreen_launches=None)
        screen0 = items_pl = None
        if self.screen_mode == "prescreen":
            key = _residency_key(geom, args, self.screen_mode)
            before = screen_ops.launch_counts()
            screen0, mode, delta, items_pl = self._dispatch_prescreen(key, geom, args, targs,
                                                                      carried)
            self._publish(
                last_prescreen_mode=mode,
                last_prescreen_launches={
                    k: v - before[k] for k, v in screen_ops.launch_counts().items()},
                last_prescreen_delta={
                    "rows": len(delta.rows), "cols": len(delta.cols),
                    "rb": delta.rb, "cb": delta.cb,
                } if mode == "refresh" else None)
            mark("prescreen", mode=mode, cold=cold)
        run = make_device_run(segments, zone_seg, ct_seg, snap.topo_meta, N, log_len,
                              screen_v=screen_v, screen_mode=self.screen_mode)
        # re-label for the long silent stretch ahead: a wedge inside the
        # scan names the device phase, not the last host-side mark
        supervise.touch_heartbeat("solver.phase.device")
        log, ptr, state = dispatch_solve(run, screen0, targs, items_pl, sync=self._sync)
        mark("device")
        self._programs.dispatch("solve", warm_key,
                                device_ms=phases.get("prescreen", 0.0) + phases["device"])
        nopen = int(state.nopen)
        log = fetch_log(log)
        host_state = _HostState(state, nopen)
        mark("fetch")
        result = decode_solve(snap, (log, ptr), host_state)
        mark("decode")
        return result

    # -- the batched consolidation replan ------------------------------------

    def replan_screen(self, snap: EncodedSnapshot, provisioners, count_rows: np.ndarray,
                      exist_open: np.ndarray, uninitialized: Optional[np.ndarray] = None,
                      cluster=None, want_slots: bool = False):
        """Screen K candidate subsets of one union snapshot
        (tpu_solver.py:1907-2055). Subset k closes the existing slots
        exist_open[k] [E] leaves False and activates the replica counts
        count_rows[k] [I]; the rung-mode solve program re-packs them
        against the rest of the cluster (ops/pack.make_batched_replan_kernel).

        One device_args and upload serve the whole call; the prescreen is
        dispatched once, at the residency key a solve at this geometry
        uses, so a replan refreshes the resident [N, C] tensor instead of
        recomputing it (the change feed of `cluster` gates it, as in
        solve()); then the subsets go through in chunks of the K ladder
        (encode.replan_chunks). Under screen_mode="tiered" there is no
        tensor and each scan screens per item.

        Returns (verdicts [K, 4] int32: scheduled, expected, n_new,
        inconclusive per subset; pods_per_slot [K, N] int32 when
        want_slots, else None). Only the verdicts are fetched otherwise."""
        with self._take_carried() as carried:
            phases: Dict[str, float] = {}
            try:
                return self._replan_carried(snap, provisioners, count_rows, exist_open,
                                            uninitialized, cluster, want_slots, carried,
                                            phases)
            finally:
                self._publish(last_replan_phase_ms=phases)

    def _replan_carried(self, snap, provisioners, count_rows, exist_open, uninitialized,
                        cluster, want_slots, carried, phases):
        t = time.perf_counter_ns()

        def mark(name):
            nonlocal t
            self._sync()
            now = time.perf_counter_ns()
            phases[name] = (now - t) / 1e6
            TRACER.add_span(f"solver.phase.replan.{name}", t, now)
            t = now
            supervise.touch_heartbeat(f"solver.phase.replan.{name}")

        # dispatch-start heartbeat: staleness counts from the replan's
        # dispatch, not from the last solve
        supervise.touch_heartbeat("solver.phase.replan.device")
        chaos.maybe_fail(chaos.SOLVER_DEVICE)
        chaos.maybe_fail(chaos.SOLVER_DEVICE_HANG)
        before = screen_ops.launch_counts()
        geom = solve_geometry(snap, self.max_nodes)
        N, segments, zone_seg, ct_seg, log_len, screen_v = (
            geom[7], geom[8], geom[9], geom[10], geom[12], geom[16]
        )
        E = geom[3]
        args = device_args(snap, provisioners)
        mark("args")
        if self._inc_enabled():
            carried.gate_ok = carried.diff_gate.gate(cluster)
        targs = args_to_torch(args, self.device)
        uninit = np.zeros(E, dtype=bool)
        if uninitialized is not None:
            m = min(len(uninitialized), E)
            uninit[:m] = np.asarray(uninitialized, dtype=bool)[:m]
        uninit_t = torch.from_numpy(uninit).to(self.device)
        mark("upload")
        self._publish(last_prescreen_mode=None, last_prescreen_delta=None)
        screen0 = items_pl = mode = None
        if self.screen_mode == "prescreen":
            key = _residency_key(geom, args, self.screen_mode)
            screen0, mode, _delta, items_pl = self._dispatch_prescreen(key, geom, args, targs,
                                                                       carried)
            self._publish(last_prescreen_mode=mode)
            mark("prescreen")
        rung_run = make_device_run(segments, zone_seg, ct_seg, snap.topo_meta, N, log_len,
                                   screen_v=screen_v, screen_mode=self.screen_mode,
                                   rung_mode=True)
        replan = make_batched_replan_kernel(rung_run, E)
        warm_key = (geom, self.screen_mode)

        def on_chunk(kp, ms):
            self._programs.dispatch("replan", (warm_key, kp), device_ms=ms,
                                    meta={"tier": f"K{kp}", "mode": self.screen_mode})

        verdict_parts, pods_parts, chunks, scans = dispatch_replan(
            replan, count_rows, exist_open, uninit_t, screen0, targs, items_pl, want_slots,
            on_chunk=on_chunk, sync=self._sync)
        mark("device")
        K = int(count_rows.shape[0])
        verdicts, pods = fetch_replan(verdict_parts, pods_parts, want_slots)
        mark("fetch")
        self._publish(last_replan_stats={
            "K": K, "chunks": chunks, "prescreen": mode,
            "launches": {k: v - before[k] for k, v in screen_ops.launch_counts().items()},
            "scans": scans,
        })
        return verdicts, pods

    # -- the startup prewarm -------------------------------------------------

    def prewarm_snapshot(self, snap: EncodedSnapshot, provisioners) -> str:
        """Pay a geometry's cold costs without solving
        (tpu_solver.py:1104-1191): on the card, load the screen library
        (nvcc builds it when the source is newer than the built one);
        then device_args and the upload of the snapshot, and the
        prescreen at its geometry (screen_prep and the screen forms that
        geometry takes), which also makes the caching allocator's first
        allocations there. The scan does not run. Returns "compiled" when
        this call loaded the library or first met the snapshot's solve
        geometry, "cached" otherwise (a live solve or an earlier prewarm
        got there first).

        It takes no carried state: it neither reads nor adopts a resident
        prescreen tensor, and leaves the per-solve state (`last_phase_ms`,
        `last_prescreen_*`, ops/pack.LAST_SCAN) as the last solve left it."""
        t0 = time.perf_counter()
        fresh = load_screen_library(self.device)
        geom = solve_geometry(snap, self.max_nodes)
        key = (geom, self.screen_mode)
        fresh = self._warm(key) or fresh
        args = device_args(snap, provisioners)
        # the prescreen at this geometry, with no resident tensor
        dispatch_prescreen(geom[8], geom[16], geom[7], None,
                           args_to_torch(args, self.device))
        self._sync()
        self._programs.mint("solve", key, origin="prewarm", meta=self._program_meta(geom),
                            seconds=time.perf_counter() - t0)
        return "compiled" if fresh else "cached"


class GreedySolver:
    """The host fallback behind the same Solver interface: the host
    scheduler (controllers/provisioning/scheduling/scheduler.py), the
    reference semantics, run on the pods' deep copies in simulation mode.
    The scheduler's per-pod causes (topology, host ports, limits) ride in
    `errors`."""

    def solve(self, pods, provisioners, instance_types, daemonset_pods=None,
              state_nodes=None, kube_client=None, cluster=None) -> SolveResult:
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.scheduler import (
            SchedulerOptions,
            build_scheduler,
        )

        pods = [copy.deepcopy(p) for p in pods]
        scheduler = build_scheduler(
            kube_client, cluster, provisioners, instance_types, pods,
            state_nodes=state_nodes, daemonset_pods=daemonset_pods,
            opts=SchedulerOptions(simulation_mode=True),
        )
        res = scheduler.solve(pods)
        machines = [
            SolvedMachine(
                provisioner_name=m.provisioner_name,
                template=m.template,
                pods=m.pods,
                requests=m.requests,
                options_fn=lambda m=m: m.instance_type_options,
                requirements_fn=lambda m=m: m.requirements,
            )
            for m in res.new_machines if m.pods
        ]
        existing = [(n.state_node, n.pods) for n in res.existing_nodes if n.pods]
        return SolveResult(new_machines=machines, existing_assignments=existing,
                           failed_pods=res.failed_pods, errors=dict(res.errors))
