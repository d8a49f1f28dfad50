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

With pack_scan="segmented" (or KCT_PACK_SCAN=segmented) a prescreen solve
first tries the segmented scan (tpu_solver.py:1451-1906): the partition of
the class columns into conflict-independent components
(ops/pack.make_segment_partition_kernel), one lane scan per group of
components, and the host merge of the lanes' logs into global item order;
`last_segment_stats` reports the attempt, which degrades to the
sequential scan on the reference's grounds.

On a device grid (parallel/sharded.ShardedSolver, whose `_layout_for`
returns a parallel/specs.SpecLayout for batches that clear the routing
floor) the prescreen's verdict tensor and the static feasibility planes
are computed as tiles, each on its grid device, and gathered on the lead
device; the scan runs there, and so do the segmented scan's lanes, one
after another (the reference splits them over dp; the port's scan steps
items from the host, so lanes on threads would take turns at the GIL and
could not overlap). The layout's key joins the warm-state and residency
keys, so the grid's entries never meet the single device's. `last_spec_layout` is the last
solve's layout (None: the single-device path).

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
from karpenter_core_tpu_torch.obs import envflags
from karpenter_core_tpu_torch.ops import compat as ops_compat
from karpenter_core_tpu_torch.ops import pack as pack_ops
from karpenter_core_tpu_torch.ops import pack_scan
from karpenter_core_tpu_torch.ops import screen as screen_ops
from karpenter_core_tpu_torch.ops.cuda_build import KernelError
from karpenter_core_tpu_torch.ops.feasibility import (
    feasibility_static,
    feasibility_tiles,
    openable_mask,
)
from karpenter_core_tpu_torch.ops.pack import (
    SCREEN_MODES,
    PackState,
    ScreenOps,
    class_planes,
    grid_initial_screen,
    make_batched_replan_kernel,
    make_pack_kernel,
    make_segment_partition_kernel,
    screen_refresh,
)
from karpenter_core_tpu_torch.ops.topology import TopoGroupMeta, TopoMeta
from karpenter_core_tpu_torch.scheduling.preferences import Preferences
from karpenter_core_tpu_torch.scheduling.requirement import Requirement
from karpenter_core_tpu_torch.scheduling.requirements import Requirements
from karpenter_core_tpu_torch.solver.encode import (
    SEGMENT_LANE_BUCKETS,
    EncodedSnapshot,
    EncodeReuse,
    ReqSetArrays,
    bucket_pow2,
    encode_snapshot,
    replan_chunks,
    segment_item_pad,
    segment_lane_pad,
)
from karpenter_core_tpu_torch.solver.incremental import DiffGate, IncrementalScreen
from karpenter_core_tpu_torch.utils import supervise
from karpenter_core_tpu_torch.utils.compilecache import record_compile_seconds, record_lookup
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
                    screen_mode: str = "prescreen", rung_mode: bool = False,
                    segment_mode: bool = False, spec_layout=None, host_kernel: bool = False):
    """The solve program (make_device_run with an external prescreen):
    feasibility + openable + the pack scan, a function of args_to_torch's
    tensors and the prescreen tensor (None under screen_mode="tiered"),
    with the class planes the prescreen built (items_pl) reused by the
    scan. Returns (log, ptr, state); run(..., verdicts=[]) also appends
    the scan's final [N, C] verdict tensor to the list.

    Where ops/pack.kernel_routes holds (a CUDA device, the prescreen, a
    commit log; topology groups or none) the scan is the pack_scan kernel
    (ops/pack_scan.py): one launch and one read per solve. Every other
    scan runs the eager make_pack_kernel.pack. host_kernel=True (tests
    only) routes as on a card and runs the kernel's CPU build.

    rung_mode=True is the consolidation replan's form
    (tpu_solver.py:345-370,558-570): run(count_row, exist_open, screen0,
    *args, items_pl=None, shared=None) replaces the replica counts with
    the host row count_row [I] and opens only the existing slots
    exist_open [E] leaves open (closed ones are neither open nor
    existing); no commit log is written. `shared` (a dict kept across
    the calls of one replan chunk) holds what does not depend on the
    subset: the feasibility planes, the openable mask and the scan's
    constants.

    segment_mode=True is the segmented scan's lane run
    (tpu_solver.py:282-316,423-556): seg_run(item_sel [S, M], exist_open
    [S, E], screen0, *args, items_pl) packs each lane s on its own: the
    items item_sel[s] names (global item indices in order, -1 pads), the
    existing slots exist_open[s] leaves open (the partition proved the
    lanes' slots disjoint) and a private machine region [E, N). The
    feasibility planes are computed once over the whole item axis and
    gathered per lane; `items_pl` must be the prescreen's class planes of
    the whole axis. On the kernel route every lane with items is a scan of
    one launch (the lanes are its batch axis); else the lanes run one
    after another. A lane with no item is not run (its scan would commit
    nothing). Each lane refreshes its
    own copy of screen0 as the sequential scan does; the reference's
    read-only variant for all-neutral lanes (seg_frozen) is not ported,
    since a fully neutral batch is one component and never dispatches
    lanes. Returns one (log, ptr, state) per lane, None for a lane not
    run.

    spec_layout (parallel/specs.SpecLayout) is the device grid's form
    (tpu_solver.py:367-410,528-553): feasibility_static runs as the
    grid's tiles (ops/feasibility.feasibility_tiles) and is gathered on
    the lead device, where openable_mask and the scan run on the inputs
    the lead holds. The segmented lanes run there too, where the
    reference splits them over dp (segment_axis): one launch on the
    kernel route, else one after another (ROADMAP Queue B). The
    replan (rung_mode) runs on the lead device, as the reference's runs
    the single-device program. run() and seg_run() take `placed`, the
    GridArgs of SpecLayout.put_args, whose type-plane tiles the
    feasibility tiles read."""
    segments = [tuple(s) for s in segments]
    topo = topo_meta_from(topo_meta)
    pack = make_pack_kernel(segments, zone_seg, ct_seg, topo_meta=topo, screen_v=screen_v,
                            screen_mode=screen_mode)
    if rung_mode:
        spec_layout = None

    def run_impl(count_row, exist_open, screen0, pod_arrays, tmpl, tmpl_daemon,
                 tmpl_type_mask, types, type_alloc, type_capacity, type_offering_ok,
                 pod_tol_all, exist, exist_used, exist_cap, well_known, remaining0,
                 topo_counts0, topo_hcounts0, topo_doms0, topo_terms, exist_ports,
                 exist_vols, exist_vol_limits, vol_driver, items_pl=None, shared=None,
                 item_sel=None, placed=None, verdicts=None):
        dev = exist_used.device
        E = exist_used.shape[0]
        T = type_alloc.shape[0]
        J = tmpl_daemon.shape[0]
        kernel = pack_ops.kernel_routes("cuda" if host_kernel else dev, screen_mode,
                                        count_row is None)
        pre = shared if shared is not None else {}
        if "f_static" not in pre:
            feas_args = ({k: pod_arrays[k] for k in ("allow", "out", "defined", "escape")},
                         tmpl, types, pod_arrays["tol_tmpl"], tmpl_type_mask,
                         type_offering_ok, zone_seg, ct_seg, segments, well_known)
            if spec_layout is not None:
                pre["f_static"] = feasibility_tiles(spec_layout, *feas_args, targs=placed)
            else:
                pre["f_static"] = feasibility_static(*feas_args)
            pre["openable"] = openable_mask(pre["f_static"], pod_arrays["requests"],
                                            tmpl_daemon, type_alloc)
        f_static, openable = pre["f_static"], pre["openable"]
        if kernel:
            # the scan as one device program: the wrapper takes the whole
            # item axis and each scan's item list
            states = [initial_state(eo, exist, exist_used, exist_cap, remaining0,
                                    topo_counts0, topo_hcounts0, topo_doms0, exist_ports,
                                    exist_vols, J, T)
                      for eo in (exist_open if item_sel is not None else [exist_open])]
            geo = pre.setdefault("scan", {}).setdefault("geo", {})
            item_arrays = dict(pod_arrays, tol=pod_tol_all)
            if not geo:
                geo.update(pack_ops._scan_constants(
                    segments, pod_arrays["allow"].shape[1], screen_v, types,
                    type_offering_ok, item_arrays, items_pl, tmpl, False,
                    topo.groups if topo is not None else [], topo_terms, dev))
            runs = pack_scan.run(
                states, item_arrays, f_static, openable,
                {k: tmpl[k] for k in ("allow", "out", "defined")}, tmpl_daemon,
                tmpl_type_mask, types, type_alloc, type_capacity, type_offering_ok,
                segments=segments, zone_seg=zone_seg, ct_seg=ct_seg, screen0=screen0,
                items_pl=geo["items_pl"], geo=geo, log_len=log_len, n_exist=E,
                vol_limits=exist_vol_limits, vol_driver=vol_driver, topo=topo,
                topo_terms=topo_terms, well_known=well_known, item_sel=item_sel,
                bulk_len=None if item_sel is None else lane_bulk_len(item_sel.shape[1]),
                host=host_kernel, verdicts=verdicts)
            got = [(log, ptr, state) for state, log, ptr in runs]
            return got if item_sel is not None else got[0]
        lane = {}
        if item_sel is not None:
            # a lane scans its gathered items only
            # pads (-1) gather row 0 with valid=False and count=0, so they
            # skip as padded items do
            gi = torch.as_tensor(np.maximum(item_sel, 0), dtype=torch.int64, device=dev)
            onsel = torch.as_tensor(item_sel >= 0, device=dev)
            pod_arrays = {k: v[gi] for k, v in pod_arrays.items() if k != "scls_first"}
            pod_arrays["valid"] = pod_arrays["valid"] & onsel
            pod_arrays["count"] = torch.where(onsel, pod_arrays["count"], 0)
            pod_tol_all = pod_tol_all[gi]
            f_static, openable = f_static[:, gi, :], openable[:, gi]
            lane = dict(item_ids=item_sel, bulk_len=lane_bulk_len(len(item_sel)))
        state = initial_state(exist_open, exist, exist_used, exist_cap, remaining0,
                              topo_counts0, topo_hcounts0, topo_doms0, exist_ports,
                              exist_vols, J, T)
        item_arrays = dict(pod_arrays, tol=pod_tol_all)
        state, log, ptr = pack(
            state, item_arrays, f_static, openable,
            {k: tmpl[k] for k in ("allow", "out", "defined")},
            tmpl_daemon, tmpl_type_mask, types, type_alloc, type_capacity,
            type_offering_ok, well_known=well_known, topo_terms=topo_terms,
            log_len=log_len, n_exist=E, vol_limits=exist_vol_limits,
            vol_driver=vol_driver, screen0=screen0, items_pl=items_pl,
            log_commits=count_row is None, counts_host=count_row,
            shared=pre.setdefault("scan", {}), verdicts=verdicts, **lane,
        )
        return log, ptr, state

    def initial_state(exist_open, exist, exist_used, exist_cap, remaining0, topo_counts0,
                      topo_hcounts0, topo_doms0, exist_ports, exist_vols, J, T):
        """A scan's PackState at entry: the existing prefix from the
        snapshot (exist_open [E], when given, closes slots: a closed slot
        is neither open nor existing), a closed machine region [E, N)."""
        dev = exist_used.device
        E = exist_used.shape[0]
        N = n_slots
        open0 = torch.arange(N, device=dev) < E
        if exist_open is not None:
            open0[:E] &= exist_open

        def prefix(fill, rows, dtype):
            out = torch.full((N,) + tuple(rows.shape[1:]), fill, dtype=dtype, device=dev)
            out[:E] = rows
            return out

        return PackState(
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

    if segment_mode:
        if screen_mode != "prescreen":
            raise ValueError("the segmented scan reads the prescreen's verdict tensor")

        def seg_run(item_sel, exist_open, screen0, *args, items_pl, placed=None):
            dev = args[RUN_ARG_NAMES.index("exist_used")].device
            open_dev = torch.from_numpy(np.ascontiguousarray(exist_open)).to(dev)
            # the feasibility planes and the scan's geometry constants are
            # the lanes' own only through their item rows: shared
            pre = {}
            geo = {}
            live = [s for s, sel in enumerate(item_sel) if (np.asarray(sel) >= 0).any()]
            out = [None] * len(item_sel)
            if live and pack_ops.kernel_routes("cuda" if host_kernel else dev, screen_mode,
                                               True):
                # every lane with items in one launch, the lanes its batch
                pre["scan"] = {"geo": geo}
                runs = run_impl(None, open_dev[live], screen0, *args, items_pl=items_pl,
                                shared=pre, item_sel=np.asarray(item_sel)[live], placed=placed)
                for s, got in zip(live, runs):
                    out[s] = got
                return out
            for s in live:
                pre["scan"] = {"geo": geo}
                out[s] = run_impl(None, open_dev[s], screen0, *args, items_pl=items_pl,
                                  shared=pre, item_sel=np.asarray(item_sel[s]), placed=placed)
            return out

        return seg_run

    if rung_mode:
        def rung_run(count_row, exist_open, screen0, *args, items_pl=None, shared=None):
            return run_impl(np.asarray(count_row), exist_open, screen0, *args,
                            items_pl=items_pl, shared=shared)

        rung_run.n_slots = n_slots
        return rung_run

    def run(screen0, *args, items_pl=None, placed=None, verdicts=None):
        return run_impl(None, None, screen0, *args, items_pl=items_pl, placed=placed,
                        verdicts=verdicts)

    return run


def lane_bulk_len(m: int) -> int:
    """A segmented lane's bulk take budget for m item rows."""
    return min(2 * m + 64, 4096)


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


class _MergedSlotState:
    """The slot state a segmented solve decodes: each opened machine row
    from its lane's final state, at its global slot (decode reads machine
    rows only; the existing rows stay zero)."""

    def __init__(self, fields: Dict[str, np.ndarray]):
        self.__dict__.update(fields)


def _segment_tmpl_fingerprint(host_args) -> bytes:
    """A digest of the partitioner's template-side inputs (the template
    planes and the well-known mask), which the verdict tensor's
    fingerprints do not cover (tpu_solver.py:136-150)."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    tmpl = host_args[RUN_ARG_NAMES.index("tmpl")]
    for k in sorted(tmpl):
        h.update(k.encode())
        h.update(np.ascontiguousarray(tmpl[k]).tobytes())
    h.update(np.ascontiguousarray(host_args[RUN_ARG_NAMES.index("well_known")]).tobytes())
    return h.digest()


def _lane_plan(labels, slot_label, host_args, n_exist: int, item_pad: int, lanes_req: int):
    """The segmented solve's host grouping (tpu_solver.py:1686-1746): items
    grouped by their class's component label, the components LPT-balanced
    by item count into at most `lanes_req` lanes (clamped to [2, the top
    lane bucket]), each lane's items in global order, padded to the lane
    and item buckets, and each existing slot open in the lane of its
    label. Returns None when no item is valid, else (item_sel [S, M],
    exist_open [S, E], components, lanes, the largest lane's items), the
    first two None when there is one component (its items the last)."""
    pa = host_args[0]
    scls = np.asarray(pa["scls"])
    valid = np.asarray(pa["valid"])
    real = np.nonzero(valid)[0]
    if len(real) == 0:
        return None
    labs = labels[scls[real]]
    sort_i = np.argsort(labs, kind="stable")
    sorted_labs = labs[sort_i]
    cuts = np.nonzero(np.diff(sorted_labs))[0] + 1
    group_items = np.split(real[sort_i], cuts)
    group_labels = sorted_labs[np.concatenate(([0], cuts))]
    s_real = len(group_items)
    if s_real <= 1:
        return None, None, s_real, 0, len(real)
    max_lanes = min(max(lanes_req, 2), SEGMENT_LANE_BUCKETS[-1])
    lanes_n = min(s_real, max_lanes)
    # LPT by item count (a lane's scan length); ties keep the component
    # order, as the reference's sorted() does
    order_sz = sorted(range(s_real), key=lambda g: -len(group_items[g]))
    lane_members = [[] for _ in range(lanes_n)]
    loads = [0] * lanes_n
    lane_of_label = {}
    for g in order_sz:
        tgt = min(range(lanes_n), key=lambda x: loads[x])
        lane_members[tgt].append(group_items[g])
        loads[tgt] += len(group_items[g])
        lane_of_label[int(group_labels[g])] = tgt
    m_real = max(loads)
    s_pad = segment_lane_pad(lanes_n)
    m_pad = segment_item_pad(m_real, item_pad)
    item_sel = np.full((s_pad, m_pad), -1, np.int32)
    for s, members in enumerate(lane_members):
        rows = np.sort(np.concatenate(members))
        item_sel[s, : len(rows)] = rows
    exist_open = np.zeros((s_pad, n_exist), bool)
    if n_exist:
        lane_of = np.full(len(labels) + 1, -1, np.int32)
        for lab, tgt in lane_of_label.items():
            lane_of[lab] = tgt
        sl = np.asarray(slot_label[:n_exist])
        owner = np.where(sl >= 0, lane_of[np.maximum(sl, 0)], -1)
        for s in range(lanes_n):
            exist_open[s] = owner == s
    return item_sel, exist_open, s_real, lanes_n, m_real


def merge_lanes(lanes, n_exist: int):
    """The host merge of a segmented solve (tpu_solver.py:1818-1892): the
    lanes' commit logs interleaved into global item order, machine slots
    numbered in first-open order (the sequential scan's nopen order), bulk
    take rows renumbered in merged order, and each opened machine row's
    state gathered from its lane. `lanes` holds per lane (log arrays on
    the host with bulk_take cut to bulk_n, ptr, host state rows [:nopen])
    or None. Returns (log, ptr, _MergedSlotState)."""
    E = n_exist
    run = [(s, ln) for s, ln in enumerate(lanes) if ln is not None]

    def cat(name):
        parts = [ln[0][name][: ln[1]] for _s, ln in run]
        return np.concatenate(parts) if parts else np.zeros(0, np.int32)

    items_c, slots_c, ns_c, k_c, kl_c = (cat(n) for n in ("item", "slot", "ns", "k", "k_last"))
    lane_c = np.concatenate([np.full(ln[1], s, np.int32) for s, ln in run]) if run else (
        np.zeros(0, np.int32))
    order = np.argsort(items_c, kind="stable")
    slot_map: Dict[tuple, int] = {}
    next_g = E
    m_item, m_slot, m_ns, m_k, m_kl = [], [], [], [], []
    bulk_rows = []
    for e in order:
        ln, ns, sl = int(lane_c[e]), int(ns_c[e]), int(slots_c[e])
        kk, kl = int(k_c[e]), int(kl_c[e])
        if ns == -1:
            bulk_rows.append(np.asarray(lanes[ln][0]["bulk_take"][kk]))
            kk = len(bulk_rows) - 1
            sl = 0
        elif sl >= E:
            for j in range(ns):
                if (ln, sl + j) not in slot_map:
                    slot_map[(ln, sl + j)] = next_g
                    next_g += 1
            sl = slot_map[(ln, sl)]
        m_item.append(int(items_c[e]))
        m_slot.append(sl)
        m_ns.append(ns)
        m_k.append(kk)
        m_kl.append(kl)
    log = {
        "item": np.asarray(m_item, np.int32),
        "slot": np.asarray(m_slot, np.int32),
        "ns": np.asarray(m_ns, np.int32),
        "k": np.asarray(m_k, np.int32),
        "k_last": np.asarray(m_kl, np.int32),
        "bulk_take": np.stack(bulk_rows) if bulk_rows else np.zeros((0, E), np.int32),
        "bulk_n": len(bulk_rows),
    }
    fields = {}
    like = run[0][1][2] if run else None
    for f in _HostState.FIELDS:
        arr0 = getattr(like, f) if like is not None else np.zeros((0,), np.int32)
        out = np.zeros((next_g,) + arr0.shape[1:], dtype=arr0.dtype)
        for (s, row), g in slot_map.items():
            out[g] = getattr(lanes[s][2], f)[row]
        fields[f] = out
    return log, len(order), _MergedSlotState(fields)


# -- the device path's dispatch, shared by TorchSolver and the solver
# service (solver/service.py), so that a wire solve and an in-process solve
# run the same code from device_args on


def dispatch_prescreen(segments, screen_v, n_slots: int, host_args, targs, inc=None,
                       key=None, gate_ok: bool = True, spec_layout=None):
    """The [N, C] verdict tensor of a solve or replan (_dispatch_prescreen,
    tpu_solver.py:1369-1458). With `inc` (an IncrementalScreen) the tensor
    resident at `key` is refreshed in its changed rows and columns when
    the delta is narrow; otherwise, and when planning or the refresh
    fails, the full precompute runs. `host_args` are device_args' numpy
    arrays (the fingerprints read them), `targs` their tensors.

    With spec_layout (a device grid) the full precompute runs as the
    grid's tiles, gathered on the lead device (ops/pack.
    grid_initial_screen); the refresh runs on the lead device, where the
    resident tensor, `targs` and the class planes are.

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
    if screen0 is None and spec_layout is not None:
        screen0 = grid_initial_screen(ops, spec_layout, items_pl, exist, n_slots, targs=targs)
    elif screen0 is None:
        screen0 = ops.initial_screen(items_pl, exist["allow"], exist["out"], exist["defined"],
                                     n_slots)
    if inc is not None:
        inc.adopt(key, screen0)
    return screen0, mode, delta, items_pl, error


def dispatch_solve(run, screen0, targs, items_pl, sync=None):
    """One solve program's run on its device (under obs.device_profiler):
    (log, ptr, PackState), still on the device. `targs` may be a
    device grid's GridArgs, whose tiles the tiled precompute reads."""
    with device_profiler():
        log, ptr, state = run(screen0, *targs, items_pl=items_pl, placed=targs)
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


# the kernels a solve on the card runs: the screen and the pack scan
SOLVE_LIBRARIES = ("screen", "pack_scan")


def load_solve_libraries(device) -> bool:
    """On the card, load the libraries a solve's kernels live in (the
    screen's and the pack scan's; nvcc builds one when its source is newer
    than the built one); True when this call loaded one."""
    if torch.device(device).type != "cuda":
        return False
    from karpenter_core_tpu_torch.ops import cuda_build

    loaded = cuda_build.loaded_names()
    fresh = any(name not in loaded for name in SOLVE_LIBRARIES)
    for name in SOLVE_LIBRARIES:
        cuda_build.load(name)
    return fresh


INCREMENTAL_MODES = ("on", "off")
PACK_SCANS = ("sequential", "segmented")


# the planes the [N, C] verdict tensor is computed from (the prescreen's
# inputs), by run() argument
_SCREEN_PLANES = {
    "pod_arrays": ("allow", "out", "defined", "escape", "custom_deny", "scls_first"),
    "exist": ("allow", "out", "defined"),
}


def _residency_key(geom, args, screen_mode: str, layout_key=None) -> tuple:
    """The key of a resident verdict tensor: what its shape and contents
    depend on besides the planes' values (which plan() fingerprints): N,
    the label segments, the screen width, the shape and dtype of every
    plane the prescreen reads, the screen mode, and the device grid's key
    (None: the single device)."""
    N, segments, screen_v = geom[7], geom[8], geom[16]
    named = dict(zip(RUN_ARG_NAMES, args))
    shapes = tuple((name, k, named[name][k].shape, str(named[name][k].dtype))
                   for name, keys in _SCREEN_PLANES.items() for k in keys)
    return (N, segments, screen_v, shapes, screen_mode, layout_key)


class _Carried:
    """What one solve carries to the next: the type planes of the encode
    (EncodeReuse), the previous solve's label dictionary, the resident
    prescreen tensors by residency key (an LRU), the change-feed gate, and
    that gate's verdict for the solve under way. One holder at a time:
    TorchSolver hands it out under its lock, and a solve or replan that
    finds it held (by a dispatch a watchdog abandoned, or by another
    thread) takes a fresh one, so no resident tensor is ever shared with a
    dispatch that may still write it."""

    __slots__ = ("encode_reuse", "dictionary", "inc_screens", "segment_labels", "diff_gate",
                 "gate_ok", "held")

    def __init__(self):
        self.encode_reuse = EncodeReuse()
        self.dictionary = None
        self.inc_screens: "OrderedDict[tuple, IncrementalScreen]" = OrderedDict()
        # the segmented scan's partition by residency key: (labels,
        # slot_label, the template fingerprint), an LRU
        self.segment_labels: "OrderedDict[tuple, tuple]" = OrderedDict()
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
    under "prescreen", as the reference resolves it. pack_scan:
    "sequential" or "segmented", None (the default) reading KCT_PACK_SCAN
    at each solve (ops/compat.resolve_pack_scan); "segmented" applies only
    under "prescreen" and degrades to the sequential scan wherever the
    reference's does, `last_segment_stats` saying why.

    Concurrent calls do not wait for each other: the state carried across
    solves (_Carried) has one holder, and a call that finds it held runs
    on a fresh one (a full precompute, counted as full_miss). So a solve
    that ResilientSolver abandoned as wedged, and that runs on in its
    thread, never holds up the next solve (nor does one in the reference's
    TPUSolver, which locks only its program cache)."""

    # resident tensors kept, least recently used first out
    MAX_INC_SCREENS = 8
    # resident segment partitions kept, likewise
    MAX_SEGMENT = 16
    # the consolidation search screens its candidate subsets through
    # replan_screen (solver/replan.py)
    supports_batched_replan = True

    def __init__(self, max_nodes: int = 1024,
                 max_relax_rounds: int = DEFAULT_MAX_RELAX_ROUNDS,
                 device="cuda", screen_mode: str = "prescreen",
                 incremental: str = "on", pack_scan: Optional[str] = None):
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
        if pack_scan not in (None,) + PACK_SCANS:
            raise ValueError(f"TorchSolver: pack_scan must be None or one of {PACK_SCANS}")
        self.max_nodes = max_nodes
        self.max_relax_rounds = max_relax_rounds
        self.screen_mode = screen_mode
        self.incremental = incremental
        self.pack_scan = pack_scan
        self.last_phase_ms: Dict[str, float] = {}
        # the last solve round's segmented attempt (None under sequential):
        # mode "segmented" with its segments, lanes, largest lane, frozen,
        # fixup_fraction 0.0, opens and segment_ms, or "sequential-fallback"
        # with the reason and fixup_fraction 1.0, as the reference's
        self.last_segment_stats: Optional[Dict[str, object]] = None
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
        # the device grid's layout the last solve ran on (None: the single
        # device; parallel/sharded.ShardedSolver routes)
        self.last_spec_layout = None
        # the state carried across solves, and the lock of its hand-over
        # (held only to take or return it, never across a dispatch); the
        # per-call results above and the warm keys below are written under
        # it too, since calls on several threads may run at once
        self._carried = _Carried()
        self._lock = threading.Lock()
        # the solve geometries (solve_geometry, screen mode, the grid's
        # key or None) a solve or a prewarm has met, in order (the
        # counterpart of the reference's compiled-program cache keys)
        self._warm_keys: Dict[tuple, None] = {}
        # the replan's (warm key, K pad) entries met, likewise
        self._replan_keys: Dict[tuple, None] = {}
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

    def _layout_for(self, snap):
        """The device grid's layout this snapshot solves on: None, the
        single device. parallel/sharded.ShardedSolver returns its grid's
        for batches that clear the routing floor."""
        return None

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

    def _dispatch_prescreen(self, key, geom, host_args, targs, carried, layout=None):
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
            geom[8], geom[16], geom[7], host_args, targs, inc=inc, key=key, gate_ok=gate_ok,
            spec_layout=layout)
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
        layout = self._layout_for(snap)
        layout_key = None if layout is None else layout.key
        self._publish(last_spec_layout=layout)
        warm_key = (geom, self.screen_mode, layout_key)
        N, segments, zone_seg, ct_seg, log_len, screen_v = (
            geom[7], geom[8], geom[9], geom[10], geom[12], geom[16]
        )
        args = device_args(snap, provisioners)
        mark("args")
        # "pack": the geometry's warm-state lookup (the reference's bundle
        # staging and compiled-program lookup); a span of its own at the
        # head of the upload phase, which keeps its time
        t_pack = time.perf_counter_ns()
        cold = self._warm(warm_key)
        record_lookup("tpu_solver", not cold)
        self._programs.mint("solve", warm_key, meta=self._program_meta(geom))
        TRACER.add_span("solver.phase.pack", t_pack, time.perf_counter_ns())
        targs = args_to_torch(args, self.device)
        mark("upload")
        self._publish(last_prescreen_mode=None, last_prescreen_delta=None,
                      last_prescreen_launches=None)
        screen0 = items_pl = None
        if self.screen_mode == "prescreen":
            key = _residency_key(geom, args, self.screen_mode, layout_key)
            before = screen_ops.launch_counts()
            screen0, mode, delta, items_pl = self._dispatch_prescreen(key, geom, args, targs,
                                                                      carried, layout)
            self._publish(
                last_prescreen_mode=mode,
                last_prescreen_launches={
                    k: v - before[k] for k, v in screen_ops.launch_counts().items()},
                last_prescreen_delta={
                    "rows": len(delta.rows), "cols": len(delta.cols),
                    "rb": delta.rb, "cb": delta.cb,
                } if mode == "refresh" else None)
            mark("prescreen", mode=mode, cold=cold)
            # the segmented scan (tpu_solver.py:2429-2456): a failure of its
            # attempt degrades to the sequential scan below, but a kernel
            # that did not build or launch is the card's fault, not the
            # attempt's, and is raised; so is a grid collective that failed
            # (the other ranks did not take this path: degrading here would
            # meet them at yet another collective)
            self._publish(last_segment_stats=None)
            if (self.pack_scan or ops_compat.resolve_pack_scan()) == "segmented":
                from karpenter_core_tpu_torch.parallel.specs import GridCollectiveError

                try:
                    chaos.maybe_fail(chaos.SOLVER_SEGMENT)
                    seg = self._try_segmented(snap, geom, key, warm_key, args, targs,
                                              screen0, items_pl, mode, delta, mark, carried,
                                              layout)
                except (KernelError, GridCollectiveError):
                    raise
                except Exception as exc:  # noqa: BLE001 — the reference's degrade
                    self._publish(last_segment_stats={
                        "mode": "sequential-fallback", "reason": f"error:{type(exc).__name__}",
                        "segments": 0, "max_segment": 0, "fixup_fraction": 1.0,
                    })
                    seg = None
                if seg is not None:
                    with TRACER.span("solver.phase.bind"):
                        result = decode_solve(snap, seg[:2], seg[2])
                    mark("decode")
                    return result
        run = make_device_run(segments, zone_seg, ct_seg, snap.topo_meta, N, log_len,
                              screen_v=screen_v, screen_mode=self.screen_mode,
                              spec_layout=layout)
        # re-label for the long silent stretch ahead: a wedge inside the
        # scan names the device phase, not the last host-side mark
        supervise.touch_heartbeat("solver.phase.device")
        log, ptr, state = dispatch_solve(run, screen0, targs, items_pl, sync=self._sync)
        mark("device", compile_cache="miss" if cold else "hit")
        first_ms = phases.get("prescreen", 0.0) + phases["device"]
        self._programs.dispatch("solve", warm_key, device_ms=first_ms)
        if cold:
            # a miss's first dispatch pays the geometry's warm-up
            record_compile_seconds(first_ms / 1e3)
        nopen = int(state.nopen)
        log = fetch_log(log)
        host_state = _HostState(state, nopen)
        mark("fetch")
        # "bind": the slot assignments decoded back into machines and
        # placements (expand_log's span nests inside)
        with TRACER.span("solver.phase.bind"):
            result = decode_solve(snap, (log, ptr), host_state)
        mark("decode")
        return result

    # -- the segmented pack scan ----------------------------------------------

    def _segment_eligible(self, snap: EncodedSnapshot, geom, host_args):
        """The reference's structural gate (tpu_solver.py:1453-1474):
        (ok, the reason when not)."""
        if not snap.seg_eligible:
            return False, "structure"  # topology, host ports, volumes
        remaining0 = host_args[RUN_ARG_NAMES.index("remaining0")]
        if not bool((remaining0 >= np.float32(1e29)).all()):
            return False, "finite-limits"
        if host_args[0]["scls_first"].shape[0] > 4096:
            return False, "class-axis"  # the [C, C] conflict matrix
        if len(geom[8]) > 128:
            return False, "key-axis"  # one deny-lift term per key
        return True, ""

    def _partition_fn(self, warm_key, geom):
        """The partitioner for a solve geometry (ops/pack.
        make_segment_partition_kernel) and whether its key was new in the
        program ledger's segment family."""
        cold = self._programs.mint("segment", (warm_key, "segmented", "partition"),
                                   meta=dict(self._program_meta(geom), role="partition"))
        return make_segment_partition_kernel(geom[8], geom[3], screen_v=geom[16]), cold

    def _try_segmented(self, snap, geom, key, warm_key, host_args, targs, screen0, items_pl,
                       scr_mode, delta, mark, carried, layout=None):
        """One segmented dispatch (_try_segmented, tpu_solver.py:1594-1906):
        the partition (resident across churn while the refresh's delta is
        empty and the template fingerprint matches), the lanes, the host
        merge. Returns (log, ptr, merged state) or None to degrade to the
        sequential scan; `last_segment_stats` says which, with the
        reference's dict."""
        E, N, L = geom[3], geom[7], geom[12]

        def fallback(reason, segments=0, max_segment=0):
            self._publish(last_segment_stats={
                "mode": "sequential-fallback", "reason": reason,
                "segments": int(segments), "max_segment": int(max_segment),
                "fixup_fraction": 1.0,
            })
            return None

        ok, reason = self._segment_eligible(snap, geom, host_args)
        if not ok:
            return fallback(reason)
        t_seg = time.perf_counter()
        tmpl_fp = _segment_tmpl_fingerprint(host_args)
        cached = carried.segment_labels.get(key)
        part_cold = False
        if (cached is not None and scr_mode == "refresh" and delta is not None
                and len(delta.rows) == 0 and len(delta.cols) == 0 and cached[2] == tmpl_fp):
            labels, slot_label = cached[:2]
            carried.segment_labels.move_to_end(key)
        else:
            part_fn, part_cold = self._partition_fn(warm_key, geom)
            labels_d, _neutral, slot_label_d = part_fn(
                screen0, targs[0], targs[RUN_ARG_NAMES.index("tmpl")],
                targs[RUN_ARG_NAMES.index("well_known")], items_pl=items_pl)
            self._programs.dispatch("segment", (warm_key, "segmented", "partition"))
            labels, slot_label = labels_d.cpu().numpy(), slot_label_d.cpu().numpy()
            carried.segment_labels[key] = (labels, slot_label, tmpl_fp)
            carried.segment_labels.move_to_end(key)
            while len(carried.segment_labels) > self.MAX_SEGMENT:
                carried.segment_labels.popitem(last=False)

        # an oversized or unparseable KCT_SEGMENT_LANES tunes down to the
        # top bucket, as the reference's does
        try:
            lanes_req = int(envflags.raw("KCT_SEGMENT_LANES", "8") or 8)
        except ValueError:
            lanes_req = 8
        plan = _lane_plan(labels, slot_label, host_args, E, geom[0], lanes_req)
        if plan is None:
            return fallback("empty")
        item_sel, exist_open, s_real, lanes_n, m_real = plan
        if item_sel is None:
            return fallback("single-segment", segments=s_real, max_segment=m_real)
        s_pad, m_pad = item_sel.shape
        mark("segment", segments=s_real, lanes=lanes_n, max_segment=m_real, cold=part_cold)

        # the reference's `frozen` stat (every class plane-neutral, when it
        # runs read-only lanes); the port's lanes always refresh
        neutral = snap.seg_plane_neutral
        frozen = bool(neutral is not None and neutral.size and neutral.all())
        lane_key = (warm_key, "segmented", s_pad, m_pad)
        lane_cold = self._programs.mint("segment", lane_key, meta=dict(
            self._program_meta(geom), lanes=s_pad, segment_bucket=m_pad))
        seg_run = make_device_run(geom[8], geom[9], geom[10], None, N, L, screen_v=geom[16],
                                  screen_mode="prescreen", segment_mode=True,
                                  spec_layout=layout)
        supervise.touch_heartbeat("solver.phase.device")
        t0 = time.perf_counter()
        with device_profiler():
            runs = seg_run(item_sel, exist_open, screen0, *targs, items_pl=items_pl,
                           placed=targs)
            self._sync()
        self._programs.dispatch("segment", lane_key,
                                device_ms=(time.perf_counter() - t0) * 1e3)
        mark("device", compile_cache="miss" if lane_cold else "hit", lanes=lanes_n)

        ptr_a = np.asarray([0 if r is None else int(r[1]) for r in runs])
        nopen_a = np.asarray([E if r is None else int(r[2].nopen) for r in runs])
        bulkn_a = np.asarray([0 if r is None else int(r[0]["bulk_n"]) for r in runs])
        opens = np.maximum(nopen_a - E, 0)
        lane_lb = lane_bulk_len(m_pad) if E else 1
        if int(opens.sum()) > N - E:
            # the slot budget is shared: the sequential scan would have run
            # out mid-way, and from there its result depends on the order
            return fallback("slot-budget", segments=s_real, max_segment=m_real)
        if bool((ptr_a >= L).any()) or bool((bulkn_a >= lane_lb).any()):
            return fallback("log-overflow", segments=s_real, max_segment=m_real)
        lanes = [None if r is None else (fetch_log(r[0]), int(r[1]),
                                         _HostState(r[2], int(r[2].nopen)))
                 for r in runs]
        mark("fetch")

        log, ptr, state = merge_lanes(lanes, E)
        mark("merge", entries=int(ptr))
        self._publish(last_segment_stats={
            "mode": "segmented",
            "segments": int(s_real),
            "lanes": int(lanes_n),
            "max_segment": int(m_real),
            "frozen": frozen,
            "fixup_fraction": 0.0,
            "opens": int(opens.sum()),
            "segment_ms": round((time.perf_counter() - t_seg) * 1e3, 1),
        })
        return log, ptr, state

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

        def mark(name, **attrs):
            nonlocal t
            self._sync()
            now = time.perf_counter_ns()
            phases[name] = (now - t) / 1e6
            TRACER.add_span(f"solver.phase.replan.{name}", t, now, **attrs)
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
        # the replan runs on the single device (the lead of a grid), as
        # the reference's dispatches the single-device program
        warm_key = (geom, self.screen_mode, None)
        misses = []

        def on_chunk(kp, ms):
            rkey = (warm_key, kp)
            with self._lock:
                hit = rkey in self._replan_keys
                self._replan_keys[rkey] = None
            record_lookup("replan", hit)
            if not hit:
                misses.append(rkey)
            self._programs.dispatch("replan", rkey, device_ms=ms,
                                    meta={"tier": f"K{kp}", "mode": self.screen_mode})

        verdict_parts, pods_parts, chunks, scans = dispatch_replan(
            replan, count_rows, exist_open, uninit_t, screen0, targs, items_pl, want_slots,
            on_chunk=on_chunk, sync=self._sync)
        mark("device", compile_cache="miss" if misses else "hit", subsets=int(count_rows.shape[0]))
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
        (tpu_solver.py:1104-1191): on the card, load the screen and pack
        scan libraries (nvcc builds one when its source is newer than the
        built one);
        then device_args and the upload of the snapshot, and the
        prescreen at its geometry (screen_prep and the screen forms that
        geometry takes), which also makes the caching allocator's first
        allocations there. The scan does not run. Returns "compiled" when
        this call loaded a library or first met the snapshot's solve
        geometry, "cached" otherwise (a live solve or an earlier prewarm
        got there first).

        It takes no carried state: it neither reads nor adopts a resident
        prescreen tensor, and leaves the per-solve state (`last_phase_ms`,
        `last_prescreen_*`, ops/pack.LAST_SCAN) as the last solve left it."""
        t0 = time.perf_counter()
        fresh = load_solve_libraries(self.device)
        geom = solve_geometry(snap, self.max_nodes)
        # a tier that a live solve would route to the device grid prewarms
        # under the grid's key, and its tiles (tpu_solver.py:1133-1161)
        layout = self._layout_for(snap)
        key = (geom, self.screen_mode, None if layout is None else layout.key)
        cold = self._warm(key)
        record_lookup("prewarm", not cold)
        fresh = cold or fresh
        args = device_args(snap, provisioners)
        # the prescreen at this geometry, with no resident tensor
        dispatch_prescreen(geom[8], geom[16], geom[7], None,
                           args_to_torch(args, self.device), spec_layout=layout)
        self._sync()
        seconds = time.perf_counter() - t0
        self._programs.mint("solve", key, origin="prewarm", meta=self._program_meta(geom),
                            seconds=seconds)
        if fresh:
            record_compile_seconds(seconds)
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
