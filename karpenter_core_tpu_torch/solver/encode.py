"""Snapshot -> dense numpy arrays for the solver (host side).

The reference evaluates the constraint algebra object by object inside the
serial Solve loop (scheduler.go:96-133, machine.go:137-159). Here the whole
snapshot is lowered once into dense arrays over a closed label dictionary.
Every Requirement becomes

  allow[V]    for each dictionary value of its key, requirement.has(value)
  out[K]      complement flag: values outside the dictionary are allowed
  defined[K]  the key is constrained at all
  escape[K]   operator in {NotIn, DoesNotExist} (the Intersects escape)

and, because concrete In-sets are dictionary-closed, the nonemptiness of a
per-key intersection is exactly (outA & outB) | any_v(allowA & allowB).

Topology spread and pod (anti-)affinity lower to the domain-count tensors
of ops/topology.py, seeded from the cluster when a kube client or cluster
is given. Host ports lower to per-entry columns with a conflict matrix,
PVC-backed volumes to per-claim columns with a claim -> CSI driver map and
the existing nodes' per-driver attach limits.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.api.provisioner import order_by_weight
from karpenter_core_tpu_torch.kube.objects import (
    LABEL_HOSTNAME,
    LABEL_TOPOLOGY_ZONE,
    ResourceList,
)
from karpenter_core_tpu_torch.ops.topology import (
    TOPO_ANTI,
    TOPO_SPREAD,
    encode_topology,
)
from karpenter_core_tpu_torch.scheduling import taints as taints_mod
from karpenter_core_tpu_torch.scheduling.machinetemplate import MachineTemplate
from karpenter_core_tpu_torch.scheduling.requirement import (
    OP_DOES_NOT_EXIST,
    OP_IN,
    OP_NOT_IN,
    Requirement,
)
from karpenter_core_tpu_torch.scheduling.hostportusage import host_ports
from karpenter_core_tpu_torch.scheduling.requirements import Requirements
from karpenter_core_tpu_torch.scheduling.volumeusage import VolumeUsage
from karpenter_core_tpu_torch.state.node import resolve_volume_limits
from karpenter_core_tpu_torch.utils import resources as resources_util

# resource axis order: fixed core resources then discovered extended ones
CORE_RESOURCES = ["cpu", "memory", "pods", "ephemeral-storage"]


def bucket_pow2(n: int, lo: int) -> int:
    """Round n up to a power-of-two bucket (min lo); 0 stays 0."""
    if n <= 0:
        return 0
    b = lo
    while b < n:
        b *= 2
    return b


# -- the geometry bucket ladder ----------------------------------------------
# The solve-shaping batch axes (items, instance types, existing nodes) pad
# to the values of the tier table (api/settings.py), so the geometries a
# process can meet are known before the first pod arrives and the startup
# prewarm (solver/prewarm.py) can warm each. Past the top rung an axis
# continues power-of-two: a geometry no prewarm covered, counted by axis.

BUCKET_OVERFLOW = None  # bound at the first overflow


def _count_overflow(axis: str) -> None:
    global BUCKET_OVERFLOW
    if BUCKET_OVERFLOW is None:
        from karpenter_core_tpu_torch.metrics.registry import NAMESPACE, REGISTRY

        BUCKET_OVERFLOW = REGISTRY.counter(
            f"{NAMESPACE}_bucket_overflow_total",
            "Geometry axes padded past the configured bucket ladder's top "
            "rung (power-of-two fallback: a compile the prewarm never "
            "covered), by axis",
        )
    BUCKET_OVERFLOW.inc({"axis": axis})


def resolve_ladder(ladder=None):
    """The tier table in effect: an explicit one, else the process-wide
    Settings'. Empty turns the snapping off (power-of-two padding)."""
    if ladder is not None:
        return tuple(ladder)
    from karpenter_core_tpu_torch.api import settings as api_settings

    return tuple(api_settings.current().bucket_ladder or ())


def ladder_pad(n: int, ladder, axis: str, lo: int) -> int:
    """Round n up to the smallest tier value on `axis`; 0 stays 0. Past the
    top rung, continue power-of-two from it, and count the overflow. With
    no ladder, bucket_pow2."""
    if n <= 0:
        return 0
    values = sorted(getattr(t, axis) for t in ladder) if ladder else ()
    if not values:
        return bucket_pow2(n, lo)
    for v in values:
        if n <= v:
            return v
    _count_overflow(axis)
    b = values[-1]
    while b < n:
        b *= 2
    return b


# -- the candidate-subset axis of the batched consolidation replan --------
# The replan screens K candidate subsets per dispatch; K rides its own
# small ladder (the multi-node prefix ladder of <= 8 rungs fits the bottom
# bucket; single-node sweeps chunk at the top one).

REPLAN_K_BUCKETS = (8, 16, 32, 64)


def replan_k_pad(k: int) -> int:
    """Round a subset count up to REPLAN_K_BUCKETS; a count above the top
    bucket is a caller error (replan_chunks chunks at it)."""
    if k <= 0:
        return REPLAN_K_BUCKETS[0]
    for v in REPLAN_K_BUCKETS:
        if k <= v:
            return v
    raise ValueError(
        f"subset axis {k} exceeds the replan chunk cap "
        f"{REPLAN_K_BUCKETS[-1]} (callers must chunk)"
    )


# -- the segmented pack scan's axes ------------------------------------------
# The segmented dispatch packs S conflict-independent lanes of at most M
# items each (TorchSolver._try_segmented); both axes ride the reference's
# ladders: the lane axis a short bucket list (the lane count is capped
# below its top), the per-lane item axis a power-of-two bucket capped at
# the snapshot's item tier.

SEGMENT_LANE_BUCKETS = (4, 8, 16)


def segment_lane_pad(s: int) -> int:
    """Round a lane count up to SEGMENT_LANE_BUCKETS; a count above the
    top bucket is a caller error (the dispatcher balances into fewer
    lanes)."""
    for v in SEGMENT_LANE_BUCKETS:
        if s <= v:
            return v
    raise ValueError(
        f"lane axis {s} exceeds the segment lane cap "
        f"{SEGMENT_LANE_BUCKETS[-1]} (the dispatcher load-balances into "
        f"fewer lanes)"
    )


def segment_item_pad(m: int, item_pad: int) -> int:
    """Round a lane's item count up to its power-of-two bucket, capped at
    the snapshot's item tier (a lane never holds more than every item)."""
    return min(bucket_pow2(max(m, 1), 32), max(item_pad, 32))


def replan_chunks(count_rows, exist_open):
    """Yield (k_real, k_pad, counts, open) dispatch chunks along the
    candidate axis: slices of at most REPLAN_K_BUCKETS[-1] subsets, padded
    up to the ladder with no-op subsets (zero active pods, nothing
    closed), whose verdict rows the caller drops."""
    K = int(count_rows.shape[0])
    CH = REPLAN_K_BUCKETS[-1]
    for lo in range(0, K, CH):
        counts = np.ascontiguousarray(count_rows[lo: lo + CH])
        opened = np.ascontiguousarray(exist_open[lo: lo + CH])
        k = counts.shape[0]
        kp = replan_k_pad(k)
        if kp > k:
            counts = np.concatenate(
                [counts, np.zeros((kp - k,) + counts.shape[1:], counts.dtype)]
            )
            opened = np.concatenate(
                [opened, np.ones((kp - k,) + opened.shape[1:], opened.dtype)]
            )
        yield k, kp, counts, opened


def _ids(lst):
    return tuple(map(id, lst))


def _aff_duo(x):
    # identity of the leaf term objects, which producers share across a
    # deployment's pods even when each pod gets fresh wrapper objects
    return None if x is None else (_ids(x.required), _ids(x.preferred))


def _memo_repr(memo: Dict, key: Tuple, obj) -> str:
    r = memo.get(key)
    if r is None:
        r = memo[key] = repr(obj)
    return r


def _pod_spec_signature(p, memo: Dict) -> Tuple:
    """Content key for pod spec-equivalence: everything the encoder derives
    per pod (namespace, labels for topology selection, node selector,
    host ports, volume claims, node and pod affinity, tolerations, spread
    constraints, resources). Pods with equal signatures are
    interchangeable; pods that differ only in host ports or claims are
    not. Constraint objects key by content (repr), memoized by the
    identity of their leaf objects."""
    s = p.spec
    aff = s.affinity
    aff_r = None if aff is None else _memo_repr(
        memo, ("aff", _aff_duo(aff.node_affinity), _aff_duo(aff.pod_affinity),
               _aff_duo(aff.pod_anti_affinity)), aff)
    tol = s.tolerations
    tol_r = _memo_repr(memo, ("tol",) + _ids(tol), tol) if tol else None
    tsc = s.topology_spread_constraints
    tsc_r = _memo_repr(memo, ("tsc",) + _ids(tsc), tsc) if tsc else None
    res = tuple(
        (tuple(c.resources.requests.items()), tuple(c.resources.limits.items()))
        for c in s.containers
    )
    ports = tuple(
        (pt.host_ip, pt.host_port, pt.protocol)
        for c in s.containers for pt in c.ports if pt.host_port
    )
    vol_r = tuple(
        v.persistent_volume_claim.claim_name
        for v in s.volumes if v.persistent_volume_claim is not None
    ) if s.volumes else None
    ic = s.init_containers
    ic_r = (
        tuple(
            (tuple(c.resources.requests.items()), tuple(c.resources.limits.items()))
            for c in ic
        )
        if ic
        else None
    )
    return (
        p.metadata.namespace,
        tuple(p.metadata.labels.items()),
        tuple(s.node_selector.items()),
        ports,
        vol_r,
        aff_r,
        tol_r,
        tsc_r,
        res,
        ic_r,
    )


class LabelDictionary:
    """Closed (key, value) universe: every value any requirement or node
    label mentions. Flat value axis V with per-key contiguous segments."""

    def __init__(self):
        self.keys: List[str] = []
        self.key_index: Dict[str, int] = {}
        self._values: List[Dict[str, int]] = []  # per key: value -> local idx

    def add_key(self, key: str) -> int:
        if key not in self.key_index:
            self.key_index[key] = len(self.keys)
            self.keys.append(key)
            self._values.append({})
        return self.key_index[key]

    def add_value(self, key: str, value: str) -> None:
        vals = self._values[self.add_key(key)]
        if value not in vals:
            vals[value] = len(vals)

    def freeze(self) -> None:
        """Assign flat offsets."""
        self.offsets = np.zeros(len(self.keys) + 1, dtype=np.int32)
        for k in range(len(self.keys)):
            self.offsets[k + 1] = self.offsets[k] + len(self._values[k])
        self.V = int(self.offsets[-1])
        self.K = len(self.keys)

    def flat_index(self, key: str, value: str) -> Optional[int]:
        k = self.key_index.get(key)
        if k is None:
            return None
        local = self._values[k].get(value)
        if local is None:
            return None
        return int(self.offsets[k]) + local

    def values_of(self, key: str) -> List[str]:
        k = self.key_index.get(key)
        if k is None:
            return []
        return [v for v, _ in sorted(self._values[k].items(), key=lambda kv: kv[1])]

    def canonicalize(self, last_key: Optional[str] = None) -> None:
        """Sort keys and values, with `last_key`'s segment forced last, and
        freeze: the dictionary becomes a pure function of its content (value
        order breaks domain ties), and the hostname segment sits last so
        the screens can slice it off."""
        order = sorted(self.keys)
        if last_key is not None and last_key in order:
            order.remove(last_key)
            order.append(last_key)
        self._values = [
            {v: i for i, v in enumerate(sorted(self._values[self.key_index[key]]))}
            for key in order
        ]
        self.keys = order
        self.key_index = {name: i for i, name in enumerate(order)}
        self.freeze()

    def segment(self, key: str) -> Tuple[int, int]:
        k = self.key_index[key]
        return int(self.offsets[k]), int(self.offsets[k + 1])


def dictionary_covers(carrier: LabelDictionary, fresh: LabelDictionary) -> bool:
    """True when `carrier` (an earlier batch's dictionary) can encode all
    that `fresh` (this batch's closure) mentions: every key and value
    mapped, the hostname segment still last (the screens' tail elision),
    and the carrier no larger than twice the live vocabulary (stale
    hostnames of departed nodes would otherwise grow V for ever)."""
    if carrier.V > max(2 * fresh.V, fresh.V + 32):
        return False
    if LABEL_HOSTNAME in carrier.key_index:
        _lo, hi = carrier.segment(LABEL_HOSTNAME)
        if hi != carrier.V:
            return False
    for key in fresh.keys:
        k = carrier.key_index.get(key)
        if k is None:
            return False
        have = carrier._values[k]
        for value in fresh._values[fresh.key_index[key]]:
            if value not in have:
                return False
    return True


def dictionary_rebind_hostnames(carrier: LabelDictionary,
                                fresh: LabelDictionary) -> bool:
    """For a growing cluster: when the only values `carrier` lacks are
    hostnames (a node joined or was replaced), rename hostname entries
    that `fresh` no longer mentions (pad sentinels, departed nodes) to
    them. A value index is a column, so the planes' content changes and
    V, K and the segments stay. Mutates `carrier` on success; False leaves
    it as it was."""
    k_host = carrier.key_index.get(LABEL_HOSTNAME)
    if k_host is None:
        return False
    _lo, hi = carrier.segment(LABEL_HOSTNAME)
    if hi != carrier.V:
        return False
    missing = []
    for key in fresh.keys:
        k = carrier.key_index.get(key)
        if k is None:
            return False
        have = carrier._values[k]
        for value in fresh._values[fresh.key_index[key]]:
            if value not in have:
                if key != LABEL_HOSTNAME:
                    return False
                missing.append(value)
    if not missing:
        return True
    host_vals = carrier._values[k_host]
    fresh_hosts = fresh._values[fresh.key_index[LABEL_HOSTNAME]]
    rebindable = [v for v in host_vals if v not in fresh_hosts]
    if len(missing) > len(rebindable):
        return False
    for value, stale in zip(missing, rebindable):
        host_vals[value] = host_vals.pop(stale)
    return True


@dataclass
class ReqSetArrays:
    """Dense form of a batch of Requirements (one row each)."""

    allow: np.ndarray  # [N, V] bool
    out: np.ndarray  # [N, K] bool
    defined: np.ndarray  # [N, K] bool
    escape: np.ndarray  # [N, K] bool


def _collect_requirement_values(reqs: Requirements, dictionary: LabelDictionary) -> None:
    for key, r in reqs.items():
        dictionary.add_key(key)
        for v in r.values:
            dictionary.add_value(key, v)


def encode_reqsets(req_list: Sequence[Requirements],
                   dictionary: LabelDictionary) -> ReqSetArrays:
    n = len(req_list)
    # undefined keys read as Exists: allow everything, outside included
    allow = np.ones((n, dictionary.V), dtype=bool)
    out = np.ones((n, dictionary.K), dtype=bool)
    defined = np.zeros((n, dictionary.K), dtype=bool)
    escape = np.zeros((n, dictionary.K), dtype=bool)
    for i, reqs in enumerate(req_list):
        for key, r in reqs.items():
            k = dictionary.key_index.get(key)
            if k is None:
                continue
            lo, hi = dictionary.segment(key)
            if r.greater_than is None and r.less_than is None:
                local = dictionary._values[k]
                if not r.complement:
                    allow[i, lo:hi] = False
                    for v in r.values:
                        li = local.get(v)
                        if li is not None:
                            allow[i, lo + li] = True
                else:
                    for v in r.values:
                        li = local.get(v)
                        if li is not None:
                            allow[i, lo + li] = False
            else:
                allow[i, lo:hi] = [r.has(v) for v in dictionary.values_of(key)]
            out[i, k] = r.complement
            defined[i, k] = True
            escape[i, k] = r.operator() in (OP_NOT_IN, OP_DOES_NOT_EXIST)
    return ReqSetArrays(allow=allow, out=out, defined=defined, escape=escape)


@dataclass
class EncodedSnapshot:
    """Everything the device program needs, as numpy arrays. Axes: U pod
    spec classes, T instance types, J templates, K keys, V flat values,
    R resources, E existing nodes (padded), Z zones, C capacity types."""

    dictionary: LabelDictionary
    resource_names: List[str]

    pod_reqs_u: ReqSetArrays  # [U, ...]
    pod_requests_u: np.ndarray  # [U, R] float32 (incl. pods=1)
    pod_tol_u: np.ndarray  # [U, J] bool: tolerates template j's taints
    uidx: np.ndarray  # [P] int32 class of sorted pod i

    tmpl_reqs: ReqSetArrays  # [J, ...]
    tmpl_daemon: np.ndarray  # [J, R] float32 daemon overhead
    tmpl_type_mask: np.ndarray  # [J, T] bool

    type_reqs: ReqSetArrays  # [T, ...]
    type_alloc: np.ndarray  # [T, R] float32 (-1 on pad rows)
    type_capacity: np.ndarray  # [T, R] float32
    type_offering_ok: np.ndarray  # [T, Z, C] bool

    well_known: np.ndarray  # [K] bool
    zone_seg: Tuple[int, int]
    ct_seg: Tuple[int, int]

    exist_reqs: ReqSetArrays = None  # [E, ...]
    exist_used: np.ndarray = None  # [E, R] remaining daemon overhead
    exist_cap: np.ndarray = None  # [E, R] available() (-1 on pad rows)
    tol_exist_us: np.ndarray = None  # [U, S+1] bool; column S: pad rows
    sig_of_node: np.ndarray = None  # [E] int64 -> taint signature

    # host ports (Q entry columns) and CSI volumes (W claim columns, D
    # drivers); zero-width when the batch and the nodes use none
    pod_ports_u: np.ndarray = None  # [U, Q] bool
    pod_port_conflict_u: np.ndarray = None  # [U, Q] bool: entries it conflicts with
    exist_ports: np.ndarray = None  # [E, Q] bool
    pod_vols_u: np.ndarray = None  # [U, W] bool
    exist_vols: np.ndarray = None  # [E, W] bool
    exist_vol_limits: np.ndarray = None  # [E, D] float32 (inf: no limit)
    vol_driver_onehot: np.ndarray = None  # [W, D] float32

    n_slots: int = 0  # E + machine slot budget
    screen_v: int = 0  # screens read allow[:, :screen_v]

    item_counts: np.ndarray = None  # [I] int32
    item_rep: np.ndarray = None  # [I] int32 representative pod row
    item_members: List[List[int]] = None  # pod rows per item, in order
    item_scls: np.ndarray = None  # [I] int32 verdict column of item i
    scls_items: np.ndarray = None  # [C] int32 one item index per column
    item_pad: int = 0
    cls_pad: int = 0

    # the segmented scan's gates: structural eligibility (no topology
    # groups, host-port or volume planes: the couplings a conflict
    # partition cannot express) and per class, plane neutrality (no
    # defined key inside the screen width), which selects the lanes'
    # read-only verdict variant when every class has it
    seg_eligible: bool = False
    seg_plane_neutral: np.ndarray = None  # [U] bool

    instance_types: List = field(default_factory=list)
    templates: List[MachineTemplate] = field(default_factory=list)
    pods: List = field(default_factory=list)
    state_nodes: List = field(default_factory=list)

    # topology groups (None when the batch has none)
    topo_meta: object = None  # ops.topology.TopoMeta
    topo_arrays: object = None  # ops.topology.TopoArrays
    item_of_pod: np.ndarray = None  # [P] int32 item of sorted pod i


class EncodeReuse:
    """The instance-type planes carried across solves. A cluster's type
    universe is the same objects solve after solve, and their planes
    depend only on (the type objects, the dictionary's content, the
    resource names, the offerings' state, the types' resources), which
    the key holds whole, so any change there misses and re-encodes. It
    keeps the keyed type objects alive (the key holds their ids) and is
    thread-safe. A solver owns one and passes it to
    encode_snapshot(reuse=...)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._key = None
        self._planes = None
        self._keyed_types = None

    def get(self, key):
        with self._lock:
            return self._planes if self._key == key else None

    def put(self, key, planes, all_types) -> None:
        with self._lock:
            self._key = key
            self._planes = planes
            self._keyed_types = list(all_types)

    @staticmethod
    def dict_signature(dictionary: LabelDictionary) -> Tuple:
        return tuple((k, tuple(dictionary.values_of(k))) for k in dictionary.keys)

    @staticmethod
    def offering_signature(all_types) -> Tuple:
        # availability and price change in place between solves
        return tuple(
            tuple((o.zone, o.capacity_type, o.available, o.price) for o in it.offerings)
            for it in all_types
        )

    @staticmethod
    def resource_signature(all_types) -> Tuple:
        # capacity and overhead are mutable attributes of the same type
        # objects; requirements are keyed by identity
        return tuple(
            (tuple(sorted(it.capacity.items())),
             tuple(sorted(it.allocatable().items())),
             id(it.requirements))
            for it in all_types
        )


def encode_snapshot(
    pods: List,
    provisioners: List,
    instance_types: Dict[str, List],
    daemonset_pods: Optional[List] = None,
    state_nodes: Optional[List] = None,
    kube_client=None,
    cluster=None,
    max_nodes: int = 1024,
    reuse_dictionary: Optional[LabelDictionary] = None,
    ladder=None,
    reuse: Optional[EncodeReuse] = None,
    carry_dictionary: Optional[LabelDictionary] = None,
) -> EncodedSnapshot:
    """Lower a provisioning snapshot to arrays.

    kube_client (any object with get(kind, namespace, name) and
    list(kind, namespace=, selector=)) resolves claims to CSI drivers,
    fills the existing nodes' empty attach limits from CSINode objects and
    seeds the topology counts with the scheduled cluster pods; cluster
    (state/cluster.Cluster) contributes the inverse anti-affinity of its
    bound pods.

    Pods are sorted first-fit-decreasing (cpu desc, mem desc, creation,
    uid: queue.go:74-110) so the pack scan consumes them in reference order.
    `reuse_dictionary`, from an earlier encode of the same batch, keeps
    V/K/segments fixed across relaxation rounds (relaxation only removes
    requirements). `reuse` (an EncodeReuse) carries the instance-type
    planes across solves. `carry_dictionary`, the previous solve's
    dictionary, is offered, not trusted: the fresh closure is built first
    and the carrier replaces it only when it covers it
    (dictionary_covers) or covers it once new hostnames are rebound onto
    unused ones (dictionary_rebind_hostnames), so consecutive batches of a
    churning cluster keep one geometry. `ladder` overrides the tier table
    of the process-wide Settings (resolve_ladder)."""
    daemonset_pods = daemonset_pods or []
    # only nodes launched by us participate (scheduler.go:226-229)
    state_nodes = [n for n in (state_nodes or []) if n.owned()]
    # CSI attach limits ride the state nodes; nodes that bypassed a
    # Cluster resolve theirs here
    resolve_volume_limits(state_nodes, kube_client)
    provisioners = [
        p for p in order_by_weight(provisioners)
        if p.metadata.deletion_timestamp is None
    ]
    templates = [MachineTemplate(p) for p in provisioners]
    ladder = resolve_ladder(ladder)

    # global dedup of instance types by object identity
    all_types: List = []
    type_ids: Dict[int, int] = {}
    tmpl_type_mask_rows = []
    for p in provisioners:
        row = set()
        for it in instance_types.get(p.name, []):
            tid = type_ids.get(id(it))
            if tid is None:
                tid = len(all_types)
                type_ids[id(it)] = tid
                all_types.append(it)
            row.add(tid)
        tmpl_type_mask_rows.append(row)
    # the type axis pads to its ladder tier with closed rows: allocatable
    # -1 (fits() rejects negatives), no offerings, offered by no template
    T_real = len(all_types)
    T_pad = ladder_pad(T_real, ladder, "instance_types", 1) if ladder else T_real

    # pod spec-equivalence classes: everything derived from a pod is a pure
    # function of its signature, computed once per class and gathered
    P0 = len(pods)
    sig_of: Dict[Tuple, int] = {}
    uidx0 = np.empty(P0, dtype=np.int32)
    uniq_pods: List = []
    memo: Dict = {}
    for i, p in enumerate(pods):
        sig = _pod_spec_signature(p, memo)
        u = sig_of.get(sig)
        if u is None:
            u = len(uniq_pods)
            sig_of[sig] = u
            uniq_pods.append(p)
        uidx0[i] = u
    U = len(uniq_pods)

    req_u = [resources_util.requests_for_pods(p) for p in uniq_pods]

    # FFD sort (cpu desc, mem desc, creation, uid) as one lexsort
    cpu_u = np.array([rl.get("cpu", 0.0) for rl in req_u], dtype=np.float64)
    mem_u = np.array([rl.get("memory", 0.0) for rl in req_u], dtype=np.float64)
    ts = np.array([p.metadata.creation_timestamp or 0.0 for p in pods],
                  dtype=np.float64)
    uids = np.array([p.metadata.uid for p in pods])
    order = (
        np.lexsort((uids, ts, -mem_u[uidx0], -cpu_u[uidx0])).astype(np.int32)
        if P0
        else np.zeros(0, np.int32)
    )
    pods_sorted = [pods[i] for i in order]
    uidx = uidx0[order]

    def ffd_key_of_class(u):
        return (-cpu_u[u], -mem_u[u])

    pod_reqs_u = [Requirements.from_pod(p) for p in uniq_pods]
    tmpl_reqs_list = [t.requirements for t in templates]
    type_reqs_list = [it.requirements for it in all_types]
    exist_reqs_list = []
    for node in state_nodes:
        reqs = Requirements.from_labels(node.labels())
        reqs.add(Requirement(LABEL_HOSTNAME, OP_IN, [node.hostname()]))
        exist_reqs_list.append(reqs)

    # the batch's topology groups, seeded with the cluster's pods (the host
    # Topology is a controllers module: solver reaches it at call time only)
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (
        Topology,
        build_domains,
    )

    host_topology = Topology(kube_client, cluster,
                             build_domains(provisioners, instance_types),
                             pods_sorted, update_pods=uniq_pods)
    topo_groups = list(host_topology.topologies.values()) + list(
        host_topology.inverse_topologies.values()
    )

    # dictionary closure; the existing-node axis pads to its tier and
    # hostname values pad in step, so the segment tracks the bucket
    E_real = len(state_nodes)
    E_pad = ladder_pad(E_real, ladder, "existing_nodes", 8)
    if reuse_dictionary is not None:
        dictionary = reuse_dictionary
    else:
        dictionary = LabelDictionary()
        for reqs in pod_reqs_u + tmpl_reqs_list + type_reqs_list + exist_reqs_list:
            _collect_requirement_values(reqs, dictionary)
        for tg in topo_groups:
            # hostname domains live on slot identity: the key alone
            dictionary.add_key(tg.key)
            if tg.key != LABEL_HOSTNAME:
                for d in tg.domains:
                    dictionary.add_value(tg.key, d)
            for term in tg.node_filter.terms:
                _collect_requirement_values(term, dictionary)
        dictionary.add_key(LABEL_TOPOLOGY_ZONE)
        dictionary.add_key(api_labels.LABEL_CAPACITY_TYPE)
        for it in all_types:
            for o in it.offerings:
                dictionary.add_value(LABEL_TOPOLOGY_ZONE, o.zone)
                dictionary.add_value(api_labels.LABEL_CAPACITY_TYPE, o.capacity_type)
        if E_real:
            for i in range(E_real, E_pad):
                dictionary.add_value(LABEL_HOSTNAME, f"__exist-pad-{i}")
        dictionary.canonicalize(last_key=LABEL_HOSTNAME)
        if carry_dictionary is not None and (
            dictionary_covers(carry_dictionary, dictionary)
            or (
                # the same size bound, then new node hostnames rebound onto
                # unused pad or stale entries (a cluster growing inside one
                # existing-axis bucket)
                carry_dictionary.V <= max(2 * dictionary.V, dictionary.V + 32)
                and dictionary_rebind_hostnames(carry_dictionary, dictionary)
            )
        ):
            dictionary = carry_dictionary

    extended = sorted(
        set().union(
            *[set(rl) for rl in req_u] or [set()],
            *[set(it.allocatable()) for it in all_types] or [set()],
        )
        - set(CORE_RESOURCES)
    )
    resource_names = CORE_RESOURCES + extended
    R = len(resource_names)
    r_index = {r: i for i, r in enumerate(resource_names)}

    def encode_resources(rl: ResourceList) -> np.ndarray:
        out = np.zeros(R, dtype=np.float32)
        for name, q in rl.items():
            if name in r_index:
                out[r_index[name]] = q
        return out

    P, J, T = len(pods_sorted), len(templates), T_pad
    pod_requests_u = (
        np.stack([encode_resources(rl) for rl in req_u])
        if U
        else np.zeros((0, R), np.float32)
    )

    # daemon overhead per template (scheduler.go:253-270)
    tmpl_daemon = np.zeros((J, R), dtype=np.float32)
    for j, template in enumerate(templates):
        daemons = [
            p for p in daemonset_pods
            if taints_mod.tolerates(template.taints, p) is None
            and template.requirements.compatible(Requirements.from_pod(p)) is None
        ]
        tmpl_daemon[j] = encode_resources(
            resources_util.requests_for_pods(*daemons) if daemons else {"pods": 0.0}
        )

    tmpl_type_mask = np.zeros((J, T), dtype=bool)
    for j, row in enumerate(tmpl_type_mask_rows):
        for tid in row:
            tmpl_type_mask[j, tid] = True

    zlo, zhi = dictionary.segment(LABEL_TOPOLOGY_ZONE)
    clo, chi = dictionary.segment(api_labels.LABEL_CAPACITY_TYPE)

    # the instance-type planes, a pure function of the type key, carried
    # across solves by `reuse`
    type_key = (
        _ids(all_types),
        T_pad,
        EncodeReuse.dict_signature(dictionary),
        tuple(resource_names),
        EncodeReuse.offering_signature(all_types),
        EncodeReuse.resource_signature(all_types),
    )
    cached = reuse.get(type_key) if reuse is not None else None
    if cached is not None:
        type_reqs_arr, type_alloc, type_capacity, type_offering_ok = cached
    else:
        type_alloc = np.full((T, R), -1.0, dtype=np.float32)
        type_capacity = np.zeros((T, R), dtype=np.float32)
        if T_real:
            type_alloc[:T_real] = np.stack(
                [encode_resources(it.allocatable()) for it in all_types]
            )
            type_capacity[:T_real] = np.stack(
                [encode_resources(it.capacity) for it in all_types]
            )
        z_index = {z: i for i, z in enumerate(dictionary.values_of(LABEL_TOPOLOGY_ZONE))}
        c_index = {
            c: i for i, c in enumerate(dictionary.values_of(api_labels.LABEL_CAPACITY_TYPE))
        }
        type_offering_ok = np.zeros((T, zhi - zlo, chi - clo), dtype=bool)
        for t, it in enumerate(all_types):
            for o in it.offerings:
                if not o.available:
                    continue
                zi, ci = z_index.get(o.zone), c_index.get(o.capacity_type)
                if zi is not None and ci is not None:
                    type_offering_ok[t, zi, ci] = True
        type_reqs_arr = encode_reqsets(
            type_reqs_list + [Requirements() for _ in range(T_pad - T_real)],
            dictionary,
        )
        if reuse is not None:
            reuse.put(type_key,
                      (type_reqs_arr, type_alloc, type_capacity, type_offering_ok),
                      all_types)

    pod_tol_u = np.zeros((U, J), dtype=bool)
    for j, template in enumerate(templates):
        for u, p in enumerate(uniq_pods):
            pod_tol_u[u, j] = taints_mod.tolerates(template.taints, p) is None

    well_known = np.array(
        [k in api_labels.WELL_KNOWN_LABELS or k == LABEL_HOSTNAME
         for k in dictionary.keys],
        dtype=bool,
    )

    # existing nodes; rows [E_real, E_pad) are closed sentinels: cap -1
    # never fits and their toleration column is all False
    exist_used = np.zeros((E_pad, R), dtype=np.float32)
    exist_cap = np.full((E_pad, R), -1.0, dtype=np.float32)
    exist_cap[:E_real] = 0.0
    exist_reqs_list = exist_reqs_list + [Requirements() for _ in range(E_pad - E_real)]
    taint_sig_ids: Dict[Tuple, int] = {}
    tol_rows_u: List[np.ndarray] = []
    sig_of_node = np.empty(E_pad, dtype=np.int64)
    for e, node in enumerate(state_nodes):
        node_taints = node.taints()
        # daemons that would schedule to this node (scheduler.go:231-240)
        daemons = [
            p for p in daemonset_pods
            if taints_mod.tolerates(node_taints, p) is None
            and Requirements.from_labels(node.labels()).compatible(
                Requirements.from_pod(p)
            ) is None
        ]
        daemon_req = (
            resources_util.requests_for_pods(*daemons) if daemons else {"pods": 0.0}
        )
        remaining = resources_util.subtract(daemon_req, node.total_daemonset_requests())
        exist_used[e] = encode_resources({k: max(v, 0.0) for k, v in remaining.items()})
        exist_cap[e] = encode_resources(node.available())
        sig = tuple(sorted((t.key, t.value, t.effect) for t in node_taints))
        s = taint_sig_ids.get(sig)
        if s is None:
            s = taint_sig_ids[sig] = len(tol_rows_u)
            tol_rows_u.append(np.fromiter(
                (taints_mod.tolerates(node_taints, p) is None for p in uniq_pods),
                dtype=bool, count=U,
            ))
        sig_of_node[e] = s
    S = len(tol_rows_u)
    sig_of_node[E_real:] = S
    tol_exist_us = np.zeros((U, S + 1), dtype=bool)
    if S:
        tol_exist_us[:, :S] = np.stack(tol_rows_u, axis=1)

    ports_vols = _port_volume_arrays(uniq_pods, state_nodes, E_pad, kube_client)
    n_slots = E_pad + min(max_nodes, bucket_pow2(max(P, 1), 64))
    topo_meta, topo_arrays = encode_topology(
        host_topology, pods_sorted, dictionary, n_slots,
        [n.hostname() for n in state_nodes], uidx=uidx, uniq_pods=uniq_pods,
    )
    pod_reqs_u_arr = encode_reqsets(pod_reqs_u, dictionary)

    # screens may run on a prefix of the value axis: when no pod or type
    # constrains hostname, every hostname term resolves through ~shared,
    # and its segment sits last by construction
    if reuse_dictionary is not None:
        screen_v = getattr(dictionary, "screen_v", dictionary.V)
    else:
        screen_v = dictionary.V
        if LABEL_HOSTNAME in dictionary.key_index:
            hlo, hhi = dictionary.segment(LABEL_HOSTNAME)
            k_h = dictionary.key_index[LABEL_HOSTNAME]
            pods_constrain = bool(pod_reqs_u_arr.defined[:, k_h].any()) if U else False
            types_constrain = any(LABEL_HOSTNAME in it.requirements for it in all_types)
            if hhi == dictionary.V and not pods_constrain and not types_constrain:
                screen_v = hlo
        dictionary.screen_v = screen_v

    item_of_pod, item_counts, item_rep, item_members = _build_items(
        uidx, topo_meta, topo_arrays, ffd_key_of_class=ffd_key_of_class,
    )
    # verdict columns: one per distinct class among items
    cls_of_item = uidx[item_rep] if len(item_rep) else item_rep
    _ucls, scls_items, item_scls = np.unique(
        cls_of_item, return_index=True, return_inverse=True
    )
    item_pad = ladder_pad(max(len(item_counts), 1), ladder, "items", 32)
    cls_pad = ladder_pad(max(len(scls_items), 1), ladder, "items", 32)

    seg_key_scr = np.array(
        [dictionary.segment(k)[0] < screen_v for k in dictionary.keys], dtype=bool)
    seg_plane_neutral = ~(pod_reqs_u_arr.defined & seg_key_scr[None, :]).any(axis=1)
    seg_eligible = (
        (topo_meta is None or len(topo_meta.groups) == 0)
        and ports_vols["pod_ports_u"].shape[1] == 0
        and ports_vols["pod_vols_u"].shape[1] == 0
    )

    return EncodedSnapshot(
        dictionary=dictionary,
        resource_names=resource_names,
        pod_reqs_u=pod_reqs_u_arr,
        pod_requests_u=pod_requests_u,
        pod_tol_u=pod_tol_u,
        uidx=uidx,
        tmpl_reqs=encode_reqsets(tmpl_reqs_list, dictionary),
        tmpl_daemon=tmpl_daemon,
        tmpl_type_mask=tmpl_type_mask,
        type_reqs=type_reqs_arr,
        type_alloc=type_alloc,
        type_capacity=type_capacity,
        type_offering_ok=type_offering_ok,
        well_known=well_known,
        zone_seg=(zlo, zhi),
        ct_seg=(clo, chi),
        exist_reqs=encode_reqsets(exist_reqs_list, dictionary),
        exist_used=exist_used,
        exist_cap=exist_cap,
        tol_exist_us=tol_exist_us,
        sig_of_node=sig_of_node,
        **ports_vols,
        n_slots=n_slots,
        screen_v=screen_v,
        item_counts=item_counts,
        item_rep=item_rep,
        item_members=item_members,
        item_scls=item_scls.astype(np.int32),
        scls_items=scls_items.astype(np.int32),
        item_pad=item_pad,
        cls_pad=cls_pad,
        seg_eligible=seg_eligible,
        seg_plane_neutral=seg_plane_neutral,
        instance_types=all_types,
        templates=templates,
        pods=pods_sorted,
        state_nodes=state_nodes,
        topo_meta=topo_meta,
        topo_arrays=topo_arrays,
        item_of_pod=item_of_pod,
    )


def _port_volume_arrays(uniq_pods, state_nodes, E_pad: int, kube_client) -> Dict:
    """The host-port and CSI volume columns (encode.py:1166-1253): entry
    and claim columns in first-seen order over the pod classes, then the
    nodes, each axis padded to a power-of-two bucket whose pad columns
    never conflict or count."""
    U = len(uniq_pods)
    pod_ports_u_list = [host_ports(p) for p in uniq_pods]
    port_index: Dict[Tuple, int] = {}
    port_entries: List = []

    def _port_id(entry):
        key = (entry.ip, entry.port, entry.protocol)
        q = port_index.get(key)
        if q is None:
            q = port_index[key] = len(port_entries)
            port_entries.append(entry)
        return q

    for entries in pod_ports_u_list:
        for entry in entries:
            _port_id(entry)
    exist_port_rows: List[List[int]] = []
    for node in state_nodes:
        exist_port_rows.append([_port_id(entry)
                                for entries in node.hostport_usage.reserved.values()
                                for entry in entries])
    Q = bucket_pow2(len(port_entries), 8)
    pod_ports_u = np.zeros((U, Q), dtype=bool)
    for u, entries in enumerate(pod_ports_u_list):
        for entry in entries:
            pod_ports_u[u, port_index[(entry.ip, entry.port, entry.protocol)]] = True
    conflict = np.zeros((Q, Q), dtype=bool)
    for a in range(len(port_entries)):
        for b in range(len(port_entries)):
            conflict[a, b] = port_entries[a].matches(port_entries[b])
    pod_port_conflict_u = pod_ports_u @ conflict  # [U, Q]
    exist_ports = np.zeros((E_pad, Q), dtype=bool)
    for e, row in enumerate(exist_port_rows):
        exist_ports[e, row] = True

    vu = VolumeUsage(kube_client)
    pod_vols_u_list = [vu._resolve(p) for p in uniq_pods]
    vol_index: Dict[Tuple[str, str], int] = {}
    driver_index: Dict[str, int] = {}

    def _vol_id(driver, pvc_id):
        w = vol_index.get((driver, pvc_id))
        if w is None:
            w = vol_index[(driver, pvc_id)] = len(vol_index)
            if driver not in driver_index:
                driver_index[driver] = len(driver_index)
        return w

    for vols in pod_vols_u_list:
        for driver, ids in vols.items():
            for pvc_id in ids:
                _vol_id(driver, pvc_id)
    for node in state_nodes:
        for driver, ids in node.volume_usage.volumes.items():
            for pvc_id in ids:
                _vol_id(driver, pvc_id)
        for driver in node.volume_limits:
            if driver not in driver_index:
                driver_index[driver] = len(driver_index)
    W = bucket_pow2(len(vol_index), 8)
    D = bucket_pow2(len(driver_index), 2)
    pod_vols_u = np.zeros((U, W), dtype=bool)
    for u, vols in enumerate(pod_vols_u_list):
        for driver, ids in vols.items():
            for pvc_id in ids:
                pod_vols_u[u, vol_index[(driver, pvc_id)]] = True
    exist_vols = np.zeros((E_pad, W), dtype=bool)
    exist_vol_limits = np.full((E_pad, D), np.inf, dtype=np.float32)
    for e, node in enumerate(state_nodes):
        for driver, ids in node.volume_usage.volumes.items():
            for pvc_id in ids:
                exist_vols[e, vol_index[(driver, pvc_id)]] = True
        for driver, limit in node.volume_limits.items():
            if limit is not None:
                exist_vol_limits[e, driver_index[driver]] = float(limit)
    vol_driver_onehot = np.zeros((W, D), dtype=np.float32)
    for (driver, _pvc), w in vol_index.items():
        vol_driver_onehot[w, driver_index[driver]] = 1.0

    return dict(
        pod_ports_u=pod_ports_u,
        pod_port_conflict_u=pod_port_conflict_u,
        exist_ports=exist_ports,
        pod_vols_u=pod_vols_u,
        exist_vols=exist_vols,
        exist_vol_limits=exist_vol_limits,
        vol_driver_onehot=vol_driver_onehot,
    )


def _build_items(uidx, topo_meta, topo_arrays, ffd_key_of_class=None):
    """Group FFD-sorted pods into items by spec-equivalence class, in order
    of first appearance. Classes in a VALUE-KEY anti-affinity group expand
    back to count-1 items: each placement blocks every possible domain
    (topology.go:120-143), so the reference's per-pod re-evaluation must
    be kept. Hostname anti-affinity is slot-local and stays bulk, except
    owners that do not match their own selector (their replicas may share
    a node, which the kernel's one-per-slot cap would forbid). Spread and
    affinity owners stay bulk. Returns (item_of_pod [P], item_counts [I],
    item_rep [I], members)."""
    P = len(uidx)
    if P == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.int32), [])
    expand_pod = np.zeros(P, dtype=bool)
    if topo_meta is not None:
        owner, sel = topo_arrays.owner, topo_arrays.sel  # [G, P]
        for g, gm in enumerate(topo_meta.groups):
            if gm.gtype != TOPO_ANTI:
                continue
            if not gm.is_hostname or gm.filter_term_rows:
                expand_pod |= sel[g] if gm.is_inverse else owner[g]
            elif not gm.is_inverse:
                expand_pod |= owner[g] & ~sel[g]
    class_item: Dict[int, int] = {}
    item_of_pod = np.zeros(P, dtype=np.int32)
    counts: List[int] = []
    reps: List[int] = []
    members: List[List[int]] = []
    for i in range(P):
        if expand_pod[i]:
            item = len(counts)
            counts.append(1)
            reps.append(i)
            members.append([i])
        else:
            u = int(uidx[i])
            item = class_item.get(u)
            if item is None:
                item = class_item[u] = len(counts)
                counts.append(0)
                reps.append(i)
                members.append([])
            counts[item] += 1
            members[item].append(i)
        item_of_pod[i] = item

    # Within an FFD tie group, hostname-spread and hostname-anti owners go
    # first: each replica opens or claims a near-empty node, which the
    # reference's interleaved per-pod loop lets same-sized pods that follow
    # reuse (machines rank by ascending pod count, scheduler.go:186-193)
    if topo_meta is not None and ffd_key_of_class is not None:
        hs_groups = [
            g for g, gm in enumerate(topo_meta.groups)
            if gm.gtype in (TOPO_SPREAD, TOPO_ANTI) and gm.is_hostname
            and not gm.is_inverse
        ]
        if hs_groups:
            owner = topo_arrays.owner
            owns_hs = [any(owner[g, reps[it]] for g in hs_groups)
                       for it in range(len(counts))]
            order = sorted(
                range(len(counts)),
                key=lambda it: (ffd_key_of_class(uidx[reps[it]]),
                                0 if owns_hs[it] else 1, it),
            )
            inv = np.zeros(len(counts), dtype=np.int32)
            for new, old in enumerate(order):
                inv[old] = new
            item_of_pod = inv[item_of_pod]
            counts = [counts[old] for old in order]
            reps = [reps[old] for old in order]
            members = [members[old] for old in order]
    return (
        item_of_pod,
        np.asarray(counts, dtype=np.int32),
        np.asarray(reps, dtype=np.int32),
        members,
    )
