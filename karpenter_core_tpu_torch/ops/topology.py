"""Topology as domain-count tensors, in PyTorch.

The port of karpenter_core_tpu/ops/topology.py. The host topology
(controllers/provisioning/scheduling/topology.py) lowers onto arrays the
pack scan updates in place:

  counts[G, V]      per-group occupancy per domain on the flat value axis
                    (zone, region and custom-key groups), float32
  hcounts[G, N]     hostname groups count per SLOT: a machine slot is its
                    own hostname domain (machine.go:44-48), so slot identity
                    replaces dictionary values, float32
  domain_mask[G, V] registered domains per group, bool
  owner[G, P]       the pod carries the constraint (direct groups)
  sel[G, P]         the group's selector matches the pod

Per-(pod, slot) viability and the committed narrowing follow
topologygroup.go:155-243; Record follows topology.go:120-143, including the
anti-affinity rule that blocks every possible domain and the complement
quirk of Requirement.Values().

The device functions take a pod's group flags (`own`, `selp`) as host
booleans: the scan reads them once per item, so every branch on them is
host control flow, and a group that does not apply to the pod costs
nothing. Each function returns exactly what the reference's returns for
the same inputs; counts are small integers in float32, exact in any
summation order.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

TOPO_SPREAD = 0
TOPO_AFFINITY = 1
TOPO_ANTI = 2

BIGK = 2**30


@dataclass
class TopoGroupMeta:
    """Static description of one group."""

    gtype: int
    seg: Tuple[int, int]
    key_k: int  # key index (for the complement flag of merged requirements)
    max_skew: int
    is_hostname: bool
    is_inverse: bool
    filter_term_rows: List[int]  # rows into the filter-term ReqSet arrays


@dataclass
class TopoArrays:
    """Per-solve arrays (numpy)."""

    counts0: np.ndarray  # [G, V] float32 (value-key groups)
    hcounts0: np.ndarray  # [G, N] float32 (hostname groups, per slot)
    domain_mask0: np.ndarray  # [G, V] bool
    owner: np.ndarray  # [G, P] bool
    sel: np.ndarray  # [G, P] bool
    term_allow: np.ndarray  # [GT, V] node-filter terms as one ReqSet batch
    term_out: np.ndarray  # [GT, K]
    term_defined: np.ndarray  # [GT, K]
    term_escape: np.ndarray  # [GT, K]


@dataclass
class TopoMeta:
    groups: List[TopoGroupMeta] = field(default_factory=list)


def encode_topology(host_topology, pods_sorted, dictionary, n_slots: int,
                    exist_hostnames: List[str], uidx=None, uniq_pods=None):
    """Lower a host Topology to (TopoMeta, TopoArrays), or (None, None)
    when the batch has no topology groups. exist_hostnames[e] names
    existing slot e's hostname domain. With (uidx, uniq_pods) ownership and
    selection are evaluated once per pod-spec class and gathered."""
    from karpenter_core_tpu_torch.kube.objects import LABEL_HOSTNAME
    from karpenter_core_tpu_torch.solver.encode import encode_reqsets

    groups = list(host_topology.topologies.values()) + list(
        host_topology.inverse_topologies.values()
    )
    if not groups:
        return None, None
    P = len(pods_sorted)
    V = dictionary.V
    G = len(groups)
    per_class = uidx is not None and uniq_pods is not None
    if not per_class:
        uid_to_idx = {p.metadata.uid: i for i, p in enumerate(pods_sorted)}
    n_direct = len(host_topology.topologies)

    metas: List[TopoGroupMeta] = []
    counts0 = np.zeros((G, V), dtype=np.float32)
    hcounts0 = np.zeros((G, n_slots), dtype=np.float32)
    domain_mask0 = np.zeros((G, V), dtype=bool)
    U = len(uniq_pods) if per_class else P
    owner_u = np.zeros((G, U), dtype=bool)
    sel_u = np.zeros((G, U), dtype=bool)
    term_reqs = []
    type_map = {"topology spread": TOPO_SPREAD, "pod affinity": TOPO_AFFINITY,
                "pod anti-affinity": TOPO_ANTI}
    for g, tg in enumerate(groups):
        is_hostname = tg.key == LABEL_HOSTNAME
        seg = dictionary.segment(tg.key) if tg.key in dictionary.key_index else (0, 0)
        rows = []
        for term in tg.node_filter.terms:
            rows.append(len(term_reqs))
            term_reqs.append(term)
        metas.append(TopoGroupMeta(
            gtype=type_map[tg.type], seg=seg,
            key_k=dictionary.key_index.get(tg.key, 0),
            max_skew=int(tg.max_skew), is_hostname=is_hostname,
            is_inverse=(g >= n_direct), filter_term_rows=rows,
        ))
        if is_hostname:
            for e, hostname in enumerate(exist_hostnames):
                hcounts0[g, e] = tg.domains.get(hostname, 0)
        else:
            for domain, count in tg.domains.items():
                fi = dictionary.flat_index(tg.key, domain)
                if fi is None:
                    continue
                domain_mask0[g, fi] = True
                counts0[g, fi] = count
        if per_class:
            for u, rep in enumerate(uniq_pods):
                owner_u[g, u] = tg.is_owned_by(rep.metadata.uid)
                sel_u[g, u] = tg._selects(rep)
        else:
            for uid in tg.owners:
                if uid in uid_to_idx:
                    owner_u[g, uid_to_idx[uid]] = True
            for i, pod in enumerate(pods_sorted):
                sel_u[g, i] = tg._selects(pod)
    if per_class:
        owner, sel = owner_u[:, uidx], sel_u[:, uidx]
    else:
        owner, sel = owner_u, sel_u
    terms = encode_reqsets(term_reqs, dictionary)
    return TopoMeta(groups=metas), TopoArrays(
        counts0=counts0, hcounts0=hcounts0, domain_mask0=domain_mask0,
        owner=owner, sel=sel, term_allow=terms.allow, term_out=terms.out,
        term_defined=terms.defined, term_escape=terms.escape,
    )


# ---------------------------------------------------------------------------
# device-side group evaluation (inside the pack scan)


def _flags(x) -> List[bool]:
    """A pod's [G] group flags as host booleans."""
    if isinstance(x, torch.Tensor):
        return x.cpu().tolist()
    return [bool(v) for v in x]


def _first_true_onehot(mask: torch.Tensor) -> torch.Tensor:
    """[..., S] bool -> onehot of the first True (all-False rows -> zeros)."""
    if mask.shape[-1] == 0:
        return mask
    idx = torch.argmax(mask.to(torch.uint8), dim=-1)
    oh = torch.arange(mask.shape[-1], device=mask.device) == idx[..., None]
    return oh & mask.any(dim=-1, keepdim=True)


def _applies(gm: TopoGroupMeta, own, selp, g: int) -> bool:
    return selp[g] if gm.is_inverse else own[g]


def topo_screen(meta: TopoMeta, tcounts, thost, tdoms, own, selp, pod_allow,
                slot_allow) -> torch.Tensor:
    """[N] viability of every slot row under the pod's groups
    (topologygroup.go Get()): spread membership, affinity positive or seed
    domains, anti-affinity zero-count domains. Hostname groups evaluate on
    slot identity (thost [G, N])."""
    own, selp = _flags(own), _flags(selp)
    N = slot_allow.shape[0]
    viable = torch.ones(N, dtype=torch.bool, device=slot_allow.device)
    for g, gm in enumerate(meta.groups):
        if not _applies(gm, own, selp, g):
            continue
        if gm.is_hostname:
            hc = thost[g]
            if gm.gtype == TOPO_SPREAD:
                g_viable = (hc + float(selp[g])) - 0.0 <= gm.max_skew
            elif gm.gtype == TOPO_AFFINITY:
                pos = hc > 0.5
                if selp[g]:
                    g_viable = torch.where(pos.any(), pos, True)
                else:
                    g_viable = pos
            else:
                g_viable = hc < 0.5
        else:
            lo, hi = gm.seg
            doms = tdoms[g, lo:hi]
            cnt = tcounts[g, lo:hi]
            pod_dom = pod_allow[lo:hi]
            sallow = slot_allow[:, lo:hi]
            if gm.gtype == TOPO_SPREAD:
                # membership only: the scan's water-fill decides the domain
                g_viable = ((pod_dom & doms)[None, :] & sallow).any(dim=-1)
            elif gm.gtype == TOPO_AFFINITY:
                pos = pod_dom & doms & (cnt > 0.5)
                if selp[g]:
                    seed1 = _first_true_onehot(pod_dom[None, :] & doms[None, :] & sallow)
                    seed2 = _first_true_onehot((pod_dom & doms)[None, :])
                    opts = torch.where(pos.any(), pos[None, :], seed1 | seed2)
                else:
                    opts = pos[None, :]
                g_viable = (opts & sallow).any(dim=-1)
            else:
                opts = pod_dom & doms & (cnt < 0.5)
                g_viable = (opts[None, :] & sallow).any(dim=-1)
        viable &= g_viable
    return viable


def topo_narrow_single(meta: TopoMeta, tcounts, thost, tdoms, own, selp,
                       pod_allow, slot_allow_row, slot_n, n_keys: int,
                       spread_force=None):
    """(viable, narrow[V], applied_keys[K], k_cap) for ONE candidate slot
    (0-d tensors for the scalars). applied_keys mark keys that become
    defined In-sets on the merged requirements (topology.go:149-167).
    Hostname groups evaluate on the slot's identity and narrow nothing.
    Value-key spread narrowing follows spread_force [V], the scan's
    water-fill choice; None admits every registered domain. k_cap bounds
    the identical replicas the slot may take: the skew headroom of owned
    hostname spread groups, 1 under anti-affinity."""
    own, selp = _flags(own), _flags(selp)
    dev = slot_allow_row.device
    V = slot_allow_row.shape[0]
    viable = torch.ones((), dtype=torch.bool, device=dev)
    narrow = torch.ones(V, dtype=torch.bool, device=dev)
    applied_keys = torch.zeros(n_keys, dtype=torch.bool, device=dev)
    k_cap = torch.full((), BIGK, dtype=torch.int32, device=dev)
    for g, gm in enumerate(meta.groups):
        if not _applies(gm, own, selp, g):
            continue
        if gm.is_hostname:
            hc = thost[g, slot_n]
            if gm.gtype == TOPO_SPREAD:
                g_viable = hc + float(selp[g]) <= gm.max_skew
                if selp[g]:
                    headroom = torch.clamp(
                        torch.tensor(float(gm.max_skew), dtype=torch.float32,
                                     device=dev) - hc, min=0.0,
                    ).to(torch.int32)
                    k_cap = torch.minimum(k_cap, headroom)
            elif gm.gtype == TOPO_AFFINITY:
                if selp[g]:
                    g_viable = torch.where((thost[g] > 0.5).any(), hc > 0.5, True)
                else:
                    g_viable = hc > 0.5
            else:
                g_viable = hc < 0.5
                # only the direct group caps replicas at one a slot
                if not gm.is_inverse:
                    k_cap = torch.clamp(k_cap, max=1)
            viable = viable & g_viable
            continue
        lo, hi = gm.seg
        doms = tdoms[g, lo:hi]
        cnt = tcounts[g, lo:hi]
        pod_dom = pod_allow[lo:hi]
        sallow = slot_allow_row[lo:hi]
        if gm.gtype == TOPO_SPREAD:
            sf = spread_force[lo:hi] if spread_force is not None else doms
            g_narrow = sf & doms
        elif gm.gtype == TOPO_AFFINITY:
            pos = pod_dom & doms & (cnt > 0.5)
            if selp[g]:
                seed1 = _first_true_onehot((pod_dom & doms & sallow)[None, :])[0]
                seed2 = _first_true_onehot((pod_dom & doms)[None, :])[0]
                g_narrow = torch.where(pos.any(), pos, seed1 | seed2)
            else:
                g_narrow = pos
        else:
            g_narrow = pod_dom & doms & (cnt < 0.5)
            k_cap = torch.clamp(k_cap, max=1)
        viable = viable & (g_narrow & sallow).any()
        narrow[lo:hi] &= g_narrow
        applied_keys[gm.key_k] = True
    return viable, narrow, applied_keys, k_cap


def topo_bulk_item_ok(meta: TopoMeta, own, selp) -> bool:
    """May this item take the bulk existing fill? Not under anti-affinity
    (each placement blocks domains for the next), not as a hostname
    affinity owner (replicas co-locate on one host), not with node-filter
    terms (evaluated per merged slot row)."""
    own, selp = _flags(own), _flags(selp)
    ok = True
    for g, gm in enumerate(meta.groups):
        has_terms = len(gm.filter_term_rows) > 0
        if gm.is_inverse:
            ok &= not own[g]
            if has_terms:
                ok &= not selp[g]
            continue
        if gm.gtype == TOPO_ANTI:
            ok &= not (own[g] or selp[g])
        elif gm.gtype == TOPO_AFFINITY and gm.is_hostname:
            ok &= not own[g]
        if has_terms:
            ok &= not (own[g] or selp[g])
    return ok


def topo_mach_bulk_item_ok(meta: TopoMeta, own, selp) -> bool:
    """May this item take the full-axis (machine-region) bulk fill? As
    topo_bulk_item_ok, but hostname anti-affinity (direct, own or
    selected; inverse, owned) is allowed: its domain is the slot, so each
    placement changes only its own slot's viability."""
    own, selp = _flags(own), _flags(selp)
    ok = True
    for g, gm in enumerate(meta.groups):
        if gm.filter_term_rows:
            ok &= not (own[g] or selp[g])
            continue
        if gm.is_inverse:
            if not gm.is_hostname:
                ok &= not own[g]
            continue
        if gm.gtype == TOPO_ANTI and not gm.is_hostname:
            ok &= not (own[g] or selp[g])
        elif gm.gtype == TOPO_AFFINITY and gm.is_hostname:
            ok &= not own[g]
    return ok


def topo_bulk_need_seed(meta: TopoMeta, tcounts, tdoms, own, pod_allow):
    """0-d bool: an owned value-key affinity group has no positive domain
    yet, so the first replica must seed one on the single-slot path."""
    own = _flags(own)
    need = torch.zeros((), dtype=torch.bool, device=tcounts.device)
    for g, gm in enumerate(meta.groups):
        if gm.is_inverse or gm.is_hostname or gm.gtype != TOPO_AFFINITY or not own[g]:
            continue
        lo, hi = gm.seg
        has_pos = (pod_allow[lo:hi] & tdoms[g, lo:hi] & (tcounts[g, lo:hi] > 0.5)).any()
        need = need | ~has_pos
    return need


def topo_bulk_narrow(meta: TopoMeta, tcounts, thost, tdoms, own, selp,
                     pod_allow, n_keys: int, spread_force=None):
    """(narrow[V], applied_keys[K], k_cap[N]) for the bulk fill: one
    slot-independent narrowing row merged into every filled slot, and the
    per-slot replica headroom (hostname spread skew, 1 under hostname
    anti-affinity)."""
    own, selp = _flags(own), _flags(selp)
    dev = pod_allow.device
    V = pod_allow.shape[0]
    N = thost.shape[1] if thost.dim() == 2 else 0
    narrow = torch.ones(V, dtype=torch.bool, device=dev)
    applied = torch.zeros(n_keys, dtype=torch.bool, device=dev)
    k_cap = torch.full((N,), BIGK, dtype=torch.int32, device=dev)
    for g, gm in enumerate(meta.groups):
        if gm.is_inverse or not own[g]:
            continue
        if gm.is_hostname:
            if gm.gtype == TOPO_SPREAD and selp[g]:
                headroom = torch.clamp(
                    torch.tensor(float(gm.max_skew), dtype=torch.float32,
                                 device=dev) - thost[g], min=0.0,
                ).to(torch.int32)
                k_cap = torch.minimum(k_cap, headroom)
            elif gm.gtype == TOPO_ANTI:
                k_cap = torch.clamp(k_cap, max=1)
            continue
        lo, hi = gm.seg
        doms = tdoms[g, lo:hi]
        if gm.gtype == TOPO_SPREAD:
            sf = spread_force[lo:hi] if spread_force is not None else doms
            g_narrow = sf & doms
        elif gm.gtype == TOPO_AFFINITY:
            g_narrow = pod_allow[lo:hi] & doms & (tcounts[g, lo:hi] > 0.5)
        else:
            continue
        narrow[lo:hi] &= g_narrow
        applied[gm.key_k] = True
    return narrow, applied, k_cap


def topo_record_bulk(meta: TopoMeta, tcounts, thost, tdoms, own, selp,
                     m_allow_rows, m_out_rows, k_row):
    """topo_record for the bulk fills, per merged slot row. Their items
    carry no value-key anti-affinity and no node-filter terms, so value-key
    counting is the singleton rule per slot. k_row and the row planes may
    cover a PREFIX of the slot axis. Updates the three tensors in place and
    returns them."""
    own, selp = _flags(own), _flags(selp)
    k_row_f = k_row.to(torch.float32)
    touched = k_row > 0
    n_pre = k_row.shape[0]
    for g, gm in enumerate(meta.groups):
        if gm.is_hostname:
            if own[g] if gm.is_inverse else selp[g]:
                thost[g, :n_pre] += k_row_f
            continue
        if gm.is_inverse or not selp[g]:
            continue  # inverse groups record on OWNER placements only
        lo, hi = gm.seg
        allow_seg = m_allow_rows[:, lo:hi]
        out_k = m_out_rows[:, gm.key_k]
        singleton = (~out_k) & (allow_seg.sum(dim=-1) == 1)
        delta = allow_seg & singleton[:, None]
        tcounts[g, lo:hi] += (delta.to(torch.float32) * k_row_f[:, None]).sum(dim=0)
        tdoms[g, lo:hi] |= (delta & touched[:, None]).any(dim=0)
    return tcounts, thost, tdoms


def topo_record(meta: TopoMeta, tcounts, thost, tdoms, own, selp, nf_ok,
                m_allow, m_out, row_mask, k_row):
    """Commit a placement into the counts (topology.go:120-143). nf_ok [G]
    (host booleans): node-filter match of each group against the merged
    slot requirements; m_allow / m_out: the committed merged row, the same
    for every slot written; row_mask [N] the slots written, k_row [N] the
    replicas per slot. A call that places nothing changes nothing. Updates
    the three tensors in place and returns them."""
    own, selp, nf_ok = _flags(own), _flags(selp), _flags(nf_ok)
    k_row_f = torch.where(row_mask, k_row, 0).to(torch.float32)
    placed_total = k_row_f.sum()
    active = placed_total > 0
    for g, gm in enumerate(meta.groups):
        if gm.is_hostname:
            if own[g] if gm.is_inverse else (selp[g] and nf_ok[g]):
                thost[g] += k_row_f
            continue
        if not (own[g] if gm.is_inverse else (selp[g] and nf_ok[g])):
            continue
        lo, hi = gm.seg
        allow_seg = m_allow[lo:hi]
        out_k = m_out[gm.key_k]
        # Requirement.Values(): the allowed values of an In-set, the
        # EXCLUDED values of a complement set (requirement.go:178-180)
        vals = torch.where(out_k, ~allow_seg, allow_seg)
        if gm.is_inverse or gm.gtype == TOPO_ANTI:
            delta = vals
        else:
            delta = allow_seg & ((~out_k) & (allow_seg.sum() == 1))
        tcounts[g, lo:hi] += delta.to(torch.float32) * placed_total
        tdoms[g, lo:hi] |= delta & active
    return tcounts, thost, tdoms


def topo_node_filter_ok(meta: TopoMeta, terms, segments, well_known, m_allow,
                        m_out, m_defined) -> torch.Tensor:
    """[G] bool: TopologyNodeFilter.MatchesRequirements of the merged slot
    requirements (topologynodefilter.go:46-56): an empty filter matches,
    else any term with Compatible(merged, term)."""
    from karpenter_core_tpu_torch.ops import compat

    dev = m_allow.device
    if terms is None or terms["allow"].shape[0] == 0:
        return torch.ones(len(meta.groups), dtype=torch.bool, device=dev)
    m_escape = compat.escape_flags(m_allow[None], m_out[None], m_defined[None],
                                   segments)[0]
    node = {"allow": m_allow[None, :], "out": m_out[None, :],
            "defined": m_defined[None, :], "escape": m_escape[None, :]}
    ok_rows = compat.pairwise_compatible(node, terms, segments, well_known)[0]
    out = [
        ok_rows[list(gm.filter_term_rows)].any() if gm.filter_term_rows
        else torch.ones((), dtype=torch.bool, device=dev)
        for gm in meta.groups
    ]
    return torch.stack(out)
