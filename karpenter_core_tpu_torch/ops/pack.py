"""Greedy packing over FFD-ordered items, in eager PyTorch.

The port of karpenter_core_tpu/ops/pack.py for both screen modes
(prescreen and tiered) and a logged commit sequence, with the topology,
host-port and CSI volume lanes, and the delta refresh of a resident
prescreen tensor (screen_refresh). It replaces the serial
Solve loop (scheduler.go:96-133,177-222) with a scan over a fixed budget
of node slots:

  slot state: accumulated requests, merged requirement masks, remaining
  instance-type mask, optimistic capacity, pod count, reserved host-port
  entries, mounted volume claims (existing slots); global state: the
  topology groups' domain counts (ops/topology.py).

Per item (one pod spec class with a replica count):
  1. SCREEN all slots: taints ∧ requirement verdict (a column of the [N, C]
     prescreen tensor, or under tiered the open slot rows screened against
     the item on the spot) ∧ optimistic fit ∧ topology viability ∧ no
     host-port conflict ∧ CSI attach limits (existing slots).
  2. Rank candidates: existing nodes by index first, then open machines by
     ascending pod count (scheduler.go:179-193).
  3. Fill the bulk region in one commit (existing nodes; the whole slot
     axis for batches with hostname anti-affinity), VERIFY and commit to
     the best candidate (narrowed to the topology domain choice), or OPEN
     fresh slots from the first template that can host the item (weight
     order, scheduler.go:195-221) within provisioner limits
     (scheduler.go:276-293). Owners of a value-key spread pack by a
     per-iteration water-fill over the domains.
  4. Record each commit into the topology counts (topology.go:120-143).

The consolidation replan (make_batched_replan_kernel) runs the same scan
once per candidate subset, in rung mode: no commit log, the subset's
replica counts, and its victims' existing slots closed. The segmented
scan's lanes run it on a gathered subset of the items, each with its own
existing slots and machine region, after the conflict partition
(make_segment_partition_kernel) proved the lanes independent.

The reference's lax.scan is a Python loop here, and its lax.while_loop and
lax.cond are Python control flow on small scalars read from the device,
batched into one read per decision. Every float is computed with the
reference's operations in the reference's order, one float32 op at a time,
so slot state and counts match bit for bit. The commit log keeps the
reference's layout (item, slot, ns, k, k_last, bulk_take, bulk_n) and
budgets, so it decodes with the same expand_log.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from karpenter_core_tpu_torch.ops import compat
from karpenter_core_tpu_torch.ops.screen import (
    ScreenItems,
    ScreenLayout,
    launch_counts,
    screen_block,
    screen_row,
)
from karpenter_core_tpu_torch.ops.topology import (
    TOPO_AFFINITY,
    TOPO_ANTI,
    TOPO_SPREAD,
    TopoMeta,
    topo_bulk_item_ok,
    topo_bulk_narrow,
    topo_bulk_need_seed,
    topo_mach_bulk_item_ok,
    topo_narrow_single,
    topo_node_filter_ok,
    topo_record,
    topo_record_bulk,
    topo_screen,
)
from karpenter_core_tpu_torch.utils import supervise

BIG = 1e30  # float32(1e30) once it meets a float32 tensor
BIGK = 2**30

# the last pack call's work: items stepped and while-iterations per branch
LAST_SCAN = {"items": 0, "bulk": 0, "candidate": 0, "open": 0}


class PackState(NamedTuple):
    used: torch.Tensor  # [N, R] float32
    open: torch.Tensor  # [N] bool
    is_existing: torch.Tensor  # [N] bool
    tmpl: torch.Tensor  # [N] int32 template id (machine slots)
    tol_idx: torch.Tensor  # [N] int32 row into pod_tol_all
    pods: torch.Tensor  # [N] int32
    allow: torch.Tensor  # [N, V] bool merged requirement masks
    out: torch.Tensor  # [N, K] bool
    defined: torch.Tensor  # [N, K] bool
    tmask: torch.Tensor  # [N, T] bool remaining instance types (machine slots)
    cap: torch.Tensor  # [N, R] float32 optimistic capacity
    nopen: torch.Tensor  # 0-d int32: next free slot
    remaining: torch.Tensor  # [J, R] float32 provisioner limit left (1e30: none)
    tcounts: torch.Tensor  # [G, V] float32 topology domain counts
    thost: torch.Tensor  # [G, N] float32 hostname-group counts per slot
    tdoms: torch.Tensor  # [G, V] bool registered domains per group
    ports: torch.Tensor  # [N, Q] bool reserved host-port entries
    vols: torch.Tensor  # [E, W] bool mounted claims (existing slots only)


def _segment_max_alloc(tmask: torch.Tensor, type_alloc: torch.Tensor) -> torch.Tensor:
    """[..., T] bool, [T, R] -> [..., R] max allocatable over allowed types."""
    masked = torch.where(tmask[..., None], type_alloc, -BIG)
    return masked.max(dim=-2).values


def replica_cap(alloc, used, req):
    """alloc [X, R] vs used [1 or X, R] + k*req [R]: the most identical
    replicas k per row with exact-fit semantics (the float floor corrected
    by one either way so k*req <= room holds in float32). Rows with a
    negative allocatable, or already over on a resource the item does not
    request, get 0. Separate float32 ops, as in the reference."""
    room = alloc - used
    safe = req > 0
    denom = torch.where(safe, req, 1.0)
    kf = torch.clamp(torch.floor(room / denom), 0.0, float(BIGK))
    kf = torch.where((kf + 1.0) * denom <= room, kf + 1.0, kf)
    kf = torch.where(kf * denom > room, kf - 1.0, kf)
    k = torch.clamp(kf, 0.0, float(BIGK)).to(torch.int32)
    k = torch.where(safe, k, BIGK)
    kmin = k.min(dim=-1).values
    valid = torch.all((alloc >= 0.0) & ((room >= 0.0) | safe), dim=-1)
    return torch.where(valid, kmin, 0).to(torch.int32)


class ScreenOps:
    """The batched class x slot requirement screen (make_screen_ops):
    Compatible(slot row = node side, item row = pod side). Every form runs
    on the screen kernel (ops/screen.py) at the screen width."""

    def __init__(self, segments, V: int, screen_v: Optional[int]):
        w = V if screen_v is None else min(screen_v, V)
        self.width = w
        # rows_vs_items skips keys past the width; items_vs_row evaluates
        # every key on its clipped segment (the reference's two forms)
        self.rows_layout = ScreenLayout(segments, w, every_key=False)
        self.row_layout = ScreenLayout(segments, w, every_key=True)

    def items_vs_row(self, items: ScreenItems, s_allow, s_out, s_defined):
        """[C] verdict of every item against ONE slot row."""
        return screen_block(s_allow[None], s_out[None], s_defined[None], items,
                            self.row_layout)[0]

    def rows_vs_items(self, items: ScreenItems, s_allow, s_out, s_defined):
        """[B, C] slot-major verdict block."""
        return screen_block(s_allow, s_out, s_defined, items, self.rows_layout)

    def initial_screen(self, items: ScreenItems, e_allow, e_out, e_defined,
                       n_slots: int):
        """[N, C] verdict tensor at scan entry: the exact block over the
        existing prefix plus the virgin row broadcast over the (closed,
        unread until opened) machine region."""
        dev = e_allow.device
        V, K, E = e_allow.shape[1], e_out.shape[1], e_allow.shape[0]
        if E:
            block = self.rows_vs_items(items, e_allow, e_out, e_defined)
        else:
            block = torch.zeros((0, items.B), dtype=torch.bool, device=dev)
        virgin = self.items_vs_row(
            items,
            torch.ones(V, dtype=torch.bool, device=dev),
            torch.ones(K, dtype=torch.bool, device=dev),
            torch.zeros(K, dtype=torch.bool, device=dev),
        )
        tail = virgin[None, :].expand(n_slots - E, items.B)
        return torch.cat([block, tail], dim=0)


def class_planes(pod_arrays, ops: ScreenOps) -> ScreenItems:
    """The verdict tensor's column planes: item rows gathered through
    scls_first (one representative item per class column), prepared in the
    screen's packing (both of its layouts share it)."""
    sf = pod_arrays["scls_first"].to(torch.int64)
    return ScreenItems({
        k: pod_arrays[k][sf]
        for k in ("allow", "out", "defined", "escape", "custom_deny")
    }, ops.rows_layout)


# the last grid_initial_screen's tiles of this process: (i, j, rank,
# device, screen launches by kernel and form) per tile, in grid order
LAST_TILES: List[tuple] = []


def grid_initial_screen(ops: ScreenOps, layout, items_pl: ScreenItems, exist, n_slots: int,
                        targs=None) -> torch.Tensor:
    """initial_screen's [N, C] tensor as tiles of `layout`'s device grid
    (parallel/specs.py): tile (i, j), on grid device (i, j), screens the
    existing-slot rows E_i against the class columns C_j (rows_vs_items,
    the block form on the card), its class planes prepared there; the last
    dp row's tiles also screen the virgin row against C_j (items_vs_row,
    row_n1). A process computes its own cells' tiles; the tiles are
    gathered on its lead device (on a grid over processes, through the
    collectives: the block's, then the virgin row's from the ranks that
    own the last dp row), where the virgin row is broadcast over the
    machine region as initial_screen does, so the tensor equals
    initial_screen's. The reference tiles the whole N axis over dp; the
    machine region is one broadcast row, so the port tiles the existing
    prefix and moves one row per column tile. `targs`, when given, may
    carry the existing planes' tiles its upload made."""
    E = exist["allow"].shape[0]
    C = items_pl.B
    spec = layout.verdict()
    cols = layout.split(items_pl.planes, (layout.tp_axis, None))
    ex = layout.split_arg(targs, "exist", {k: exist[k] for k in ("allow", "out", "defined")},
                          layout.slot_plane())
    V, K = exist["allow"].shape[1], exist["out"].shape[1]
    last = layout.ndp - 1
    blocks = [[None] * layout.ntp for _ in range(layout.ndp)]
    virgin = [[None] * layout.ntp for _ in range(layout.ndp)]
    tiles = []
    for i, j in layout.mesh.cells():
        dev = layout.mesh.devices[i][j]
        before = launch_counts()
        items = ScreenItems(cols[i][j], ops.rows_layout)
        e = ex[i][j]
        blocks[i][j] = ops.rows_vs_items(items, e["allow"], e["out"], e["defined"])
        if i == last and n_slots > E:
            virgin[i][j] = ops.items_vs_row(
                items, torch.ones(V, dtype=torch.bool, device=dev),
                torch.ones(K, dtype=torch.bool, device=dev),
                torch.zeros(K, dtype=torch.bool, device=dev))
        after = launch_counts()
        tiles.append((i, j, layout.mesh.owner(i, j), str(dev),
                      {k: after[k] - before[k] for k in after}))
    LAST_TILES[:] = tiles
    block = layout.gather(blocks, spec, shape=(E, C), dtype=torch.bool)
    if n_slots <= E:
        return block
    row = layout.gather(virgin, (layout.tp_axis,), shape=(C,), dtype=torch.bool, row=last)
    return torch.cat([block, row[None, :].expand(n_slots - E, row.shape[0])], dim=0)


def make_prescreen_kernel(segments, n_slots: int, screen_v: Optional[int] = None,
                          spec_layout=None):
    """(pod item planes, existing planes) -> [N, C] slot-major verdicts over
    the deduped class columns (make_prescreen_kernel). With spec_layout
    (parallel/specs.SpecLayout) the tensor is computed as the grid's tiles
    and gathered on its lead device (grid_initial_screen)."""
    segments = [tuple(s) for s in segments]

    def prescreen(pod_arrays, exist):
        V = pod_arrays["allow"].shape[1]
        ops = ScreenOps(segments, V, screen_v)
        items_pl = class_planes(pod_arrays, ops)
        if spec_layout is not None:
            return grid_initial_screen(ops, spec_layout, items_pl, exist, n_slots)
        return ops.initial_screen(items_pl, exist["allow"], exist["out"], exist["defined"],
                                  n_slots)

    return prescreen


def screen_refresh(screen, ops: ScreenOps, items_pl: ScreenItems, exist, rows, cols):
    """Delta refresh of a resident [N, C] verdict tensor, in place (the
    reference's make_screen_refresh_kernel, pack.py:255-344): the
    incremental re-solve's device work (solver/incremental.py).

    verdict[n, c] depends only on slot row n's planes and class column c's
    planes, so a solve at an unchanged geometry recomputes only the
    existing rows whose planes changed (`rows`), against every column
    (rows_vs_items), and the columns whose class planes changed (`cols`),
    in full: the block over the existing prefix (rows_vs_items) and the
    virgin row (items_vs_row) broadcast over the machine region, as
    initial_screen builds them. `items_pl` is the solve's class planes.
    On a device grid the resident tensor, the class planes and the
    existing planes all live on the lead device, and so does the refresh,
    as the reference's runs on its gathered (replicated) operands.
    Rows outside the existing prefix and columns outside the tensor are
    dropped, never clamped, wrapped or written; an empty side is skipped.
    The writes are index ops on the tensor."""
    dev = screen.device
    N, C = screen.shape
    E = exist["allow"].shape[0]
    rows = np.asarray(rows, dtype=np.int64)
    rows = rows[(rows >= 0) & (rows < E)]
    cols = np.asarray(cols, dtype=np.int64)
    cols = cols[(cols >= 0) & (cols < C)]
    if len(rows):
        ri = torch.as_tensor(rows, device=dev)
        screen[ri] = ops.rows_vs_items(items_pl, exist["allow"][ri], exist["out"][ri],
                                       exist["defined"][ri])  # [rows, C]
    if len(cols):
        ci = torch.as_tensor(cols, device=dev)
        col_items = items_pl.take(ci)
        screen[:, ci] = ops.initial_screen(col_items, exist["allow"], exist["out"],
                                           exist["defined"], N)  # [N, cols]
    return screen


class _Log:
    """The commit log on the host (its scalars are host values already:
    the scan's control flow reads them), with the bulk take matrix on the
    device. Layout and budgets are the reference's (pack.py:963-1000).

    A disabled log (log_commits=False, the consolidation replan's rung
    scan, which reads only the final slot state) writes nothing and never
    gates a commit on log space, as the reference's rung mode skips every
    log write and its space gating (pack.py:960-975,1214-1226)."""

    def __init__(self, L: int, LB: int, BR: int, device, enabled: bool = True):
        self.L = L
        self.LB = LB
        self.enabled = enabled
        self.rows: List[tuple] = []  # (item, slot, ns, k, k_last)
        self.bulk_take = torch.zeros((LB, BR), dtype=torch.int32, device=device)
        self.bulk_n = 0

    @property
    def ptr(self) -> int:
        return len(self.rows)

    def has_room(self) -> bool:
        return self.ptr < self.L or not self.enabled

    def bulk_room(self) -> bool:
        return self.bulk_n < self.LB or not self.enabled

    def write(self, item, slot, ns, k, k_last) -> None:
        if self.enabled:
            self.rows.append((item, slot, ns, k, k_last))

    def write_bulk(self, item, take, width: int, placed: int) -> None:
        """A bulk commit: its take row and the ns=-1 marker entry."""
        if self.enabled:
            self.bulk_take[self.bulk_n, :width] = take
            self.write(item, 0, -1, self.bulk_n, placed)
            self.bulk_n += 1

    def arrays(self):
        L = self.L
        out = {
            "item": np.full(L, -1, np.int32),
            "slot": np.zeros(L, np.int32),
            "ns": np.zeros(L, np.int32),
            "k": np.zeros(L, np.int32),
            "k_last": np.zeros(L, np.int32),
        }
        if self.rows:
            cols = np.asarray(self.rows, dtype=np.int64).T
            for name, col in zip(("item", "slot", "ns", "k", "k_last"), cols):
                out[name][: len(col)] = col
        out["bulk_take"] = self.bulk_take
        out["bulk_n"] = self.bulk_n
        return out


def replica_cap_rows(alloc, used_rows, req):
    """replica_cap over slot rows: alloc [T, R] against per-slot used
    [X, R] + k*req [R] -> [X, T] identical replicas, with the same
    exact-fit corrections and validity rules, looped over the resource
    axis as in the reference."""
    X, T = used_rows.shape[0], alloc.shape[0]
    bigf = float(BIGK)
    kmin = torch.full((X, T), bigf, dtype=torch.float32, device=alloc.device)
    valid = torch.ones((X, T), dtype=torch.bool, device=alloc.device)
    for r in range(alloc.shape[1]):
        alloc_r = alloc[None, :, r]
        room = alloc_r - used_rows[:, r:r + 1]
        reqr = req[r]
        safe = reqr > 0
        denom = torch.where(safe, reqr, 1.0)
        kf = torch.clamp(torch.floor(room / denom), 0.0, bigf)
        kf = torch.where((kf + 1.0) * denom <= room, kf + 1.0, kf)
        kf = torch.where(kf * denom > room, kf - 1.0, kf)
        kr = torch.where(safe, torch.clamp(kf, 0.0, bigf), bigf)
        kmin = torch.minimum(kmin, kr)
        valid &= (alloc_r >= 0.0) & ((room >= 0.0) | safe)
    return torch.where(valid, kmin, 0.0).to(torch.int32)


SCREEN_MODES = ("prescreen", "tiered")


def _scan_constants(segments, V, screen_v, type_reqs, type_offering_ok, item_arrays,
                    items_pl, tmpl_reqs, tiered, groups, topo_terms, dev) -> dict:
    """What a scan reads that depends only on the geometry, the class
    planes, the templates and the types: the screen ops and the type rows
    at the screen width, the class planes and, under prescreen, each
    template's verdict row (a plane-neutral item merges as the identity,
    so the row an open writes for it IS its template's), and the node
    filters' triviality per topology group."""
    ops = ScreenOps(segments, V, screen_v)
    WSCR = ops.width
    if items_pl is None:
        items_pl = class_planes(item_arrays, ops)
    tmpl_rows = None
    if not tiered:
        tmpl_rows = ops.rows_vs_items(
            items_pl, tmpl_reqs["allow"], tmpl_reqs["out"], tmpl_reqs["defined"]
        )  # [J, C]
    out = {
        "ops": ops,
        "sm": torch.as_tensor(compat.seg_matrix(segments, V)[:WSCR], device=dev),
        "type_rows": dict(type_reqs, allow=type_reqs["allow"][:, :WSCR]),
        "offer_f": type_offering_ok.to(torch.float32),
        "key_scr": np.asarray([lo < WSCR for (lo, _hi) in segments], dtype=bool),
        "items_pl": items_pl,
        "tmpl_rows": tmpl_rows,
        "nf_trivial": None, "seg_scr": None,
    }
    if groups:
        # a group whose node filter has an empty term (a spread pod with no
        # node selector or affinity) matches every merged row
        term_def = topo_terms["defined"].cpu().numpy()
        out["nf_trivial"] = [
            not gm.filter_term_rows
            or any(not term_def[r].any() for r in gm.filter_term_rows)
            for gm in groups
        ]
        out["seg_scr"] = [gm.seg[0] < WSCR for gm in groups]
    return out


def _item_flags(item_arrays, Q, W, groups) -> dict:
    """Host copies of the per-item flags the scan's control flow reads."""
    out = {
        "valid_h": item_arrays["valid"].cpu().numpy(),
        "scls_h": item_arrays["scls"].cpu().numpy(),
        "defined_h": item_arrays["defined"].cpu().numpy(),
        "has_ports_h": item_arrays["ports"].any(dim=1).cpu().numpy() if Q else None,
        "has_conflict_h": (item_arrays["port_conflict"].any(dim=1).cpu().numpy()
                           if Q else None),
        "has_vols_h": item_arrays["vols"].any(dim=1).cpu().numpy() if W else None,
        "own_h": None, "sel_h": None,
    }
    if groups:
        out["own_h"] = item_arrays["topo_own"].cpu().numpy()
        out["sel_h"] = item_arrays["topo_sel"].cpu().numpy()
    return out


def make_segment_partition_kernel(segments, n_exist: int, screen_v: Optional[int] = None):
    """The segmented scan's partitioner (make_segment_partition_kernel,
    pack.py:410-551): label every verdict-tensor class column with its
    conflict component, so that independent components can be packed as
    separate lanes with the sequential scan's result.

    Two classes conflict when their feasible existing slots intersect (the
    existing prefix of the [N, C] verdict tensor), when their template
    verdicts intersect (both could land on, or open, a machine of one
    template), or when one defines a custom key the other custom-denies
    and their values on that key can meet (a commit that defines the key
    lifts the deny, requirements.go:123-133). Every test is a superset of
    what the scan can route between two classes, so a missing edge proves
    them independent.

    The two Gram products run in float32 on 0/1 counts tested > 0.5 (exact:
    the counts stay far below 2**24); the template rows come from the
    screen kernel (ScreenOps.rows_vs_items). Components are labelled by
    min-label propagation to its fixpoint, each class taking the least
    class index of its component.

    Returns partition(screen0 [N, C], pod_arrays, tmpl, well_known,
    items_pl=None) -> (labels [C] int32, neutral [C] bool: no defined key
    inside the screen width, slot_label [E] int32: the least label of the
    classes feasible on an existing slot, -1 where none is), on the device.
    `items_pl`, when given, is the prescreen's class planes (their prep is
    reused). On a device grid it runs on the lead device, where the
    gathered verdict tensor and the class planes are (the reference's
    partition runs on gathered, replicated operands, pack.py:456)."""
    segments = [tuple(s) for s in segments]

    def partition(screen0, pod_arrays, tmpl, well_known, items_pl=None):
        dev = screen0.device
        V = pod_arrays["allow"].shape[1]
        ops = ScreenOps(segments, V, screen_v)
        if items_pl is None:
            items_pl = class_planes(pod_arrays, ops)
        items = items_pl.planes
        C = items_pl.B
        key_scr = torch.as_tensor(
            np.asarray([lo < ops.width for (lo, _hi) in segments], dtype=bool), device=dev)
        neutral = ~torch.any(items["defined"] & key_scr[None, :], dim=-1)
        tmpl_rows = ops.rows_vs_items(items_pl, tmpl["allow"], tmpl["out"],
                                      tmpl["defined"])  # [J, C]
        conf = compat._count(tmpl_rows.T, tmpl_rows) > 0.5  # [C, C]
        if n_exist:
            a = screen0[:n_exist]
            conf |= compat._count(a.T, a) > 0.5
        # the deny-lift channel, per key: class c defines a custom key k,
        # class c' custom-denies it, and their value sets on k can meet. A
        # key no class defines off the well-known set, or none denies,
        # adds no edge, so only the others are evaluated
        lift_keys = (items["defined"].any(dim=0) & ~well_known
                     & items["custom_deny"].any(dim=0)).cpu().numpy()
        lift = torch.zeros((C, C), dtype=torch.bool, device=dev)
        for k in np.nonzero(lift_keys)[0].tolist():
            lo, hi = segments[k]
            pair = items["defined"][:, k:k + 1] & items["custom_deny"][None, :, k]
            nonempty = items["out"][:, k:k + 1] & items["out"][None, :, k]
            if hi > lo:
                a = items["allow"][:, lo:hi]
                nonempty = nonempty | (compat._count(a, a.T) > 0.5)
            lift |= pair & nonempty
        conf |= lift | lift.T
        conf |= torch.eye(C, dtype=torch.bool, device=dev)
        # connected components by min-label propagation; the fixpoint is
        # reached in at most the components' diameter rounds
        labels = torch.arange(C, dtype=torch.int64, device=dev)
        none = torch.full((), C, dtype=torch.int64, device=dev)
        while True:
            new = torch.where(conf, labels[None, :], none).min(dim=-1).values
            new = torch.minimum(new, labels)
            if not bool((new != labels).any()):
                break
            labels = new
        if n_exist:
            slot_label = torch.where(screen0[:n_exist], labels[None, :], none).min(
                dim=-1).values
            slot_label = torch.where(slot_label == C, -1, slot_label)
        else:
            slot_label = torch.zeros((0,), dtype=torch.int64, device=dev)
        return labels.to(torch.int32), neutral, slot_label.to(torch.int32)

    return partition


def make_pack_kernel(segments, zone_seg, ct_seg, topo_meta: Optional[TopoMeta] = None,
                     screen_v: Optional[int] = None, screen_mode: str = "prescreen"):
    """Build the packing function for a fixed label geometry and, when the
    batch has topology groups, their structure (logged commits).

    screen_mode "prescreen" reads each item's requirement verdicts from a
    column of the [N, C] prescreen tensor, which the commits keep in step
    with the slot planes; "tiered" screens every open slot row against the
    item at its step (the reference's slot_compat_screen) on the screen
    kernel's B = 1 form and keeps no tensor."""
    if screen_mode not in SCREEN_MODES:
        raise ValueError(f"screen_mode must be one of {SCREEN_MODES}, got {screen_mode!r}")
    tiered = screen_mode == "tiered"
    segments = [tuple(s) for s in segments]
    zlo, zhi = zone_seg
    clo, chi = ct_seg
    has_topo = topo_meta is not None and len(topo_meta.groups) > 0
    groups = topo_meta.groups if has_topo else []
    # machine-region bulk fill: with hostname anti-affinity groups (slot-
    # local: the domain is the node) the bulk region widens from the
    # existing prefix to the whole slot axis, with exact per-slot type
    # narrowing for machine rows
    mach_bulk = any(gm.gtype == TOPO_ANTI and gm.is_hostname for gm in groups)
    # value-key spread groups: their owners pack by a per-iteration
    # water-fill over the domains
    vk_spread_gs = [(g, gm) for g, gm in enumerate(groups)
                    if gm.gtype == TOPO_SPREAD and not gm.is_hostname]
    vk_ids = {g for g, _gm in vk_spread_gs}
    host_aff_gs = [g for g, gm in enumerate(groups)
                   if gm.is_hostname and gm.gtype == TOPO_AFFINITY and not gm.is_inverse]

    def pack(
        state: PackState,
        item_arrays: dict,
        f_static: torch.Tensor,  # [J, I, T]
        openable: torch.Tensor,  # [J, I]
        tmpl_reqs: dict,  # [J, ...]
        tmpl_daemon: torch.Tensor,  # [J, R]
        tmpl_type_mask: torch.Tensor,  # [J, T]
        type_reqs: dict,
        type_alloc: torch.Tensor,
        type_capacity: torch.Tensor,
        type_offering_ok: torch.Tensor,
        well_known: Optional[torch.Tensor] = None,
        topo_terms: Optional[dict] = None,
        log_len: int = 0,
        n_exist: int = 0,
        vol_limits: Optional[torch.Tensor] = None,  # [E, D] (inf: no limit)
        vol_driver: Optional[torch.Tensor] = None,  # [W, D] claim -> driver onehot
        screen0: Optional[torch.Tensor] = None,  # [N, C] prescreen tensor
        items_pl: Optional[ScreenItems] = None,  # the class planes, if built
        log_commits: bool = True,
        counts_host: Optional[np.ndarray] = None,  # [I] replica counts, host
        shared: Optional[dict] = None,
        item_ids: Optional[np.ndarray] = None,  # [I] global item id per row, host
        bulk_len: Optional[int] = None,
    ):
        """One scan. log_commits=False is the consolidation replan's rung
        mode: no log is written and no commit waits on log space (so the
        bulk take matrix is one row). counts_host overrides the replica
        counts with a host array (the rung's count row). `shared` is a
        dict the caller keeps across scans of one geometry: its "geo"
        entry holds what depends only on the class planes, templates and
        types, its "items" entry the host copies of the item rows' flags;
        each is computed by the first scan that finds it empty (the K
        subsets of a replan chunk share both, a segmented solve's lanes
        only the first).

        A segmented lane (make_device_run(segment_mode=True)) scans a
        gathered subset of the item axis: `items_pl` is then the class
        planes of the whole axis (the reference's class_planes argument:
        scls_first indexes the whole axis), `item_ids` the global item
        index each row logs, and `bulk_len` the lane's own take-matrix
        budget."""
        dev = state.used.device
        N, V = state.allow.shape
        K = state.out.shape[1]
        J = tmpl_daemon.shape[0]
        I = item_arrays["requests"].shape[0]
        # host-port and volume axes; zero width skips every check
        Q = state.ports.shape[1]
        W = state.vols.shape[1]
        EV = state.vols.shape[0]  # the existing prefix carrying volume state
        G = len(groups)
        pre = shared if shared is not None else {}
        geo = pre.setdefault("geo", {})
        if not geo:
            geo.update(_scan_constants(
                segments, V, screen_v, type_reqs, type_offering_ok, item_arrays,
                items_pl, tmpl_reqs, tiered, groups, topo_terms, dev))
        flags = pre.setdefault("items", {})
        if not flags:
            flags.update(_item_flags(item_arrays, Q, W, groups))
        pre = dict(geo, **flags)
        ops = pre["ops"]
        WSCR = ops.width
        sm, type_rows, offer_f, key_scr = (
            pre["sm"], pre["type_rows"], pre["offer_f"], pre["key_scr"])
        items_pl, tmpl_rows = pre["items_pl"], pre["tmpl_rows"]

        EB = n_exist
        BR = N if mach_bulk else EB  # bulk-fill region
        L = log_len
        if BR == 0 or not log_commits:
            LB = 1
        elif bulk_len is not None:
            # a segmented lane sizes its take matrix to its own items
            LB = max(int(bulk_len), 1)
        elif mach_bulk:
            # take rows per bulk commit: ~2 per plain bulk item plus one per
            # water-fill round of the value-key spread items
            spread_w = sum(gm.seg[1] - gm.seg[0] for _g, gm in vk_spread_gs)
            LB = min(3 * I + spread_w + 64, 2048)
        else:
            LB = min(2 * I + V + 64, 4096)
        log = _Log(L, LB, BR, dev, enabled=log_commits)

        if tiered:
            screen = None
        elif screen0 is not None:
            screen = screen0.clone()  # refreshed in place below
        else:
            screen = ops.initial_screen(
                items_pl, state.allow[:n_exist], state.out[:n_exist],
                state.defined[:n_exist], N,
            )

        # host copies of what the control flow reads per item
        valid_h, scls_h, defined_h = pre["valid_h"], pre["scls_h"], pre["defined_h"]
        count_h = (counts_host if counts_host is not None
                   else item_arrays["count"].cpu().numpy())
        has_ports_h, has_conflict_h, has_vols_h = (
            pre["has_ports_h"], pre["has_conflict_h"], pre["has_vols_h"])
        vol_cnt = None  # [EV, D] mounted claims per driver, rebuilt after a vols write
        own_h, sel_h, nf_trivial, seg_scr = (
            pre["own_h"], pre["sel_h"], pre["nf_trivial"], pre["seg_scr"])
        nopen = int(state.nopen)
        idx_f = torch.arange(N, dtype=torch.float32, device=dev)
        arange_n = torch.arange(N, device=dev)
        ones_v = torch.ones(V, dtype=torch.bool, device=dev)
        true_t = torch.ones((), dtype=torch.bool, device=dev)

        def merged_types_compat(m_allow, m_out, m_defined, base_tmask):
            """[T]: types surviving requirements and offerings for a merged
            row (compatible ∧ hasOffering, machine.go:137-159); resource fit
            is separate (replica caps)."""
            m_allow_s = m_allow[:WSCR]
            m_escape = compat.escape_flags_m(
                m_allow_s[None], m_out[None], m_defined[None], sm
            )[0]
            ok_t = compat.row_vs_rows_compat_m(
                m_allow_s, m_out, m_defined, m_escape, type_rows, sm
            )
            offer_t = torch.einsum(
                "tzc,z,c->t", offer_f,
                m_allow[zlo:zhi].to(torch.float32),
                m_allow[clo:chi].to(torch.float32),
            ) > 0.5
            return base_tmask & ok_t & offer_t

        def mach_rows_types_compat(m_allow_rows, m_out_rows, m_def_rows,
                                   base_tmask_rows):
            """merged_types_compat over slot rows: [X, T]. The hostname tail
            past the screen width is exact to skip (no type defines it)."""
            a = m_allow_rows[:, :WSCR]
            esc = compat.escape_flags_m(a, m_out_rows, m_def_rows, sm)
            ok = torch.ones((a.shape[0], type_alloc.shape[0]), dtype=torch.bool,
                            device=dev)
            for k, (lo, hi) in enumerate(segments):
                if lo >= WSCR:
                    continue
                hi_s = min(hi, WSCR)
                shared = m_def_rows[:, k:k + 1] & type_reqs["defined"][None, :, k]
                nonempty = m_out_rows[:, k:k + 1] & type_reqs["out"][None, :, k]
                if hi_s > lo:
                    nonempty = nonempty | (compat._count(
                        a[:, lo:hi_s], type_rows["allow"][:, lo:hi_s].T) > 0.5)
                escapes = esc[:, k:k + 1] & type_reqs["escape"][None, :, k]
                ok &= (~shared) | nonempty | escapes
            offer = torch.einsum(
                "tzc,nz,nc->nt", offer_f,
                m_allow_rows[:, zlo:zhi].to(torch.float32),
                m_allow_rows[:, clo:chi].to(torch.float32),
            ) > 0.5
            return base_tmask_rows & ok & offer

        # In place of the reference's refresh descriptor (pack.py:1078-1216,
        # which exists only to keep XLA from copying the [N, C] tensor under
        # lax.cond) the rows a commit writes are re-screened here, at commit
        # time, in place, with the screen form the reference's op uses. The
        # tensor is read once per item, at step entry, so what matters is
        # its value there; as pack.py:1091-1095 argues, re-screening a slot
        # row from its current planes always yields the true verdict, and a
        # row written twice in one step keeps the later commit's value, so
        # the entry tensor is the reference's. (Its budget-overflow drain
        # re-screens whole intervals with rows_vs_items; that form and
        # items_vs_row agree unless an item defines a key at or past the
        # screen width, which the encoder's elision rule prevents.)

        for k in LAST_SCAN:
            LAST_SCAN[k] = 0
        for i in range(I):
            count = int(count_h[i])
            if not valid_h[i] or count <= 0:
                continue
            # the scan's proof of life for the dispatch watchdogs: a long
            # scan on a loaded host is slow, not wedged
            supervise.touch_progress()
            LAST_SCAN["items"] += 1
            iid = i if item_ids is None else int(item_ids[i])
            allow_i = item_arrays["allow"][i]
            out_i = item_arrays["out"][i]
            def_i = item_arrays["defined"][i]
            req_i = item_arrays["requests"][i]
            tol_i = item_arrays["tol"][i]
            f_static_p = f_static[:, i, :]  # [J, T]
            openable_p = openable[:, i]  # [J]
            if has_topo:
                own = own_h[i].tolist()
                sel = sel_h[i].tolist()
            else:
                own = sel = []
            # does any group own or select the item? Items outside every
            # group skip the per-group work, which changes nothing for them
            any_topo_i = any(own) or any(sel)
            # an item with no defined screened key and no group on a
            # screened key merges as the identity on the screened planes:
            # its commits cannot change any verdict, so they re-screen
            # nothing (hostname groups narrow only the elided tail)
            plane_mut = bool((defined_h[i] & key_scr).any()) or any(
                (own[g] or sel[g]) and seg_scr[g] for g in range(G))
            # a pod with host ports never runs two replicas on one node: its
            # own entries conflict (hostportusage.go:42-54)
            port_k_cap = 1 if Q and has_ports_h[i] else BIGK
            ports_i = item_arrays["ports"][i] if Q else None
            vols_i = item_arrays["vols"][i] if W else None
            writes_vols = bool(W and has_vols_h[i])
            # node-filter matches are read only for selected direct groups
            # whose filter can fail
            need_nf = any(sel[g] and not nf_trivial[g] and not gm.is_inverse
                          for g, gm in enumerate(groups))

            # -- screen once per item: slots at or past nopen are closed
            # (open is False there), so the screen runs on the prefix
            # [:nopen] and the rest scores BIG. The reference's tiers
            # (pack.py:1412-1426) only size its XLA programs: their
            # prefixes cover nopen and add closed slots, which verdict
            # False either way
            lim = nopen
            if tiered:
                # every open slot row against this item's class row: the
                # B = 1 form, every key evaluated on its clipped segment
                # as the reference's rows_compat_m on allow[:, :screen_v]
                req_l = screen_row(state.allow[:lim], state.out[:lim],
                                   state.defined[:lim], items_pl, int(scls_h[i]),
                                   ops.row_layout)
            else:
                req_l = screen[:lim, int(scls_h[i])]
            sc = (
                state.open[:lim]
                & tol_i[state.tol_idx[:lim].to(torch.int64)]
                & compat.fits(state.used[:lim] + req_i[None, :], state.cap[:lim])
                & req_l
            )
            if any_topo_i:
                sc &= topo_screen(topo_meta, state.tcounts, state.thost[:, :lim],
                                  state.tdoms, own, sel, allow_i, state.allow[:lim])
            if Q and has_conflict_h[i]:
                # host-port conflicts (machine.go:69, existingnode.go:77)
                sc &= ~torch.any(
                    state.ports[:lim] & item_arrays["port_conflict"][i][None, :], dim=-1)
            if W:
                # CSI volume limits on existing slots (existingnode.go:62-
                # 115): the mounted claims per driver plus the item's NEW
                # claims stay within the CSINode limit. 0/1 sums in float32
                # are exact; nopen never falls below EV
                if vol_cnt is None:
                    vol_cnt = state.vols.to(torch.float32) @ vol_driver
                cnt_d = vol_cnt
                if writes_vols:
                    new = vols_i[None, :] & ~state.vols
                    cnt_d = cnt_d + new.to(torch.float32) @ vol_driver
                vol_ok = torch.all(cnt_d <= vol_limits, dim=-1)
                sc[:EV] &= vol_ok
            s0 = torch.where(
                state.is_existing[:lim],
                idx_f[:lim],
                float(N) + state.pods[:lim].to(torch.float32) * N + idx_f[:lim],
            )
            score = torch.full((N,), BIG, dtype=torch.float32, device=dev)
            score[:lim] = torch.where(sc, s0, BIG)

            owned_vk = [g for g, _gm in vk_spread_gs if own[g]]
            n_owned_vk = len(owned_vk)
            owns_vk_spread = n_owned_vk > 0
            owns_nonspread = any(own[g] for g in range(G) if g not in vk_ids)
            # the water-fill is statically provable only when one value-key
            # spread is the item's sole structural constraint; otherwise its
            # plan degrades to the per-pod skew bound
            not_provable = n_owned_vk > 1 or owns_nonspread
            if EB > 0 and has_topo:
                item_bulk_ok = topo_bulk_item_ok(topo_meta, own, sel)
            else:
                item_bulk_ok = EB > 0
            mach_ok_i = mach_bulk and topo_mach_bulk_item_ok(topo_meta, own, sel)
            own_hostaff = any(own[g] for g in host_aff_gs)

            def dom_open_one(lo, hi):
                """[seg]: domains a fresh machine could open in for this
                item (the per-item probe): the template allows the domain
                and some feasible type does, with an available offering
                for zone spread."""
                dom_open = torch.zeros(hi - lo, dtype=torch.bool, device=dev)
                for j in range(J):
                    f_j = f_static_p[j] & tmpl_type_mask[j]
                    type_dom = type_reqs["allow"][:, lo:hi]
                    if (lo, hi) == (zlo, zhi):
                        ct_allow = tmpl_reqs["allow"][j, clo:chi] & allow_i[clo:chi]
                        type_zone_ok = torch.einsum(
                            "tzc,c->tz", offer_f, ct_allow.to(torch.float32)
                        ) > 0.5
                        type_dom = type_dom & type_zone_ok
                    dom_open |= (openable_p[j] & tmpl_reqs["allow"][j, lo:hi]
                                 & (f_j[:, None] & type_dom).any(dim=0))
                return dom_open

            dom_open_by_g = {g: dom_open_one(*gm.seg) for g, gm in vk_spread_gs
                             if own[g]}

            def spread_plan(remaining, dead):
                """The water-fill for the owned value-key spread groups
                (pack.py:1492-1593): the argmin-count live domain d* and a
                commit cap up to the fill level, bounded by the frozen
                domains' minimum plus maxSkew (or, degraded when a budget
                is scarce, by the minimum over all the pod's domains).
                Returns (force[V], cap, blocked, gate[N], dmark[V])."""
                force = ones_v.clone()
                dmark = torch.zeros(V, dtype=torch.bool, device=dev)
                gate = torch.ones(N, dtype=torch.bool, device=dev)
                cands = score < BIG
                limits_finite = (state.remaining < 1e29).any()
                caps = []
                for g in owned_vk:
                    gm = groups[g]
                    lo, hi = gm.seg
                    if hi == lo:
                        # a key no label, requirement or offering mentions:
                        # no domain at all, so blocked (the reference fails
                        # here on an empty argmin; ROADMAP Queue C)
                        caps.append(torch.zeros((), dtype=torch.int32, device=dev))
                        caps.append(true_t)
                        continue
                    pod_dom = allow_i[lo:hi] & state.tdoms[g, lo:hi]
                    dom_cand = (cands[:, None] & state.allow[:, lo:hi]).any(dim=0)
                    live = pod_dom & ~dead[lo:hi] & (dom_cand | dom_open_by_g[g])
                    frozen = pod_dom & ~live
                    cnt = state.tcounts[g, lo:hi]
                    inf = float("inf")
                    minc_frozen = torch.where(frozen, cnt, inf).min()
                    minc_all = torch.where(pod_dom, cnt, inf).min()
                    n_live = live.sum()
                    degraded = (limits_finite | ((N - nopen) < n_live)
                                | ((L - log.ptr) < n_live + 1) | not_provable)
                    level = (
                        torch.where(live, cnt, 0.0).sum()
                        + torch.tensor(float(remaining), dtype=torch.float32, device=dev)
                    ) / torch.clamp(n_live, min=1).to(torch.float32)
                    cntm = torch.where(live, cnt, inf)
                    d_star = torch.argmin(cntm)
                    c_star = cntm[d_star]
                    has_live = live.any()
                    level_cap = torch.clamp(torch.floor(level - c_star), min=1.0)
                    skew = float(gm.max_skew)
                    skew_cap = torch.where(degraded, minc_all + skew - c_star,
                                           minc_frozen + skew - c_star)
                    cap_f = torch.minimum(level_cap, skew_cap)
                    skew_blocked = has_live & (cap_f < 1.0)
                    cap_g = torch.where(
                        skew_blocked | ~has_live, 0,
                        torch.clamp(cap_f, 1.0, float(BIGK)).to(torch.int32),
                    )
                    oh = (torch.arange(hi - lo, device=dev) == d_star) & has_live
                    force[lo:hi] = oh
                    dmark[lo:hi] = oh
                    gate &= state.allow[:, lo + d_star]
                    caps.append(cap_g.to(torch.int32))
                    caps.append(~has_live | skew_blocked)
                vals = torch.stack([c.to(torch.int64) for c in caps]).tolist()
                cap = min([BIGK] + vals[0::2])
                blocked = any(vals[1::2])
                return force, cap, blocked, gate, dmark

            def node_filter(m_allow, m_out, m_defined):
                if not need_nf:
                    return [True] * G
                return topo_node_filter_ok(
                    topo_meta, topo_terms, segments, well_known, m_allow, m_out,
                    m_defined).tolist()

            def record(m_allow, m_out, m_defined, row_mask, k_row):
                """record_topo (pack.py:895-907); a no-op for an item no
                group owns or selects."""
                if any_topo_i:
                    topo_record(topo_meta, state.tcounts, state.thost, state.tdoms,
                                own, sel, node_filter(m_allow, m_out, m_defined),
                                m_allow, m_out, row_mask, k_row)

            def do_candidate(remaining, force, cap, gate, dead):
                nonlocal vol_cnt
                n_t = torch.argmin(score if gate is None else torch.where(gate, score, BIG))
                slot_allow = state.allow[n_t]
                if any_topo_i:
                    t_viable, narrow, applied, k_topo = topo_narrow_single(
                        topo_meta, state.tcounts, state.thost, state.tdoms, own, sel,
                        allow_i, slot_allow, n_t, K, spread_force=force)
                    m_allow = slot_allow & allow_i & narrow
                    m_out = state.out[n_t] & out_i & ~applied
                    m_def = state.defined[n_t] | def_i | applied
                else:
                    t_viable, k_topo = true_t, None
                    m_allow = slot_allow & allow_i
                    m_out = state.out[n_t] & out_i
                    m_def = state.defined[n_t] | def_i
                compat_tmask = merged_types_compat(
                    m_allow, m_out, m_def,
                    state.tmask[n_t] & f_static_p[state.tmpl[n_t].to(torch.int64)],
                )
                used_n = state.used[n_t][None, :]
                kcap_t = replica_cap(type_alloc, used_n, req_i)
                kmax_exist = replica_cap(state.cap[n_t][None, :], used_n, req_i)[0]
                kmax_mach = torch.where(compat_tmask, kcap_t, 0).max()
                kmax_t = torch.where(state.is_existing[n_t], kmax_exist, kmax_mach)
                if k_topo is not None:
                    kmax_t = torch.minimum(kmax_t, k_topo)
                if port_k_cap < BIGK:
                    kmax_t = torch.clamp(kmax_t, max=port_k_cap)
                n, kmax, is_ex, viable = torch.stack([
                    n_t, kmax_t.to(torch.int64),
                    state.is_existing[n_t].to(torch.int64), t_viable.to(torch.int64),
                ]).tolist()
                kmax = min(kmax, BIGK)
                k = min(remaining, kmax, cap)
                do = bool(viable) and kmax >= 1 and k >= 1 and log.has_room()
                if do:
                    tmask_k = compat_tmask & (kcap_t >= k)
                    state.used[n] = state.used[n] + float(k) * req_i
                    state.pods[n] += k
                    state.allow[n] = m_allow
                    state.out[n] = m_out
                    state.defined[n] = m_def
                    if not is_ex:
                        state.tmask[n] = tmask_k
                        state.cap[n] = _segment_max_alloc(tmask_k, type_alloc)
                    if Q:
                        state.ports[n] |= ports_i
                    if writes_vols and n < EV:
                        # only the existing prefix carries volume state
                        state.vols[n] |= vols_i
                        vol_cnt = None
                    row_mask = arange_n == n
                    record(m_allow, m_out, m_def, row_mask,
                           torch.where(row_mask, k, 0).to(torch.int32))
                    log.write(iid, n, 1, k, k)
                    remaining -= k
                    if plane_mut and not tiered:
                        screen[n] = ops.items_vs_row(
                            items_pl, state.allow[n], state.out[n], state.defined[n]
                        )
                # retire on failure or when filled to capacity; a commit cut
                # only by the water-fill cap leaves the slot for a later round
                if not do or k >= kmax:
                    score[n] = BIG
                return remaining, False, dead

            def do_bulk(remaining, dead):
                """Every candidate of the bulk region in one commit, filled
                in index order (existing prefix) or, over the machine
                region, in score order, under per-slot caps
                (scheduler.go:179-193). Rows at or past nopen are closed and
                take nothing, so the work stops at min(BR, nopen). A spread
                group always has a node filter, which keeps its owners off
                the bulk paths, so no water-fill plan (force, cap, gate)
                reaches here."""
                nonlocal vol_cnt
                BRo = min(BR, nopen)
                sa = state.allow[:BRo]
                cands = score[:BRo] < BIG
                if not mach_ok_i:
                    cands &= state.is_existing[:BRo]
                if any_topo_i:
                    thost_e = state.thost[:, :BRo]
                    viable = topo_screen(topo_meta, state.tcounts, thost_e, state.tdoms,
                                         own, sel, allow_i, sa)
                    narrow, applied, k_topo_e = topo_bulk_narrow(
                        topo_meta, state.tcounts, thost_e, state.tdoms, own, sel,
                        allow_i, K)
                    # owned narrowed domains must stay reachable per slot
                    for g, gm in enumerate(groups):
                        if (gm.is_hostname or gm.is_inverse or not own[g]
                                or gm.gtype == TOPO_ANTI):
                            continue
                        lo, hi = gm.seg
                        viable &= (sa[:, lo:hi] & narrow[lo:hi]).any(dim=-1)
                    m_allow_rows = sa & (allow_i & narrow)[None, :]
                    m_out_rows = state.out[:BRo] & (out_i & ~applied)[None, :]
                    m_def_rows = state.defined[:BRo] | (def_i | applied)[None, :]
                else:
                    viable, k_topo_e = None, None
                    m_allow_rows = sa & allow_i[None, :]
                    m_out_rows = state.out[:BRo] & out_i[None, :]
                    m_def_rows = state.defined[:BRo] | def_i[None, :]
                KEW = min(EB, BRo) if mach_bulk else BRo
                k_slot = replica_cap(state.cap[:KEW], state.used[:KEW], req_i)
                if mach_bulk:
                    # exact surviving types for machine rows (the bulk analog
                    # of the candidate verify); the existing prefix keeps its
                    # fixed capacity
                    MW = BRo - KEW
                    if mach_ok_i and MW > 0:
                        tmask_rows = mach_rows_types_compat(
                            m_allow_rows[KEW:], m_out_rows[KEW:], m_def_rows[KEW:],
                            state.tmask[KEW:BRo]
                            & f_static_p[state.tmpl[KEW:BRo].to(torch.int64)],
                        )
                        kcap_rows = replica_cap_rows(type_alloc, state.used[KEW:BRo], req_i)
                        k_mach = torch.where(tmask_rows, kcap_rows, 0).max(dim=-1).values
                    else:
                        k_mach = torch.zeros(MW, dtype=torch.int32, device=dev)
                    k_slot = torch.cat([k_slot, k_mach])
                ok = cands if viable is None else cands & viable
                k_slot = k_slot if k_topo_e is None else torch.minimum(k_slot, k_topo_e)
                k_eff = torch.where(ok, torch.clamp(k_slot, max=min(BIGK, port_k_cap)),
                                    0).to(torch.int32)
                budget = remaining
                if mach_bulk:
                    # take in score order (existing rank before machines) so a
                    # small budget lands where the candidate loop would put it
                    order = torch.argsort(torch.where(k_eff > 0, score[:BRo], BIG),
                                          stable=True)
                    k_ord = k_eff[order]
                    csum = torch.cumsum(k_ord, dim=0, dtype=torch.int32)
                    take_o = torch.minimum(torch.clamp(budget - (csum - k_ord), min=0),
                                           k_ord).to(torch.int32)
                    take = torch.zeros_like(k_eff).scatter_(0, order, take_o)
                else:
                    csum = torch.cumsum(k_eff, dim=0, dtype=torch.int32)
                    take = torch.minimum(torch.clamp(budget - (csum - k_eff), min=0),
                                         k_eff).to(torch.int32)
                placed = int(take.sum())
                do = placed >= 1 and log.has_room() and log.bulk_room()
                if do:
                    touched = take > 0
                    tm = touched[:, None]
                    state.used[:BRo] = (
                        state.used[:BRo]
                        + take[:, None].to(torch.float32) * req_i[None, :]
                    )
                    state.pods[:BRo] += take
                    state.allow[:BRo] = torch.where(tm, m_allow_rows, sa)
                    state.out[:BRo] = torch.where(tm, m_out_rows, state.out[:BRo])
                    state.defined[:BRo] = torch.where(tm, m_def_rows, state.defined[:BRo])
                    if Q:
                        state.ports[:BRo] |= tm & ports_i[None, :]
                    if writes_vols:
                        EVB = min(EV, BRo)
                        state.vols[:EVB] |= tm[:EVB] & vols_i[None, :]
                        vol_cnt = None
                    if mach_bulk and mach_ok_i and BRo > KEW:
                        # touched machine rows narrow their types to those
                        # that fit the committed replicas
                        rows = torch.nonzero(touched[KEW:]).flatten()
                        new_tm = tmask_rows[rows] & (kcap_rows[rows] >= take[KEW + rows, None])
                        state.tmask[KEW + rows] = new_tm
                        state.cap[KEW + rows] = _segment_max_alloc(new_tm, type_alloc)
                    if any_topo_i:
                        topo_record_bulk(topo_meta, state.tcounts, state.thost,
                                         state.tdoms, own, sel, m_allow_rows,
                                         m_out_rows, take)
                    log.write_bulk(iid, take, BRo, placed)
                    remaining -= placed
                    if plane_mut and not tiered:
                        rows = torch.nonzero(touched).flatten()
                        screen[rows] = ops.rows_vs_items(
                            items_pl, state.allow[rows], state.out[rows],
                            state.defined[rows],
                        )
                    retire = cands & ((k_eff == 0) | (take >= k_eff))
                else:
                    retire = cands
                score[:BRo] = torch.where(retire, BIG, score[:BRo])
                # fused open: no candidate left at all -> open in the same
                # iteration
                live = score < BIG
                exist_left, mach_cand = torch.stack([
                    (live & state.is_existing).any(), (live & ~state.is_existing).any()
                ]).tolist()
                if do and not exist_left and not mach_cand and remaining > 0:
                    return open_commit(remaining, None, BIGK, None, dead)
                return remaining, False, dead

            def open_commit(remaining, force, cap, dmark, dead):
                """Bulk-open s fresh slots with m replicas each, from the
                first template that can host the item (weight order)."""
                nonlocal nopen
                cap_ok = torch.all(
                    type_capacity[None, :, :] <= state.remaining[:, None, :], dim=-1
                )  # [J, T]
                slot_n = min(nopen, N - 1)
                viab, allows, outs, defs, compats, kcaps, ktopos = (
                    [], [], [], [], [], [], [])
                for j in range(J):
                    fresh_allow = tmpl_reqs["allow"][j]
                    m_allow_j = fresh_allow & allow_i
                    m_out_j = tmpl_reqs["out"][j] & out_i
                    m_def_j = tmpl_reqs["defined"][j] | def_i
                    tv = true_t
                    if any_topo_i:
                        tv, tnarrow, tkeys, k_topo_j = topo_narrow_single(
                            topo_meta, state.tcounts, state.thost, state.tdoms, own,
                            sel, allow_i, fresh_allow, slot_n, K, spread_force=force)
                        m_allow_j = m_allow_j & tnarrow
                        m_out_j = m_out_j & ~tkeys
                        m_def_j = m_def_j | tkeys
                        ktopos.append(k_topo_j)
                    compat_j = merged_types_compat(
                        m_allow_j, m_out_j, m_def_j,
                        tmpl_type_mask[j] & cap_ok[j] & f_static_p[j],
                    )
                    kcap_j = replica_cap(type_alloc, tmpl_daemon[j][None, :], req_i)
                    viab.append(tv & (compat_j & (kcap_j >= 1)).any())
                    allows.append(m_allow_j)
                    outs.append(m_out_j)
                    defs.append(m_def_j)
                    compats.append(compat_j)
                    kcaps.append(kcap_j)
                can_open_j = torch.stack(viab) & openable_p
                jc_t = torch.argmax(can_open_j.to(torch.uint8))
                compat_o = torch.stack(compats)[jc_t]
                kcap_o = torch.stack(kcaps)[jc_t]
                m_eff_t = torch.where(compat_o, kcap_o, 0).max()
                if ktopos:
                    m_eff_t = torch.minimum(m_eff_t, torch.stack(ktopos)[jc_t])
                m_eff_t = torch.clamp(m_eff_t, 0, min(BIGK, port_k_cap))
                # provisioner-limit slot budget: pessimistic max capacity
                # over the k >= 1 types (scheduler.go:276-293)
                tmask_1 = compat_o & (kcap_o >= 1)
                max_cap = torch.where(tmask_1[:, None], type_capacity, -BIG).max(dim=0).values
                max_cap = torch.clamp(max_cap, min=0.0)
                lim_r = state.remaining[jc_t]
                s_lim_r = torch.where(
                    max_cap > 0,
                    torch.floor(lim_r / torch.where(max_cap > 0, max_cap, 1.0)),
                    float(BIGK),
                )
                s_limit_t = torch.clamp(s_lim_r.min(), 0.0, float(BIGK)).to(torch.int64)
                jc, m_eff, s_limit, can_any = torch.stack([
                    jc_t, m_eff_t.to(torch.int64), s_limit_t,
                    can_open_j.any().to(torch.int64),
                ]).tolist()
                # the water-fill cap bounds this iteration's share
                target = min(remaining, cap)
                s_need = (target + max(m_eff, 1) - 1) // max(m_eff, 1)
                s = min(s_need, N - nopen, s_limit)
                if own_hostaff:
                    # a hostname-affinity owner's replicas co-locate on the
                    # seeded host: never more than one fresh slot
                    s = min(s, 1)
                can = bool(can_any) and m_eff >= 1 and s >= 1 and log.has_room()
                if not can:
                    # a single owned spread group retires the forced domain
                    # and retries the next; anything else is stuck
                    if dmark is not None and n_owned_vk == 1:
                        dead = dead | dmark
                    return remaining, n_owned_vk != 1, dead
                placed = min(target, s * m_eff)
                k_last = placed - (s - 1) * m_eff
                lo, hi = nopen, nopen + s
                m_allow_o, m_out_o, m_def_o = allows[jc], outs[jc], defs[jc]
                tmask_full = compat_o & (kcap_o >= m_eff)
                tmask_last = compat_o & (kcap_o >= k_last)
                k_row = torch.full((s,), m_eff, dtype=torch.int32, device=dev)
                k_row[-1] = k_last
                state.used[lo:hi] = (
                    tmpl_daemon[jc][None, :]
                    + k_row[:, None].to(torch.float32) * req_i[None, :]
                )
                state.open[lo:hi] = True
                state.is_existing[lo:hi] = False
                state.tmpl[lo:hi] = jc
                state.tol_idx[lo:hi] = jc
                state.pods[lo:hi] = k_row
                state.allow[lo:hi] = m_allow_o
                state.out[lo:hi] = m_out_o
                state.defined[lo:hi] = m_def_o
                state.tmask[lo:hi - 1] = tmask_full
                state.tmask[hi - 1] = tmask_last
                state.cap[lo:hi - 1] = _segment_max_alloc(tmask_full, type_alloc)
                state.cap[hi - 1] = _segment_max_alloc(tmask_last, type_alloc)
                state.remaining[jc] = state.remaining[jc] - float(s) * max_cap
                if Q:
                    state.ports[lo:hi] = ports_i
                nopen = hi
                if any_topo_i:
                    row_mask = (arange_n >= lo) & (arange_n < hi)
                    k_full = torch.zeros(N, dtype=torch.int32, device=dev)
                    k_full[lo:hi] = k_row
                    record(m_allow_o, m_out_o, m_def_o, row_mask, k_full)
                log.write(iid, lo, s, m_eff, k_last)
                remaining -= placed
                # opened slots become candidates for later fill rounds
                score[lo:hi] = float(N) + k_row.to(torch.float32) * N + idx_f[lo:hi]
                if tiered:
                    return remaining, False, dead  # no tensor to keep in step
                if s > min(64, N):
                    # the reference re-screens wide opens row by row
                    screen[lo:hi] = ops.rows_vs_items(
                        items_pl, m_allow_o[None], m_out_o[None], m_def_o[None]
                    )
                elif plane_mut:
                    screen[lo:hi] = ops.items_vs_row(
                        items_pl, m_allow_o, m_out_o, m_def_o
                    )
                else:
                    screen[lo:hi] = tmpl_rows[jc]
                return remaining, False, dead

            remaining = count
            exhausted = False
            tries = 0
            dead = torch.zeros(V, dtype=torch.bool, device=dev)
            # backstop only: commits consume count, failed verifies retire
            # slots (<= N), failed opens end the item or retire a domain
            while remaining > 0 and not exhausted and tries < count + N + V + 64:
                tries += 1
                supervise.touch_progress()
                force, cap, gate, dmark = None, BIGK, None, None
                if owns_vk_spread:
                    force, cap, blocked, gate, dmark = spread_plan(remaining, dead)
                    if blocked:
                        # the reference's blocked iteration commits nothing
                        # (its cap is 0) and ends the item
                        break
                live = score < BIG
                if gate is not None:
                    live &= gate
                flags = [live.any(), (live & state.is_existing).any()]
                if BR > 0 and has_topo and any(own):
                    flags.append(topo_bulk_need_seed(topo_meta, state.tcounts,
                                                     state.tdoms, own, allow_i))
                has_cand, exist_cand, *seed = torch.stack(flags).tolist()
                use_bulk = (
                    BR > 0
                    and ((item_bulk_ok and exist_cand) or (mach_ok_i and has_cand))
                    and not any(seed)
                    and log.bulk_room()
                )
                if use_bulk:
                    LAST_SCAN["bulk"] += 1
                    remaining, exhausted, dead = do_bulk(remaining, dead)
                elif has_cand:
                    LAST_SCAN["candidate"] += 1
                    remaining, exhausted, dead = do_candidate(
                        remaining, force, cap, gate, dead)
                else:
                    LAST_SCAN["open"] += 1
                    remaining, exhausted, dead = open_commit(
                        remaining, force, cap, dmark, dead)

        state = state._replace(
            nopen=torch.tensor(nopen, dtype=torch.int32, device=dev)
        )
        return state, log.arrays(), log.ptr

    return pack


def make_replan_verdict_kernel(n_exist: int):
    """Per-subset verdict of the batched consolidation replan
    (solver/replan.py), reduced on the device: how many pods the rung
    re-packed, how many it had to, how many new machine slots opened, and
    whether an uninitialized existing node took pods (inconclusive), as
    int32 [4]. The caller fetches [K, 4], never the [K, N] slot plane."""

    def verdict(pods_per_slot, count_row, uninit):
        scheduled = pods_per_slot.sum()
        expected = count_row.sum()
        n_new = (pods_per_slot[n_exist:] > 0).sum()
        incon = (pods_per_slot[:n_exist] * uninit[:n_exist]).sum() > 0
        return torch.stack(
            [scheduled, expected, n_new, incon.to(torch.int64)]
        ).to(torch.int32)

    return verdict


# the last replan chunk's work: subsets scanned and skipped, and the scans'
# items and while-iterations per branch, summed
LAST_REPLAN = {"subsets": 0, "skipped": 0, "items": 0, "bulk": 0, "candidate": 0,
               "open": 0}


def make_batched_replan_kernel(rung_run, n_exist: int):
    """The batched consolidation replan: K candidate subsets of one union
    snapshot, each re-packed by a rung-mode solve program
    (torch_solver.make_device_run(..., rung_mode=True)). Subset k closes
    its victims' existing slots (exist_open[k] False) and activates their
    pods' replica counts (count_rows[k]).

    The candidate axis enters only through those two planes, so what does
    not depend on it (the feasibility planes, the openable mask, the class
    planes and screen ops, the template verdict rows) is computed by the
    first scan of the call and shared by the rest (`shared`). Every subset
    scans its own copy of the slot state and of the [N, C] verdict tensor
    (the caller's screen0, which no subset writes; None under the tiered
    screen, so the reference's external_screen flag has nothing to
    choose here). A subset with no active pod (the chunk's pad rungs
    among them) re-packs nothing, so it is not scanned: its row is the
    zero verdict and zero slot counts, what its scan would leave.

    Returns replan(count_rows [K, I] int32 (host), exist_open [K, E] bool
    (host), uninit [E] bool, screen0, *run_args, items_pl=None) ->
    (pods_per_slot [K, N] int32, verdicts [K, 4] int32), on the device."""
    verdict_of = make_replan_verdict_kernel(n_exist)

    def replan(count_rows, exist_open, uninit, screen0, *run_args, items_pl=None):
        K = int(count_rows.shape[0])
        dev = uninit.device
        counts_dev = torch.from_numpy(np.ascontiguousarray(count_rows)).to(dev)
        open_dev = torch.from_numpy(np.ascontiguousarray(exist_open)).to(dev)
        shared: dict = {}
        for k in LAST_REPLAN:
            LAST_REPLAN[k] = 0
        pods = torch.zeros((K, rung_run.n_slots), dtype=torch.int32, device=dev)
        verdicts = torch.zeros((K, 4), dtype=torch.int32, device=dev)
        for r in range(K):
            if not (count_rows[r] > 0).any():
                LAST_REPLAN["skipped"] += 1
                continue
            LAST_REPLAN["subsets"] += 1
            _log, _ptr, state = rung_run(
                count_rows[r], open_dev[r], screen0,
                *run_args, items_pl=items_pl, shared=shared)
            for key in ("items", "bulk", "candidate", "open"):
                LAST_REPLAN[key] += LAST_SCAN[key]
            pods[r] = state.pods
            verdicts[r] = verdict_of(state.pods, counts_dev[r], uninit)
        return pods, verdicts

    return replan
