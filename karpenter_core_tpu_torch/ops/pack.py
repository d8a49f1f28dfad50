"""Greedy packing over FFD-ordered items, in eager PyTorch.

The port of karpenter_core_tpu/ops/pack.py for the generic batch: no
topology groups, no host-port or volume lanes (Q = W = 0), the prescreen
screen mode and a logged commit sequence. It replaces the serial Solve loop
(scheduler.go:96-133,177-222) with a scan over a fixed budget of node slots:

  slot state: accumulated requests, merged requirement masks, remaining
  instance-type mask, optimistic capacity, pod count.

Per item (one pod spec class with a replica count):
  1. SCREEN all slots: taints ∧ requirement verdict (a column of the [N, C]
     prescreen tensor) ∧ optimistic fit.
  2. Rank candidates: existing nodes by index first, then open machines by
     ascending pod count (scheduler.go:179-193).
  3. Fill existing nodes in one bulk commit, VERIFY and commit to the best
     candidate, or OPEN fresh slots from the first template that can host
     the item (weight order, scheduler.go:195-221) within provisioner limits
     (scheduler.go:276-293).

The reference's lax.scan is a Python loop here, and its lax.while_loop and
lax.cond are Python control flow on small scalars read from the device.
Every float is computed with the reference's operations in the reference's
order, one float32 op at a time, so slot state matches bit for bit. The
commit log keeps the reference's layout (item, slot, ns, k, k_last,
bulk_take, bulk_n) and budgets, so it decodes with the same expand_log.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from karpenter_core_tpu_torch.ops import compat
from karpenter_core_tpu_torch.ops.screen import ScreenItems, ScreenLayout, screen_block

BIG = 1e30  # float32(1e30) once it meets a float32 tensor
BIGK = 2**30


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
    tcounts: torch.Tensor  # [0, V] topology lanes (not in this slice)
    thost: torch.Tensor  # [0, N]
    tdoms: torch.Tensor  # [0, V]
    ports: torch.Tensor  # [N, 0]
    vols: torch.Tensor  # [E, 0]


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


def make_prescreen_kernel(segments, n_slots: int, screen_v: Optional[int] = None):
    """(pod item planes, existing planes) -> [N, C] slot-major verdicts over
    the deduped class columns (make_prescreen_kernel, single device)."""
    segments = [tuple(s) for s in segments]

    def prescreen(pod_arrays, exist):
        V = pod_arrays["allow"].shape[1]
        ops = ScreenOps(segments, V, screen_v)
        return ops.initial_screen(
            class_planes(pod_arrays, ops), exist["allow"], exist["out"],
            exist["defined"], n_slots,
        )

    return prescreen


class _Log:
    """The commit log on the host (its scalars are host values already:
    the scan's control flow reads them), with the bulk take matrix on the
    device. Layout and budgets are the reference's (pack.py:963-1000)."""

    def __init__(self, L: int, LB: int, BR: int, device):
        self.L = L
        self.LB = LB
        self.rows: List[tuple] = []  # (item, slot, ns, k, k_last)
        self.bulk_take = torch.zeros((LB, BR), dtype=torch.int32, device=device)
        self.bulk_n = 0

    @property
    def ptr(self) -> int:
        return len(self.rows)

    def has_room(self) -> bool:
        return self.ptr < self.L

    def write(self, item, slot, ns, k, k_last) -> None:
        self.rows.append((item, slot, ns, k, k_last))

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


def make_pack_kernel(segments, zone_seg, ct_seg, screen_v: Optional[int] = None):
    """Build the packing function for a fixed label geometry (the generic
    slice of make_pack_kernel: prescreen mode, no topology, Q = W = 0,
    logged commits)."""
    segments = [tuple(s) for s in segments]
    zlo, zhi = zone_seg
    clo, chi = ct_seg

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
        log_len: int,
        n_exist: int,
        screen0: Optional[torch.Tensor] = None,  # [N, C] prescreen tensor
    ):
        if state.tcounts.shape[0] or state.ports.shape[1] or state.vols.shape[1]:
            raise NotImplementedError(
                "topology, host-port and volume lanes are not ported yet "
                "(ROADMAP Queue A items 7-8)"
            )
        dev = state.used.device
        N, V = state.allow.shape
        K = state.out.shape[1]
        J = tmpl_daemon.shape[0]
        I = item_arrays["requests"].shape[0]
        ops = ScreenOps(segments, V, screen_v)
        WSCR = ops.width
        sm = torch.as_tensor(compat.seg_matrix(segments, V)[:WSCR], device=dev)
        type_rows = dict(type_reqs, allow=type_reqs["allow"][:, :WSCR])
        offer_f = type_offering_ok.to(torch.float32)
        key_scr = np.asarray([lo < WSCR for (lo, _hi) in segments], dtype=bool)

        EB = n_exist
        BR = EB  # bulk-fill region: the existing prefix
        L = log_len
        LB = 1 if BR == 0 else min(2 * I + V + 64, 4096)
        log = _Log(L, LB, BR, dev)

        items_pl = class_planes(item_arrays, ops)
        if screen0 is not None:
            screen = screen0.clone()  # refreshed in place below
        else:
            screen = ops.initial_screen(
                items_pl, state.allow[:n_exist], state.out[:n_exist],
                state.defined[:n_exist], N,
            )
        # per-template verdict rows, computed once per solve: a plane-
        # neutral item merges as the identity, so the row an open writes
        # for it IS its template's planes
        tmpl_rows = ops.rows_vs_items(
            items_pl, tmpl_reqs["allow"], tmpl_reqs["out"], tmpl_reqs["defined"]
        )  # [J, C]

        # host copies of what the control flow reads per item
        valid_h = item_arrays["valid"].cpu().numpy()
        count_h = item_arrays["count"].cpu().numpy()
        scls_h = item_arrays["scls"].cpu().numpy()
        defined_h = item_arrays["defined"].cpu().numpy()
        nopen = int(state.nopen)
        idx_f = torch.arange(N, dtype=torch.float32, device=dev)
        arange_j = torch.arange(J, device=dev)

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

        for i in range(I):
            count = int(count_h[i])
            if not valid_h[i] or count <= 0:
                continue
            allow_i = item_arrays["allow"][i]
            out_i = item_arrays["out"][i]
            def_i = item_arrays["defined"][i]
            req_i = item_arrays["requests"][i]
            tol_i = item_arrays["tol"][i]
            f_static_p = f_static[:, i, :]  # [J, T]
            openable_p = openable[:, i]  # [J]
            plane_mut = bool((defined_h[i] & key_scr).any())

            # -- screen once per item: slots at or past nopen are closed
            lim = nopen
            sc = (
                state.open[:lim]
                & tol_i[state.tol_idx[:lim].to(torch.int64)]
                & compat.fits(state.used[:lim] + req_i[None, :], state.cap[:lim])
                & screen[:lim, int(scls_h[i])]
            )
            s0 = torch.where(
                state.is_existing[:lim],
                idx_f[:lim],
                float(N) + state.pods[:lim].to(torch.float32) * N + idx_f[:lim],
            )
            score = torch.full((N,), BIG, dtype=torch.float32, device=dev)
            score[:lim] = torch.where(sc, s0, BIG)

            def do_candidate(remaining):
                n_t = torch.argmin(score)
                m_allow = state.allow[n_t] & allow_i
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
                n, kmax, is_ex = torch.stack([
                    n_t, kmax_t.to(torch.int64),
                    state.is_existing[n_t].to(torch.int64),
                ]).tolist()
                kmax = min(kmax, BIGK)
                k = min(remaining, kmax)
                do = kmax >= 1 and k >= 1 and log.has_room()
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
                    log.write(i, n, 1, k, k)
                    remaining -= k
                    if plane_mut:
                        screen[n] = ops.items_vs_row(
                            items_pl, state.allow[n], state.out[n], state.defined[n]
                        )
                if not do or k >= kmax:
                    score[n] = BIG  # retire: failed, or filled to capacity
                return remaining, False

            def do_bulk(remaining):
                """All existing candidates in one commit, filled in index
                order under per-slot caps (scheduler.go:179-185)."""
                cands = (score[:BR] < BIG) & state.is_existing[:BR]
                k_e = replica_cap(state.cap[:BR], state.used[:BR], req_i)
                k_eff = torch.where(cands, torch.clamp(k_e, max=BIGK), 0)
                csum = torch.cumsum(k_eff, dim=0, dtype=torch.int32)
                take = torch.minimum(
                    torch.clamp(remaining - (csum - k_eff), min=0), k_eff
                ).to(torch.int32)
                placed = int(take.sum())
                do = placed >= 1 and log.has_room() and log.bulk_n < LB
                if do:
                    touched = take > 0
                    tm = touched[:, None]
                    state.used[:BR] = (
                        state.used[:BR]
                        + take[:, None].to(torch.float32) * req_i[None, :]
                    )
                    state.pods[:BR] += take
                    state.allow[:BR] = torch.where(
                        tm, state.allow[:BR] & allow_i[None, :], state.allow[:BR]
                    )
                    state.out[:BR] = torch.where(
                        tm, state.out[:BR] & out_i[None, :], state.out[:BR]
                    )
                    state.defined[:BR] = torch.where(
                        tm, state.defined[:BR] | def_i[None, :], state.defined[:BR]
                    )
                    log.bulk_take[log.bulk_n] = take
                    log.write(i, 0, -1, log.bulk_n, placed)
                    log.bulk_n += 1
                    remaining -= placed
                    if plane_mut:
                        rows = torch.nonzero(touched).flatten()
                        screen[rows] = ops.rows_vs_items(
                            items_pl, state.allow[rows], state.out[rows],
                            state.defined[rows],
                        )
                    retire = cands & ((k_eff == 0) | (take >= k_eff))
                else:
                    retire = cands
                score[:BR] = torch.where(retire, BIG, score[:BR])
                # fused open: no candidate left at all -> open in the same
                # iteration
                live = score < BIG
                exist_left, mach_cand = torch.stack([
                    (live & state.is_existing).any(), (live & ~state.is_existing).any()
                ]).tolist()
                if do and not exist_left and not mach_cand and remaining > 0:
                    return open_commit(remaining)
                return remaining, False

            def open_commit(remaining):
                """Bulk-open s fresh slots with m replicas each."""
                nonlocal nopen
                cap_ok = torch.all(
                    type_capacity[None, :, :] <= state.remaining[:, None, :], dim=-1
                )  # [J, T]
                viab, allows, outs, defs, compats, kcaps = [], [], [], [], [], []
                for j in range(J):
                    m_allow_j = tmpl_reqs["allow"][j] & allow_i
                    m_out_j = tmpl_reqs["out"][j] & out_i
                    m_def_j = tmpl_reqs["defined"][j] | def_i
                    compat_j = merged_types_compat(
                        m_allow_j, m_out_j, m_def_j,
                        tmpl_type_mask[j] & cap_ok[j] & f_static_p[j],
                    )
                    kcap_j = replica_cap(type_alloc, tmpl_daemon[j][None, :], req_i)
                    viab.append((compat_j & (kcap_j >= 1)).any())
                    allows.append(m_allow_j)
                    outs.append(m_out_j)
                    defs.append(m_def_j)
                    compats.append(compat_j)
                    kcaps.append(kcap_j)
                can_open_j = torch.stack(viab) & openable_p
                jc_t = torch.argmax(can_open_j.to(torch.uint8))
                compat_o = torch.stack(compats)[jc_t]
                kcap_o = torch.stack(kcaps)[jc_t]
                m_eff_t = torch.clamp(torch.where(compat_o, kcap_o, 0).max(), 0, BIGK)
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
                s_need = (remaining + max(m_eff, 1) - 1) // max(m_eff, 1)
                s = min(s_need, N - nopen, s_limit)
                can = bool(can_any) and m_eff >= 1 and s >= 1 and log.has_room()
                if not can:
                    return remaining, True  # exhausted: nothing can open
                placed = min(remaining, s * m_eff)
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
                nopen = hi
                log.write(i, lo, s, m_eff, k_last)
                remaining -= placed
                # opened slots become candidates for later fill rounds
                score[lo:hi] = float(N) + k_row.to(torch.float32) * N + idx_f[lo:hi]
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
                return remaining, False

            remaining = count
            exhausted = False
            tries = 0
            # backstop only: commits consume count, failed verifies retire
            # slots (<= N), failed opens end the item
            while remaining > 0 and not exhausted and tries < count + N + V + 64:
                live = score < BIG
                has_cand, exist_cand = torch.stack([
                    live.any(), (live & state.is_existing).any()
                ]).tolist()
                if BR > 0 and exist_cand and log.bulk_n < LB:
                    remaining, exhausted = do_bulk(remaining)
                elif has_cand:
                    remaining, exhausted = do_candidate(remaining)
                else:
                    remaining, exhausted = open_commit(remaining)
                tries += 1

        state = state._replace(
            nopen=torch.tensor(nopen, dtype=torch.int32, device=dev)
        )
        return state, log.arrays(), log.ptr

    return pack
