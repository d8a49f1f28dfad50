"""The pack scan as one device program: ``csrc/pack_scan.cu``.

The eager scan (ops/pack.py make_pack_kernel.pack) steps the FFD items
from the host: every branch decision is a read from the card and every
commit that rewrites a slot row re-screens it with a screen launch. The
kernel walks the items on the card in one launch instead, one thread
block per scan: the slot screen of each item, the per-item loop with its
bulk, candidate and open branches, the commit log under its budgets and,
after each commit that changes a screened plane, the re-screen of the
written slot row against every class column (csrc/screen_dev.cuh), with
the topology lanes: the groups' viability, narrowing, water-fill and
counts (ops/topology.py), and the bulk fill over the whole slot axis
under hostname anti-affinity. It takes every scan under the prescreen
that writes a commit log (ops/pack.kernel_routes); a segmented solve's
lanes are its batch axis, B scans in one launch.

The scan's logic is written once, in ``csrc/pack_scan_body.h``, against
a few block primitives; ``csrc/pack_scan.cu`` defines them for a CUDA
thread block and ``csrc/pack_scan_host.cpp`` as serial loops. That CPU
build is loaded only by the tests (``host=True``), which hold it bit for
bit against the reference on the CPU; the solver never loads it.

``run`` lays out and checks the arguments, stacks each scan's initial
state into [B, ...] tensors, makes one launch and one synchronising read
(the commit logs and scalars, packed into one int32 tensor), and returns
per scan the (log, ptr, PackState) that make_pack_kernel.pack returns,
the state and the bulk take matrix still on the card. The plain version
is the eager scan, which the solver runs itself off the kernel's route;
``run`` refuses CPU tensors unless asked for the CPU build. A build, load
or launch failure raises KernelError; nothing falls back.
"""
from __future__ import annotations

import ctypes
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from karpenter_core_tpu_torch.ops import pack as tpack
from karpenter_core_tpu_torch.ops import screen as screen_ops
from karpenter_core_tpu_torch.ops.cuda_build import KernelError
from karpenter_core_tpu_torch.ops.topology import TOPO_ANTI, TOPO_SPREAD
from karpenter_core_tpu_torch.utils import supervise

HDR = 8  # per scan: ptr, bulk_n, nopen, items, bulk, candidate, open, -
THREADS = 512  # threads per scan's block (csrc/pack_scan.cu)

_SIZES = ("B", "N", "V", "K", "R", "T", "J", "I", "M", "C", "Q", "W", "D", "EV", "E", "L",
          "LB", "WSCR", "zlo", "zhi", "clo", "chi", "NW", "KW", "TOLW", "G", "GT", "BR", "MACH")
_POINTERS = (
    "i_allow", "i_out", "i_def", "i_req", "i_tol", "i_valid", "i_count", "i_scls", "i_ports",
    "i_conf", "i_vptr", "i_vidx", "item_sel", "f_static", "openable", "i_own", "i_sel",
    "g_meta", "g_tptr", "g_trows", "term_allow", "term_out", "term_def", "term_esc",
    "well_known",
    "t_allow", "t_out", "t_def", "t_daemon", "t_tmask", "t_rows",
    "y_allow", "y_out", "y_def", "y_esc", "y_alloc", "y_cap", "y_offer",
    "vol_limits", "vol_driver", "key_lo", "key_hi", "key_scr",
    "bit_col", "word_key", "word_valid", "key_w0", "key_w1", "group_w0", "on_row", "on_rows",
    "c_words", "c_flags",
    "used", "open", "is_ex", "tmpl", "tol_idx", "pods", "allow", "out", "def", "tmask", "cap",
    "remaining", "ports", "vols", "screen", "nopen", "tcounts", "thost", "tdoms",
    "hdr", "bulk_take",
    "score", "keff", "take", "m_allow", "m_keys", "ctm", "kcap", "sw", "sflag", "rvec",
    "vcnt", "tv", "tk", "tg", "fkey", "rtmp",
    "progress",
)
# a group's metadata row (csrc/pack_scan_body.h G_* columns)
_GMETA = 8


class _Args(ctypes.Structure):
    """pack_scan::Args (csrc/pack_scan_body.h), field for field."""
    _fields_ = ([(n, ctypes.c_int64) for n in _SIZES]
                + [(n, ctypes.c_void_p) for n in _POINTERS])


def _c_launch(host: bool):
    """The C entry of csrc/pack_scan.cu (host: the CPU build), built and
    loaded on first use."""
    from karpenter_core_tpu_torch.ops import cuda_build

    if host:
        fn = cuda_build.load("pack_scan_host", host=True).pack_scan_host_run
        if fn.argtypes is None:
            fn.argtypes, fn.restype = [ctypes.POINTER(_Args)], ctypes.c_int
        return fn
    fn = cuda_build.load("pack_scan").pack_scan_launch
    if fn.argtypes is None:  # pointers must not travel as 32-bit ints
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


_LAYOUTS: Dict[tuple, Dict[str, np.ndarray]] = {}


def _layout_arrays(rows: screen_ops.ScreenLayout, row: screen_ops.ScreenLayout):
    """The packing's per-word and per-key tables the scan reads beside the
    layout's own: each word's valid bits, each key's word range, each key
    group's first word, and both key rules' masks."""
    key = (rows.pack_key, rows.every_key, row.every_key)
    got = _LAYOUTS.get(key)
    if got is None:
        NW, K, KW = rows.n_words, rows.K, rows.KW
        bits = (rows.bit_col.reshape(NW, 32) >= 0).astype(np.uint64) if NW else np.zeros((0, 32))
        valid = (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
        wk = rows.word_key
        w0 = np.searchsorted(wk, np.arange(K), side="left").astype(np.int32)
        w1 = np.searchsorted(wk, np.arange(K), side="right").astype(np.int32)
        gw = np.searchsorted(wk, 32 * np.arange(KW + 1), side="left").astype(np.int32)
        got = _LAYOUTS[key] = {
            "bit_col": rows.bit_col, "word_key": wk, "word_valid": valid.view(np.int32),
            "key_w0": w0, "key_w1": w1, "group_w0": gw,
            "on_row": row.on_mask.view(np.int32), "on_rows": rows.on_mask.view(np.int32),
        }
    return got


def _check(t: torch.Tensor, name: str, dtype, dim: int, dev) -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"pack_scan: {name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"pack_scan: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"pack_scan: {name} must have {dim} dimensions, got {t.dim()}")
    if t.device != dev:
        raise ValueError(f"pack_scan: {name} is on {t.device}, expected {dev}")
    return t.contiguous()


def _group_tables(groups, nf_trivial, topo_terms, dev) -> Dict[str, torch.Tensor]:
    """The topology groups' metadata rows (type, segment, key, maxSkew,
    hostname, inverse, and whether the node filter matches every row,
    ops/pack._scan_constants' nf_trivial), their node-filter term rows as
    offsets into one list, and the term planes."""
    meta = np.zeros((len(groups), _GMETA), dtype=np.int32)
    ptr = [0]
    rows: List[int] = []
    for g, gm in enumerate(groups):
        rows += list(gm.filter_term_rows)
        ptr.append(len(rows))
        meta[g] = (gm.gtype, gm.seg[0], gm.seg[1], gm.key_k, gm.max_skew, gm.is_hostname,
                   gm.is_inverse, nf_trivial[g])
    out = {
        "g_meta": torch.as_tensor(meta, device=dev),
        "g_tptr": torch.as_tensor(np.asarray(ptr, np.int32), device=dev),
        "g_trows": torch.as_tensor(np.asarray(rows or [0], np.int32), device=dev),
    }
    for name, key in (("term_allow", "allow"), ("term_out", "out"), ("term_def", "defined"),
                      ("term_esc", "escape")):
        out[name] = _check(topo_terms[key], f"topo_terms {key}", torch.bool, 2, dev)
    return out


def run(states: List[tpack.PackState], item_arrays, f_static, openable, tmpl_reqs, tmpl_daemon,
        tmpl_type_mask, type_reqs, type_alloc, type_capacity, type_offering_ok, *, segments,
        zone_seg, ct_seg, screen0, items_pl, geo, log_len: int, n_exist: int, vol_limits,
        vol_driver, topo=None, topo_terms=None, well_known=None,
        item_sel: Optional[np.ndarray] = None, bulk_len: Optional[int] = None,
        host: bool = False, verdicts: Optional[list] = None):
    """B scans in one launch, scan b from the initial state states[b].

    item_arrays is the whole item axis (the solve's pod arrays with `tol`,
    pod_tol_all, and with topology groups `topo_own`/`topo_sel` [I, G]);
    item_sel [B, M] lists each scan's items (global indices in order, -1
    pads), None for one sequential scan over every item. `topo` is the
    scan's TopoMeta (None or no group: no topology lane), `topo_terms` the
    groups' node-filter term planes and `well_known` the [K] well-known
    keys; each state carries its groups' counts (tcounts, thost, tdoms),
    which the scan updates.
    `geo` is the scan's geometry constants (ops/pack._scan_constants under
    the prescreen: the screen ops, the class planes, the template verdict
    rows, the node filters' triviality per group), screen0 the [N, C]
    prescreen tensor, which every scan copies.
    bulk_len sizes a lane's bulk take matrix, as the eager lane does.
    `verdicts`, when given, receives each scan's final [N, C] verdict
    tensor, as make_pack_kernel.pack's does.

    Returns one (PackState, log, ptr) per scan, as make_pack_kernel.pack."""
    B = len(states)
    dev = states[0].used.device
    ops = geo["ops"]
    if item_sel is not None:
        item_sel = np.ascontiguousarray(item_sel, dtype=np.int32)
        if item_sel.ndim != 2 or item_sel.shape[0] != B:
            raise ValueError(f"pack_scan: item_sel must be [{B}, M], got {item_sel.shape}")
    if host != (dev.type == "cpu"):
        raise ValueError(f"pack_scan: the {'host' if host else 'CUDA'} build cannot run on {dev}")
    if B == 0:
        return []
    u8, i32, f32 = torch.bool, torch.int32, torch.float32
    ia = item_arrays
    t = {
        "i_allow": _check(ia["allow"], "allow", u8, 2, dev),
        "i_out": _check(ia["out"], "out", u8, 2, dev),
        "i_def": _check(ia["defined"], "defined", u8, 2, dev),
        "i_req": _check(ia["requests"], "requests", f32, 2, dev),
        "i_tol": _check(ia["tol"], "tol", u8, 2, dev),
        "i_valid": _check(ia["valid"], "valid", u8, 1, dev),
        "i_count": _check(ia["count"], "count", i32, 1, dev),
        "i_scls": _check(ia["scls"], "scls", i32, 1, dev),
        "i_ports": _check(ia["ports"], "ports", u8, 2, dev),
        "i_conf": _check(ia["port_conflict"], "port_conflict", u8, 2, dev),
        "i_vols": _check(ia["vols"], "vols", u8, 2, dev),
        "f_static": _check(f_static, "f_static", u8, 3, dev),
        "openable": _check(openable, "openable", u8, 2, dev),
        "t_allow": _check(tmpl_reqs["allow"], "tmpl allow", u8, 2, dev),
        "t_out": _check(tmpl_reqs["out"], "tmpl out", u8, 2, dev),
        "t_def": _check(tmpl_reqs["defined"], "tmpl defined", u8, 2, dev),
        "t_daemon": _check(tmpl_daemon, "tmpl_daemon", f32, 2, dev),
        "t_tmask": _check(tmpl_type_mask, "tmpl_type_mask", u8, 2, dev),
        "t_rows": _check(geo["tmpl_rows"], "tmpl_rows", u8, 2, dev),
        "y_allow": _check(type_reqs["allow"], "type allow", u8, 2, dev),
        "y_out": _check(type_reqs["out"], "type out", u8, 2, dev),
        "y_def": _check(type_reqs["defined"], "type defined", u8, 2, dev),
        "y_esc": _check(type_reqs["escape"], "type escape", u8, 2, dev),
        "y_alloc": _check(type_alloc, "type_alloc", f32, 2, dev),
        "y_cap": _check(type_capacity, "type_capacity", f32, 2, dev),
        "y_offer": _check(type_offering_ok, "type_offering_ok", u8, 3, dev),
        "vol_limits": _check(vol_limits, "vol_limits", f32, 2, dev),
        "vol_driver": _check(vol_driver, "vol_driver", f32, 2, dev),
    }
    I, V = t["i_allow"].shape
    K, R, Q, W = t["i_out"].shape[1], t["i_req"].shape[1], t["i_ports"].shape[1], t["i_vols"].shape[1]
    J, T = t["t_tmask"].shape
    N = states[0].used.shape[0]
    C = screen0.shape[1]
    EV, D = t["vol_limits"].shape
    E, L = int(n_exist), int(log_len)
    zlo, zhi = zone_seg
    clo, chi = ct_seg
    if tuple(t["f_static"].shape) != (J, I, T) or tuple(t["openable"].shape) != (J, I):
        raise ValueError("pack_scan: f_static must be [J, I, T] and openable [J, I]")
    if tuple(t["y_offer"].shape) != (T, zhi - zlo, chi - clo):
        raise ValueError("pack_scan: type_offering_ok does not match the zone and capacity keys")
    if tuple(t["t_rows"].shape) != (J, C) or tuple(screen0.shape) != (N, C):
        raise ValueError("pack_scan: the template rows and the prescreen need [J, C] and [N, C]")
    if t["vol_driver"].shape != (W, D) or states[0].vols.shape != (EV, W):
        raise ValueError("pack_scan: the volume planes disagree")
    # each item's claim columns, row by row (an item mounts a few of W)
    rows, cols = torch.nonzero(t.pop("i_vols"), as_tuple=True)
    t["i_vptr"] = torch.zeros(I + 1, dtype=i32, device=dev)
    t["i_vptr"][1:] = torch.cumsum(torch.bincount(rows, minlength=I), 0)
    t["i_vidx"] = torch.cat([cols.to(i32), torch.zeros(1, dtype=i32, device=dev)])
    groups = list(topo.groups) if topo is not None else []
    G = len(groups)
    if G:
        if topo_terms is None or well_known is None:
            raise ValueError("pack_scan: topology groups need their term planes and well_known")
        t["i_own"] = _check(ia["topo_own"], "topo_own", u8, 2, dev)
        t["i_sel"] = _check(ia["topo_sel"], "topo_sel", u8, 2, dev)
        if tuple(t["i_own"].shape) != (I, G) or tuple(t["i_sel"].shape) != (I, G):
            raise ValueError(f"pack_scan: topo_own and topo_sel must be [{I}, {G}]")
        t.update(_group_tables(groups, geo["nf_trivial"], topo_terms, dev))
        t["well_known"] = _check(well_known, "well_known", u8, 1, dev)
        if t["term_allow"].shape[1] != V or t["term_out"].shape[1] != K or len(
                t["well_known"]) != K:
            raise ValueError("pack_scan: the term planes and well_known disagree with the items")
    # the bulk region: the existing prefix, or with hostname anti-affinity
    # groups (slot-local) the whole slot axis
    mach = any(gm.gtype == TOPO_ANTI and gm.is_hostname for gm in groups)
    items_pl.check_packing(ops.rows_layout)
    lay = _layout_arrays(ops.rows_layout, ops.row_layout)
    t.update({k: torch.as_tensor(v, device=dev) for k, v in lay.items()})
    seg = np.asarray(segments, dtype=np.int32).reshape(-1, 2)
    t["key_lo"] = torch.as_tensor(np.ascontiguousarray(seg[:, 0]), device=dev)
    t["key_hi"] = torch.as_tensor(np.ascontiguousarray(seg[:, 1]), device=dev)
    t["key_scr"] = torch.as_tensor(geo["key_scr"], device=dev)
    if host:
        prep = screen_ops.screen_prep_plain(
            items_pl.planes["allow"], items_pl.planes["out"], items_pl.planes["defined"],
            ops.rows_layout, escape=items_pl.planes["escape"],
            custom_deny=items_pl.planes["custom_deny"])
    else:
        prep = items_pl.prepared
    t["c_words"] = _check(prep["words"], "class words", i32, 2, dev)
    t["c_flags"] = _check(prep["flags"], "class flags", i32, 3, dev)
    if item_sel is not None:
        M = item_sel.shape[1]
        t["item_sel"] = torch.as_tensor(item_sel, device=dev)
    else:
        M = I
    BR = N if mach else E
    # the bulk take matrix's rows, as the eager scan sizes them
    if BR == 0:
        LB = 1
    elif bulk_len is not None:
        LB = max(int(bulk_len), 1)
    elif mach:
        spread_w = sum(gm.seg[1] - gm.seg[0] for gm in groups
                       if gm.gtype == TOPO_SPREAD and not gm.is_hostname)
        LB = min(3 * I + spread_w + 64, 2048)
    else:
        LB = min(2 * I + V + 64, 4096)

    # the scans' state, [B, ...], each from its own initial state
    names = ("used", "open", "is_existing", "tmpl", "tol_idx", "pods", "allow", "out",
             "defined", "tmask", "cap", "remaining", "ports", "vols")
    types = (f32, u8, u8, i32, i32, i32, u8, u8, u8, u8, f32, f32, u8, u8)
    st = {}
    for name, dtype in zip(names, types):
        st[name] = torch.stack([_check(getattr(s, name), name, dtype, getattr(s, name).dim(), dev)
                                for s in states])
    st["nopen"] = torch.stack([s.nopen.to(i32) for s in states])
    st["screen"] = _check(screen0, "screen0", u8, 2, dev).unsqueeze(0).repeat(B, 1, 1)
    for name, dtype, shape in (("tcounts", f32, (G, V)), ("thost", f32, (G, N)),
                               ("tdoms", u8, (G, V))):
        st[name] = torch.stack([_check(getattr(s, name), name, dtype, 2, dev) for s in states])
        if tuple(st[name].shape[1:]) != shape:
            raise ValueError(f"pack_scan: {name} must be {list(shape)}, got "
                             f"{list(st[name].shape[1:])}")
    out = {
        "hdr": torch.zeros((B, HDR + 5 * L), dtype=i32, device=dev),
        "bulk_take": torch.zeros((B, LB, BR), dtype=i32, device=dev),
    }
    NW, KW = ops.rows_layout.n_words, ops.rows_layout.KW
    br1 = max(BR, 1)
    scratch = {
        "score": torch.empty((B, N), dtype=f32, device=dev),
        "keff": torch.empty((B, br1), dtype=i32, device=dev),
        "take": torch.empty((B, br1), dtype=i32, device=dev),
        "m_allow": torch.empty((B, V), dtype=torch.uint8, device=dev),
        "m_keys": torch.empty((B, 3, K), dtype=torch.uint8, device=dev),
        "ctm": torch.empty((B, T), dtype=torch.uint8, device=dev),
        "kcap": torch.empty((B, T), dtype=i32, device=dev),
        "sw": torch.empty((B, max(NW, 1)), dtype=i32, device=dev),
        "sflag": torch.empty((B, 3 * KW), dtype=i32, device=dev),
        "rvec": torch.empty((B, 3, max(R, 1)), dtype=f32, device=dev),
        "vcnt": torch.empty((B, max(EV * D, 1)), dtype=f32, device=dev),
        "tv": torch.empty((B, 6, V), dtype=torch.uint8, device=dev),
        "tk": torch.empty((B, 2, K), dtype=torch.uint8, device=dev),
        "tg": torch.empty((B, 3, max(G, 1)), dtype=i32, device=dev),
        "fkey": torch.empty((B, N), dtype=f32, device=dev),
        "rtmp": torch.empty((B, N), dtype=i32, device=dev),
    }
    progress = None
    if not host:
        progress = torch.zeros(B, dtype=i32).pin_memory()
    sizes = dict(B=B, N=N, V=V, K=K, R=R, T=T, J=J, I=I, M=M, C=C, Q=Q, W=W, D=D, EV=EV, E=E,
                 L=L, LB=LB, WSCR=ops.width, zlo=zlo, zhi=zhi, clo=clo, chi=chi, NW=NW, KW=KW,
                 TOLW=t["i_tol"].shape[1], G=G, GT=t["term_allow"].shape[0] if G else 0, BR=BR,
                 MACH=int(mach))
    tensors = dict(t, **{("is_ex" if k == "is_existing" else "def" if k == "defined" else k): v
                         for k, v in st.items()}, **out, **scratch)
    if progress is not None:
        tensors["progress"] = progress
    args = _Args(**sizes, **{k: (tensors[k].data_ptr() if k in tensors else None)
                             for k in _POINTERS})
    fn = _c_launch(host)
    supervise.touch_progress()
    if host:
        fn(ctypes.byref(args))
    else:
        _launch_on_card(fn, args, dev, progress)
    hdr = out["hdr"].cpu().numpy()  # the one synchronising read
    supervise.touch_progress()

    results = []
    counts = dict.fromkeys(tpack.SCAN_COUNTERS, 0)
    for b in range(B):
        h = hdr[b]
        ptr, bulk_n, nopen = int(h[0]), int(h[1]), int(h[2])
        for i, k in enumerate(tpack.SCAN_COUNTERS):
            counts[k] += int(h[3 + i])
        lg = h[HDR:].reshape(5, L)
        log = {name: lg[i].copy() for i, name in enumerate(("item", "slot", "ns", "k", "k_last"))}
        log["bulk_take"] = out["bulk_take"][b]
        log["bulk_n"] = bulk_n
        state = tpack.PackState(
            used=st["used"][b], open=st["open"][b], is_existing=st["is_existing"][b],
            tmpl=st["tmpl"][b], tol_idx=st["tol_idx"][b], pods=st["pods"][b],
            allow=st["allow"][b], out=st["out"][b], defined=st["defined"][b],
            tmask=st["tmask"][b], cap=st["cap"][b], nopen=st["nopen"][b],
            remaining=st["remaining"][b], tcounts=st["tcounts"][b], thost=st["thost"][b],
            tdoms=st["tdoms"][b], ports=st["ports"][b], vols=st["vols"][b])
        if int(state.nopen) != nopen:
            raise KernelError(f"pack_scan: scan {b} reported nopen {nopen}, its state "
                              f"{int(state.nopen)}")
        results.append((state, log, ptr))
    if verdicts is not None:
        verdicts.extend(st["screen"].unbind(0))
    tpack.LAST_SCAN.update(counts, impl="kernel")
    return results


# the last launch on the card: its scans and the kernel's time alone (CUDA
# events around the launch); max_ms the longest launch of this process
LAST_LAUNCH: Dict[str, float] = {"scans": 0, "ms": 0.0, "max_ms": 0.0}


def _launch_on_card(fn, args, dev, progress) -> None:
    """One launch on `dev`'s current stream; while it runs, the host
    touches the dispatch heartbeat each time the kernel's item counter
    (in host memory the card writes) moves, so a long scan reads as alive
    and a stuck one as a wedge."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        rc = fn(ctypes.byref(args), THREADS, stream.cuda_stream)
        if rc != 0:
            raise KernelError(f"pack_scan kernel launch failed: CUDA error {rc}")
        screen_ops._counted("pack_scan", dev)
        done.record(stream)
        counter = progress.numpy()
        seen = counter.copy()
        try:
            while not done.query():
                if not np.array_equal(counter, seen):
                    seen = counter.copy()
                    supervise.touch_progress()
                time.sleep(0.001)
            ms = start.elapsed_time(done)
            LAST_LAUNCH.update(scans=int(args.B), ms=ms, max_ms=max(LAST_LAUNCH["max_ms"], ms))
        except RuntimeError as exc:  # the kernel faulted on the card
            raise KernelError(f"pack_scan kernel failed on {dev}: {exc}") from exc
