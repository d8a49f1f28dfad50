"""Device primitives for the requirement algebra, on torch tensors.

Lowers the set algebra of pkg/scheduling/{requirement,requirements}.go onto
dense masks (see solver/encode.py for the encoding):

  nonempty(A ∩ B) per key  =  (outA & outB) | any_v(allowA & allowB)
  Intersects(a, b) fails on a shared-defined key with empty intersection
    unless BOTH operators are NotIn/DoesNotExist (requirements.go:189-206)
  Compatible(node, pod) additionally denies custom (non-well-known) keys the
    node side does not define, unless the pod's operator is NotIn or
    DoesNotExist (requirements.go:123-133)

The `_m` forms reduce every key segment at once with a [V, K] membership
matrix; the sliced forms loop over the segments. Contractions of 0/1 masks
run in float32 and test > 0.5: the counts are small integers, so the test
is exact on every device.

`resolve_screen_mode`, `resolve_incremental_mode` and `resolve_pack_scan`
read the reference's environment flags for the device path's strategies
(the solver service resolves its screen and residency through them).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

Segments = List[Tuple[int, int]]  # per key: (lo, hi) into the flat value axis


def resolve_screen_mode() -> str:
    """The pack scan's slot-screen strategy, from KCT_PACK_SCREEN (auto,
    prescreen, tiered) as the reference reads it: "prescreen" (the
    default) computes the [N, C] verdict tensor before the scan; "tiered"
    screens the open slots per item inside it. The solver service keys
    its entries on the resolved mode."""
    from karpenter_core_tpu_torch.obs import envflags

    mode = envflags.raw("KCT_PACK_SCREEN", "auto").strip().lower()
    if mode in ("tiered", "prescreen"):
        return mode
    return "prescreen"


def resolve_pack_scan() -> str:
    """The pack scan's strategy, from KCT_PACK_SCAN (auto, sequential,
    segmented). "auto" resolves to "sequential", as in the reference; the
    segmented lanes are not ported (ROADMAP Queue A item 6), so asking for
    them raises rather than run the sequential scan in their place."""
    from karpenter_core_tpu_torch.obs import envflags

    mode = envflags.raw("KCT_PACK_SCAN", "auto").strip().lower()
    if mode == "segmented":
        raise NotImplementedError(
            "KCT_PACK_SCAN=segmented: the segmented scan is not ported yet "
            "(ROADMAP Queue A item 6); unset it or set it to sequential")
    return "sequential"


def resolve_incremental_mode() -> str:
    """The delta re-solve policy, from KCT_INCREMENTAL (auto, on, off):
    "on" (the default) keeps a geometry's verdict tensor resident across
    solves and refreshes only the changed rows and columns; "off" runs the
    full precompute every solve. Both give bit-identical tensors."""
    from karpenter_core_tpu_torch.obs import envflags

    mode = envflags.raw("KCT_INCREMENTAL", "auto").strip().lower()
    if mode in ("on", "off"):
        return mode
    return "on"


def seg_matrix(segments: Segments, V: int) -> np.ndarray:
    """[V, K] one-hot membership matrix: column k marks the values of key k."""
    m = np.zeros((V, len(segments)), dtype=np.float32)
    for k, (lo, hi) in enumerate(segments):
        m[lo:hi, k] = 1.0
    return m


def _count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """0/1 contraction a @ b in float32 (exact for these counts)."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def segment_any_m(mask: torch.Tensor, seg_mat: torch.Tensor) -> torch.Tensor:
    """[..., V] bool -> [..., K] bool via one contraction."""
    return _count(mask, seg_mat) > 0.5


def escape_flags_m(allow, out, defined, seg_mat) -> torch.Tensor:
    """Recover operator in {NotIn, DoesNotExist} for (merged) rows
    (requirement.go:186-197): NotIn = complement with an excluded value,
    DoesNotExist = no complement and nothing allowed."""
    has_allow = segment_any_m(allow, seg_mat)
    has_excl = segment_any_m(~allow, seg_mat)
    return defined & ((out & has_excl) | (~out & ~has_allow))


def rows_compat_m(node, pod_row, seg_mat, custom_deny=None) -> torch.Tensor:
    """Requirements.Compatible(node rows, one pod row) -> [N] bool.
    node: allow [N, V] / out, defined [N, K]; pod_row: allow [V] /
    out, defined, escape [K]."""
    node_escape = escape_flags_m(node["allow"], node["out"], node["defined"], seg_mat)
    shared = node["defined"] & pod_row["defined"][None, :]
    both_out = node["out"] & pod_row["out"][None, :]
    inter = segment_any_m(node["allow"] & pod_row["allow"][None, :], seg_mat)
    escapes = node_escape & pod_row["escape"][None, :]
    ok = ((~shared) | both_out | inter | escapes).all(dim=-1)
    if custom_deny is not None:
        ok &= ~torch.any(custom_deny[None, :] & ~node["defined"], dim=-1)
    return ok


def row_vs_rows_compat_m(m_allow, m_out, m_defined, m_escape, rows, seg_mat):
    """Intersects(one merged row, batch rows) -> [T] bool.
    rows: allow [T, V] / out, defined, escape [T, K]."""
    shared = m_defined[None, :] & rows["defined"]
    both_out = m_out[None, :] & rows["out"]
    inter = segment_any_m(rows["allow"] & m_allow[None, :], seg_mat)
    escapes = m_escape[None, :] & rows["escape"]
    return ((~shared) | both_out | inter | escapes).all(dim=-1)


def segment_any(mask: torch.Tensor, segments: Segments) -> torch.Tensor:
    """[..., V] bool -> [..., K] bool: any within each key's segment."""
    cols = [
        mask[..., lo:hi].any(dim=-1)
        if hi > lo
        else torch.zeros(mask.shape[:-1], dtype=torch.bool, device=mask.device)
        for lo, hi in segments
    ]
    return torch.stack(cols, dim=-1)


def escape_flags(allow, out, defined, segments: Segments) -> torch.Tensor:
    """escape_flags_m with a loop over the segments."""
    has_allow = segment_any(allow, segments)
    has_excl = segment_any(~allow, segments)
    return defined & ((out & has_excl) | (~out & ~has_allow))


def pairwise_nonempty_key(allow_a, out_a, allow_b, out_b, k: int, lo: int,
                          hi: int) -> torch.Tensor:
    """[A, B] nonempty(A_i ∩ B_j) for key k."""
    both_out = out_a[:, k: k + 1] & out_b[:, k][None, :]
    if hi == lo:
        return both_out
    inter = _count(allow_a[:, lo:hi], allow_b[:, lo:hi].T) > 0.5
    return both_out | inter


def pairwise_intersects(a, b, segments: Segments) -> torch.Tensor:
    """[A, B] Requirements.Intersects between rows of two requirement sets
    (dicts with allow/out/defined/escape)."""
    ok = torch.ones((a["allow"].shape[0], b["allow"].shape[0]), dtype=torch.bool,
                    device=a["allow"].device)
    for k, (lo, hi) in enumerate(segments):
        shared = a["defined"][:, k: k + 1] & b["defined"][None, :, k]
        nonempty = pairwise_nonempty_key(a["allow"], a["out"], b["allow"], b["out"],
                                         k, lo, hi)
        escapes = a["escape"][:, k: k + 1] & b["escape"][None, :, k]
        ok &= (~shared) | nonempty | escapes
    return ok


def pairwise_compatible(node, pod, segments: Segments, well_known) -> torch.Tensor:
    """[Nnode, Npod] Requirements.Compatible(node side, pod side)."""
    ok = pairwise_intersects(node, pod, segments)
    deny = (~well_known)[None, :] & pod["defined"] & ~pod["escape"]  # [Npod, K]
    denied = torch.any(deny[None, :, :] & ~node["defined"][:, None, :], dim=-1)
    return ok & ~denied


def rows_nonempty(allow_a, out_a, allow_b, out_b, segments: Segments) -> torch.Tensor:
    """Row-aligned nonempty over broadcastable rows -> [..., K]."""
    cols = []
    for k, (lo, hi) in enumerate(segments):
        both_out = out_a[..., k] & out_b[..., k]
        if hi > lo:
            inter = (allow_a[..., lo:hi] & allow_b[..., lo:hi]).any(dim=-1)
            cols.append(both_out | inter)
        else:
            cols.append(both_out)
    return torch.stack(cols, dim=-1)


def fits(requests: torch.Tensor, alloc: torch.Tensor) -> torch.Tensor:
    """resources.Fits: requests [..., R] vs alloc [..., R] -> [...] bool.
    Any negative allocatable entry never fits."""
    return torch.all((requests <= alloc) & (alloc >= 0.0), dim=-1)
