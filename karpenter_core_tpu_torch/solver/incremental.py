"""Incremental re-solve bookkeeping: the host half of the delta path.

An operator solves a stream of batches over one cluster, and consecutive
solves see nearly the same world: the same instance types (carried by
encode.EncodeReuse), nearly the same existing nodes (a few narrowed by
bindings, freed by terminations, joined), and a batch of mostly new
items. verdict[n, c] of the [N, C] prescreen tensor depends only on (slot
row n's planes, class column c's planes), so this module finds the rows
and columns whose planes changed since the previous solve and decides
whether replaying them through ops.pack.screen_refresh beats
the full precompute (the reference's solver/incremental.py).

Two layers guard correctness:

  * the change-feed gate (state.Cluster.changes_since): a feed fault or a
    history gap forces the full path for one solve and drops the resident
    tensor;
  * plane fingerprints: the delta is found by comparing the previous and
    current planes byte for byte (bit-packed rows), never inferred from
    the feed, so the feed can only make the path more conservative. The
    refreshed entries are computed by the same screen ops as the full
    precompute, so the refreshed tensor, and every placement decoded
    from it, equals the full path's.

`OUTCOMES` counts the dispatch decisions by outcome: `refresh` (a delta
replayed), `full_miss` (nothing resident), `full_shape` (the planes'
shapes drifted), `full_wide` (a delta past its budget), `full_gated` (the
feed gate dropped live residency) and `full_deg` (a refresh that failed
and fell back to the full precompute).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from karpenter_core_tpu_torch.solver.encode import bucket_pow2

# dispatch decisions by outcome, counted where the reference counts them
OUTCOMES: Dict[str, int] = {
    "refresh": 0, "full_miss": 0, "full_shape": 0, "full_wide": 0,
    "full_gated": 0, "full_deg": 0,
}

# delta budgets: past these many changed rows or columns the full
# precompute is dispatched instead
MAX_ROW_DELTA = 128
MAX_COL_DELTA = 128

_COL_KEYS = ("allow", "out", "defined", "escape", "custom_deny")


def reset_outcomes() -> None:
    for k in OUTCOMES:
        OUTCOMES[k] = 0


def _pack_rows(arr: np.ndarray) -> np.ndarray:
    """Row-wise bit-packed fingerprint of a bool plane ([B, W] -> [B, ~W/8])."""
    return np.packbits(np.ascontiguousarray(arr), axis=1)


def exist_fingerprint(exist: Dict[str, np.ndarray]) -> Tuple[np.ndarray, ...]:
    """Per-slot-row fingerprint of the existing planes; escape is derived
    from allow, out and defined, so those three determine the row."""
    return tuple(_pack_rows(exist[k]) for k in ("allow", "out", "defined"))


def col_fingerprint(pod_arrays: Dict[str, np.ndarray]) -> Tuple[np.ndarray, ...]:
    """Per-verdict-column fingerprint: the class planes each column screens
    with, gathered as the prescreen gathers them (scls_first)."""
    sf = pod_arrays["scls_first"]
    return tuple(_pack_rows(pod_arrays[k][sf]) for k in _COL_KEYS)


def _changed_rows(old: Tuple[np.ndarray, ...], new: Tuple[np.ndarray, ...]):
    """Indices whose fingerprint rows differ, or None on any shape drift."""
    changed = None
    for o, n in zip(old, new):
        if o.shape != n.shape:
            return None
        d = (o != n).any(axis=1)
        changed = d if changed is None else (changed | d)
    return np.nonzero(changed)[0].astype(np.int32) if changed is not None else None


@dataclass
class ScreenDelta:
    """A refresh plan: the changed existing-row and verdict-column indices,
    and the reference's budgets rb and cb for them (the power-of-two
    buckets its static shapes pad to; 0 for an empty side), reported
    beside the delta."""

    rows: np.ndarray
    cols: np.ndarray
    rb: int
    cb: int


class IncrementalScreen:
    """One resident verdict tensor and the fingerprints of the planes it
    was computed from, under one residency key (every value of the solve
    geometry the tensor's shape or contents depend on, and the screen
    mode). plan() stages this solve's fingerprints and adopt() commits
    them with this solve's tensor, so a solve that fails between the two
    leaves the pair consistent. Not thread-safe: a solver runs one solve
    at a time and owns its carriers."""

    def __init__(self):
        self._key = None
        self._screen = None  # the resident [N, C] tensor
        self._exist_fp = None
        self._col_fp = None
        self._pending = None

    def plan(self, key, pod_arrays, exist, gate_ok: bool = True) -> Optional[ScreenDelta]:
        """Refresh or full for this solve: a ScreenDelta to replay, or None
        (dispatch the full precompute). Either way the caller hands the
        resulting tensor to adopt()."""
        new_exist_fp = exist_fingerprint(exist)
        new_col_fp = col_fingerprint(pod_arrays)
        delta = None
        resident = self._key == key and self._screen is not None
        if not gate_ok:
            # full_gated only when the gate dropped live residency
            outcome = "full_gated" if resident else "full_miss"
            self.invalidate()
        elif not resident:
            outcome = "full_miss"
        else:
            rows = _changed_rows(self._exist_fp, new_exist_fp)
            cols = _changed_rows(self._col_fp, new_col_fp)
            if rows is None or cols is None:
                outcome = "full_shape"
            elif len(rows) > MAX_ROW_DELTA or len(cols) > MAX_COL_DELTA:
                outcome = "full_wide"
            else:
                E = exist["allow"].shape[0]
                C = pod_arrays["scls_first"].shape[0]
                # budgets bucket pow2 (at least 8) within the axis; an
                # empty side is budget 0 and skips that half
                delta = ScreenDelta(
                    rows=rows, cols=cols,
                    rb=0 if len(rows) == 0 else min(bucket_pow2(len(rows), 8), max(E, 1)),
                    cb=0 if len(cols) == 0 else min(bucket_pow2(len(cols), 8), max(C, 1)),
                )
                outcome = "refresh"
        if outcome != "refresh":
            # a planned refresh is counted when its dispatch succeeds
            # (count_refresh) or fails (count_degraded)
            OUTCOMES[outcome] += 1
        self._pending = (key, new_exist_fp, new_col_fp)
        return delta

    @staticmethod
    def count_refresh() -> None:
        OUTCOMES["refresh"] += 1

    @staticmethod
    def count_degraded() -> None:
        OUTCOMES["full_deg"] += 1

    def adopt(self, key, screen) -> None:
        """Make this solve's tensor (full or refreshed) the resident one,
        committing the fingerprints plan() staged; without a matching plan
        residency is dropped."""
        pend = self._pending
        if pend is None or pend[0] != key:
            self.invalidate()
            return
        self._key, self._exist_fp, self._col_fp = pend
        self._screen = screen
        self._pending = None

    def resident(self, key):
        return self._screen if self._key == key else None

    def drop_resident(self) -> None:
        """Drop the tensor and its fingerprints but keep what plan() staged:
        after a failed refresh, the fallback full tensor is computed from
        exactly the staged planes and can still be adopted."""
        self._key = None
        self._screen = None
        self._exist_fp = None
        self._col_fp = None

    def invalidate(self) -> None:
        """Drop the tensor, its fingerprints and the staged plan."""
        self.drop_resident()
        self._pending = None


class DiffGate:
    """Reads state.Cluster.changes_since between solves. gate() is True
    when the feed proves continuous history since the previous consult; a
    feed fault or a history gap gives False, and the caller must drop its
    resident state, not just skip one reuse."""

    def __init__(self):
        self._cursor: Optional[int] = None

    def gate(self, cluster) -> bool:
        if cluster is None or not hasattr(cluster, "changes_since"):
            # no feed: the plane fingerprints alone are exact
            return True
        try:
            cursor, changed = cluster.changes_since(self._cursor)
        except Exception:
            # a feed fault: degrade to the full path, restart history
            self._cursor = None
            return False
        self._cursor = cursor
        return changed is not None
