"""Taint toleration checks and merging (pkg/scheduling/taints.go:26-56)."""
from __future__ import annotations

from typing import List, Optional


def tolerates(taints: List, pod) -> Optional[str]:
    """None if the pod tolerates ALL taints, else an error string."""
    errs = []
    for taint in taints:
        if not any(t.tolerates_taint(taint) for t in pod.spec.tolerations):
            errs.append(f"did not tolerate {taint.key}={taint.value}:{taint.effect}")
    return "; ".join(errs) if errs else None


def merge(taints: List, with_taints: List) -> List:
    """The union keyed on (key, effect), the left side kept
    (taints.go:44-56)."""
    result = list(taints)
    for taint in with_taints:
        if not any(taint.match_taint(t) for t in result):
            result.append(taint)
    return result
