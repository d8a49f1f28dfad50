"""Requirements: a map key -> Requirement closed under intersection
(pkg/scheduling/requirements.go:32-223)."""
from __future__ import annotations

import functools
from typing import Dict, Iterable, List, Optional

from karpenter_core_tpu_torch.scheduling.requirement import (
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_IN,
    OP_NOT_IN,
    Requirement,
)


class Requirements(Dict[str, Requirement]):
    """dict[key, Requirement] with intersection-on-add (requirements.go:32)."""

    def __init__(self, requirements: Iterable[Requirement] = ()):
        super().__init__()
        self.add(*requirements)

    @classmethod
    def from_node_selector_requirements(cls, *reqs) -> "Requirements":
        """requirements.go:43-49."""
        return cls(Requirement(r.key, r.operator, r.values) for r in reqs)

    @classmethod
    def from_labels(cls, labels: Dict[str, str]) -> "Requirements":
        """Each label k=v becomes In(v) (requirements.go:52-58)."""
        return cls(Requirement(k, OP_IN, [v]) for k, v in labels.items())

    @classmethod
    def from_pod(cls, pod) -> "Requirements":
        """nodeSelector + heaviest preferred term + FIRST required term
        (requirements.go:61-78; relaxation drops the rest)."""
        requirements = cls.from_labels(pod.spec.node_selector)
        affinity = pod.spec.affinity
        if affinity is None or affinity.node_affinity is None:
            return requirements
        node_affinity = affinity.node_affinity
        if node_affinity.preferred:
            heaviest = max(node_affinity.preferred, key=lambda t: t.weight)
            requirements.add(
                *cls.from_node_selector_requirements(
                    *heaviest.preference.match_expressions
                ).values()
            )
        if node_affinity.required:
            requirements.add(
                *cls.from_node_selector_requirements(
                    *node_affinity.required[0].match_expressions
                ).values()
            )
        return requirements

    def add(self, *requirements: Requirement) -> None:
        """Intersecting add (requirements.go:87-94)."""
        for requirement in requirements:
            existing = super().get(requirement.key)
            if existing is not None:
                requirement = requirement.intersection(existing)
            self[requirement.key] = requirement

    def get_requirement(self, key: str) -> Requirement:
        """Missing keys read as Exists (requirements.go:114-120)."""
        existing = super().get(key)
        if existing is None:
            return Requirement(key, OP_EXISTS)
        return existing

    def compatible(self, requirements: "Requirements") -> Optional[str]:
        """None if `requirements` can be met by this (node-side) set, else an
        error string (requirements.go:123-133): custom labels must be
        defined here unless the incoming operator is NotIn or DoesNotExist;
        well-known labels intersect when present."""
        from karpenter_core_tpu_torch.api.labels import WELL_KNOWN_LABELS

        errs: List[str] = []
        for key in sorted(set(requirements) - WELL_KNOWN_LABELS):
            op = requirements.get_requirement(key).operator()
            if key in self or op in (OP_NOT_IN, OP_DOES_NOT_EXIST):
                continue
            errs.append(f'label "{key}" does not have known values' + self._label_hint(key))
        err = self.intersects(requirements)
        if err:
            errs.append(err)
        return "; ".join(errs) if errs else None

    def _label_hint(self, key: str) -> str:
        """A typo suggestion for an unknown label (requirements.go:172-186):
        a well-known label, then one of these keys, that contains `key` or
        lies within a fifth of its length in edit distance."""
        from karpenter_core_tpu_torch.api.labels import WELL_KNOWN_LABELS

        hint = _well_known_hint(key, tuple(sorted(WELL_KNOWN_LABELS)))
        if hint:
            return hint
        for existing in sorted(self.keys()):
            if key in existing or _edit_distance(key, existing) < len(existing) // 5:
                return f' (typo of "{existing}"?)'
        return ""

    def intersects(self, requirements: "Requirements") -> Optional[str]:
        """None if every shared key overlaps (requirements.go:189-206)."""
        errs: List[str] = []
        for key in sorted(set(self) & set(requirements)):
            existing = self.get_requirement(key)
            incoming = requirements.get_requirement(key)
            if existing.intersection(incoming).len() == 0:
                escape = (OP_NOT_IN, OP_DOES_NOT_EXIST)
                if incoming.operator() in escape and existing.operator() in escape:
                    continue
                errs.append(f"key {key}, {incoming!r} not in {existing!r}")
        return "; ".join(errs) if errs else None

    def labels(self) -> Dict[str, str]:
        """Representative node labels (requirements.go:208-218): a value
        for each key a node may carry."""
        from karpenter_core_tpu_torch.api.labels import is_restricted_node_label

        out: Dict[str, str] = {}
        for key, requirement in self.items():
            if not is_restricted_node_label(key):
                value = requirement.any()
                if value:
                    out[key] = value
        return out

    def __repr__(self) -> str:
        from karpenter_core_tpu_torch.api.labels import RESTRICTED_LABELS

        return ", ".join(repr(r) for k, r in sorted(self.items())
                         if k not in RESTRICTED_LABELS)


@functools.lru_cache(maxsize=4096)
def _well_known_hint(key: str, known_sorted: tuple) -> str:
    for known in known_sorted:
        if key in known or _edit_distance(key, known) < len(known) // 5:
            return f' (typo of "{known}"?)'
    return ""


def _edit_distance(s: str, t: str) -> int:
    """Levenshtein distance (requirements.go:135-165)."""
    if not s:
        return len(t)
    if not t:
        return len(s)
    prev = list(range(len(t) + 1))
    for i, cs in enumerate(s, start=1):
        cur = [i] + [0] * len(t)
        for j, ct in enumerate(t, start=1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (0 if cs == ct else 1))
        prev = cur
    return prev[-1]
