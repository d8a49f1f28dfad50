"""One label key's constraint: a (possibly complemented) value set with
integer bounds (pkg/scheduling/requirement.go:36-243).

``complement=True`` means the set holds *excluded* values (NotIn/Exists);
Gt/Lt bounds survive only on complement sets. The encoder
(``solver/encode.py``) lowers each Requirement to a bitmask over the key's
closed value dictionary plus a complement bit.
"""
from __future__ import annotations

import random
from typing import Iterable, Optional, Set

OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"
OP_GT = "Gt"
OP_LT = "Lt"

MAX_LEN = 2**63 - 1  # stand-in for the infinite universe (requirement.go:199-204)


def _normalize_key(key: str) -> str:
    from karpenter_core_tpu_torch.api.labels import NORMALIZED_LABELS

    return NORMALIZED_LABELS.get(key, key)


class Requirement:
    """requirement.go:36-68."""

    __slots__ = ("key", "complement", "values", "greater_than", "less_than")

    def __init__(self, key: str, operator: str = OP_EXISTS,
                 values: Iterable[str] = ()):
        self.key = _normalize_key(key)
        self.complement = operator not in (OP_IN, OP_DOES_NOT_EXIST)
        self.values: Set[str] = set()
        self.greater_than: Optional[int] = None
        self.less_than: Optional[int] = None
        values = list(values)
        if operator in (OP_IN, OP_NOT_IN):
            self.values.update(values)
        elif operator == OP_GT:
            self.greater_than = int(values[0])
        elif operator == OP_LT:
            self.less_than = int(values[0])

    @classmethod
    def _make(cls, key, complement, values, greater_than=None,
              less_than=None) -> "Requirement":
        r = cls.__new__(cls)
        r.key = key
        r.complement = complement
        r.values = set(values)
        r.greater_than = greater_than
        r.less_than = less_than
        return r

    def intersection(self, other: "Requirement") -> "Requirement":
        """Closed under intersection (requirement.go:117-150)."""
        complement = self.complement and other.complement
        greater_than = _max_opt(self.greater_than, other.greater_than)
        less_than = _min_opt(self.less_than, other.less_than)
        if (greater_than is not None and less_than is not None
                and greater_than >= less_than):
            return Requirement(self.key, OP_DOES_NOT_EXIST)
        if self.complement and other.complement:
            values = self.values | other.values
        elif self.complement and not other.complement:
            values = other.values - self.values
        elif not self.complement and other.complement:
            values = self.values - other.values
        else:
            values = self.values & other.values
        values = {v for v in values if _within_bounds(v, greater_than, less_than)}
        if not complement:
            greater_than, less_than = None, None
        return Requirement._make(self.key, complement, values, greater_than,
                                 less_than)

    def has(self, value: str) -> bool:
        """requirement.go:171-176."""
        if self.complement:
            return value not in self.values and _within_bounds(
                value, self.greater_than, self.less_than
            )
        return value in self.values and _within_bounds(
            value, self.greater_than, self.less_than
        )

    def any(self) -> str:
        """A representative allowed value (requirement.go:152-168): the
        least of an In set; for NotIn / Exists a random integer within the
        bounds that the set does not exclude."""
        op = self.operator()
        if op == OP_IN:
            return min(self.values)
        if op in (OP_NOT_IN, OP_EXISTS):
            lo = 0 if self.greater_than is None else self.greater_than + 1
            hi = MAX_LEN if self.less_than is None else self.less_than
            if hi <= lo:
                return str(lo)
            for _ in range(32):
                v = str(random.randrange(lo, hi))
                if v not in self.values:
                    return v
            return str(lo)
        return ""

    def insert(self, *items: str) -> None:
        self.values.update(items)

    def to_node_selector_requirement(self):
        """The v1.NodeSelectorRequirement form (requirement.go:70-113)."""
        from karpenter_core_tpu_torch.kube.objects import NodeSelectorRequirement

        if self.greater_than is not None:
            return NodeSelectorRequirement(self.key, OP_GT, [str(self.greater_than)])
        if self.less_than is not None:
            return NodeSelectorRequirement(self.key, OP_LT, [str(self.less_than)])
        op = self.operator()
        if op in (OP_IN, OP_NOT_IN):
            return NodeSelectorRequirement(self.key, op, self.values_list())
        return NodeSelectorRequirement(self.key, op, [])

    def values_list(self):
        return sorted(self.values)

    def operator(self) -> str:
        """Recovered NodeSelector operator (requirement.go:186-197)."""
        if self.complement:
            return OP_NOT_IN if self.values else OP_EXISTS
        return OP_IN if self.values else OP_DOES_NOT_EXIST

    def len(self) -> int:
        """Cardinality; complement sets count down from MAX_LEN."""
        if self.complement:
            return MAX_LEN - len(self.values)
        return len(self.values)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Requirement)
            and self.key == other.key
            and self.complement == other.complement
            and self.values == other.values
            and self.greater_than == other.greater_than
            and self.less_than == other.less_than
        )

    def __hash__(self):
        return hash((self.key, self.complement, frozenset(self.values),
                     self.greater_than, self.less_than))

    def __repr__(self) -> str:
        op = self.operator()
        if op in (OP_EXISTS, OP_DOES_NOT_EXIST):
            s = f"{self.key} {op}"
        else:
            vals = self.values_list()
            if len(vals) > 5:
                vals = vals[:5] + [f"and {len(self.values) - 5} others"]
            s = f"{self.key} {op} {vals}"
        if self.greater_than is not None:
            s += f" >{self.greater_than}"
        if self.less_than is not None:
            s += f" <{self.less_than}"
        return s


def _within_bounds(value: str, greater_than: Optional[int],
                   less_than: Optional[int]) -> bool:
    """requirement.go:227-243 — with bounds set, non-integers are invalid."""
    if greater_than is None and less_than is None:
        return True
    try:
        v = int(value)
    except (TypeError, ValueError):
        return False
    if greater_than is not None and greater_than >= v:
        return False
    if less_than is not None and less_than <= v:
        return False
    return True


def _min_opt(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


def _max_opt(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)
