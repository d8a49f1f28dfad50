"""ResourceList algebra (pkg/utils/resources/resources.go) on plain
``dict[str, float]`` resource lists."""
from __future__ import annotations

import re
from typing import Dict

ResourceList = Dict[str, float]

_SUFFIXES = {
    "": 1.0,
    "m": 1e-3,
    "k": 1e3,
    "K": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
    "Pi": 2**50,
    "Ei": 2**60,
}

_QUANTITY_RE = re.compile(r"^([+-]?[0-9.]+(?:[eE][+-]?[0-9]+)?)([a-zA-Z]*)$")


def parse_quantity(value) -> float:
    """Parse a k8s quantity ("100m", "1Gi", "2", 2.5) into a float."""
    if isinstance(value, (int, float)):
        return float(value)
    m = _QUANTITY_RE.match(str(value).strip())
    if not m:
        raise ValueError(f"cannot parse quantity {value!r}")
    number, suffix = m.groups()
    if suffix not in _SUFFIXES:
        raise ValueError(f"cannot parse quantity suffix {suffix!r} in {value!r}")
    return float(number) * _SUFFIXES[suffix]


def parse_resource_list(d: Dict[str, object]) -> ResourceList:
    return {k: parse_quantity(v) for k, v in d.items()}


def merge(*resource_lists: ResourceList) -> ResourceList:
    """Key-wise sum (resources.go Merge)."""
    result: ResourceList = {}
    for rl in resource_lists:
        for name, q in rl.items():
            result[name] = result.get(name, 0.0) + q
    return result


def subtract(lhs: ResourceList, rhs: ResourceList) -> ResourceList:
    """lhs - rhs over the keys of lhs (resources.go Subtract)."""
    result = dict(lhs)
    for name in lhs:
        result[name] = lhs[name] - rhs.get(name, 0.0)
    return result


def max_resources(*resource_lists: ResourceList) -> ResourceList:
    """Key-wise maximum (resources.go MaxResources)."""
    result: ResourceList = {}
    for rl in resource_lists:
        for name, q in rl.items():
            if name not in result or q > result[name]:
                result[name] = q
    return result


def fits(candidate: ResourceList, total: ResourceList) -> bool:
    """candidate <= total key-wise; a negative total never fits
    (resources.go Fits)."""
    for q in total.values():
        if q < 0:
            return False
    for name, q in candidate.items():
        if q > total.get(name, 0.0):
            return False
    return True


def _container_requests(container) -> ResourceList:
    """Limits fill in missing requests (MergeResourceLimitsIntoRequests)."""
    requests = dict(container.resources.requests)
    for name, q in container.resources.limits.items():
        requests.setdefault(name, q)
    return requests


def ceiling_requests(pod) -> ResourceList:
    """max(sum of containers, max of init containers) — resources.go Ceiling."""
    total: ResourceList = {}
    for c in pod.spec.containers:
        total = merge(total, _container_requests(c))
    for c in pod.spec.init_containers:
        total = max_resources(total, _container_requests(c))
    return total


def ceiling_limits(pod) -> ResourceList:
    """The limits counterpart of ceiling_requests (no request merge)."""
    total: ResourceList = {}
    for c in pod.spec.containers:
        total = merge(total, dict(c.resources.limits))
    for c in pod.spec.init_containers:
        total = max_resources(total, dict(c.resources.limits))
    return total


def requests_for_pods(*pods) -> ResourceList:
    """Total requests plus a "pods" count entry (resources.go RequestsForPods)."""
    merged = merge(*[ceiling_requests(p) for p in pods])
    merged["pods"] = float(len(pods))
    return merged


def limits_for_pods(*pods) -> ResourceList:
    """Total limits plus a "pods" count entry (resources.go LimitsForPods)."""
    merged = merge(*[ceiling_limits(p) for p in pods])
    merged["pods"] = float(len(pods))
    return merged


def to_string(rl: ResourceList) -> str:
    """`cpu=1, memory=1024` in key order; `{}` when empty."""
    if not rl:
        return "{}"
    return ", ".join(f"{k}={rl[k]:g}" for k in sorted(rl))
