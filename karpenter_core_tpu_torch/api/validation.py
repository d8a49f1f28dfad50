"""Requirement validation (provisioner_validation.go ValidateRequirement):
the check a pending pod's node-affinity terms must pass before the
provisioner takes the pod into a batch."""
from __future__ import annotations

import re
from typing import List

from karpenter_core_tpu_torch.api import labels as api_labels

SUPPORTED_NODE_SELECTOR_OPS = frozenset({"In", "NotIn", "Gt", "Lt", "Exists", "DoesNotExist"})

_NAME_PART = re.compile(r"^[A-Za-z0-9]([A-Za-z0-9._-]*[A-Za-z0-9])?$")
_DNS1123_SUBDOMAIN = re.compile(
    r"^[a-z0-9]([a-z0-9-]*[a-z0-9])?(\.[a-z0-9]([a-z0-9-]*[a-z0-9])?)*$"
)


def is_qualified_name(name: str) -> List[str]:
    """Label key syntax: an optional DNS-1123 subdomain prefix and '/', then
    a name part of at most 63 characters."""
    errs: List[str] = []
    if not name:
        return ["name part must be non-empty"]
    parts = name.split("/")
    if len(parts) == 1:
        prefix, part = "", parts[0]
    elif len(parts) == 2:
        prefix, part = parts
        if not prefix:
            errs.append("prefix part must be non-empty")
        elif len(prefix) > 253 or not _DNS1123_SUBDOMAIN.match(prefix):
            errs.append(f"prefix part {prefix!r} must be a valid DNS-1123 subdomain")
    else:
        return [f"a qualified name {name!r} must have at most one '/'"]
    if not part:
        errs.append("name part must be non-empty")
    elif len(part) > 63 or not _NAME_PART.match(part):
        errs.append(
            f"name part {part!r} must be 63 characters or less, start and end "
            f"alphanumeric, with '-', '_' or '.' between"
        )
    return errs


def is_valid_label_value(value: str) -> List[str]:
    if value == "":
        return []
    if len(value) > 63 or not _NAME_PART.match(value):
        return [
            f"label value {value!r} must be 63 characters or less, start and end "
            f"alphanumeric, with '-', '_' or '.' between"
        ]
    return []


def validate_requirement(req) -> List[str]:
    """The errors of one NodeSelectorRequirement (empty when valid)."""
    errs: List[str] = []
    key = api_labels.NORMALIZED_LABELS.get(req.key, req.key)
    if req.operator not in SUPPORTED_NODE_SELECTOR_OPS:
        errs.append(
            f"key {key} has an unsupported operator {req.operator} not in "
            f"{sorted(SUPPORTED_NODE_SELECTOR_OPS)}"
        )
    restricted = api_labels.is_restricted_label(key)
    if restricted is not None:
        errs.append(restricted)
    for err in is_qualified_name(key):
        errs.append(f"key {key} is not a qualified name, {err}")
    for value in req.values:
        for err in is_valid_label_value(value):
            errs.append(f"invalid value {value} for key {key}, {err}")
    if req.operator == "In" and not req.values:
        errs.append(f"key {key} with operator In must have a value defined")
    if req.operator in ("Gt", "Lt"):
        ok = len(req.values) == 1
        if ok:
            try:
                ok = int(req.values[0]) >= 0
            except ValueError:
                ok = False
        if not ok:
            errs.append(
                f"key {key} with operator {req.operator} must have a single "
                f"positive integer value"
            )
    return errs
