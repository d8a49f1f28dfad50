"""API validation and defaulting for the Provisioner and Machine CRDs
(provisioner_validation.go: TTL signs, consolidation against the empty
TTL, provider xor providerRef, label name and value syntax, restricted
labels, taint keys, effects and duplicates, requirement operators and
values, the kubelet's eviction signals and reserved resources;
machine_validation.go and the *_defaults.go files, empty upstream).

Every function returns a list of readable field errors (knative's
apis.FieldError) and raises nothing; `validate_or_raise` raises
ValidationError. The pending-pod check of the provisioner reads
`validate_requirement`.
"""
from __future__ import annotations

import re
from typing import Dict, List

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.api.machine import Machine
from karpenter_core_tpu_torch.api.provisioner import (
    KubeletConfiguration,
    Provisioner,
    ProvisionerSpec,
)
from karpenter_core_tpu_torch.kube.objects import NodeSelectorRequirement, Taint
from karpenter_core_tpu_torch.utils.resources import parse_quantity

# provisioner_validation.go:35-43
SUPPORTED_NODE_SELECTOR_OPS = frozenset(
    {"In", "NotIn", "Gt", "Lt", "Exists", "DoesNotExist"}
)
# provisioner_validation.go:45-50
SUPPORTED_RESERVED_RESOURCES = frozenset({"cpu", "memory", "ephemeral-storage", "pid"})
# provisioner_validation.go:52-59
SUPPORTED_EVICTION_SIGNALS = frozenset(
    {
        "memory.available",
        "nodefs.available",
        "nodefs.inodesFree",
        "imagefs.available",
        "imagefs.inodesFree",
        "pid.available",
    }
)

TAINT_EFFECTS = frozenset({"NoSchedule", "PreferNoSchedule", "NoExecute", ""})

_NAME_PART = re.compile(r"^[A-Za-z0-9]([A-Za-z0-9._-]*[A-Za-z0-9])?$")
_DNS1123_SUBDOMAIN = re.compile(
    r"^[a-z0-9]([a-z0-9-]*[a-z0-9])?(\.[a-z0-9]([a-z0-9-]*[a-z0-9])?)*$"
)
_DNS1123_LABEL = re.compile(r"^[a-z0-9]([a-z0-9-]*[a-z0-9])?$")


class ValidationError(Exception):
    """Aggregated field errors (admission-reject analog)."""

    def __init__(self, errors: List[str]):
        self.errors = errors
        super().__init__("; ".join(errors))


# ---------------------------------------------------------------------------
# k8s name / label syntax (apimachinery util/validation analog)


def is_qualified_name(name: str) -> List[str]:
    """Label/taint key syntax: optional DNS-1123 subdomain prefix + '/' +
    a 63-char alphanumeric name part."""
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


def is_dns1123_subdomain(value: str) -> List[str]:
    if len(value) > 253 or not _DNS1123_SUBDOMAIN.match(value):
        return [f"{value!r} must be a valid DNS-1123 subdomain"]
    return []


# ---------------------------------------------------------------------------
# requirement validation (provisioner_validation.go ValidateRequirement)


def validate_requirement(req: NodeSelectorRequirement) -> List[str]:
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


# ---------------------------------------------------------------------------
# provisioner validation


def validate_provisioner(provisioner: Provisioner) -> List[str]:
    errs: List[str] = []
    name = provisioner.metadata.name
    if not name:
        errs.append("metadata.name: name is required")
    elif len(name) > 63 or not _DNS1123_LABEL.match(name):
        errs.append(f"metadata.name: {name!r} must be a valid DNS-1123 label")
    errs.extend(_validate_spec(provisioner.spec))
    return errs


def _validate_spec(spec: ProvisionerSpec) -> List[str]:
    errs: List[str] = []
    if spec.ttl_seconds_until_expired is not None and spec.ttl_seconds_until_expired < 0:
        errs.append("ttlSecondsUntilExpired: cannot be negative")
    if spec.ttl_seconds_after_empty is not None and spec.ttl_seconds_after_empty < 0:
        errs.append("ttlSecondsAfterEmpty: cannot be negative")
    # TTLSecondsAfterEmpty and consolidation are mutually exclusive
    if (
        spec.consolidation is not None
        and spec.consolidation.enabled
        and spec.ttl_seconds_after_empty is not None
    ):
        errs.append(
            "expected exactly one, got both: ttlSecondsAfterEmpty, consolidation.enabled"
        )
    errs.extend(_validate_provider(spec))
    errs.extend(_validate_labels(spec.labels))
    errs.extend(_validate_taints(spec))
    for i, req in enumerate(spec.requirements):
        if req.key == api_labels.PROVISIONER_NAME_LABEL_KEY:
            errs.append(f"requirements[{i}]: {req.key} is restricted")
        errs.extend(f"requirements[{i}]: {e}" for e in validate_requirement(req))
    if spec.kubelet_configuration is not None:
        errs.extend(
            f"kubeletConfiguration: {e}"
            for e in _validate_kubelet(spec.kubelet_configuration)
        )
    return errs


def _validate_provider(spec: ProvisionerSpec) -> List[str]:
    if spec.provider is not None and spec.provider_ref is not None:
        return ["expected exactly one, got both: provider, providerRef"]
    if spec.provider is None and spec.provider_ref is None:
        return ["expected exactly one, got neither: provider, providerRef"]
    return []


def _validate_labels(labels: Dict[str, str]) -> List[str]:
    errs: List[str] = []
    for key, value in labels.items():
        if key == api_labels.PROVISIONER_NAME_LABEL_KEY:
            errs.append(f"labels: invalid key name {key}, restricted")
        for err in is_qualified_name(key):
            errs.append(f"labels: invalid key name {key}, {err}")
        for err in is_valid_label_value(value):
            errs.append(f"labels[{key}]: invalid value {value}, {err}")
        restricted = api_labels.is_restricted_label(key)
        if restricted is not None:
            errs.append(f"labels: invalid key name {key}, {restricted}")
    return errs


def _validate_taints(spec: ProvisionerSpec) -> List[str]:
    errs: List[str] = []
    seen: set = set()
    for field_name, taints in (("taints", spec.taints), ("startupTaints", spec.startup_taints)):
        for i, taint in enumerate(taints):
            errs.extend(_validate_taint(taint, field_name, i))
            pair = (taint.key, taint.effect)
            if pair in seen:
                errs.append(
                    f"{field_name}[{i}]: duplicate taint Key/Effect pair "
                    f"{taint.key}={taint.effect}"
                )
            seen.add(pair)
    return errs


def _validate_taint(taint: Taint, field_name: str, i: int) -> List[str]:
    errs: List[str] = []
    if not taint.key:
        errs.append(f"{field_name}[{i}]: taint key is required")
    else:
        for err in is_qualified_name(taint.key):
            errs.append(f"{field_name}[{i}]: {err}")
    if taint.value:
        for err in is_valid_label_value(taint.value):
            errs.append(f"{field_name}[{i}]: {err}")
    if taint.effect not in TAINT_EFFECTS:
        errs.append(f"{field_name}[{i}]: invalid effect {taint.effect}")
    return errs


def _validate_kubelet(kc: KubeletConfiguration) -> List[str]:
    errs: List[str] = []
    errs.extend(_validate_eviction_thresholds(kc.eviction_hard, "evictionHard"))
    errs.extend(_validate_eviction_thresholds(kc.eviction_soft, "evictionSoft"))
    errs.extend(_validate_reserved(kc.kube_reserved, "kubeReserved"))
    errs.extend(_validate_reserved(kc.system_reserved, "systemReserved"))
    for k in kc.eviction_soft_grace_period:
        if k not in SUPPORTED_EVICTION_SIGNALS:
            errs.append(f"evictionSoftGracePeriod: invalid key name {k}")
    # soft thresholds and grace periods must pair up exactly
    for k in set(kc.eviction_soft) - set(kc.eviction_soft_grace_period):
        errs.append(
            f"evictionSoft: key {k} does not have a matching evictionSoftGracePeriod"
        )
    for k in set(kc.eviction_soft_grace_period) - set(kc.eviction_soft):
        errs.append(
            f"evictionSoftGracePeriod: key {k} does not have a matching "
            f"evictionSoft threshold value"
        )
    hi, lo = kc.image_gc_high_threshold_percent, kc.image_gc_low_threshold_percent
    if hi is not None and hi < (lo or 0):
        errs.append(
            "imageGCHighThresholdPercent: must be greater than imageGCLowThresholdPercent"
        )
    if kc.max_pods is not None and kc.max_pods < 0:
        errs.append("maxPods: cannot be negative")
    if kc.pods_per_core is not None and kc.pods_per_core < 0:
        errs.append("podsPerCore: cannot be negative")
    return errs


def _validate_reserved(resources: Dict[str, object], field_name: str) -> List[str]:
    errs: List[str] = []
    for k, v in resources.items():
        if k not in SUPPORTED_RESERVED_RESOURCES:
            errs.append(f"{field_name}: invalid key name {k}")
        try:
            if parse_quantity(v) < 0:
                errs.append(f'{field_name}["{k}"]: value cannot be a negative quantity')
        except (ValueError, TypeError):
            errs.append(f'{field_name}["{k}"]: value could not be parsed as a quantity')
    return errs


def _validate_eviction_thresholds(m: Dict[str, str], field_name: str) -> List[str]:
    errs: List[str] = []
    for k, v in m.items():
        if k not in SUPPORTED_EVICTION_SIGNALS:
            errs.append(f"{field_name}: invalid key name {k}")
        if isinstance(v, str) and v.endswith("%"):
            try:
                p = float(v[:-1])
            except ValueError:
                errs.append(
                    f'{field_name}["{k}"]: value could not be parsed as a percentage'
                )
                continue
            if p < 0:
                errs.append(f'{field_name}["{k}"]: percentage values cannot be negative')
            if p > 100:
                errs.append(
                    f'{field_name}["{k}"]: percentage values cannot be greater than 100'
                )
        else:
            try:
                parse_quantity(v)
            except (ValueError, TypeError):
                errs.append(
                    f'{field_name}["{k}"]: value could not be parsed as a quantity'
                )
    return errs


# ---------------------------------------------------------------------------
# machine validation and the defaults (machine_validation.go, *_defaults.go:
# empty upstream, kept as parity points)


def validate_machine(machine: Machine) -> List[str]:
    return []


def set_provisioner_defaults(provisioner: Provisioner) -> None:
    return None


def set_machine_defaults(machine: Machine) -> None:
    return None


def validate_or_raise(obj) -> None:
    """Dispatch by kind; raises ValidationError on failure."""
    kind = type(obj).__name__
    errors = {"Provisioner": validate_provisioner, "Machine": validate_machine}.get(
        kind, lambda _: []
    )(obj)
    if errors:
        raise ValidationError(errors)
