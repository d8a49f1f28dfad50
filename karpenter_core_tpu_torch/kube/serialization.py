"""k8s JSON <-> object-model conversion: the port's copy of the reference
package's, over the port's own object model.

The object model (kube/objects.py, api/*.py) uses snake_case dataclasses
with float quantities; the wire format (a flight record, an AdmissionReview
payload, a real apiserver) uses camelCase JSON with string quantities.
`from_k8s_dict` / `to_k8s_dict` convert generically from the dataclass type
hints, so every kind round-trips without per-type marshalling code, and a
dict written by either package reads back in the other.
"""
from __future__ import annotations

import dataclasses
import typing

from karpenter_core_tpu_torch.utils.resources import parse_quantity


def camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


def snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


# fields whose wire names aren't a plain camelCase of the attribute.
# provider_id rides as "providerID" (capital ID — k8s convention, and the
# shipped Machine CRD schema's own spelling): a real apiserver would
# silently drop "providerId" writes and the adapter would decode '' back,
# breaking node<->machine matching.
_SPECIAL_WIRE = {
    "creation_timestamp": "creationTimestamp",
    "deletion_timestamp": "deletionTimestamp",
    "resource_version": "resourceVersion",
    "provider_id": "providerID",
}


def _wire_name(cls, fname: str) -> str:
    overrides = getattr(cls, "_WIRE_OVERRIDES", None)
    if overrides and fname in overrides:
        return overrides[fname]
    return _SPECIAL_WIRE.get(fname, camel(fname))


def _is_time_field(name: str) -> bool:
    """Float fields holding epoch seconds that ride the wire as RFC3339
    (k8s Time/MicroTime): creationTimestamp, deletionTimestamp, the Event
    first/lastTimestamp, the Lease acquire/renewTime. A real apiserver
    always stamps these — the adapter must parse them, not feed them to
    the quantity parser."""
    return name.endswith("_timestamp") or name.endswith("_time")


def _parse_time(v) -> float:
    if isinstance(v, (int, float)):
        return float(v)
    from datetime import datetime

    return datetime.fromisoformat(str(v).replace("Z", "+00:00")).timestamp()


def _format_time(v: float) -> str:
    from datetime import datetime, timezone

    return (
        datetime.fromtimestamp(float(v), timezone.utc)
        .isoformat(timespec="microseconds")
        .replace("+00:00", "Z")
    )


def _strip_optional(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _is_quantity_map(tp) -> bool:
    """Dict[str, float] fields are ResourceLists: values may arrive as k8s
    quantity strings ("100m", "1Gi")."""
    return (
        typing.get_origin(tp) is dict
        and typing.get_args(tp) == (str, float)
    )


# per type: how from_k8s_dict reads it and to_k8s_dict writes it (a
# dataclass's type hints resolved once per type, not once per object)
_PLANS: dict = {}


def _plan(cls):
    plan = _PLANS.get(cls)
    if plan is not None:
        return plan
    tp = _strip_optional(cls)
    origin = typing.get_origin(tp)
    if origin is list:
        plan = ("list", typing.get_args(tp)[0])
    elif origin is dict:
        val_tp = typing.get_args(tp)[1]
        plan = ("quantities", None) if val_tp is float else ("dict", val_tp)
    elif dataclasses.is_dataclass(tp):
        hints = typing.get_type_hints(tp)
        wrap = getattr(tp, "_WIRE_WRAP", None) or {}
        plan = ("dataclass", tp, tuple(
            (f.name, _wire_name(tp, f.name), hints[f.name], wrap.get(f.name),
             _is_time_field(f.name))
            for f in dataclasses.fields(tp)))
    elif tp is float:
        plan = ("float", None)
    else:
        plan = ("as_is", None)  # int, str, bool, Any, a plain dict
    _PLANS[cls] = plan
    return plan


def from_k8s_dict(cls, data):
    """Build `cls` from a camelCase k8s JSON dict. Unknown keys are ignored
    (server-side pruning analog); missing keys take dataclass defaults."""
    if data is None:
        return None
    plan = _plan(cls)
    how = plan[0]
    if how == "dataclass":
        kwargs = {}
        for name, wire, hint, wrap_key, is_time in plan[2]:
            if wire in data:
                raw = data[wire]
            elif name in data:
                raw = data[name]
            else:
                continue
            if wrap_key is not None and isinstance(raw, dict):
                # wire wraps the list in an object (e.g. NodeAffinity's
                # required is a NodeSelector{nodeSelectorTerms: [...]})
                raw = raw.get(wrap_key, [])
            if is_time and raw is not None:
                kwargs[name] = _parse_time(raw)
            else:
                kwargs[name] = from_k8s_dict(hint, raw)
        return plan[1](**kwargs)
    if how == "list":
        return [from_k8s_dict(plan[1], item) for item in data]
    if how == "quantities":
        return {k: _to_float(v) for k, v in data.items()}
    if how == "dict":
        return {k: from_k8s_dict(plan[1], v) for k, v in data.items()}
    if how == "float":
        return _to_float(data)
    return data


def _to_float(v) -> float:
    if isinstance(v, str):
        return parse_quantity(v)
    return float(v)


def to_k8s_dict(obj):
    """Serialize an object-model instance to a camelCase k8s JSON dict.
    Empty lists/dicts/None are dropped (k8s omitempty semantics)."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for name, wire, _hint, wrap_key, is_time in _plan(type(obj))[2]:
            value = getattr(obj, name)
            if is_time and isinstance(value, (int, float)):
                # zero means unset in the object model: OMIT it rather than
                # emit a bare float a real apiserver would reject for a
                # Time/MicroTime field
                encoded = _format_time(value) if value else None
            else:
                encoded = to_k8s_dict(value)
            if encoded in (None, [], {}, ""):
                continue
            if wrap_key is not None:
                encoded = {wrap_key: encoded}
            out[wire] = encoded
        return out
    if isinstance(obj, list):
        return [to_k8s_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_k8s_dict(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return list(obj)
    return obj
