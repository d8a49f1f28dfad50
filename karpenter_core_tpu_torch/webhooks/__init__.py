"""Admission webhooks: CRD defaulting, CRD validation and the settings
ConfigMap's validation (webhooks.go:17-63).

Admission runs in-process: `install(client)` wraps the kube client's
create and update so that every write is defaulted, then validated, the
guarantee an admission webhook gives at the apiserver.
webhooks/server.py serves the same brain over HTTPS as AdmissionReview.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from karpenter_core_tpu_torch.api.settings import Settings
from karpenter_core_tpu_torch.api.validation import (
    ValidationError,
    set_machine_defaults,
    set_provisioner_defaults,
    validate_machine,
    validate_provisioner,
)

SETTINGS_CONFIG_MAP_NAME = "karpenter-global-settings"


def validate_settings_config_map(config_map) -> List[str]:
    """The ConfigMap webhook (webhooks.go:44-52): the settings must parse;
    unknown keys are tolerated, as upstream."""
    try:
        Settings.from_config_map(getattr(config_map, "data", {}) or {})
    except (ValueError, KeyError) as e:
        return [f"invalid settings: {e}"]
    return []


class AdmissionWebhooks:
    """Defaulting and validating admission for Provisioner, Machine and the
    settings ConfigMap."""

    def __init__(self):
        self.defaulters: dict = {
            "Provisioner": set_provisioner_defaults,
            "Machine": set_machine_defaults,
        }
        self.validators: dict = {
            "Provisioner": validate_provisioner,
            "Machine": validate_machine,
        }

    def admit(self, obj) -> object:
        """Default, then validate; ValidationError on rejection."""
        kind = type(obj).__name__
        if kind == "ConfigMap" and obj.metadata.name == SETTINGS_CONFIG_MAP_NAME:
            errors = validate_settings_config_map(obj)
            if errors:
                raise ValidationError(errors)
            return obj
        defaulter = self.defaulters.get(kind)
        if defaulter is not None:
            defaulter(obj)
        validator = self.validators.get(kind)
        if validator is not None:
            errors = validator(obj)
            if errors:
                raise ValidationError(errors)
        return obj


def install(kube_client, webhooks: Optional[AdmissionWebhooks] = None) -> AdmissionWebhooks:
    """Wrap the client's create and update with admission
    (operator.WithWebhooks, operator.go:149-152)."""
    webhooks = webhooks or AdmissionWebhooks()
    create, update = kube_client.create, kube_client.update

    def admitted(write: Callable):
        def inner(obj):
            webhooks.admit(obj)
            return write(obj)

        return inner

    kube_client.create = admitted(create)
    kube_client.update = admitted(update)
    return webhooks
