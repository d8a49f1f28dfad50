"""Metrics decorator for the CloudProvider SPI.

Mirrors the reference decorator (pkg/cloudprovider/metrics/cloudprovider.go:37-66):
every SPI call is timed into a shared duration histogram labeled by
(controller, method, provider), so vendor latency is observable regardless of
which controller triggered the call.
"""
from __future__ import annotations

import time
from typing import List

from karpenter_core_tpu_torch.cloudprovider.types import InstanceType
from karpenter_core_tpu_torch.metrics.registry import NAMESPACE, REGISTRY

METHOD_DURATION = REGISTRY.histogram(
    f"{NAMESPACE}_cloudprovider_duration_seconds",
    "Duration of cloud provider method calls, by method and provider.",
)


class DecoratedCloudProvider:
    """Wraps any CloudProvider, timing each SPI method
    (cloudprovider/metrics/cloudprovider.go:66 Decorate). The reference
    resolves the controller label from the injected context; here each
    controller holds its own named wrapper around the shared inner provider."""

    def __init__(self, inner, controller: str = ""):
        self._inner = inner
        self._controller = controller

    def _measure(self, method: str, fn, *args, **kwargs):
        start = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            METHOD_DURATION.observe(
                time.perf_counter() - start,
                labels={
                    "controller": self._controller,
                    "method": method,
                    "provider": self._inner.name(),
                },
            )

    def create(self, machine):
        return self._measure("Create", self._inner.create, machine)

    def delete(self, machine) -> None:
        return self._measure("Delete", self._inner.delete, machine)

    def get(self, machine_name: str, provisioner_name: str = ""):
        return self._measure("Get", self._inner.get, machine_name, provisioner_name)

    def get_instance_types(self, provisioner) -> List[InstanceType]:
        return self._measure("GetInstanceTypes", self._inner.get_instance_types, provisioner)

    def is_machine_drifted(self, machine) -> bool:
        return self._measure("IsMachineDrifted", self._inner.is_machine_drifted, machine)

    def name(self) -> str:
        return self._inner.name()

    def __getattr__(self, attr):
        # vendor/test extensions (e.g. the fake's create_calls) pass through
        return getattr(self._inner, attr)


def decorate(provider, controller: str = ""):
    """Wrap a provider for a given controller. Re-decorating with the same
    controller is a no-op; a different controller gets its own wrapper around
    the shared inner provider (never a wrapper-of-wrapper)."""
    if isinstance(provider, DecoratedCloudProvider):
        if provider._controller == controller:
            return provider
        return DecoratedCloudProvider(provider._inner, controller)
    return DecoratedCloudProvider(provider, controller)
