"""Per-node unique (hostIP, hostPort, protocol) reservations with
validate-before-add (pkg/scheduling/hostportusage.go:29-145)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from karpenter_core_tpu_torch.kube.objects import NamespacedName, object_key

_UNSPECIFIED = ("", "0.0.0.0", "::")


@dataclass(frozen=True)
class HostPortEntry:
    ip: str
    port: int
    protocol: str

    def matches(self, other: "HostPortEntry") -> bool:
        """hostportusage.go:42-54: an unspecified IP conflicts with every
        IP; the port and the protocol must match."""
        if self.protocol != other.protocol:
            return False
        if self.port != other.port:
            return False
        if (self.ip != other.ip and self.ip not in _UNSPECIFIED
                and other.ip not in _UNSPECIFIED):
            return False
        return True

    def __str__(self) -> str:
        return f"IP={self.ip} Port={self.port} Proto={self.protocol}"


def host_ports(pod) -> List[HostPortEntry]:
    """hostportusage.go:117-140: hostIP defaults to 0.0.0.0, the protocol
    to TCP."""
    usage = []
    for container in pod.spec.containers:
        for port in container.ports:
            if port.host_port == 0:
                continue
            usage.append(HostPortEntry(ip=port.host_ip or "0.0.0.0",
                                       port=port.host_port,
                                       protocol=port.protocol or "TCP"))
    return usage


class HostPortUsage:
    """hostportusage.go:29-115."""

    def __init__(self):
        self.reserved: Dict[NamespacedName, List[HostPortEntry]] = {}

    def add(self, pod) -> None:
        new_usage, _ = self._validate(pod)
        self.reserved[object_key(pod)] = new_usage

    def validate(self, pod) -> Optional[str]:
        _, err = self._validate(pod)
        return err

    def _validate(self, pod) -> Tuple[List[HostPortEntry], Optional[str]]:
        new_usage = host_ports(pod)
        pod_key = object_key(pod)
        for new_entry in new_usage:
            for key, entries in self.reserved.items():
                if key == pod_key:
                    continue
                for existing in entries:
                    if new_entry.matches(existing):
                        return [], (f"{new_entry} conflicts with existing HostPort "
                                    f"configuration {existing}")
        return new_usage, None

    def delete_pod(self, key: NamespacedName) -> None:
        self.reserved.pop(key, None)

    def deep_copy(self) -> "HostPortUsage":
        out = HostPortUsage()
        out.reserved = {k: list(v) for k, v in self.reserved.items()}
        return out
