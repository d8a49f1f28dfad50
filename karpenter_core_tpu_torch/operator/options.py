"""Process options: command-line flags with environment fallbacks
(options/options.go:30-76): the ports, the client's QPS and burst, leader
election, the memory limit, profiling, the webhook switch, the batcher's
windows and the solver endpoint. Flags win over the environment, the
environment over the defaults, so a deployment configured by environment
keeps working.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

from karpenter_core_tpu_torch.obs import envflags

_env = envflags.raw


@dataclass
class Options:
    """options.go:30-45."""

    metrics_port: int = 8000
    health_probe_port: int = 8081
    webhook_port: int = 8443
    kube_client_qps: float = 200.0
    kube_client_burst: int = 300
    enable_leader_election: bool = True
    enable_profiling: bool = False
    disable_webhook: bool = False
    memory_limit: int = -1  # bytes; <= 0: no collector tuning
    log_level: str = "INFO"
    batch_idle_seconds: float = 1.0
    batch_max_seconds: float = 10.0
    solver_endpoint: str = ""

    def apply_memory_limit(self) -> None:
        """The reference process sets a collector soft limit at 90% of
        --memory-limit (options.go:72-76, debug.SetMemoryLimit); here a
        configured limit raises the collector's thresholds for a large
        heap, and no limit changes nothing."""
        if self.memory_limit > 0:
            import gc

            gc.set_threshold(50_000, 50, 50)


def parse_options(argv=None) -> Options:
    """Flags > environment > defaults (options.go:48-76)."""
    parser = argparse.ArgumentParser(
        prog="karpenter-core-tpu-torch",
        description="karpenter-core-tpu-torch controller process",
    )
    parser.add_argument("--metrics-port", type=int,
                        default=int(_env("KARPENTER_METRICS_PORT", "8000")))
    parser.add_argument("--health-probe-port", type=int,
                        default=int(_env("KARPENTER_HEALTH_PROBE_PORT", "8081")))
    parser.add_argument("--webhook-port", type=int,
                        default=int(_env("KARPENTER_WEBHOOK_PORT", "8443")))
    parser.add_argument("--kube-client-qps", type=float,
                        default=float(_env("KARPENTER_KUBE_CLIENT_QPS", "200")))
    parser.add_argument("--kube-client-burst", type=int,
                        default=int(_env("KARPENTER_KUBE_CLIENT_BURST", "300")))
    parser.add_argument("--leader-elect", dest="enable_leader_election",
                        action=argparse.BooleanOptionalAction,
                        default=_env("KARPENTER_LEADER_ELECT", "true").lower() != "false")
    parser.add_argument("--enable-profiling", action="store_true",
                        default=_env("KARPENTER_ENABLE_PROFILING", "") == "1")
    parser.add_argument("--disable-webhook", action="store_true",
                        default=_env("KARPENTER_DISABLE_WEBHOOK", "") == "1")
    parser.add_argument("--memory-limit", type=int,
                        default=int(_env("KARPENTER_MEMORY_LIMIT", "-1")))
    parser.add_argument("--log-level", default=_env("KARPENTER_LOG_LEVEL", "INFO"))
    parser.add_argument("--batch-idle-seconds", type=float,
                        default=float(_env("KARPENTER_BATCH_IDLE_SECONDS", "1")))
    parser.add_argument("--batch-max-seconds", type=float,
                        default=float(_env("KARPENTER_BATCH_MAX_SECONDS", "10")))
    parser.add_argument("--solver-endpoint", default=_env("KARPENTER_SOLVER_ENDPOINT", ""))
    ns = parser.parse_args(argv)
    return Options(**vars(ns))
