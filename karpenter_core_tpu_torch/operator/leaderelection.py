"""Lease-based leader election (operator.go:108-110: controller-runtime's
"leases" lock, id "karpenter-leader-election").

The control plane runs only while its process holds a
coordination.k8s.io/v1 Lease; a standby takes the lease once the holder's
renew time is older than the lease duration. Both transitions are
compare-and-swap shaped against the apiserver's 409 contract (a create
loses to AlreadyExists, a takeover or renewal is a compare_and_update at
the observed resource version), so of several processes racing over one
client exactly one wins.
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Optional

LEASE_NAME = "karpenter-leader-election"
LEASE_NAMESPACE = "kube-system"
LEASE_DURATION = 15.0  # controller-runtime's defaults
RENEW_PERIOD = 2.0
RETRY_PERIOD = 2.0


class LeaderElector:
    def __init__(self, kube_client, identity: Optional[str] = None,
                 clock=time.time, lease_duration: float = LEASE_DURATION):
        self.kube_client = kube_client
        self.identity = identity or f"karpenter-{uuid.uuid4().hex[:8]}"
        self.clock = clock
        self.lease_duration = lease_duration
        self._renew_thread: Optional[threading.Thread] = None

    def _lease(self):
        return self.kube_client.get("Lease", LEASE_NAMESPACE, LEASE_NAME)

    def try_acquire(self) -> bool:
        """Take or renew the lease when it is free, expired or ours. A lost
        create race or a conflicting write means another process moved
        first: this attempt fails and the caller retries."""
        from karpenter_core_tpu_torch.kube.objects import Lease, LeaseSpec, ObjectMeta

        now = self.clock()
        lease = self._lease()
        if lease is None:
            lease = Lease(
                metadata=ObjectMeta(name=LEASE_NAME, namespace=LEASE_NAMESPACE),
                spec=LeaseSpec(holder_identity=self.identity,
                               lease_duration_seconds=int(self.lease_duration),
                               acquire_time=now, renew_time=now),
            )
            try:
                self.kube_client.create(lease)
            except Exception:  # AlreadyExists: another process created it
                return False
            return True
        holder = lease.spec.holder_identity
        renew_time = lease.spec.renew_time or 0.0
        if holder == self.identity or now - renew_time > self.lease_duration:
            observed_rv = lease.metadata.resource_version
            if holder != self.identity:  # a takeover, not a renewal
                lease.spec.acquire_time = now
                lease.spec.lease_transitions += 1
            lease.spec.holder_identity = self.identity
            lease.spec.renew_time = now
            cas = getattr(self.kube_client, "compare_and_update", None)
            try:
                if cas is not None:
                    cas(lease, observed_rv)
                else:
                    self.kube_client.update(lease)
            except Exception:  # conflict: another process wrote first
                return False
            return True
        return False

    def acquire_blocking(self, stop: threading.Event) -> bool:
        """Block until the lease is held or `stop` is set; whether held."""
        while not stop.is_set():
            if self.try_acquire():
                return True
            stop.wait(RETRY_PERIOD)
        return False

    def start_renewing(self, stop: threading.Event) -> None:
        """Renew every RENEW_PERIOD on a thread; a lost lease sets `stop`,
        which stops the control plane."""
        def renew():
            while not stop.is_set():
                stop.wait(RENEW_PERIOD)
                if stop.is_set():
                    return
                if not self.try_acquire():
                    stop.set()
                    return

        self._renew_thread = threading.Thread(target=renew, name="leader-election-renew",
                                              daemon=True)
        self._renew_thread.start()

    def join(self, timeout: float = 5.0) -> bool:
        """Wait for the renew thread after `stop`; whether it ended."""
        t = self._renew_thread
        if t is not None:
            t.join(timeout)
            return not t.is_alive()
        return True

    def release(self) -> None:
        """Clear the renew time so that a standby takes over at once (a
        graceful hand-off). None, not 0.0, so that the field is left out
        on the wire: an apiserver refuses a MicroTime that is not
        RFC 3339."""
        lease = self._lease()
        if lease is not None and lease.spec.holder_identity == self.identity:
            lease.spec.renew_time = None
            self.kube_client.update(lease)
