"""The event recorder: deduplicated, rate-limited publishing of the
typed events of pkg/events (events.go, recorder.go).

A published event lands in an in-memory ring (for_object, export) and, when
the recorder has a kube client, as a core/v1 Event object written through
it by one buffered poster thread, so that a slow client never blocks the
controller that publishes. An identical event (kind, name, type, reason and
dedupe values, or the message) is dropped for two minutes; an event that
carries a rate limit draws from a token bucket shared by its (kind,
reason), which only pod nomination does.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional


@dataclass(frozen=True)
class Event:
    involved_kind: str
    involved_name: str
    type: str  # Normal | Warning
    reason: str
    message: str
    dedupe_values: tuple = ()
    timestamp: float = 0.0
    # this event's dedupe window in seconds; None: Recorder.DEDUPE_TTL
    dedupe_timeout: Optional[float] = None
    # (qps, burst) of the token bucket shared per (kind, reason)
    rate_limit: Optional[tuple] = None

    def dedupe_key(self) -> tuple:
        return (self.involved_kind, self.involved_name, self.type, self.reason,
                self.dedupe_values or (self.message,))


class Recorder:
    """recorder.go: a two-minute dedupe window per event key and the
    token bucket of the events that carry one."""

    DEDUPE_TTL = 120.0
    # PodNominationRateLimiter (events.go:25), shared by every nomination
    POD_NOMINATION_RATE_LIMIT = (5.0, 10)

    def __init__(self, clock=None, capacity: int = 4096, kube_client=None):
        self.clock = clock if clock is not None else time.time
        self.kube_client = kube_client
        self._mu = threading.Lock()
        self._seen: Dict[tuple, float] = {}
        self._tokens: Dict[tuple, List[float]] = {}  # (kind, reason) -> [tokens, last]
        self._last_purge = 0.0
        self._posted = 0
        self._post_q = None
        self._post_thread: Optional[threading.Thread] = None
        self._closed = False
        self._post_idle = threading.Event()
        self._post_idle.set()
        self.events: Deque[Event] = deque(maxlen=capacity)

    def publish(self, event: Event) -> bool:
        """True when the event was recorded, False when deduplicated or
        rate-limited."""
        now = self.clock()
        key = event.dedupe_key()
        ttl = self.DEDUPE_TTL if event.dedupe_timeout is None else event.dedupe_timeout
        with self._mu:
            if now - self._last_purge > self.DEDUPE_TTL:
                self._seen = {k: exp for k, exp in self._seen.items() if now < exp}
                self._last_purge = now
            expiry = self._seen.get(key)
            if expiry is not None and now < expiry:
                return False
            self._seen[key] = now + ttl
            if event.rate_limit is not None:
                qps, burst = event.rate_limit
                type_key = (event.involved_kind, event.reason)
                tokens, last_t = self._tokens.get(type_key, [float(burst), now])
                tokens = min(float(burst), tokens + (now - last_t) * qps)
                if tokens < 1.0:
                    self._tokens[type_key] = [tokens, now]
                    return False
                self._tokens[type_key] = [tokens - 1.0, now]
            self.events.append(dataclasses.replace(event, timestamp=now))
            self._posted += 1
            seq = self._posted
        self._post_to_cluster(event, now, seq)
        return True

    def _post_to_cluster(self, event: Event, now: float, seq: int) -> None:
        """Queue the core/v1 Event for the poster thread, named
        `<name>.<hex>` as client-go names them; a full queue drops the
        cluster's copy (the ring keeps the event)."""
        if self.kube_client is None:
            return
        from karpenter_core_tpu_torch.kube.objects import Event as KubeEvent

        ns, _, name = event.involved_name.rpartition("/")
        obj = KubeEvent()
        obj.metadata.namespace = ns or "default"
        obj.metadata.name = f"{name}.{format(int(now * 1e6) + seq, 'x')}"
        obj.involved_object.kind = event.involved_kind
        obj.involved_object.namespace = ns
        obj.involved_object.name = name
        obj.reason = event.reason
        obj.message = event.message
        obj.type = event.type
        obj.first_timestamp = obj.last_timestamp = now
        poster = self._poster()
        if poster is None:
            return  # closed: the ring keeps the event
        try:
            poster.put_nowait(obj)
        except queue.Full:
            return
        self._post_idle.clear()

    def _poster(self) -> Optional[queue.Queue]:
        with self._mu:
            if self._closed:
                return None
            if self._post_q is None:
                self._post_q = q = queue.Queue(maxsize=1024)
                self._post_thread = threading.Thread(target=self._post_loop, args=(q,),
                                                     daemon=True, name="event-poster")
                self._post_thread.start()
            return self._post_q

    def close(self, timeout: float = 5.0) -> bool:
        """Write what is queued, then stop the poster thread and join it;
        whether it ended in time. A later publish keeps its event in the
        ring only: nothing is posted to the cluster after the close."""
        with self._mu:
            q, thread = self._post_q, self._post_thread
            self._post_q = self._post_thread = None
            self._closed = True
        if q is None:
            return True
        try:
            q.put(None, timeout=timeout)  # after everything queued before it
        except queue.Full:
            return False
        thread.join(timeout)
        return not thread.is_alive()

    def _post_loop(self, post_q: queue.Queue) -> None:
        posted = 0
        while True:
            try:
                obj = post_q.get(timeout=0.2)
            except queue.Empty:
                self._post_idle.set()
                continue
            if obj is None:  # close()
                self._post_idle.set()
                return
            try:
                self.kube_client.create(obj)
            except Exception:  # noqa: BLE001 — the cluster's copy is best-effort
                pass
            posted += 1
            if posted % 256 == 0:
                self._prune_cluster_events()
            if post_q.empty():
                self._post_idle.set()

    def _prune_cluster_events(self) -> None:
        """Keep at most the ring's capacity of Event objects in an
        in-memory client, oldest deleted first (an apiserver expires
        events itself)."""
        from karpenter_core_tpu_torch.kube.client import InMemoryKubeClient

        if not isinstance(self.kube_client, InMemoryKubeClient):
            return
        events = self.kube_client.list("Event", copy_objects=False)
        cap = self.events.maxlen or 4096
        if len(events) > cap:
            events = sorted(events, key=lambda e: e.metadata.creation_timestamp or 0.0)
            for e in events[: len(events) - cap]:
                try:
                    self.kube_client.delete("Event", e.metadata.namespace, e.metadata.name)
                except Exception:  # noqa: BLE001 — deleted meanwhile
                    pass

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait until the queued Event objects are written."""
        with self._mu:
            started = self._post_q is not None
        if not started:
            return True
        return self._post_idle.wait(timeout)

    def export(self) -> List[dict]:
        """The ring as dicts, each with its dedupe window and rate limit."""
        with self._mu:
            events = list(self.events)
        return [{
            "kind": e.involved_kind, "name": e.involved_name, "type": e.type,
            "reason": e.reason, "message": e.message, "timestamp": e.timestamp,
            "dedupe_values": list(e.dedupe_values),
            "dedupe_timeout": self.DEDUPE_TTL if e.dedupe_timeout is None else e.dedupe_timeout,
            "rate_limit": list(e.rate_limit) if e.rate_limit is not None else None,
        } for e in events]

    def for_object(self, kind: str, name: str) -> List[Event]:
        with self._mu:
            return [e for e in self.events
                    if e.involved_kind == kind and e.involved_name == name]

    # -- the typed events (events.go) -----------------------------------------

    def nominate_pod(self, pod, node_name: str) -> None:
        self.publish(Event("Pod", f"{pod.metadata.namespace}/{pod.metadata.name}", "Normal",
                           "Nominated", f"Pod should schedule on {node_name}",
                           rate_limit=self.POD_NOMINATION_RATE_LIMIT))

    def pod_failed_to_schedule(self, pod, err: str) -> None:
        self.publish(Event("Pod", f"{pod.metadata.namespace}/{pod.metadata.name}", "Warning",
                           "FailedScheduling", f"Failed to schedule pod, {err}"))

    def evict_pod(self, pod) -> None:
        self.publish(Event("Pod", f"{pod.metadata.namespace}/{pod.metadata.name}", "Normal",
                           "Evicted", "Evicted pod"))

    def node_failed_to_drain(self, node, err: str) -> None:
        self.publish(Event("Node", node.metadata.name, "Warning", "FailedDraining",
                           f"Failed to drain node, {err}"))

    def node_inflight_check(self, node, message: str) -> None:
        self.publish(Event("Node", node.metadata.name, "Warning", "FailedInflightCheck",
                           message))

    def deprovisioning_blocked(self, kind: str, name: str, reason: str) -> None:
        self.publish(Event(kind, name, "Normal", "Unconsolidatable", reason))

    def deprovisioning_launching(self, machine_name: str, reason: str) -> None:
        self.publish(Event("Machine", machine_name, "Normal", "DeprovisioningLaunching",
                           f"Launching for {reason}"))

    def deprovisioning_terminating(self, node_name: str, reason: str) -> None:
        self.publish(Event("Node", node_name, "Normal", "DeprovisioningTerminating",
                           f"Terminating for {reason}"))
