"""The provisioning batch window (batcher.go:40-74): wait for the first
trigger, then extend the window while triggers keep arriving within the
idle duration, up to the max duration. A closed window is recorded as a
`batcher.window` span from its first trigger to its close: the batching
latency a pod pays before its solve starts."""
from __future__ import annotations

import threading
import time

from karpenter_core_tpu_torch.api.settings import Settings, current
from karpenter_core_tpu_torch.obs import TRACER


class Batcher:
    def __init__(self, settings: Settings = None, clock=time.monotonic):
        self.settings = settings
        self.clock = clock
        self._trigger = threading.Event()
        self._mu = threading.Lock()
        self._triggers = 0  # triggers ever
        self._consumed = 0  # triggers folded into closed windows
        self.last_window = {}  # how the last window closed, and its triggers

    def trigger(self) -> None:
        with self._mu:
            self._triggers += 1
        self._trigger.set()

    def wait(self, timeout: float = None, poll: float = 0.01) -> bool:
        """True when a window closed with work to do; False when no
        trigger came within `timeout`."""
        settings = self.settings or current()
        if not self._trigger.wait(timeout=timeout):
            return False
        start_ns = time.perf_counter_ns()
        start = last = self.clock()
        self._trigger.clear()
        while True:
            now = self.clock()
            closed = ("max" if now - start >= settings.batch_max_duration
                      else "idle" if now - last >= settings.batch_idle_duration
                      else None)
            if closed:
                with self._mu:
                    folded = self._triggers - self._consumed
                    self._consumed = self._triggers
                    self.last_window = {"closed_by": closed, "triggers": folded,
                                        "s": now - start}
                TRACER.add_span("batcher.window", start_ns, time.perf_counter_ns(),
                                closed_by=closed, triggers=folded)
                return True
            # each wait is capped at the time left to the nearer bound, so
            # that a stream of triggers never carries the window past the
            # max duration (a trigger moves `last`, never `start`)
            remaining = min(settings.batch_max_duration - (now - start),
                            settings.batch_idle_duration - (now - last))
            if self._trigger.wait(timeout=max(min(poll, remaining), 0.0)):
                self._trigger.clear()
                last = self.clock()
