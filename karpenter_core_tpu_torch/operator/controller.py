"""The controller runtime: self-clocked singleton loops, key-based typed
reconciles and bounded parallel reconciles (operator/controller:
singleton.go:58-129, typed.go:50-81).

A Singleton reconcile may return its requeue interval; an exception is
logged, counted in RECONCILE_ERRORS (karpenter_controller_reconcile_errors_
total, by controller) and backed off with decorrelated jitter, never
swallowed. Every Singleton reconcile runs inside a `controller.reconcile`
span and a log scope carrying its controller and reconcile id, and its
duration lands in RECONCILE_DURATION (karpenter_controller_reconcile_
duration_seconds, by controller).
"""
from __future__ import annotations

import itertools
import queue
import random
import threading
import time
from typing import Callable, Optional

from karpenter_core_tpu_torch.metrics.registry import REGISTRY
from karpenter_core_tpu_torch.obs import TRACER
from karpenter_core_tpu_torch.obs.log import bound as log_bound, get_logger
from karpenter_core_tpu_torch.operator.injection import with_controller_name
from karpenter_core_tpu_torch.utils.backoff import decorrelated_jitter

LOG = get_logger("karpenter.controller")

# process-wide reconcile ids: every log line inside one reconcile carries
# the same reconcile=rNNN field, so a failing pass greps as a unit
_reconcile_ids = itertools.count(1)

RECONCILE_DURATION = REGISTRY.histogram(
    "karpenter_controller_reconcile_duration_seconds",
    "Duration of controller reconcile loops (singleton.go:66-78)",
)
RECONCILE_ERRORS = REGISTRY.counter(
    "karpenter_controller_reconcile_errors_total",
    "Reconcile invocations that raised (singleton.go:84-90)",
)


def count_error(name: str) -> None:
    RECONCILE_ERRORS.inc(labels={"controller": name})


def reset_counts() -> None:
    RECONCILE_ERRORS.clear()
    RECONCILE_DURATION.clear()


# workqueue.DefaultItemBasedRateLimiter's shape: 5 ms base, 10 s cap
ERROR_BACKOFF_BASE = 0.005
ERROR_BACKOFF_MAX = 10.0


class Singleton:
    """A self-clocked reconcile loop (singleton.go:92-129). reconcile()
    returns the seconds until the next pass, or None for `interval`."""

    def __init__(self, name: str, reconcile: Callable[[], Optional[float]],
                 interval: float = 1.0, rng: Optional[random.Random] = None):
        self.name = name
        self.reconcile = reconcile
        self.interval = interval
        self._failures = 0
        self._rng = rng or random.Random()
        self._last_backoff = ERROR_BACKOFF_BASE  # the last error sleep
        self._thread: Optional[threading.Thread] = None

    def reconcile_once(self) -> Optional[float]:
        """One reconcile; the wait before the next."""
        start = time.perf_counter()
        # allocated outside the bound scope, so that the failure line below
        # carries the same reconcile id as the pass's own lines
        reconcile_id = f"r{next(_reconcile_ids)}"
        try:
            # a provisioning reconcile's solve phases nest under this span;
            # RECONCILE_DURATION is observed below, so the tracer's metrics
            # bridge skips controller.reconcile spans
            with with_controller_name(self.name), log_bound(
                controller=self.name, reconcile=reconcile_id
            ), TRACER.span("controller.reconcile", controller=self.name):
                requeue_after = self.reconcile()
        except Exception:
            count_error(self.name)
            self._failures += 1
            backoff = decorrelated_jitter(self._last_backoff, ERROR_BACKOFF_BASE,
                                          ERROR_BACKOFF_MAX, self._rng)
            self._last_backoff = max(backoff, ERROR_BACKOFF_BASE)
            LOG.exception("reconcile failed", controller=self.name,
                          reconcile=reconcile_id, failures=self._failures,
                          backoff_s=round(backoff, 3))
            return backoff
        finally:
            RECONCILE_DURATION.observe(time.perf_counter() - start,
                                       labels={"controller": self.name})
        self._failures = 0
        self._last_backoff = ERROR_BACKOFF_BASE
        return self.interval if requeue_after is None else requeue_after

    def start(self, stop: threading.Event) -> threading.Thread:
        def loop():
            while not stop.is_set():
                wait = self.reconcile_once()
                if wait and wait > 0:
                    stop.wait(wait)

        self._thread = threading.Thread(target=loop, name=f"singleton-{self.name}",
                                        daemon=True)
        self._thread.start()
        return self._thread


class Typed:
    """Reconcile by key (typed.go:50-81): the inner controller gets a fresh
    fetch, a vanished key is a no-op, and an object being deleted goes to
    the inner controller's finalize() when it has one."""

    def __init__(self, kube_client, kind: str, inner):
        self.kube_client = kube_client
        self.kind = kind
        self.inner = inner
        self.name = f"{kind.lower()}.{type(inner).__name__}"

    def reconcile_key(self, name: str, namespace: str = ""):
        obj = self.kube_client.get(self.kind, namespace, name)
        if obj is None:
            return None
        if obj.metadata.deletion_timestamp is not None and hasattr(self.inner, "finalize"):
            return self.inner.finalize(obj)
        return self.inner.reconcile(obj)


class _DaemonPool:
    """A worker pool of daemon threads: a reconcile stuck on a dead cloud
    API leaks its worker but never holds up the process's exit (the
    workers of a ThreadPoolExecutor are joined at exit)."""

    def __init__(self, name: str, max_workers: int):
        self._q: queue.Queue = queue.Queue()
        self._threads = [threading.Thread(target=self._worker, daemon=True,
                                          name=f"{name}-{i}") for i in range(max_workers)]
        for t in self._threads:
            t.start()

    def _worker(self):
        while True:
            fn, args, box, done = self._q.get()
            try:
                box["result"] = fn(*args)
            except BaseException as e:  # noqa: BLE001 — raised again by result()
                box["error"] = e
            finally:
                done.set()

    def submit(self, fn, *args):
        box: dict = {}
        done = threading.Event()
        self._q.put((fn, args, box, done))

        def result(timeout=None):
            if not done.wait(timeout):
                raise TimeoutError("reconcile still running")
            if "error" in box:
                raise box["error"]
            return box.get("result")

        return result


# one pool per (controller, width) for the process's life: the
# housekeeping loop runs every second
_pools: dict = {}
_pools_mu = threading.Lock()


def _pool(name: str, max_workers: int) -> _DaemonPool:
    with _pools_mu:
        pool = _pools.get((name, max_workers))
        if pool is None:
            pool = _pools[(name, max_workers)] = _DaemonPool(name, max_workers)
        return pool


def reconcile_concurrently(name: str, items, reconcile_fn, max_workers: int = 10,
                           stop: Optional[threading.Event] = None) -> int:
    """Reconcile each item on at most `max_workers` threads (the
    MaxConcurrentReconciles analog: 50 for machines, machine/controller.go:166,
    10 for nodes); an error is counted and logged and never stops the
    batch. Once `stop` is set, the items not yet started are skipped.
    Returns the number of errors."""
    items = list(items)
    if not items:
        return 0

    def one(obj):
        if stop is not None and stop.is_set():
            return None
        with with_controller_name(name):
            return reconcile_fn(obj)

    errors = 0
    results = [_pool(name, max_workers).submit(one, obj) for obj in items]
    for result in results:
        try:
            result()
        except Exception:
            count_error(name)
            LOG.exception("reconcile failed", controller=name)
            errors += 1
    return errors
