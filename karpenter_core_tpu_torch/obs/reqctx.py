"""Bounded request/tenant attribution context.

Every entry point into the solver plane (an operator reconcile, the solver
service's gRPC metadata, the solver host's frame header) binds a
:class:`RequestContext` for the duration of the request. Downstream
instrumentation (the admission gate, the fallback ladder, tracer, flight
recorder, the provisioning loop's admission-to-bind histogram) reads the
context through :func:`current_tenant` / :func:`tenant_labels` and attaches
a ``tenant`` label to the series it already emits.

Two hard contracts, both held by ``tests/test_torch_obs.py``:

* **Zero cost when unset.** With no context bound, :func:`current_tenant` is
  a thread-local list check, :func:`tenant_labels` allocates nothing
  beyond the label dict the call site already paid for, and the solver
  host's frame header gains no key.
* **Bounded cardinality.** Tenant label *values* route through the module
  :data:`TENANTS` guard: a fixed slot table (:data:`DEFAULT_TENANT_CAP`)
  after which every new tenant collapses into the :data:`OVERFLOW_TENANT`
  label. A label flood can therefore never blow up exposition or the
  cross-process ``ProcessSeriesMerger``.

Wire header / gRPC metadata key for the tenant: :data:`TENANT_HEADER`.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = [
    "DEFAULT_TENANT_CAP",
    "OVERFLOW_TENANT",
    "RequestContext",
    "TENANTS",
    "TENANT_HEADER",
    "TenantGuard",
    "bind",
    "current",
    "current_deadline",
    "current_tenant",
    "tenant_labels",
]

# gRPC metadata key and solver-host frame-header key carrying the tenant.
TENANT_HEADER = "x-karpenter-tenant"

# Fixed tenant-slot cap; tenants past the cap share the overflow label.
DEFAULT_TENANT_CAP = 16
OVERFLOW_TENANT = "other"


@dataclass(frozen=True)
class RequestContext:
    """What one request is, for attribution: who, which, how urgent.

    ``tenant`` is the only field that becomes a metric label (through the
    cardinality guard); the rest ride along in logs, spans, and flight
    records where unbounded values are safe.
    """

    tenant: Optional[str] = None
    request_id: Optional[str] = None
    priority: int = 0
    deadline_s: Optional[float] = None


class _Stack(threading.local):
    def __init__(self) -> None:  # per-thread init
        self.items: List[RequestContext] = []


_STACK = _Stack()


@contextlib.contextmanager
def bind(ctx: RequestContext) -> Iterator[RequestContext]:
    """Bind *ctx* as the calling thread's request context for the block.

    Also pushes the context's identity fields onto the structured-log
    bound-context stack, so every log line emitted under the bind carries
    tenant/request_id without the call sites knowing about attribution."""
    # call-time import: reqctx is the bottom of the obs stack (log/tracer
    # both import it), so the upward edge to log must not be module-scope
    from karpenter_core_tpu_torch.obs import log as _log

    _STACK.items.append(ctx)
    fields: Dict[str, object] = {}
    if ctx.tenant is not None:
        fields["tenant"] = ctx.tenant
    if ctx.request_id is not None:
        fields["request_id"] = ctx.request_id
    try:
        if fields:
            with _log.bound(**fields):
                yield ctx
        else:
            yield ctx
    finally:
        _STACK.items.pop()


def current() -> Optional[RequestContext]:
    """The innermost bound context, or None."""
    items = _STACK.items
    return items[-1] if items else None


def current_tenant() -> Optional[str]:
    """Tenant of the innermost bound context, or None. O(1), no allocation."""
    items = _STACK.items
    return items[-1].tenant if items else None


class TenantGuard:
    """Fixed-slot tenant-label interner: the cardinality guard.

    The first :attr:`cap` distinct tenants each get their own label; every
    tenant after that maps to :data:`OVERFLOW_TENANT`. ``admit`` is the only
    way a request-derived string becomes a metric label value.
    """

    def __init__(self, cap: int = DEFAULT_TENANT_CAP) -> None:
        self.cap = int(cap)
        self._mu = threading.Lock()
        self._slots: Dict[str, str] = {}
        self._overflowed = 0

    def admit(self, tenant: Optional[str]) -> Optional[str]:
        """Guarded label for *tenant* (None passes through as None)."""
        if tenant is None:
            return None
        tenant = str(tenant)
        with self._mu:
            label = self._slots.get(tenant)
            if label is None:
                if len(self._slots) < self.cap:
                    label = self._slots[tenant] = tenant
                else:
                    self._overflowed += 1
                    label = OVERFLOW_TENANT
            return label

    def tenants(self) -> Tuple[str, ...]:
        """Admitted tenant labels, sorted."""
        with self._mu:
            return tuple(sorted(self._slots))

    def stats(self) -> Dict[str, int]:
        with self._mu:
            return {"slots": len(self._slots), "cap": self.cap, "overflowed": self._overflowed}

    def reset(self) -> None:
        """Drop all slots (tests only — live series keep their labels)."""
        with self._mu:
            self._slots.clear()
            self._overflowed = 0


# Process-wide guard. Parent and solver-host child each have their own
# instance; both cap at the same slot count so the merged series set stays
# bounded on both sides of the frame protocol.
TENANTS = TenantGuard()


def tenant_labels(**base: str) -> Optional[Dict[str, str]]:
    """Label dict for a metric call site, with the bound tenant folded in.

    No tenant bound: returns *base* unchanged (or None when empty) — zero
    allocations beyond the kwargs dict the call already paid for. Tenant
    bound: adds ``tenant=<guarded label>`` to *base*.
    """
    tenant = current_tenant()
    if tenant is None:
        return base or None
    base["tenant"] = TENANTS.admit(tenant)
    return base


def current_deadline() -> Optional[float]:
    """``deadline_s`` (the remaining budget) of the innermost bound
    context, or None. O(1), no allocation. The admission gate reads it to
    tighten a request's queue budget and to order it within its tenant's
    earliest-deadline-first sub-queue."""
    items = _STACK.items
    return items[-1].deadline_s if items else None
