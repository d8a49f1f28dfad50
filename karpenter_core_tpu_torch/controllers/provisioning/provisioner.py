"""The provisioning controller (provisioner.go:62-434) and the pod
controller that triggers it (provisioning/controller.go:56-75).

A reconcile waits for the batcher's window, then schedules: the pending
pods (with the pods of nodes marked for deletion, which must move), capped
at the batch limit, against the provisioners in weight order and their
instance types less the offerings the insufficient-capacity cache holds;
the solver places them. The solved machines launch in parallel, each a
create through the cloud provider, a Machine record and an eager Node,
its pods nominated; existing nodes that take pods are nominated. A launch
that failed for capacity or a transient fault re-triggers the batcher, so
that the pods left over re-solve against the masked universe; pods that
could not be placed get a FailedScheduling event with the cause a host
check finds.

The solver is the one the caller gives (the operator builds a TorchSolver
through solver/factory.py). A solver exception propagates unless the
caller gave a fallback solver, whose every use counts in FALLBACKS.

A reconcile is a `provisioner.reconcile` span, with the solve's spans and
a `provisioner.launch` span beneath it. The reference's series count it:
LAUNCH_FAILURES (karpenter_launch_failures_total, by reason),
LAUNCH_RESOLVE_RETRIGGERS (karpenter_launch_resolve_retriggers_total),
metrics.registry.NODES_CREATED (karpenter_nodes_created, reason
provisioning), PENDING_PODS (the karpenter_pending_pods gauge) and
ADMISSION_TO_BIND (karpenter_admission_to_bind_seconds: pod creation to its
capacity decision, observed once per pod, labeled with the pod's tenant);
reset_counts() zeroes them.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from karpenter_core_tpu_torch import chaos
from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.api.provisioner import order_by_weight
from karpenter_core_tpu_torch.api.settings import current as current_settings
from karpenter_core_tpu_torch.api.validation import validate_requirement
from karpenter_core_tpu_torch.cloudprovider.icecache import ICECache
from karpenter_core_tpu_torch.cloudprovider.types import (
    IncompatibleRequirementsError,
    InsufficientCapacityError,
)
from karpenter_core_tpu_torch.controllers.provisioning.batcher import Batcher
from karpenter_core_tpu_torch.controllers.provisioning.volumetopology import VolumeTopology
from karpenter_core_tpu_torch.kube.client import AlreadyExistsError
from karpenter_core_tpu_torch.kube.objects import NodeStatus, Pod
from karpenter_core_tpu_torch.metrics.registry import NAMESPACE, NODES_CREATED, REGISTRY
from karpenter_core_tpu_torch.obs import TRACER, reqctx
from karpenter_core_tpu_torch.obs.log import get_logger
from karpenter_core_tpu_torch.scheduling.requirements import Requirements
from karpenter_core_tpu_torch.utils import podutils
from karpenter_core_tpu_torch.utils.backoff import full_jitter

LOG = get_logger("karpenter.provisioning")

LAUNCH_FAILURES = REGISTRY.counter(
    f"{NAMESPACE}_launch_failures_total",
    "Machine launches that failed, by failure class (insufficient_capacity /"
    " transient / error)",
)
LAUNCH_RESOLVE_RETRIGGERS = REGISTRY.counter(
    f"{NAMESPACE}_launch_resolve_retriggers_total",
    "Batcher re-triggers after retryable launch failures: the residual pods"
    " re-solve against an ICE-masked universe instead of spinning on the"
    " offering the cloud just rejected",
)
ADMISSION_TO_BIND = REGISTRY.histogram(
    f"{NAMESPACE}_admission_to_bind_seconds",
    "Pod admission (creationTimestamp) to bind decision (machine launched /"
    " existing node nominated) latency, observed by the provisioning loop",
)
PENDING_PODS = REGISTRY.gauge(
    f"{NAMESPACE}_pending_pods",
    "Provisionable pending pods the last provisioning pass batched",
)
# solves that the fallback solver served after the solver raised (the
# port's own count: the reference falls back to its host solver silently)
FALLBACKS = {"solver": 0}

# launches run on at most this many threads: the reference opens one per
# machine (provisioner.go:130-148), and at a full-width backlog's 6,515
# machines that got the process killed on an H100 host (PERF.md, Launch
# width); the launches serialize on the kube client's lock either way, and
# the names still come back in machine order
LAUNCH_WORKERS = 256


def reset_counts() -> None:
    LAUNCH_FAILURES.clear()
    LAUNCH_RESOLVE_RETRIGGERS.clear()
    ADMISSION_TO_BIND.clear()
    PENDING_PODS.set(0.0)  # a gauge: what the last pass saw
    NODES_CREATED.clear({"reason": "provisioning"})
    FALLBACKS["solver"] = 0


@dataclass
class LaunchOptions:
    record_pod_nomination: bool = False
    reason: str = "provisioning"


class ProvisioningController:
    """provisioner.go:62-126."""

    # pods remembered as decided, for the batch cap's re-trigger
    MAX_ADMISSION_OBSERVED = 8192

    def __init__(self, kube_client, cloud_provider, cluster, recorder=None, solver=None,
                 fallback_solver=None, clock=None):
        if solver is None:
            raise ValueError("ProvisioningController needs a solver")
        self.kube_client = kube_client
        self.cloud_provider = cloud_provider
        self.cluster = cluster
        self.recorder = recorder
        self.clock = clock if clock is not None else time.time
        self.solver = solver
        self.fallback_solver = fallback_solver
        self.batcher = Batcher()
        self.volume_topology = VolumeTopology(kube_client)
        self.ice_cache = ICECache(clock=self.clock)
        # launch-retry pacing: consecutive retryable launch failures and
        # the monotonic time of the next re-trigger (None: none pending)
        self._launch_retry_failures = 0
        self._launch_retry_at: Optional[float] = None
        # guards the pacing above and _last_solve_inputs: step() and the
        # background loop may reconcile at once
        self._mu = threading.Lock()
        # the (provisioners, instance types) of the last solve, which the
        # failure explanation probes
        self._last_solve_inputs: Tuple[list, dict] = ([], {})
        # callables(pod, node_name) told of each capacity decision (a
        # machine launched for the pod, an existing node nominated); nomination
        # events are deduplicated and rate-limited, so they cannot serve as
        # a binding feed. A listener's fault never breaks the reconcile.
        self.bind_listeners: List = []
        # the pods (uids) that got a capacity decision, oldest dropped first
        self._admission_observed: OrderedDict = OrderedDict()

    # -- reconcile --------------------------------------------------------------

    def reconcile(self, wait_timeout: Optional[float] = 0.0, stop=None) -> int:
        """One pass; the number of machines launched (provisioner.go:105-126).
        With a wait_timeout it fires a due launch re-trigger and waits for
        the batch window, returning 0 if none closes; None solves at once
        (the operator's step()). Once `stop` (the operator's) is set, a
        pass launches nothing after its solve."""
        if wait_timeout is not None:
            self._maybe_fire_launch_retry()
            if not self.batcher.wait(timeout=wait_timeout):
                return 0
        # the reconcile's root span: the solve's spans and the launch land
        # in one trace
        with TRACER.span("provisioner.reconcile") as sp:
            return self._reconcile_traced(sp, stop)

    def _reconcile_traced(self, sp, stop=None) -> int:
        result = self.schedule()
        if result is None or (stop is not None and stop.is_set()):
            return 0
        sp.set(machines=len(result.new_machines),
               existing=len(result.existing_assignments),
               failed=len(result.failed_pods))
        with TRACER.span("provisioner.launch", machines=len(result.new_machines)):
            names, errors = self._launch_machines_with_errors(
                result.new_machines, LaunchOptions(record_pod_nomination=True))
        created = sum(1 for n in names if n)
        # a pod is decided when its machine launched or an existing node
        # was nominated for it: the admission-to-bind decision time
        now = self.clock()
        for machine, name in zip(result.new_machines, names):
            if name:
                for pod in machine.pods:
                    self._observe_bind(pod, now)
                    self._notify_bind(pod, name)
        for state_node, pods in result.existing_assignments:
            for pod in pods:
                self._observe_bind(pod, now)
                self._notify_bind(pod, state_node.name())
        if created or errors or result.failed_pods:
            LOG.info("provisioning pass", machines=len(result.new_machines),
                     launched=created, launch_errors=len(errors),
                     existing=len(result.existing_assignments),
                     failed_pods=len(result.failed_pods), rounds=result.rounds)
        if any(self._launch_retryable(e) for e in errors):
            # the failed machines' pods are still pending and their
            # offerings now masked: re-solve them soon, on a jittered
            # exponential delay while launches keep failing
            LAUNCH_RESOLVE_RETRIGGERS.inc()
            with self._mu:
                self._launch_retry_failures += 1
                failures = self._launch_retry_failures
            self._schedule_launch_retry(failures)
        else:
            with self._mu:
                self._launch_retry_failures = 0
            if result.failed_pods:
                # masked capacity returns no sooner than the earliest cache
                # entry expires: re-solve then
                wait = self.ice_cache.next_expiry_in()
                if wait is not None:
                    self._schedule_launch_retry_in(wait + 0.05)
        if created:
            NODES_CREATED.inc({"reason": "provisioning"}, created)
        for state_node, pods in result.existing_assignments:
            self.cluster.nominate_node_for_pod(state_node.name())
            if self.recorder:
                for pod in pods:
                    self.recorder.nominate_pod(pod, state_node.name())
        if result.failed_pods and self.recorder:
            # the solver says which pods failed, not why: the host checks of
            # a machine's add (taints, requirements, an instance type that
            # fits) explain what they can
            reasons = dict(result.errors or {})
            missing = [p for p in result.failed_pods if not reasons.get(p.metadata.uid)]
            if missing:
                try:
                    reasons.update(self._explain_failures(missing))
                except Exception:  # noqa: BLE001 — events are best-effort
                    LOG.exception("explaining failed pods")
            for pod in result.failed_pods:
                self.recorder.pod_failed_to_schedule(
                    pod, reasons.get(pod.metadata.uid) or "unschedulable")
        return created

    def _explain_failures(self, failed: List[Pod]) -> Dict[str, str]:
        """The cause of each failed pod (by uid) that no template can take:
        each template of the last solve, in weight order, is probed with
        the host checks of machine.go:62-107. A pod some template takes
        failed for a batch-level reason and keeps the generic message."""
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.machine import (
            filter_instance_types_by_requirements,
        )
        from karpenter_core_tpu_torch.scheduling import taints as taints_mod
        from karpenter_core_tpu_torch.scheduling.machinetemplate import MachineTemplate
        from karpenter_core_tpu_torch.utils import resources as resources_util

        reasons: Dict[str, str] = {}
        with self._mu:
            provisioners, instance_types = self._last_solve_inputs
        if not provisioners:
            return reasons
        templates = [(MachineTemplate(p), instance_types.get(p.name, []))
                     for p in provisioners]
        for pod in failed:
            pod_reqs = Requirements.from_pod(pod)
            requests = resources_util.requests_for_pods(pod)
            err_msg = None
            for template, types in templates:
                err = taints_mod.tolerates(template.taints, pod)
                if err is None:
                    merged = Requirements(template.requirements.values())
                    err = merged.compatible(pod_reqs)
                    if err:
                        err = f"incompatible requirements, {err}"
                    else:
                        merged.add(*pod_reqs.values())
                        if not filter_instance_types_by_requirements(types, merged, requests):
                            err = (f"no instance type satisfied resources "
                                   f"{resources_util.to_string(requests)} "
                                   f"and requirements {merged!r}")
                if err is None:
                    err_msg = None
                    break
                err_msg = err
            if err_msg:
                reasons[pod.metadata.uid] = err_msg
        return reasons

    @staticmethod
    def _pod_tenant(pod: Pod) -> Optional[str]:
        """The tenant a pod bills to (its karpenter.sh/tenant label)."""
        return (pod.metadata.labels or {}).get(api_labels.TENANT_LABEL_KEY)

    def _observe_bind(self, pod: Pod, now: float) -> None:
        """Remember the pod as decided, once, and observe its admission to
        bind latency then (a nominated pod re-enters every window until it
        binds, and must not be observed again)."""
        uid = pod.metadata.uid or (pod.metadata.namespace, pod.metadata.name)
        if uid in self._admission_observed:
            return
        self._admission_observed[uid] = True
        while len(self._admission_observed) > self.MAX_ADMISSION_OBSERVED:
            self._admission_observed.popitem(last=False)
        ts = pod.metadata.creation_timestamp
        if ts:
            tenant = self._pod_tenant(pod)
            if tenant is not None:
                ADMISSION_TO_BIND.observe(max(now - ts, 0.0),
                                          {"tenant": reqctx.TENANTS.admit(tenant)})
            else:
                ADMISSION_TO_BIND.observe(max(now - ts, 0.0))

    def _notify_bind(self, pod: Pod, node_name: str) -> None:
        for listener in self.bind_listeners:
            try:
                listener(pod, node_name)
            except Exception:  # noqa: BLE001 — listeners are best-effort
                LOG.warning("bind listener failed", pod=pod.metadata.name, node=node_name)

    def trigger(self) -> None:
        self.batcher.trigger()

    # -- scheduling -------------------------------------------------------------

    def get_pending_pods(self) -> List[Pod]:
        """Provisionable pods (provisioner.go:152-174); a pod that fails
        validation (opted out of provisioned nodes, an invalid affinity
        requirement, a missing volume reference) is left out."""
        pods = self.kube_client.list("Pod", field_filter=lambda p: p.spec.node_name == "")
        return [p for p in pods
                if podutils.is_provisionable(p) and self._validate_pod(p) is None]

    def _validate_pod(self, pod) -> Optional[str]:
        """Provisioner.Validate (provisioner.go:376-434)."""
        for req in Requirements.from_pod(pod).values():
            if (req.key == api_labels.PROVISIONER_NAME_LABEL_KEY
                    and req.operator() == "DoesNotExist"):
                return (f"configured to not run on a Karpenter provisioned node "
                        f"via {req.key} DoesNotExist requirement")
        affinity = pod.spec.affinity
        if affinity is not None and affinity.node_affinity is not None:
            terms = list(affinity.node_affinity.required)
            terms.extend(p.preference for p in affinity.node_affinity.preferred)
            for term in terms:
                for expr in term.match_expressions:
                    errs = validate_requirement(expr)
                    if errs:
                        return "; ".join(errs)
        return self.volume_topology.validate(pod)

    def get_daemonset_pods(self) -> List[Pod]:
        """One pod per DaemonSet template (provisioner.go:365-382)."""
        out = []
        for ds in self.kube_client.list("DaemonSet"):
            if ds.pod_template_spec is not None:
                pod = Pod(spec=copy.deepcopy(ds.pod_template_spec))
                pod.metadata.name = f"{ds.metadata.name}-daemon"
                pod.metadata.namespace = ds.metadata.namespace
                out.append(pod)
        return out

    def schedule(self):
        """provisioner.go:266-302: the SolveResult of the pending pods, or
        None when there is nothing to solve."""
        # nodes being deleted are left out of the snapshot, and their pods
        # re-enter the batch (provisioner.go:278-295)
        state_nodes, deleting_nodes = [], []
        for node in self.cluster.nodes():
            (deleting_nodes if node.is_marked_for_deletion() else state_nodes).append(node)
        pending = self.get_pending_pods()
        for node in deleting_nodes:
            if node.node is not None:
                for pod in self.kube_client.list("Pod", node_name=node.name()):
                    if not podutils.is_terminal(pod) and not podutils.is_owned_by_daemonset(pod):
                        pod.spec.node_name = ""
                        pending.append(pod)
        PENDING_PODS.set(float(len(pending)))
        if not pending:
            return None
        settings = self.batcher.settings or current_settings()
        batch_cap = settings.effective_batch_max_pods()
        if batch_cap and len(pending) > batch_cap:
            # solve the oldest slice and hand the rest to the next window
            # at once, unless every deferred pod already had its capacity
            # decision (a nominated pod stays pending until it binds)
            pending.sort(key=lambda p: p.metadata.creation_timestamp or 0.0)
            deferred = pending[batch_cap:]
            pending = pending[:batch_cap]
            LOG.info("batch capped", solving=len(pending), deferred=len(deferred))
            if any((p.metadata.uid or (p.metadata.namespace, p.metadata.name))
                   not in self._admission_observed for p in deferred):
                self.batcher.trigger()
        provisioners = order_by_weight([p for p in self.kube_client.list("Provisioner")
                                        if p.metadata.deletion_timestamp is None])
        if not provisioners:
            return None
        instance_types = {p.name: self.ice_cache.mask(self.cloud_provider.get_instance_types(p))
                          for p in provisioners}
        with self._mu:
            self._last_solve_inputs = (provisioners, instance_types)
        # the listed pods are this pass's own copies, so the zones go into
        # them in place (the reference copies each pod once more first)
        pending = [self.volume_topology.inject(p) for p in pending]
        daemonset_pods = self.get_daemonset_pods()
        args = (pending, provisioners, instance_types)
        kwargs = dict(daemonset_pods=daemonset_pods, state_nodes=state_nodes,
                      kube_client=self.kube_client, cluster=self.cluster)
        # the solve is billed to the batch's most frequent tenant (pod
        # labels); admission to bind stays per pod in _observe_bind
        tenants = [t for t in (self._pod_tenant(p) for p in pending) if t]
        batch_tenant = max(set(tenants), key=tenants.count) if tenants else None
        bind_ctx = (reqctx.bind(reqctx.RequestContext(tenant=batch_tenant))
                    if batch_tenant is not None else contextlib.nullcontext())
        with bind_ctx:
            if self.fallback_solver is None or self.fallback_solver is self.solver:
                return self.solver.solve(*args, **kwargs)
            try:
                return self.solver.solve(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — the caller chose a fallback
                FALLBACKS["solver"] += 1
                LOG.error("solver raised, using fallback solver", error=type(e).__name__,
                          error_detail=str(e), pods=len(pending))
                return self.fallback_solver.solve(*args, **kwargs)

    # -- launching --------------------------------------------------------------

    def launch_machines(self, machines, opts: Optional[LaunchOptions] = None) -> List[str]:
        """Launch in parallel (provisioner.go:130-148); "" for each failure."""
        names, _ = self._launch_machines_with_errors(machines, opts)
        return names

    @staticmethod
    def _launch_retryable(err: Exception) -> bool:
        """A failure a re-solve can get past: a capacity outage (its offering
        is now masked) or a transient fault; a request defect, a limit or a
        configuration error would fail alike again."""
        if isinstance(err, IncompatibleRequirementsError):
            return False
        return isinstance(err, (InsufficientCapacityError, ConnectionError, TimeoutError))

    def _schedule_launch_retry(self, failures: int) -> None:
        """The next re-trigger: full jitter from the batch idle window,
        doubling with consecutive failures, at most 30 s."""
        settings = self.batcher.settings or current_settings()
        base = max(settings.batch_idle_duration, 0.05)
        self._schedule_launch_retry_in(
            max(full_jitter(max(failures - 1, 0), base, cap=30.0), base))

    def _schedule_launch_retry_in(self, delay: float) -> None:
        with self._mu:
            self._launch_retry_at = time.monotonic() + delay

    def _maybe_fire_launch_retry(self) -> None:
        """Trigger the batcher when a re-trigger is due."""
        with self._mu:
            due_at = self._launch_retry_at
            if due_at is None or time.monotonic() < due_at:
                return
            self._launch_retry_at = None
        self.batcher.trigger()

    def _launch_machines_with_errors(self, machines, opts: Optional[LaunchOptions] = None
                                     ) -> Tuple[List[str], List[Exception]]:
        """launch_machines and each failure's exception, classified into
        LAUNCH_FAILURES."""
        opts = opts or LaunchOptions()
        if not machines:
            return [], []
        names: List[str] = []
        errors: List[Exception] = []
        workers = min(len(machines), LAUNCH_WORKERS)
        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
            futures = [pool.submit(self._launch_one, m, opts) for m in machines]
            for f in futures:
                try:
                    names.append(f.result())
                except Exception as e:  # noqa: BLE001 — classified below
                    names.append("")
                    errors.append(e)
                    if isinstance(e, InsufficientCapacityError):
                        reason = "insufficient_capacity"
                    elif self._launch_retryable(e):
                        reason = "transient"
                    else:
                        reason = "error"
                    LAUNCH_FAILURES.inc({"reason": reason})
                    LOG.warning("machine launch failed", reason=reason,
                                error=type(e).__name__, error_detail=str(e))
        return names, errors

    def _launch_one(self, machine, opts: LaunchOptions) -> str:
        """provisioner.go:304-361: the limits check, the create (an
        insufficient-capacity failure recorded in the cache), the Machine
        record (its status through the status subresource), the eager
        Node, the nomination."""
        latest = self.kube_client.get("Provisioner", "", machine.provisioner_name)
        if latest is None:
            raise RuntimeError(f"provisioner {machine.provisioner_name} not found")
        if latest.spec.limits is not None:
            err = latest.spec.limits.exceeded_by(latest.status.resources)
            if err:
                raise RuntimeError(err)

        template = copy.copy(machine.template)  # templates are shared across machines
        template.instance_type_options = list(machine.instance_type_options)
        template.requirements = Requirements(machine.requirements.values())
        template.requests = dict(machine.requests)
        machine_cr = template.to_machine()
        try:
            # the cloud-provider edge every launch crosses
            chaos.maybe_fail(chaos.CLOUDPROVIDER_CREATE)
            created = self.cloud_provider.create(machine_cr)
        except InsufficientCapacityError as e:
            self.ice_cache.record(e)
            raise

        # the Machine record, named after the created node (node and machine
        # look each other up 1:1); provider id, capacity and allocatable
        # live under the status subresource, written on apply's version
        machine_cr.metadata.name = created.metadata.name
        machine_cr.status.provider_id = created.status.provider_id
        machine_cr.status.capacity = dict(created.status.capacity)
        machine_cr.status.allocatable = dict(created.status.allocatable)
        machine_cr.metadata.labels.update(created.metadata.labels)
        applied = self.kube_client.apply(machine_cr)
        machine_cr.metadata.resource_version = applied.metadata.resource_version
        self.kube_client.update_status(machine_cr)

        # the Node, created eagerly (provisioner.go:337-349)
        node = template.to_node()
        node.metadata.name = created.metadata.name
        node.metadata.labels.update(created.metadata.labels)
        node.spec.provider_id = created.status.provider_id
        node.status = NodeStatus()
        try:
            self.kube_client.create(node)
        except AlreadyExistsError:
            pass  # the node registered itself first
        self.cluster.update_node(node)
        self.cluster.nominate_node_for_pod(node.metadata.name)
        if opts.record_pod_nomination and self.recorder:
            for pod in machine.pods:
                self.recorder.nominate_pod(pod, node.metadata.name)
        return node.metadata.name


class PodController:
    """A provisionable pod triggers the batcher
    (provisioning/controller.go:56-75)."""

    def __init__(self, provisioner: ProvisioningController):
        self.provisioner = provisioner

    def reconcile(self, pod) -> None:
        if podutils.is_provisionable(pod):
            self.provisioner.trigger()
