"""The operator: the control plane assembled over a kube client, and the
port's normal entry point (pkg/operator, controllers.go:46-73).

    op = new_operator(cloud_provider, kube_client=client, settings=Settings(),
                      solver=TorchSolver(...), clock=clock)
    op.step()                 # one synchronous pass over every controller
    op.start(); ...; op.stop()  # watch pumps and singleton loops in threads

step() relists the client into the Cluster (sync_state), runs the machine,
node and termination controllers, one provisioning reconcile (batch, solve
on the card, launch, nominate), the machine controller again, the counter
and the provisioner metrics, when asked one deprovisioning reconcile, then
the node metrics, and drains the eviction queue. start() runs a watch pump
per kind (Node, Pod, Machine, Provisioner) into the informers, a pod event
triggering the batcher and the pod metrics, a provisioner event the
provisioner metrics, each pump relisting after a failed delivery or a
silent stream; and three singleton loops: provisioning (paced by the
batcher), deprovisioning and housekeeping (the machine, node and
termination controllers on worker pools, the counter and the node
metrics). The inflight checks are wired but neither loop runs
them, as in the reference; their caller does. Each controller reaches the
cloud provider through its own metrics decorator
(cloudprovider/metrics.py), which times every call by controller.

new_operator(with_webhooks=True) installs the admission webhooks on the
client (webhooks.install: every create and update defaulted, then
validated). The process entry, `python -m karpenter_core_tpu_torch.operator`
(operator/__main__.py), assembles all of this the way a deployment runs it.
"""
from __future__ import annotations

import queue as queue_mod
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from karpenter_core_tpu_torch import chaos
from karpenter_core_tpu_torch.api.settings import Settings, set_current
from karpenter_core_tpu_torch.cloudprovider.metrics import decorate
from karpenter_core_tpu_torch.controllers.counter.controller import CounterController
from karpenter_core_tpu_torch.controllers.deprovisioning.controller import (
    DeprovisioningController,
)
from karpenter_core_tpu_torch.controllers.inflightchecks.controller import (
    InflightChecksController,
)
from karpenter_core_tpu_torch.controllers.machine.controller import MachineController
from karpenter_core_tpu_torch.controllers.machine.terminator import EvictionQueue, Terminator
from karpenter_core_tpu_torch.controllers.metrics.controllers import (
    NodeMetricsController,
    PodMetricsController,
    ProvisionerMetricsController,
)
from karpenter_core_tpu_torch.controllers.node.controller import NodeController
from karpenter_core_tpu_torch.controllers.provisioning.provisioner import (
    PodController,
    ProvisioningController,
)
from karpenter_core_tpu_torch.controllers.termination.controller import TerminationController
from karpenter_core_tpu_torch.events import Recorder
from karpenter_core_tpu_torch.kube.client import InMemoryKubeClient
from karpenter_core_tpu_torch.kube.objects import object_key
from karpenter_core_tpu_torch.metrics.registry import NAMESPACE, REGISTRY
from karpenter_core_tpu_torch.obs.log import get_logger
from karpenter_core_tpu_torch.operator.controller import (
    Singleton,
    Typed,
    count_error,
    reconcile_concurrently,
)
from karpenter_core_tpu_torch.state.cluster import Cluster
from karpenter_core_tpu_torch.state.informer import (
    MachineInformer,
    NodeInformer,
    PodInformer,
    ProvisionerInformer,
)

LOG = get_logger("karpenter.operator")

WATCH_RELISTS = REGISTRY.counter(
    f"{NAMESPACE}_watch_relists_total",
    "Watch relists after a dropped/stale stream or failed event "
    "delivery, by kind (the informer list-then-watch recovery)",
)


@dataclass
class Operator:
    """The assembled control plane (controllers.go:46-73)."""

    kube_client: InMemoryKubeClient
    cloud_provider: object
    cluster: Cluster
    recorder: Recorder
    provisioning: ProvisioningController
    pod_controller: PodController
    machine_controller: MachineController
    node_controller: NodeController
    termination_controller: TerminationController
    inflight_checks: InflightChecksController
    counter: CounterController
    deprovisioning: object
    node_metrics: NodeMetricsController
    pod_metrics: PodMetricsController
    provisioner_metrics: ProvisionerMetricsController
    eviction_queue: EvictionQueue
    terminator: Terminator
    clock: object = time.time
    # a zero-argument callable each watch pump calls before it delivers an
    # event: the deflake harness's randomized delays (upstream
    # pkg/test/randomdelay.go:44-70); None outside tests
    jitter: object = None
    # a pump that has seen no event for this many seconds relists (the
    # informer resync); 0 turns the periodic relist off
    watch_relist_interval: float = 600.0
    _threads: List[threading.Thread] = field(default_factory=list)
    _stop: threading.Event = field(default_factory=threading.Event)

    # -- the synchronous pass ---------------------------------------------------

    def sync_state(self) -> None:
        """Relist the client through the informers: every Node, Machine and
        Pod as MODIFIED, and a delete for each one the Cluster tracks that
        is gone from the client. The informers read the client's stored
        objects without copies (the reference lists copies): a write
        replaces a stored object, so the Cluster keeps the version it was
        given, and only a delete's deletion stamp and a finalize's
        finalizer list change one in place, both of which the next relist
        delivers anyway."""
        node_inf = NodeInformer(self.cluster)
        pod_inf = PodInformer(self.cluster)
        machine_inf = MachineInformer(self.cluster)
        nodes = self.kube_client.list("Node", copy_objects=False)
        machines = self.kube_client.list("Machine", copy_objects=False)
        pods = self.kube_client.list("Pod", copy_objects=False)
        live_nodes = {n.metadata.name for n in nodes}
        live_machines = {m.metadata.name for m in machines}
        for state_node in self.cluster.nodes():
            # a node's Machine and its Node go away independently
            if (state_node.machine is not None
                    and state_node.machine.metadata.name not in live_machines):
                self.cluster.delete_machine(state_node.machine.metadata.name)
            if state_node.node is not None and state_node.node.metadata.name not in live_nodes:
                self.cluster.delete_node(state_node.node.metadata.name)
        live_pods = {object_key(p) for p in pods}
        for key in list(self.cluster.bindings):
            if key not in live_pods:
                self.cluster.delete_pod(key)
        for node in nodes:
            node_inf.handle("MODIFIED", node)
        for machine in machines:
            machine_inf.handle("MODIFIED", machine)
        for pod in pods:
            pod_inf.handle("MODIFIED", pod)

    def step(self, provision: bool = True, deprovision: bool = False) -> dict:
        """One pass over the controllers; what it did."""
        self.sync_state()
        summary = {"launched": 0, "deprovisioned": False}
        for machine in self.kube_client.list("Machine"):
            self.machine_controller.reconcile(machine)
        for node in self.kube_client.list("Node"):
            self.node_controller.reconcile(node)
            self.termination_controller.reconcile(node)
        self.sync_state()
        if provision:
            summary["launched"] = self.provisioning.reconcile(wait_timeout=None)
            self.sync_state()
        for machine in self.kube_client.list("Machine"):
            self.machine_controller.reconcile(machine)
        provisioners = self.kube_client.list("Provisioner")
        for provisioner in provisioners:
            self.counter.reconcile(provisioner)
            self.provisioner_metrics.reconcile(provisioner)
        self.provisioner_metrics.prune({p.name for p in provisioners})
        if deprovision and self.deprovisioning is not None:
            summary["deprovisioned"] = self.deprovisioning.reconcile()
        self.node_metrics.reconcile()
        self.eviction_queue.drain()
        return summary

    # -- the background runtime -------------------------------------------------

    def start(self) -> None:
        """The watch pumps and the singleton loops (operator.go:154-169)."""
        self._stop.clear()
        self.eviction_queue.start()
        watches = [
            ("Node", NodeInformer(self.cluster).handle),
            ("Pod", PodInformer(self.cluster).handle),
            ("Machine", MachineInformer(self.cluster).handle),
            ("Provisioner", ProvisionerInformer(self.cluster).handle),
        ]
        for kind, handler in watches:
            t = threading.Thread(target=self._pump,
                                 args=(kind, self.kube_client.watch(kind), handler),
                                 daemon=True, name=f"operator-watch-{kind}")
            t.start()
            self._threads.append(t)

        # each pass gives up at its next step once the operator stops, so
        # that stop() finds every loop ended: a pass over a slow apiserver
        # must not act after its process released the lease
        stop = self._stop

        def provision_once():
            self.provisioning.reconcile(wait_timeout=0.2, stop=stop)
            return 0.0  # the batcher paces the loop

        def deprovision_once():
            if self.deprovisioning is not None:
                self.deprovisioning.reconcile(stop=stop)

        typed_machine = Typed(self.kube_client, "Machine", self.machine_controller)
        typed_node = Typed(self.kube_client, "Node", self.node_controller)
        typed_termination = Typed(self.kube_client, "Node", self.termination_controller)

        def node_reconcile(node):
            typed_node.reconcile_key(node.metadata.name)
            typed_termination.reconcile_key(node.metadata.name)

        def housekeeping_once():
            # each worker re-fetches its object by key; 50 machine and 10
            # node reconciles at a time (machine/controller.go:166)
            reconcile_concurrently(
                "machine", self.kube_client.list("Machine"),
                lambda m: typed_machine.reconcile_key(m.metadata.name), max_workers=50,
                stop=stop)
            if stop.is_set():
                return
            reconcile_concurrently("node", self.kube_client.list("Node"), node_reconcile,
                                   max_workers=10, stop=stop)
            if stop.is_set():
                return
            for provisioner in self.kube_client.list("Provisioner"):
                self.counter.reconcile(provisioner)
            self.node_metrics.reconcile()

        self.singletons = [
            Singleton("provisioning", provision_once, interval=0.0),
            Singleton("deprovisioning", deprovision_once, interval=1.0),
            Singleton("housekeeping", housekeeping_once, interval=1.0),
        ]
        for singleton in self.singletons:
            self._threads.append(singleton.start(self._stop))

    def _deliver(self, kind: str, handler, event: str, obj) -> None:
        """One event through the informer, a pod's to the pod controller
        and the pod metrics, a provisioner's to the provisioner metrics:
        shared by the stream and the relist replay. The chaos point
        `state.watch` fails a delivery, which the pump recovers from by a
        relist."""
        chaos.maybe_fail(chaos.STATE_WATCH)
        handler(event, obj)
        if kind == "Pod":
            if event != "DELETED":
                self.pod_controller.reconcile(obj)
            self.pod_metrics.reconcile(obj, deleted=event == "DELETED")
        elif kind == "Provisioner":
            self.provisioner_metrics.reconcile(obj, deleted=event == "DELETED")

    def _relist(self, kind: str, handler, known: dict) -> None:
        """Replay the client's objects of `kind` as MODIFIED, and a DELETED
        for each known key gone meanwhile; the watch queue is kept (the
        in-memory client's cannot break), and a replay may repeat events."""
        WATCH_RELISTS.inc({"kind": kind})
        current = {}
        for obj in self.kube_client.list(kind):
            key = (obj.metadata.namespace, obj.metadata.name)
            current[key] = True
            self._deliver(kind, handler, "MODIFIED", obj)
        for key in list(known):
            if key not in current:
                gone = self.kube_client.new_object(kind)
                gone.metadata.namespace, gone.metadata.name = key
                self._deliver(kind, handler, "DELETED", gone)
        known.clear()
        known.update(current)

    def _pump(self, kind: str, q: queue_mod.Queue, handler) -> None:
        known: dict = {}
        last_event = time.monotonic()
        while not self._stop.is_set():
            try:
                try:
                    event, obj = q.get(timeout=0.1)
                except queue_mod.Empty:
                    # a dead stream and a quiet cluster look alike: relist
                    # once the stream has been silent past the bound
                    if (self.watch_relist_interval
                            and time.monotonic() - last_event >= self.watch_relist_interval):
                        self._relist(kind, handler, known)
                        last_event = time.monotonic()
                    continue
                last_event = time.monotonic()
                jitter = self.jitter
                if jitter is not None:
                    jitter()
                self._deliver(kind, handler, event, obj)
                # a key counts as known only once delivered, so that a
                # failed DELETED is still found by the recovery relist
                key = (obj.metadata.namespace, obj.metadata.name)
                if event == "DELETED":
                    known.pop(key, None)
                else:
                    known[key] = True
            except Exception:
                count_error(f"watch-{kind}")
                LOG.exception("watch pump failed", kind=kind)
                while not self._stop.is_set():
                    try:
                        self._relist(kind, handler, known)
                        last_event = time.monotonic()
                        break
                    except Exception:
                        LOG.exception("watch relist failed", kind=kind)
                        self._stop.wait(0.2)

    def stop(self) -> List[threading.Thread]:
        """Stop the loops and join their threads (2 s each); the threads
        still alive after that, none when all stopped."""
        self._stop.set()
        self.eviction_queue.stop()
        for t in self._threads:
            t.join(timeout=2.0)
        alive = [t for t in self._threads if t.is_alive()]
        self._threads.clear()
        return alive


def new_operator(cloud_provider, kube_client: Optional[InMemoryKubeClient] = None,
                 settings: Optional[Settings] = None, solver=None, clock=None,
                 with_webhooks: bool = False) -> Operator:
    """Assemble the control plane (controllers.go:46-73). Without a
    solver one is built by solver/factory.build_solver: a TorchSolver on
    the CUDA card, raising when there is none. with_webhooks installs
    admission defaulting and validation on the client
    (operator.WithWebhooks, operator.go:149-152); it is off by default
    because test suites create deliberately partial objects."""
    if clock is None:
        clock = time.time
    if settings is not None:
        set_current(settings)
    if solver is None:
        from karpenter_core_tpu_torch.solver.factory import build_solver

        solver = build_solver()
    # each controller times its calls into the provider under its own name
    cp_provisioning = decorate(cloud_provider, "provisioning")
    cp_machine = decorate(cloud_provider, "machine")
    cp_node = decorate(cloud_provider, "node")
    cp_deprovisioning = decorate(cloud_provider, "deprovisioning")
    cp_inflight = decorate(cloud_provider, "inflightchecks")
    kube_client = kube_client if kube_client is not None else InMemoryKubeClient()
    if with_webhooks:
        from karpenter_core_tpu_torch.webhooks import install as install_webhooks

        install_webhooks(kube_client)
    recorder = Recorder(clock=clock, kube_client=kube_client)
    cluster = Cluster(kube_client, cp_node, clock=clock)
    eviction_queue = EvictionQueue(kube_client, recorder)
    terminator = Terminator(kube_client, cp_machine, eviction_queue, clock=clock)
    provisioning = ProvisioningController(kube_client, cp_provisioning, cluster,
                                          recorder=recorder, solver=solver, clock=clock)
    deprovisioning = DeprovisioningController(kube_client, cluster, provisioning,
                                              cp_deprovisioning, recorder, clock=clock)
    return Operator(
        kube_client=kube_client,
        cloud_provider=cloud_provider,
        cluster=cluster,
        recorder=recorder,
        provisioning=provisioning,
        pod_controller=PodController(provisioning),
        machine_controller=MachineController(kube_client, cp_machine, cluster,
                                             terminator, recorder, clock=clock),
        node_controller=NodeController(kube_client, cp_node, cluster, clock=clock),
        termination_controller=TerminationController(kube_client, terminator, cluster,
                                                     recorder),
        inflight_checks=InflightChecksController(kube_client, cp_inflight, cluster,
                                                 recorder, clock=clock),
        counter=CounterController(kube_client, cluster),
        deprovisioning=deprovisioning,
        node_metrics=NodeMetricsController(cluster),
        pod_metrics=PodMetricsController(kube_client, clock=clock),
        provisioner_metrics=ProvisionerMetricsController(kube_client),
        eviction_queue=eviction_queue,
        terminator=terminator,
        clock=clock,
    )
