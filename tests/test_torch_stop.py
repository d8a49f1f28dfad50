"""The operator's stop over a slow apiserver.

Over HTTP at a cluster's size a list of every pod takes about a second, and
a deprovisioning pass lists them once per deprovisioner. A pass that ran on
past Operator.stop()'s join could act after run() had released the lease
and closed the solver. Each test here failed before the fix it names:
- a stopped pass ends at its next step (the deprovisioning chain between
  deprovisioners, the housekeeping pass between items, the provisioning
  pass before its launch), so stop() finds every loop ended;
- run() neither releases the lease nor closes the primary while a thread
  it could not join is alive;
- the event recorder posts nothing after its close() (its poster used to
  restart on the next publish).
"""
import gc
import threading
import time

import pytest

from karpenter_core_tpu_torch.cloudprovider import fake
from karpenter_core_tpu_torch.events import Event, Recorder
from karpenter_core_tpu_torch.kube.client import InMemoryKubeClient
from karpenter_core_tpu_torch.operator import controller as operator_controller
from karpenter_core_tpu_torch.operator import new_operator
from karpenter_core_tpu_torch.solver.torch_solver import GreedySolver
from karpenter_core_tpu_torch.testing import make_node, make_pod, make_provisioner


class SlowPodLists(InMemoryKubeClient):
    """An in-memory client whose list of pods takes `delay` s on the
    deprovisioning loop's thread, as a list of every pod does over HTTP."""

    def __init__(self, delay: float):
        super().__init__()
        self.delay = delay
        self.listing = threading.Event()
        self.lists = 0

    def list(self, kind, *a, **kw):
        if kind == "Pod" and threading.current_thread().name == "singleton-deprovisioning":
            self.lists += 1
            self.listing.set()
            time.sleep(self.delay)
        return super().list(kind, *a, **kw)


def test_stop_ends_a_deprovisioning_pass_at_its_next_deprovisioner():
    client = SlowPodLists(delay=1.0)
    client.create(make_provisioner(name="default"))
    client.create(make_node(name="n-0"))
    op = new_operator(fake.FakeCloudProvider(fake.instance_types(4)), kube_client=client,
                      solver=GreedySolver())
    op.start()
    try:
        assert client.listing.wait(30.0)
    finally:
        alive = op.stop()
    # the chain's six deprovisioners list the pods once each: a pass that
    # went on would hold the thread for ~6 s, past stop()'s 2 s join
    assert [t.name for t in alive] == []
    assert client.lists <= 2


def test_stop_skips_the_items_a_housekeeping_pass_has_not_started():
    stop = threading.Event()
    done = []

    def reconcile(i):
        done.append(i)
        stop.set()

    errors = operator_controller.reconcile_concurrently("stop-test", range(20), reconcile,
                                                        max_workers=1, stop=stop)
    assert errors == 0 and done == [0]


def test_a_stopped_provisioning_pass_launches_nothing():
    client = InMemoryKubeClient()
    client.create(make_provisioner(name="default"))
    client.create(make_pod(name="p-0", requests={"cpu": "1"}))
    op = new_operator(fake.FakeCloudProvider(fake.instance_types(4)), kube_client=client,
                      solver=GreedySolver())
    op.sync_state()
    stop = threading.Event()
    stop.set()
    assert op.provisioning.reconcile(wait_timeout=None, stop=stop) == 0
    assert client.list("Machine") == []
    # unstopped, the same pass launches
    assert op.provisioning.reconcile(wait_timeout=None) == 1


def _poster_threads():
    return [t for t in threading.enumerate() if t.name == "event-poster" and t.is_alive()]


def test_recorder_posts_nothing_after_close():
    client = InMemoryKubeClient()
    rec = Recorder(kube_client=client)
    before = len(_poster_threads())

    def event(i):
        return Event(involved_kind="Pod", involved_name=f"default/p-{i}", type="Normal",
                     reason="Test", message=f"event {i}")

    assert rec.publish(event(0))
    assert rec.flush(5.0)
    assert len(client.list("Event")) == 1
    assert rec.close()
    assert rec.publish(event(1))  # the ring keeps it
    assert [e.message for e in rec.events] == ["event 0", "event 1"]
    time.sleep(0.3)
    assert len(_poster_threads()) == before
    assert len(client.list("Event")) == 1
    assert rec.close()


@pytest.mark.parametrize("straggler", [False, True], ids=["all-joined", "one-alive"])
def test_run_keeps_the_lease_and_the_primary_while_a_loop_is_alive(monkeypatch, straggler):
    from karpenter_core_tpu_torch.api import settings as tsettings
    from karpenter_core_tpu_torch.obs import TRACER
    from karpenter_core_tpu_torch.obs import log as tlog
    from karpenter_core_tpu_torch.obs.flightrec import FLIGHTREC
    from karpenter_core_tpu_torch.operator import Operator, injection, leaderelection
    from karpenter_core_tpu_torch.operator import __main__ as entry
    from karpenter_core_tpu_torch.operator.options import parse_options
    from karpenter_core_tpu_torch.solver.host import HostSolver
    from karpenter_core_tpu_torch.utils import gctuning

    monkeypatch.setenv("KARPENTER_SOLVER_HOST", "on")
    monkeypatch.setenv("KARPENTER_PREWARM", "0")
    release = threading.Event()
    lingering = threading.Thread(target=release.wait, name="singleton-lingering", daemon=True)
    real_stop = Operator.stop

    def stop_with_a_straggler(self):
        alive = real_stop(self)
        if straggler:
            lingering.start()
            alive = alive + [lingering]
        return alive

    monkeypatch.setattr(Operator, "stop", stop_with_a_straggler)
    closed = []
    monkeypatch.setattr(HostSolver, "close", lambda self: closed.append(self))
    client = InMemoryKubeClient()
    client.create(make_provisioner(name="default"))
    stop, got = threading.Event(), {}

    def on_start(proc):
        got["proc"] = proc
        stop.set()

    threshold = gc.get_threshold()
    tracing, recording = TRACER.enabled, FLIGHTREC.enabled
    level, fmt, stream = tlog.SINK.level, tlog.SINK.fmt, tlog.SINK.stream
    try:
        entry.run(fake.FakeCloudProvider(), kube_client=client, stop_event=stop, device="cpu",
                  on_start=on_start,
                  options=parse_options(["--metrics-port", "0", "--leader-elect",
                                         "--disable-webhook"]))
    finally:
        release.set()
        gc.unfreeze()
        gc.set_threshold(*threshold)
        gctuning._applied = False
        TRACER.enabled, FLIGHTREC.enabled = tracing, recording
        tlog.SINK.configure(level=level, fmt=fmt, stream=stream)
        injection._default_options = injection._default_settings = None
        tsettings.set_current(tsettings.Settings())
    proc = got["proc"]
    lease = client.get("Lease", leaderelection.LEASE_NAMESPACE, leaderelection.LEASE_NAME)
    assert lease.spec.holder_identity == proc.elector.identity
    if straggler:
        assert proc.alive == ["singleton-lingering"]
        assert lease.spec.renew_time is not None and closed == []
    else:
        assert proc.alive == []
        assert lease.spec.renew_time is None and closed == [proc.primary]
