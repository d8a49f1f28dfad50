"""The port's flight recorder against the JAX reference's, on the CPU.

The record format is the reference's (SCHEMA_VERSION 1): snapshot_inputs
of the same workload gives equal dicts and an equal input_digest in both
packages, for every family of tests/test_torch_cuda.py's workload(); a
record written by either package restores in the other and replays to
the same placements; the consolidation records of the same passes are
equal on the geometries of tests/test_torch_consolidation.py. The rest
holds the recorder itself: the ring and its caps, the dumps, the
disabled path, suppression, the environment switch, replay on the card
by default and on the host GreedySolver for the greedy replayer."""
import copy
import json
import os

import pytest

from karpenter_core_tpu.obs import flightrec as jrec
from karpenter_core_tpu.solver.tpu_solver import TPUSolver
from karpenter_core_tpu_torch.obs import flightrec as trec
from karpenter_core_tpu_torch.solver import torch_solver as tsolver
from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver
from tests.test_torch_cuda import FAMILIES, workload

REC = {"jax": jrec, "torch": trec}


PINNED_TS = "2023-11-14T22:13:20.000000Z"


def _pin_times(snap):
    """workload() pins every pod's name, uid and creation time; the
    provisioners, daemonset pods and nodes take the wall clock at build
    time and a process counter's uid, pinned here (to a fixed time and a
    uid made from the name)."""
    metas = [o["metadata"] for o in snap["provisioners"] + snap["daemonsetPods"]
             + snap.get("clusterNodes", [])]
    metas += [sn[k]["metadata"] for sn in snap["stateNodes"] for k in ("node", "machine")
              if sn.get(k)]
    for meta in metas:
        if "creationTimestamp" in meta:
            meta["creationTimestamp"] = PINNED_TS
        if "uid" in meta:
            meta["uid"] = f"uid-{meta['name']}"
    return snap


def _without_versions(snap):
    """A restored client re-creates the cluster objects, which takes new
    resource versions (in either package alike)."""
    snap = copy.deepcopy(snap)
    for o in snap.get("clusterNodes", []) + snap.get("clusterPods", []):
        o["metadata"].pop("resourceVersion", None)
    return snap


def _snapshot(family, pkg):
    pods, provs, its, daemons, nodes, max_nodes, client, _cluster = workload(family, pkg)
    return _pin_times(REC[pkg].snapshot_inputs(pods, provs, its, daemons, nodes,
                                               kube_client=client, max_nodes=max_nodes))


@pytest.mark.parametrize("family", FAMILIES)
def test_snapshot_and_digest_match_reference(family):
    """snapshot_inputs of one workload built by each package: equal dicts,
    equal digests; each package's restore of the other's snapshot
    snapshots back to the same dict."""
    ref, port = _snapshot(family, "jax"), _snapshot(family, "torch")
    assert json.loads(json.dumps(port)) == port  # JSON-able as it stands
    assert port == ref
    assert trec.input_digest(port) == jrec.input_digest(ref)
    agains = []
    for restore_pkg, snap in (("torch", ref), ("jax", port), ("torch", port)):
        r = REC[restore_pkg].restore_inputs(copy.deepcopy(snap))
        agains.append(_pin_times(REC[restore_pkg].snapshot_inputs(
            r.pods, r.provisioners, r.instance_types, r.daemonset_pods, r.state_nodes,
            kube_client=r.kube_client, max_nodes=r.max_nodes)))
        assert _without_versions(agains[-1]) == _without_versions(ref), restore_pkg
    assert agains[0] == agains[1] == agains[2]


def _ref_cluster(restored):
    """The reference's Cluster over a restored client's objects, as the
    port's restore_inputs builds its own."""
    if restored.kube_client is None:
        return None
    from karpenter_core_tpu.state.cluster import Cluster

    cluster = Cluster(restored.kube_client)
    for node in restored.kube_client.list("Node"):
        cluster.update_node(node)
    for pod in restored.kube_client.list("Pod"):
        cluster.update_pod(pod)
    return cluster


def _port_record(family):
    """A port record of one live CPU solve (begin -> solve -> finish),
    through JSON and back, and the live solve's placements."""
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload(family, "torch")
    recorder = trec.FlightRecorder().enable()
    live = recorder.begin(pods, provs, its, daemons, nodes, kube_client=client,
                          max_nodes=max_nodes)
    result = TorchSolver(max_nodes=max_nodes, device="cpu", incremental="off").solve(
        pods, provs, its, daemonset_pods=daemons, state_nodes=nodes, kube_client=client,
        cluster=cluster)
    live.finish("torch", result)
    (record,) = recorder.records()
    assert record["replayer"] == "torch" and record["schema"] == jrec.SCHEMA_VERSION
    assert record["outcome"]["placements"] == trec.canonical_placements(result)
    return json.loads(json.dumps(record)), trec.placements_json(result)


@pytest.mark.parametrize("family", ["spread", "cluster"])
def test_records_replay_across_packages(family):
    """A port record restores in the reference's restore_inputs and solves
    through TPUSolver (with a Cluster over the restored objects, as the
    port's restore builds one) to the port's replay placements, byte for
    byte; a reference record replays on the port's TorchSolver to the
    reference's placements. The spread family's record replays to its live
    solve; the cluster family's pending claim pods resolve through
    PersistentVolumeClaims and StorageClasses, which the record format
    does not carry, so its replay is held to the reference's alone."""
    record, live = _port_record(family)
    port_replay, _ = trec.replay(record, device="cpu")
    if family != "cluster":
        assert trec.placements_json(port_replay) == live
    r = jrec.restore_inputs(record["inputs"])
    ref_result = TPUSolver(max_nodes=r.max_nodes, backend="mxu", incremental="off").solve(
        r.pods, r.provisioners, r.instance_types, cluster=_ref_cluster(r),
        **r.solve_kwargs())
    assert jrec.placements_json(ref_result) == trec.placements_json(port_replay)

    pods, provs, its, daemons, nodes, max_nodes, client, _cluster = workload(family, "jax")
    recorder = jrec.FlightRecorder().enable()
    rec = recorder.begin(pods, provs, its, daemons, nodes, kube_client=client,
                         max_nodes=max_nodes)
    rec.finish("tpu", ref_result, replayer="tpu")
    jrecord = json.loads(json.dumps(recorder.last()))
    assert jrecord["digest"] == jrec.input_digest(jrecord["inputs"])
    assert trec.input_digest(_pin_times(jrecord["inputs"])) == trec.input_digest(
        _pin_times(copy.deepcopy(record["inputs"])))
    placements, _ = trec.replay(jrecord, device="cpu")  # "tpu" replays on TorchSolver
    assert trec.placements_json(placements) == jrec.placements_json(ref_result)
    assert trec.diff_placements(placements, jrecord["outcome"]["placements"]) == []


def test_build_replay_solver_hides_no_card():
    """"torch" (and a reference record's "tpu") is a TorchSolver on the
    card unless the caller asks for the CPU; "greedy" is the host
    GreedySolver, the replayer a fallback record names, and a record
    replays on it to the placements the port's GreedySolver gives."""
    import torch

    solver = trec.build_replay_solver("tpu", 64, device="cpu")
    assert isinstance(solver, TorchSolver) and solver.device.type == "cpu"
    assert solver.max_nodes == 64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trec.build_replay_solver("torch")
    assert isinstance(trec.build_replay_solver("greedy"), tsolver.GreedySolver)
    pods, provs, its, daemons, nodes, _mn, _c, _cl = workload("bulk", "torch")
    placements, _ = trec.replay({"inputs": _snapshot("bulk", "torch"), "replayer": "greedy"})
    want = tsolver.GreedySolver().solve(pods, provs, its, daemons, nodes)
    assert trec.placements_json(placements) == trec.placements_json(want)
    with pytest.raises(ValueError, match="unknown replay solver"):
        trec.build_replay_solver("mystery")


def test_placements_helpers_are_the_solvers():
    """torch_solver re-exports the recorder's canonical_placements and
    placements_json; the canonical form ignores machine and pod order."""
    assert tsolver.canonical_placements is trec.canonical_placements
    assert tsolver.placements_json is trec.placements_json
    pods, provs, its, daemons, nodes, max_nodes, _c, _cl = workload("bulk", "torch")
    result = TorchSolver(max_nodes=max_nodes, device="cpu").solve(
        pods, provs, its, daemonset_pods=daemons, state_nodes=nodes)
    canon = trec.canonical_placements(result)
    result.new_machines.reverse()
    for m in result.new_machines:
        m.pods = list(reversed(m.pods))
    assert trec.canonical_placements(result) == canon
    assert trec.placements_json(canon) == trec.placements_json(result)


def test_diff_placements_matches_reference():
    a = {"machines": [{"provisioner": "p", "instanceType": "x", "options": 2,
                       "requests": {"cpu": 1.0}, "pods": ["ns/a", "ns/b"]}],
         "existing": [{"node": "n1", "pods": ["ns/c"]}], "failed": ["ns/d"]}
    b = copy.deepcopy(a)
    b["machines"][0]["options"] = 3
    b["existing"][0]["pods"] = []
    c = copy.deepcopy(a)
    c["machines"][0]["instanceType"] = "y"
    c["failed"] = []
    for x, y in ((a, a), (a, b), (a, c), (b, c)):
        assert trec.diff_placements(x, y) == jrec.diff_placements(x, y)
    assert trec.diff_placements(a, a) == []


# -- the recorder ----------------------------------------------------------------


def _small():
    pods, provs, its, daemons, nodes, max_nodes, _c, _cl = workload("bulk", "torch")
    return pods, provs, its, daemons, nodes


def test_recorder_ring_caps_and_failures_never_raise(tmp_path):
    pods, provs, its, daemons, nodes = _small()
    rec = trec.FlightRecorder(capacity=2).enable(dump_dir=str(tmp_path))
    result = TorchSolver(max_nodes=64, device="cpu").solve(pods, provs, its)
    for _ in range(3):
        rec.begin(pods, provs, its).finish("torch", result)
    assert len(rec.records()) == 2 and rec.dropped == 1
    live = rec.begin(pods, provs, its)
    live.note_primary_error(RuntimeError("card lost"))
    live.finish("torch", result)
    assert rec.last()["primary_error"] == "RuntimeError: card lost"
    rec.begin(pods, provs, its).finish_error("torch", ValueError("boom"))
    assert rec.last()["error"] == "ValueError: boom"
    # the primary-error record and the error record dump (one file name
    # per second and digest: the second dump replaces the first's file)
    dumps = sorted(os.listdir(tmp_path))
    assert 1 <= len(dumps) <= 2 and all(d.startswith("solve-") for d in dumps)
    with open(tmp_path / dumps[0]) as f:
        assert json.load(f)["schema"] == trec.SCHEMA_VERSION
    # a snapshot that fails, and a finish on a result that cannot be read,
    # are counted, never raised
    assert rec.begin([object()], provs, its) is None
    rec.begin(pods, provs, its).finish("torch", object())
    assert rec.failures == 2
    body = json.loads(rec.to_json())
    assert body["capture_failures"] == 2 and len(body["dumped"]) == 2


def test_recorder_skips_past_the_state_node_cap(monkeypatch):
    pods, provs, its, daemons, nodes = _small()
    monkeypatch.setattr(trec, "MAX_SNAPSHOT_STATE_NODES", 2)
    rec = trec.FlightRecorder().enable()
    assert rec.begin(pods, provs, its, state_nodes=[object()] * 3) is None
    assert json.loads(rec.to_json())["skipped_large"] == 1
    assert trec.MAX_CLUSTER_SNAPSHOT_PODS == jrec.MAX_CLUSTER_SNAPSHOT_PODS == 4096
    assert jrec.MAX_SNAPSHOT_STATE_NODES == 2048


def test_cluster_context_gated_and_capped(monkeypatch):
    """Bound pods ride along only for batches whose topology counting reads
    them, and past the cap only their count does (clusterOmitted), in both
    packages alike."""
    for pkg in ("jax", "torch"):
        pods, provs, its, daemons, nodes, max_nodes, client, _cl = workload("cluster", pkg)
        snap = REC[pkg].snapshot_inputs(pods, provs, its, kube_client=client)
        assert snap["clusterPods"] and snap["clusterNodes"]
        plain = [p for p in pods if not REC[pkg]._needs_cluster_context([p])]
        assert "clusterPods" not in REC[pkg].snapshot_inputs(plain, provs, its,
                                                             kube_client=client)
        monkeypatch.setattr(REC[pkg], "MAX_CLUSTER_SNAPSHOT_PODS", 3)
        capped = REC[pkg].snapshot_inputs(pods, provs, its, kube_client=client)
        assert capped["clusterOmitted"] == len(snap["clusterPods"])
        assert "clusterPods" not in capped


def test_record_phases_are_the_solves_own():
    """With the tracer on, a record carries its own solve's phase spans,
    which are the solver's last_phase_ms."""
    from karpenter_core_tpu_torch.obs import TRACER

    pods, provs, its, daemons, nodes = _small()
    solver = TorchSolver(max_nodes=64, device="cpu", incremental="off")
    rec = trec.FlightRecorder().enable()
    was = TRACER.enabled
    TRACER.enable()
    try:
        with TRACER.span("provisioner.reconcile"):
            live = rec.begin(pods, provs, its)
            result = solver.solve(pods, provs, its)
            live.finish("torch", result)
    finally:
        TRACER.enabled = was
    record = rec.last()
    assert record["trace_id"]
    phases = dict(record["phases_ms"])
    assert phases.pop("expand") > 0  # the decode's log replay, a span of its own
    # the reference's lookup and decode spans, which are no phase of the port's
    assert phases.pop("pack") >= 0 and phases.pop("bind") > 0
    assert phases == {k: round(v, 1) for k, v in solver.last_phase_ms.items()}


def test_disabled_recorder_and_suppression():
    pods, provs, its, daemons, nodes = _small()
    rec = trec.FlightRecorder()
    assert rec.begin(pods, provs, its) is None
    assert rec.record_consolidation("x", [], [], None) is None
    rec.enable()
    with trec.suppress_recording():
        assert trec.recording_suppressed()
        assert rec.record_consolidation("x", [], [], None) is None
    assert not trec.recording_suppressed()


def test_simulate_scheduling_suppresses_recording(monkeypatch):
    """A deprovisioning simulation solves under suppress_recording and a
    deprovisioning.simulate span, so its solve is a simulation."""
    from karpenter_core_tpu_torch.controllers.deprovisioning import core
    from karpenter_core_tpu_torch.obs import TRACER

    seen = {}

    def traced(*a, **kw):
        seen["suppressed"] = trec.recording_suppressed()
        seen["span"] = TRACER.current_span_name()
        return [], True

    monkeypatch.setattr(core, "_simulate_scheduling_traced", traced)
    was = TRACER.enabled
    TRACER.enable()
    try:
        core.simulate_scheduling(None, None, None, [])
    finally:
        TRACER.enabled = was
    assert seen == {"suppressed": True, "span": "deprovisioning.simulate"}


def test_enable_flightrec_from_env(monkeypatch, tmp_path):
    was_enabled, was_dir = trec.FLIGHTREC.enabled, trec.FLIGHTREC.dump_dir
    try:
        for raw, default_on, expect in [("1", False, True), ("on", False, True),
                                        ("", False, False), ("0", True, False),
                                        ("", True, True)]:
            trec.FLIGHTREC.disable()
            monkeypatch.setenv("KARPENTER_TPU_FLIGHTREC", raw)
            monkeypatch.setenv("KARPENTER_TPU_FLIGHTREC_DIR", str(tmp_path))
            assert trec.enable_flightrec_from_env(default_on) is expect
            assert trec.FLIGHTREC.dump_dir == str(tmp_path)
    finally:
        trec.FLIGHTREC.enabled, trec.FLIGHTREC.dump_dir = was_enabled, was_dir


# -- consolidation records ------------------------------------------------------------


def _consolidation_records(build, kinds=("multi", "single")):
    """Both packages' consolidation records of the same passes (ts masked)."""
    from tests import test_torch_consolidation as tc

    out = []
    port = tc.PortEnv()
    port.cluster.cloud_provider = port.cp  # as the operator wires it
    for env, rec in ((tc.RefEnv(), jrec), (port, trec)):
        build(tc, env)
        env.sync()
        recorder = rec.FlightRecorder().enable()
        real = rec.FLIGHTREC
        rec.FLIGHTREC = recorder
        try:
            for kind in kinds:
                dep = env.multi if kind == "multi" else env.single
                dep.compute_command(tc.scan(env, dep))
        finally:
            rec.FLIGHTREC = real
        records = [dict(r, ts=0.0) for r in recorder.consolidations()]
        for r in records:
            if "inputs" in r:
                _pin_times(r["inputs"])
        out.append(records)
    return out


def _delete_geometry(tc, env):
    tc.default_provisioner(env)
    tc.add_keeper(env)
    for i in range(6):
        tc.add_node(env, f"lite-{i}")


def _replace_geometry(tc, env):
    tc.default_provisioner(env)
    tc.add_node(env, "big-1", it_name="fake-it-9", cpu="10")
    tc.add_node(env, "big-2", it_name="fake-it-4", cpu="5")


@pytest.mark.parametrize("geometry", ["delete", "replace"])
def test_consolidation_records_match_reference(geometry):
    """The multi-node ladder's and the single-node sweep's records: the
    same candidates, subsets, verdicts, objectives, Command and inputs."""
    build = {"delete": _delete_geometry, "replace": _replace_geometry}[geometry]
    ref, port = _consolidation_records(build)
    assert port and len(port) == len(ref)
    assert port == ref
    assert any("inputs" in r for r in port)
    for r, x in zip(port, ref):
        if "inputs" in r:
            assert trec.input_digest(r["inputs"]) == jrec.input_digest(x["inputs"])


def test_consolidation_record_replays_on_the_port():
    """The delete geometry's ladder record through replay_consolidation on
    the CPU: the chosen Command is confirmed, every subset agrees."""
    _ref, port = _consolidation_records(_delete_geometry, kinds=("multi",))
    record = next(r for r in port if r["deprovisioner"] == "MultiNodeConsolidation")
    out = trec.replay_consolidation(json.loads(json.dumps(record)), "torch", device="cpu")
    assert out["chosen_feasible_seq"] and out["chosen"]["action"] == "delete"
    assert all(s["agrees"] for s in out["subsets"])
    assert out["seq_pick"] is not None
    with pytest.raises(ValueError, match="not a consolidation record"):
        trec.replay_consolidation({"kind": "solve"}, "torch", device="cpu")


def _operator_cluster():
    """A kube client as the operator meets it: 9 initialized nodes over 3
    zones with 4 running pods each, among them, in test-zone-3, a guard
    pod whose required zonal anti-affinity repels app=web (inverse
    anti-affinity: the pending web pods must stay out of that zone); 40
    pending web pods and 20 pending pods of a zonal spread cohort (so the
    batch's topology reads the bound pods and the record carries them);
    one provisioner."""
    from karpenter_core_tpu_torch import testing
    from karpenter_core_tpu_torch.api.labels import (
        LABEL_CAPACITY_TYPE, LABEL_NODE_INITIALIZED, PROVISIONER_NAME_LABEL_KEY)
    from karpenter_core_tpu_torch.cloudprovider import fake
    from karpenter_core_tpu_torch.kube.client import InMemoryKubeClient
    from karpenter_core_tpu_torch.kube.objects import (
        LABEL_INSTANCE_TYPE_STABLE, LABEL_TOPOLOGY_ZONE, LabelSelector, PodAffinityTerm,
        TopologySpreadConstraint)

    universe = fake.instance_types(12)
    client = InMemoryKubeClient()
    guard = PodAffinityTerm(topology_key=LABEL_TOPOLOGY_ZONE,
                            label_selector=LabelSelector(match_labels={"app": "web"}))
    for i in range(9):
        it = universe[i % len(universe)]
        client.create(testing.make_node(
            name=f"node-{i}",
            labels={PROVISIONER_NAME_LABEL_KEY: "default", LABEL_NODE_INITIALIZED: "true",
                    LABEL_INSTANCE_TYPE_STABLE: it.name, LABEL_CAPACITY_TYPE: "on-demand",
                    LABEL_TOPOLOGY_ZONE: f"test-zone-{1 + i % 3}"},
            capacity={k: str(v) for k, v in it.capacity.items()}))
        for j in range(4):
            kw = (dict(labels={"app": "guard"}, pod_anti_affinity_required=[guard])
                  if i == 2 and j == 0 else dict(labels={"app": f"db-{j}"}))
            client.create(testing.make_pod(
                name=f"run-{i}-{j}", node_name=f"node-{i}", unschedulable=False,
                phase="Running", requests={"cpu": "100m", "memory": "128Mi"},
                uid=f"uid-run-{i}-{j}", creation_timestamp=900.0, **kw))
    spread = TopologySpreadConstraint(1, LABEL_TOPOLOGY_ZONE, "DoNotSchedule",
                                      LabelSelector(match_labels={"app": "spread"}))
    for k in range(60):
        kw = (dict(labels={"app": "spread"}, topology_spread=[spread]) if k % 3 == 2
              else dict(labels={"app": "web"}))
        client.create(testing.make_pod(name=f"p-{k}", requests={"cpu": "1", "memory": "1Gi"},
                                       uid=f"uid-p-{k:03d}", creation_timestamp=1000.0, **kw))
    client.create(testing.make_provisioner(name="default"))
    return universe, client


def test_live_operator_solve_replays_to_its_placements():
    """A live operator step()'s solve, recorded around the operator's
    solver with its bound pods in the record (under the cap): through JSON
    and back, replay on the CPU gives the live placements byte for byte.
    The live solve kept every web pod out of the guard's zone, and
    restoring without the Cluster over the record's objects loses that
    inverse anti-affinity, so the replay then differs: the restored
    Cluster is what makes it exact."""
    from karpenter_core_tpu_torch import testing
    from karpenter_core_tpu_torch.api import settings as tsettings
    from karpenter_core_tpu_torch.cloudprovider import fake
    from karpenter_core_tpu_torch.kube.objects import LABEL_TOPOLOGY_ZONE
    from karpenter_core_tpu_torch.operator import new_operator

    universe, client = _operator_cluster()
    solver = TorchSolver(max_nodes=64, device="cpu")
    recorder = trec.FlightRecorder().enable()
    live, real_solve = [], solver.solve

    def solve(*a, **kw):
        taken = recorder.begin(*a, daemonset_pods=kw.get("daemonset_pods"),
                               state_nodes=kw.get("state_nodes"),
                               kube_client=kw.get("kube_client"), max_nodes=solver.max_nodes)
        result = real_solve(*a, **kw)
        taken.finish("torch", result)
        live.append(result)
        return result

    solver.solve = solve
    op = new_operator(fake.FakeCloudProvider(universe), kube_client=client,
                      settings=tsettings.Settings(), solver=solver, clock=testing.FakeClock())
    op.step()
    (result,) = live
    assert not result.failed_pods
    zone_of = {n.name: n.metadata.labels[LABEL_TOPOLOGY_ZONE]
               for n in client.list("Node") if n.name.startswith("node-")}
    web_zones = {zone_of[node.name()] for node, pods in result.existing_assignments
                 for p in pods if p.metadata.labels.get("app") == "web"}
    for m in result.new_machines:
        if any(p.metadata.labels.get("app") == "web" for p in m.pods):
            zone = m.requirements.get(LABEL_TOPOLOGY_ZONE)
            assert zone is not None and not zone.complement
            web_zones |= set(zone.values)
    assert web_zones and "test-zone-3" not in web_zones

    record = json.loads(json.dumps(recorder.last()))
    inputs = record["inputs"]
    assert len(inputs["clusterPods"]) == 36 and "clusterOmitted" not in inputs
    replayed, _ = trec.replay(record, device="cpu")
    assert trec.placements_json(replayed) == trec.placements_json(result)

    restored = trec.restore_inputs(inputs)
    assert restored.cluster is not None
    restored.cluster = None
    bare = TorchSolver(max_nodes=restored.max_nodes, device="cpu", incremental="off").solve(
        restored.pods, restored.provisioners, restored.instance_types,
        **restored.solve_kwargs())
    assert trec.placements_json(bare) != trec.placements_json(result)
