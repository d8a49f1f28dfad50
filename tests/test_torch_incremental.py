"""The port's steady-churn re-solve path against the reference's, on the CPU.

A TorchSolver that solves batch after batch keeps the [N, C] prescreen
tensor resident and refreshes only the rows and columns whose planes
changed (solver/incremental.py, ops/pack.screen_refresh),
carries its label dictionary and the instance-type planes, and checks
all of it against the cluster's change feed. Every comparison here is
exact: bool and int arrays equal, placements byte-identical.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_core_tpu.kube.client import InMemoryKubeClient as JClient
from karpenter_core_tpu.obs.flightrec import canonical_placements, placements_json
from karpenter_core_tpu.ops import pack as jpack
from karpenter_core_tpu.solver import encode as jencode
from karpenter_core_tpu.solver import incremental as jinc
from karpenter_core_tpu.solver import tpu_solver as jsolver
from karpenter_core_tpu.state import informer as jinformer
from karpenter_core_tpu.state.cluster import Cluster as JCluster

from karpenter_core_tpu_torch.kube.client import InMemoryKubeClient as TClient
from karpenter_core_tpu_torch.kube.client import NotFoundError
from karpenter_core_tpu_torch.ops import pack as tpack
from karpenter_core_tpu_torch.solver import encode as tencode
from karpenter_core_tpu_torch.solver import incremental as tinc
from karpenter_core_tpu_torch.solver import torch_solver as tsolver
from karpenter_core_tpu_torch.state import informer as tinformer
from karpenter_core_tpu_torch.state.cluster import Cluster as TCluster

from tests.test_torch_cuda import _mods
from tests.test_torch_solver import _assert_tree_equal

ZONES = ["test-zone-1", "test-zone-2", "test-zone-3"]
APPS = [f"churn-{i}" for i in range(6)]
HOST = "kubernetes.io/hostname"
ITEM_KEYS = ("allow", "out", "defined", "escape", "custom_deny")


def _segments(lengths):
    b = np.cumsum([0] + list(lengths))
    return [(int(x), int(y)) for x, y in zip(b[:-1], b[1:])]


def _planes(rng, E, I, C, segments):
    """Seeded existing and item planes, with C class columns (scls_first)."""
    V, K = segments[-1][1], len(segments)
    exist = {"allow": rng.random((E, V)) < 0.7, "out": rng.random((E, K)) < 0.3,
             "defined": rng.random((E, K)) < 0.6}
    pods = {"allow": rng.random((I, V)) < 0.6, "out": rng.random((I, K)) < 0.3,
            "defined": rng.random((I, K)) < 0.7, "escape": rng.random((I, K)) < 0.2,
            "custom_deny": rng.random((I, K)) < 0.1,
            "scls_first": rng.permutation(I)[:C].astype(np.int32)}
    return pods, exist


def _to_torch(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def _to_jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


# an empty key, a key cut by the screen width, a key past it
SEGS = _segments([3, 0, 9, 30, 1, 40, 2])
E, I, C, N = 24, 40, 30, 56


def _refresh(segments, screen_v, prev, pods, exist, rows, cols):
    """ops/pack.screen_refresh on torch tensors, with the class planes
    built as a solve builds them."""
    ops = tpack.ScreenOps(segments, pods["allow"].shape[1], screen_v)
    return tpack.screen_refresh(prev, ops, tpack.class_planes(pods, ops), exist, rows, cols)


def _padded(delta):
    """The reference's padded form of a delta: the index vectors zero-padded
    to the budgets rb and cb, and the live counts."""
    row_idx = np.zeros(delta.rb, np.int32)
    row_idx[: len(delta.rows)] = delta.rows
    col_idx = np.zeros(delta.cb, np.int32)
    col_idx[: len(delta.cols)] = delta.cols
    return row_idx, len(delta.rows), col_idx, len(delta.cols)


@pytest.mark.parametrize("rb", [0, 8, 16])
@pytest.mark.parametrize("cb", [0, 8, 16])
def test_refresh_kernel_matches_reference(rb, cb):
    """(a) The refresh of a stale tensor, live counts below the budgets:
    the padded entries past them must be dropped, never written. The port
    takes the live indices; rows outside the existing prefix and columns
    outside the tensor must be dropped too."""
    rng = np.random.default_rng(100 + rb + cb)
    pods, exist = _planes(rng, E, I, C, SEGS)
    prev = rng.random((N, C)) < 0.5
    row_idx = np.zeros(rb, np.int32)
    row_n = max(rb - 3, 0)
    row_idx[:row_n] = rng.choice(E, size=row_n, replace=False)
    row_idx[row_n:] = rng.integers(0, E, size=rb - row_n)  # stale padding
    col_idx = np.zeros(cb, np.int32)
    col_n = max(cb - 5, 0)
    col_idx[:col_n] = rng.choice(C, size=col_n, replace=False)
    col_idx[col_n:] = rng.integers(0, C, size=cb - col_n)
    for screen_v in (None, 60):
        want = jpack.make_screen_refresh_kernel(SEGS, N, rb, cb, backend="mxu",
                                                screen_v=screen_v)(
            jnp.asarray(prev), _to_jax(pods), _to_jax(exist), jnp.asarray(row_idx),
            row_n, jnp.asarray(col_idx), col_n)
        # the reference's padded call, cut to its live counts
        got = _refresh(SEGS, screen_v, torch.from_numpy(prev.copy()), _to_torch(pods),
                       _to_torch(exist), row_idx[:row_n], col_idx[:col_n])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        outside = _refresh(SEGS, screen_v, torch.from_numpy(prev.copy()), _to_torch(pods),
                           _to_torch(exist), np.r_[row_idx[:row_n], E, N - 1, -1],
                           np.r_[-1, col_idx[:col_n], C])
        np.testing.assert_array_equal(outside.numpy(), np.asarray(want))
        if rb == cb == 0:
            np.testing.assert_array_equal(got.numpy(), prev)


def test_refreshed_tensor_equals_full_prescreen_of_new_planes():
    """(a) Full prescreen of planes A, a drift of rows and columns, the
    delta planned by IncrementalScreen and refreshed: equal to the full
    prescreen of the drifted planes."""
    rng = np.random.default_rng(7)
    pods, exist = _planes(rng, E, I, C, SEGS)
    for screen_v in (None, 60):
        pre = tpack.make_prescreen_kernel(SEGS, N, screen_v=screen_v)
        inc = tinc.IncrementalScreen()
        key = ("geom", screen_v)
        assert inc.plan(key, pods, exist) is None
        inc.adopt(key, pre(_to_torch(pods), _to_torch(exist)))
        new_pods = {k: v.copy() for k, v in pods.items()}
        new_exist = {k: v.copy() for k, v in exist.items()}
        for e in (2, 11, 23):
            new_exist["allow"][e] = rng.random(SEGS[-1][1]) < 0.5
        new_exist["defined"][5] = ~new_exist["defined"][5]
        sf = new_pods["scls_first"]
        for c in (0, 9, 29):
            new_pods["allow"][sf[c]] = rng.random(SEGS[-1][1]) < 0.5
        new_pods["custom_deny"][sf[4]] = ~new_pods["custom_deny"][sf[4]]
        delta = inc.plan(key, new_pods, new_exist)
        assert list(delta.rows) == [2, 5, 11, 23] and list(delta.cols) == [0, 4, 9, 29]
        refreshed = _refresh(SEGS, screen_v, inc.resident(key), _to_torch(new_pods),
                             _to_torch(new_exist), delta.rows, delta.cols)
        full = pre(_to_torch(new_pods), _to_torch(new_exist))
        assert torch.equal(refreshed, full)


def _outcomes_of_reference():
    return {k: jinc.INCREMENTAL_SCREEN_TOTAL.get({"outcome": k}) for k in tinc.OUTCOME_NAMES}


def _outcome_counts(run):
    """run()'s result and the dispatch outcomes it counted in each
    package: the port's OUTCOMES series and the reference's counter."""
    tinc.reset_outcomes()
    before = _outcomes_of_reference()
    got = run()
    after = _outcomes_of_reference()
    return got, tinc.outcome_counts(), {k: int(after[k] - before[k]) for k in after}


def test_plan_matches_reference(monkeypatch):
    """(b) IncrementalScreen.plan of both packages on the same planes: the
    same rows, cols, rb, cb and outcome at every step of the reference's
    outcome ladder (miss, empty refresh, narrow refresh, wide, gated,
    adopt without a plan)."""
    rng = np.random.default_rng(0)
    pods, exist = _planes(rng, 12, 9, 9, _segments([10, 30]))
    pods["scls_first"] = np.arange(9, dtype=np.int32)
    carriers = {"jax": jinc.IncrementalScreen(), "torch": tinc.IncrementalScreen()}
    key = ("geom", "prescreen")

    def step(p, e, **kw):
        before_j, before_t = _outcomes_of_reference(), tinc.outcome_counts()
        dj = carriers["jax"].plan(key, p, e, **kw)
        dt = carriers["torch"].plan(key, p, e, **kw)
        after_j = _outcomes_of_reference()
        after_t = tinc.outcome_counts()
        assert {k: after_j[k] - before_j[k] for k in after_j} == {
            k: after_t[k] - before_t[k] for k in after_t}
        assert (dj is None) == (dt is None)
        if dj is not None:
            assert (list(dj.rows), list(dj.cols), dj.rb, dj.cb) == (
                list(dt.rows), list(dt.cols), dt.rb, dt.cb)
            for a, b in zip(dj.padded(), _padded(dt)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return dt

    def adopt(k, tensor):
        for c in carriers.values():
            c.adopt(k, tensor)
        return carriers["torch"].resident(k)

    assert step(pods, exist) is None  # nothing resident
    assert adopt(key, "tensor-0") == "tensor-0"
    delta = step(pods, exist)  # identical planes: an empty refresh
    assert len(delta.rows) == 0 and len(delta.cols) == 0 and delta.rb == delta.cb == 0
    adopt(key, "tensor-1")
    exist["allow"][4] = ~exist["allow"][4]
    exist["defined"][7] = ~exist["defined"][7]
    pods["out"][2] = ~pods["out"][2]
    delta = step(pods, exist)
    assert list(delta.rows) == [4, 7] and list(delta.cols) == [2]
    assert (delta.rb, delta.cb) == (8, 8)
    adopt(key, "tensor-2")
    # past the (narrowed) row budget: full, residency kept
    monkeypatch.setattr(jinc, "MAX_ROW_DELTA", 4)
    monkeypatch.setattr(tinc, "MAX_ROW_DELTA", 4)
    assert step(pods, {k: ~v for k, v in exist.items()}) is None
    assert carriers["torch"].resident(key) == "tensor-2"
    # a feed fault with residency: full_gated, and residency dropped
    assert step(pods, exist, gate_ok=False) is None
    assert carriers["torch"].resident(key) is None
    # an adopt without a matching plan leaves the carrier empty
    assert adopt(("other", "key"), "tensor-3") is None


def _feed_sequence(m, cluster, client):
    """One mutation sequence of a cluster: nodes, bindings, a rebind, a
    terminal pod, deletes, a provisioner update."""
    nodes = [m.t.make_node(name=f"feed-{i}", labels={"z": ZONES[i % 3]},
                           capacity={"cpu": "4", "pods": "10"}) for i in range(3)]
    for n in nodes:
        cluster.update_node(n)
    for j in range(4):
        p = m.t.make_pod(name=f"feed-pod-{j}", node_name=f"feed-{j % 3}",
                         unschedulable=False, phase="Running", requests={"cpu": "1"})
        cluster.update_pod(p)
    moved = m.t.make_pod(name="feed-pod-0", node_name="feed-2", unschedulable=False,
                         phase="Running", requests={"cpu": "1"})
    cluster.update_pod(moved)
    done = m.t.make_pod(name="feed-pod-1", node_name="feed-1", unschedulable=False,
                        phase="Succeeded", requests={"cpu": "1"})
    cluster.update_pod(done)
    cluster.delete_pod(m.o.NamespacedName("default", "feed-pod-2"))
    cluster.delete_node("feed-0")
    cluster.delete_node("never-there")
    cluster.update_provisioner(m.t.make_provisioner(name="default"))


def test_changes_since_matches_reference():
    """(c) The change feed of both Clusters over the same mutations: the
    same cursors and token sets from every earlier cursor, None for an
    unknown or future cursor and after a ring overflow."""
    feeds = {}
    for pkg in ("jax", "torch"):
        m = _mods(pkg)
        cluster = m.cluster(m.client())
        start, changed = cluster.changes_since(None)
        assert changed is None
        _feed_sequence(m, cluster, cluster.kube_client)
        rev = cluster.revision()
        feeds[pkg] = [cluster.changes_since(c) for c in range(start, rev + 3)]
        feeds[pkg].append(cluster.changes_since(None))
    assert feeds["torch"] == feeds["jax"]
    assert feeds["torch"][0][1] == {"fake:///feed-0", "fake:///feed-1", "fake:///feed-2", "*"}
    # history past the ring is detected, never skipped
    for pkg in ("jax", "torch"):
        m = _mods(pkg)
        cluster = m.cluster(m.client())
        base, _ = cluster.changes_since(None)
        for i in range(cluster.CHANGE_RING + 5):
            cluster.update_node(m.t.make_node(name=f"ring-{i}"))
        cur, changed = cluster.changes_since(base)
        assert changed is None and cur == cluster.CHANGE_RING + 5
        assert cluster.changes_since(cur - 3)[1] == {f"fake:///ring-{i}" for i in range(
            cluster.CHANGE_RING + 2, cluster.CHANGE_RING + 5)}


class FaultyCluster(TCluster):
    """A Cluster whose change feed raises on the consults listed in
    `fail_on` (1-based), as a flaky store's feed would."""

    def __init__(self, client, fail_on=()):
        super().__init__(client)
        self.fail_on = set(fail_on)
        self.consults = 0

    def changes_since(self, cursor):
        self.consults += 1
        if self.consults in self.fail_on:
            raise ConnectionError("change feed unavailable")
        return super().changes_since(cursor)


def test_diff_gate_degrades_on_a_feed_fault():
    """(d) DiffGate against a feed that raises, as the reference's gate
    test runs it."""
    cluster = FaultyCluster(TClient(), fail_on=(4,))
    gate = tinc.DiffGate()
    assert gate.gate(cluster) is False  # first consult: no cursor yet
    assert gate.gate(cluster) is True  # continuous (empty) history
    cluster.update_node(_mods("torch").t.make_node(name="g-1"))
    assert gate.gate(cluster) is True  # continuous non-empty history
    assert gate.gate(cluster) is False  # the feed raised
    assert gate.gate(cluster) is False  # the cursor restarted
    assert gate.gate(cluster) is True
    assert gate.gate(object()) is True and gate.gate(None) is True


# -- churn sequences ------------------------------------------------------------

class ChurnSequence:
    """The reference's ChurnSequence (tests/test_incremental_parity.py),
    built with one package's builders and every name, uid and timestamp
    pinned: per step the cluster grows inside one existing-axis bucket
    (every other step), two bound pods leave and two bind to random
    nodes, and a fresh batch of anchor and filler pods arrives."""

    def __init__(self, m, seed, node_count=10, filler=6, grow_to=13):
        self.m = m
        self.rng = np.random.default_rng(seed)
        self.universe = m.fake.instance_types(6)
        self.nodes = [self._node(e) for e in range(node_count)]
        self.filler = filler
        self.grow_to = grow_to
        self.bound = []
        self._n = 0
        self._pods = 0
        self._step = 0

    def _node(self, e):
        it = self.universe[e % len(self.universe)]
        return self.m.node(self.m.t.make_node(
            name=f"churn-node-{e}",
            labels={"karpenter.sh/provisioner-name": "default",
                    "karpenter.sh/initialized": "true",
                    "node.kubernetes.io/instance-type": it.name,
                    "karpenter.sh/capacity-type": "on-demand",
                    "topology.kubernetes.io/zone": ZONES[e % 3]},
            capacity={k: str(v) for k, v in it.capacity.items()}))

    def _pod(self, **kw):
        self._pods += 1
        p = self.m.t.make_pod(name=f"pod-{self._step}-{self._pods}", **kw)
        p.metadata.uid = f"uid-{self._step}-{self._pods:04d}"
        p.metadata.creation_timestamp = 1000.0 + self._pods % 7
        return p

    def _anchor_pods(self):
        o = self.m.o
        spread = o.TopologySpreadConstraint(
            max_skew=2, topology_key=HOST, when_unsatisfiable="DoNotSchedule",
            label_selector=o.LabelSelector(match_labels={"app": APPS[0]}))
        anti = o.PodAffinityTerm(topology_key=HOST, label_selector=o.LabelSelector(
            match_labels={"app": APPS[1]}))
        pods = [self._pod(labels={"app": a}, requests={"cpu": "0.1"}) for a in APPS]
        pods.append(self._pod(labels={"app": APPS[0]}, requests={"cpu": "0.1"},
                              topology_spread=[spread]))
        pods.append(self._pod(labels={"app": APPS[1]}, requests={"cpu": "0.1"},
                              pod_anti_affinity_required=[anti]))
        return pods

    def step(self):
        self._step += 1
        if self._step % 2 == 0 and len(self.nodes) < self.grow_to:
            self.nodes.append(self._node(len(self.nodes)))
        for _ in range(min(2, len(self.bound))):
            e, key = self.bound.pop(0)
            self.nodes[e].cleanup_for_pod(key)
        for _ in range(2):
            e = int(self.rng.integers(len(self.nodes)))
            self._n += 1
            p = self.m.t.make_pod(name=f"bound-{self._n}",
                                  labels={"app": APPS[int(self.rng.integers(len(APPS)))]},
                                  requests={"cpu": "0.25"})
            p.metadata.uid = f"uid-bound-{self._n}"
            self.nodes[e].update_for_pod(p)
            self.bound.append((e, self.m.o.object_key(p)))
        pods = self._anchor_pods() + [
            self._pod(labels={"app": APPS[int(self.rng.integers(len(APPS)))]},
                      requests={"cpu": str(float(self.rng.choice([0.25, 0.5, 1.0])))})
            for _ in range(self.filler)
        ]
        return pods, [n.deep_copy() for n in self.nodes]


def _solve(solver, pods, nodes, its, provs, cluster=None):
    res = solver.solve(copy.deepcopy(pods), provs, its, state_nodes=nodes, cluster=cluster)
    return placements_json(canonical_placements(res)), res


def _churn_run(seed, steps, t_cluster=None, j_cluster=None):
    """One churn sequence through the port's incremental and full solvers
    and the reference's incremental solver: byte-identical placements at
    every step. Returns the two incremental solvers' prescreen modes."""
    seqs = {pkg: ChurnSequence(_mods(pkg), seed) for pkg in ("jax", "torch")}
    provs = {pkg: [_mods(pkg).t.make_provisioner(name="default")] for pkg in seqs}
    its = {pkg: {"default": seqs[pkg].universe} for pkg in seqs}
    ref = jsolver.TPUSolver(max_nodes=64, backend="mxu", screen_mode="prescreen",
                            incremental="on")
    inc = tsolver.TorchSolver(max_nodes=64, device="cpu")
    full = tsolver.TorchSolver(max_nodes=64, device="cpu", incremental="off")
    modes = {"jax": [], "torch": []}
    for k in range(steps):
        jpods, jnodes = seqs["jax"].step()
        tpods, tnodes = seqs["torch"].step()
        want, jres = _solve(ref, jpods, jnodes, its["jax"], provs["jax"], j_cluster)
        a, res_a = _solve(inc, tpods, [n.deep_copy() for n in tnodes], its["torch"],
                          provs["torch"], t_cluster)
        b, res_b = _solve(full, tpods, tnodes, its["torch"], provs["torch"])
        assert a == b, f"incremental and full solves differ at step {k}"
        assert a == want, f"the port and the reference differ at step {k}"
        assert res_a.rounds == res_b.rounds == jres.rounds
        assert full.last_prescreen_mode == "full"
        if inc.last_prescreen_mode == "refresh":
            d = inc.last_prescreen_delta
            assert d["rows"] <= d["rb"] and d["cols"] <= d["cb"]
        modes["jax"].append(ref.last_prescreen_mode)
        modes["torch"].append(inc.last_prescreen_mode)
    return modes


@pytest.mark.parametrize("seed", [3, 17, 41])
def test_churn_sequence_matches_reference(seed):
    """(e) Seeded churn sequences: the port's incremental and full solvers
    and the reference's incremental solver place alike at every step, the
    port's prescreen modes equal the reference's, and the refresh settles
    in."""
    modes, port, ref = _outcome_counts(lambda: _churn_run(seed, steps=6))
    assert modes["torch"] == modes["jax"]
    assert modes["torch"][0] == "full"
    assert modes["torch"].count("refresh") >= 3, modes
    assert port == ref and port["full_deg"] == 0


def test_feed_fault_forces_full_and_recovers():
    """(f) A Cluster whose change feed raises on the third and fourth
    consults: those solves run the full precompute (a feed fault drops
    residency), placements stay identical, and the refresh resumes after;
    the reference's solver over a feed faulted on the same consults takes
    the same modes."""
    from karpenter_core_tpu import chaos

    t_cluster = FaultyCluster(TClient(), fail_on=(3, 4))
    j_cluster = JCluster(JClient())
    try:
        chaos.arm(chaos.STATE_DIFF, error="conn", probability=1.0, after=2, times=2,
                  seed=7)
        modes, port, ref = _outcome_counts(
            lambda: _churn_run(11, steps=6, t_cluster=t_cluster, j_cluster=j_cluster))
    finally:
        chaos.disarm(chaos.STATE_DIFF)
    assert t_cluster.consults == 6
    assert modes["torch"] == modes["jax"]
    # the faulted consults (steps 3-4) and the one after (a fault resets
    # the cursor, which the next consult must prove again) run full
    assert modes["torch"][2:5] == ["full", "full", "full"], modes
    assert "refresh" in modes["torch"][:2] and modes["torch"][-1] == "refresh"
    # a fault drops every resident tensor first, so the plan counts a miss
    assert port == ref and port["full_miss"] == 4 and port["full_deg"] == 0


def test_feed_fault_through_the_port_s_chaos_point():
    """(f) through the port's own `state.diff` point: both packages' real
    Clusters, each package's chaos armed with the same spec and seed
    (after two consults, two faults). The port's solver takes the
    reference's modes and counts, as with the FaultyCluster above."""
    from karpenter_core_tpu import chaos as jchaos
    from karpenter_core_tpu_torch import chaos as tchaos

    t_cluster, j_cluster = TCluster(TClient()), JCluster(JClient())
    faults = [c.arm(c.STATE_DIFF, error="conn", probability=1.0, after=2, times=2, seed=7)
              for c in (tchaos, jchaos)]
    try:
        modes, port, ref = _outcome_counts(
            lambda: _churn_run(11, steps=6, t_cluster=t_cluster, j_cluster=j_cluster))
    finally:
        tchaos.disarm(tchaos.STATE_DIFF)
        jchaos.disarm(jchaos.STATE_DIFF)
    assert [(f.calls, f.injected) for f in faults] == [(6, 2), (6, 2)]
    assert modes["torch"] == modes["jax"]
    assert modes["torch"][2:5] == ["full", "full", "full"], modes
    assert "refresh" in modes["torch"][:2] and modes["torch"][-1] == "refresh"
    assert port == ref and port["full_miss"] == 4 and port["full_deg"] == 0


# -- watches and informers -----------------------------------------------------

def _drive_through_client(m, client, pump):
    """Nodes, bound pods, a rebind, a deletion and a node's removal, made
    through the client; pump() hands the watch events on after each."""
    for i in range(3):
        client.create(m.t.make_node(name=f"w-{i}", labels={"z": ZONES[i]},
                                    capacity={"cpu": "8", "pods": "20"}))
        pump()
    for j in range(5):
        client.create(m.t.make_pod(name=f"wp-{j}", node_name=f"w-{j % 3}",
                                   unschedulable=False, phase="Running",
                                   requests={"cpu": "1"}))
        pump()
    moved = client.get("Pod", "default", "wp-0")
    moved.spec.node_name = "w-1"
    client.update(moved)
    pump()
    client.delete("Pod", "default", "wp-3")
    pump()
    client.delete(client.get("Node", "", "w-2"))
    pump()
    client.create(m.t.make_provisioner(name="default"))
    pump()


def _state_of(cluster):
    return {
        "nodes": sorted((n.name(), sorted(n.pod_requests), sorted(n.available().items()))
                        for n in cluster.nodes()),
        "bindings": sorted(cluster.bindings.items()),
        "revision": cluster.revision(),
        "changes": cluster.changes_since(0),
    }


def test_watches_and_informers_feed_the_cluster():
    """(g) A Cluster fed by the client's watches through the informers ends
    equal to one updated directly with the same objects, and to the
    reference's Cluster fed by the reference's informers."""
    fed = {}
    for pkg, informer in (("jax", jinformer), ("torch", tinformer)):
        m = _mods(pkg)
        client = m.client()
        cluster = m.cluster(client)
        handlers = {"Node": informer.NodeInformer(cluster),
                    "Pod": informer.PodInformer(cluster),
                    "Provisioner": informer.ProvisionerInformer(cluster)}
        queues = {kind: client.watch(kind) for kind in handlers}

        def pump():
            for kind, q in queues.items():
                while not q.empty():
                    handlers[kind].handle(*q.get_nowait())

        _drive_through_client(m, client, pump)
        for kind, q in queues.items():
            client.unwatch(kind, q)
        fed[pkg] = _state_of(cluster)
    assert fed["torch"] == fed["jax"]
    assert fed["torch"]["bindings"] == [
        (("default", "wp-0"), "w-1"), (("default", "wp-1"), "w-1"),
        (("default", "wp-2"), "w-2"), (("default", "wp-4"), "w-1")]
    # the same objects handed to the Cluster directly
    m = _mods("torch")
    direct = TCluster(TClient())
    for i in range(3):
        direct.update_node(m.t.make_node(name=f"w-{i}", labels={"z": ZONES[i]},
                                         capacity={"cpu": "8", "pods": "20"}))
    pods = [m.t.make_pod(name=f"wp-{j}", node_name=f"w-{j % 3}", unschedulable=False,
                         phase="Running", requests={"cpu": "1"}) for j in range(5)]
    for p in pods:
        direct.update_pod(p)
    pods[0].spec.node_name = "w-1"
    direct.update_pod(pods[0])
    direct.delete_pod(m.o.NamespacedName("default", "wp-3"))
    direct.delete_node("w-2")
    direct.update_provisioner(m.t.make_provisioner(name="default"))
    assert _state_of(direct) == fed["torch"]


def test_client_update_delete_and_watch_backlog():
    m = _mods("torch")
    client = TClient()
    node = client.create(m.t.make_node(name="b-0", capacity={"cpu": "4"}))
    q = client.watch("Node")
    assert q.get_nowait()[0] == "ADDED"  # the backlog
    assert client.watch("Node", backlog=False).empty()
    node.metadata.labels["x"] = "y"
    node.status.capacity = {"cpu": 99.0}
    stored = client.update(node)
    # the status subresource: a plain update keeps the stored status
    assert stored.metadata.labels["x"] == "y" and stored.status.capacity == {"cpu": 4.0}
    assert q.get_nowait()[0] == "MODIFIED"
    stored.metadata.labels["x"] = "mutated"  # copies out: the store is untouched
    assert client.get("Node", "", "b-0").metadata.labels["x"] == "y"
    client.delete(stored)
    event, obj = q.get_nowait()
    assert event == "DELETED" and obj.metadata.name == "b-0"
    assert client.get("Node", "", "b-0") is None
    with pytest.raises(NotFoundError):
        client.delete("Node", "", "b-0")
    with pytest.raises(NotFoundError):
        client.update(node)
    client.unwatch("Node", q)
    client.create(m.t.make_node(name="b-1"))
    assert q.empty()
    assert tinformer.drain(client.watch("Node"), tinformer.NodeInformer(TCluster(client))) == 1


# -- the carried encode -----------------------------------------------------------

def _carry_batches(m, grow):
    """Two batches over one cluster: the second adds `grow` nodes (new
    hostnames) and a fresh pod batch."""
    its = m.fake.instance_types(6)
    provs = [m.t.make_provisioner(name="default")]
    seq_nodes = []

    def node(e):
        it = its[e % len(its)]
        return m.node(m.t.make_node(
            name=f"carry-{e}",
            labels={"karpenter.sh/provisioner-name": "default",
                    "karpenter.sh/initialized": "true",
                    "node.kubernetes.io/instance-type": it.name,
                    "topology.kubernetes.io/zone": ZONES[e % 3]},
            capacity={k: str(v) for k, v in it.capacity.items()}))

    def batch(tag):
        pods = []
        for i in range(12):
            p = m.t.make_pod(name=f"{tag}-{i}", labels={"app": APPS[i % 3]},
                             requests={"cpu": str(0.25 * (1 + i % 4))},
                             node_selector={"topology.kubernetes.io/zone": ZONES[i % 3]}
                             if i % 4 == 0 else None)
            p.metadata.uid = f"uid-{tag}-{i:03d}"
            p.metadata.creation_timestamp = 1000.0 + i
            pods.append(p)
        return pods

    seq_nodes = [node(e) for e in range(10)]
    first = (batch("a"), [n.deep_copy() for n in seq_nodes])
    seq_nodes += [node(10 + e) for e in range(grow)]
    second = (batch("b"), [n.deep_copy() for n in seq_nodes])
    return provs, {"default": its}, first, second


@pytest.mark.parametrize("grow", [0, 3, 23])
def test_carried_encode_matches_reference(grow):
    """(h) EncodeReuse, dictionary_covers and dictionary_rebind_hostnames:
    a second batch encoded with the first's dictionary carried (covered,
    rebound onto pad hostnames, or refused when the bucket overflows) and
    the type planes reused gives the reference's device_args under the
    same carry."""
    out = {}
    for pkg, enc, solver in (("jax", jencode, jsolver), ("torch", tencode, tsolver)):
        m = _mods(pkg)
        provs, its, (pods_a, nodes_a), (pods_b, nodes_b) = _carry_batches(m, grow)
        reuse = enc.EncodeReuse()
        first = enc.encode_snapshot(pods_a, provs, its, None, nodes_a, max_nodes=64,
                                    reuse=reuse)
        carrier = first.dictionary
        fresh = enc.encode_snapshot(pods_b, provs, its, None, nodes_b, max_nodes=64)
        covers = enc.dictionary_covers(carrier, fresh.dictionary)
        second = enc.encode_snapshot(pods_b, provs, its, None, nodes_b, max_nodes=64,
                                     reuse=reuse, carry_dictionary=carrier)
        out[pkg] = {
            "covers": covers,
            "carried": second.dictionary is carrier,
            "reused": second.type_reqs is first.type_reqs,
            "values": [(k, second.dictionary.values_of(k)) for k in second.dictionary.keys],
            "geom": solver.solve_geometry(second, 64),
            "args": dict(zip(solver.RUN_ARG_NAMES, solver.device_args(second, provs))),
        }
    j, t = out["jax"], out["torch"]
    assert (t["covers"], t["carried"], t["reused"]) == (j["covers"], j["carried"], j["reused"])
    assert t["values"] == j["values"] and t["geom"] == j["geom"]
    _assert_tree_equal(j["args"], t["args"])
    # no growth: covered, and the type planes reused; growth inside the
    # existing-axis bucket (32 rows): rebound, and the types re-encoded
    # (the dictionary's content changed); past it: refused
    assert t["covers"] == (grow == 0) and t["reused"] == (grow == 0)
    assert t["carried"] == (grow < 23)


def test_rebind_and_covers_match_reference_on_dictionaries():
    """dictionary_covers and dictionary_rebind_hostnames on hand-built
    dictionaries: the same verdicts and the same rebound values."""
    results = {}
    for pkg, enc in (("jax", jencode), ("torch", tencode)):
        carrier, fresh = enc.LabelDictionary(), enc.LabelDictionary()
        for v in ("a", "b", "c", "__exist-pad-3"):
            carrier.add_value(HOST, v)
        carrier.add_value("zone", "z1")
        carrier.canonicalize(last_key=HOST)
        for v in ("a", "d", "e"):
            fresh.add_value(HOST, v)
        fresh.add_value("zone", "z1")
        fresh.canonicalize(last_key=HOST)
        covered = enc.dictionary_covers(carrier, fresh)
        rebound = enc.dictionary_rebind_hostnames(carrier, fresh)
        other = enc.LabelDictionary()
        other.add_value("zone", "z9")
        other.canonicalize()
        results[pkg] = (covered, rebound, carrier.values_of(HOST), carrier.V,
                        enc.dictionary_covers(carrier, other),
                        enc.dictionary_rebind_hostnames(carrier, other))
    assert results["torch"] == results["jax"]
    assert results["torch"][:2] == (False, True)


def test_residency_outlives_geometry_the_tensor_does_not_read():
    """The resident tensor is keyed on what it is computed from (N, the
    segments, the screen width, the prescreen planes' shapes), not on the
    whole solve geometry: a batch that only grows the commit log keeps it,
    refreshing an empty delta, where the reference, which keys residency
    on its compiled program, runs the full precompute. Placements equal
    the port's full solver's and the reference's."""
    seqs = {pkg: ChurnSequence(_mods(pkg), 5) for pkg in ("jax", "torch")}
    provs = {pkg: [_mods(pkg).t.make_provisioner(name="default")] for pkg in seqs}
    its = {pkg: {"default": seqs[pkg].universe} for pkg in seqs}
    ref = jsolver.TPUSolver(max_nodes=64, backend="mxu", screen_mode="prescreen",
                            incremental="on")
    inc = tsolver.TorchSolver(max_nodes=64, device="cpu")
    full = tsolver.TorchSolver(max_nodes=64, device="cpu", incremental="off")
    nodes = {pkg: seq.step()[1] for pkg, seq in seqs.items()}
    modes, log_lens = {"jax": [], "torch": []}, []
    for n_filler in (40, 80):
        batch = {pkg: [seq._pod(labels={"app": APPS[2]}, requests={"cpu": "0.25"})
                       for _ in range(n_filler)] for pkg, seq in seqs.items()}
        want, _ = _solve(ref, batch["jax"], nodes["jax"], its["jax"], provs["jax"])
        a, _ = _solve(inc, batch["torch"], [n.deep_copy() for n in nodes["torch"]],
                      its["torch"], provs["torch"])
        b, _ = _solve(full, batch["torch"], nodes["torch"], its["torch"], provs["torch"])
        assert a == b == want
        modes["jax"].append(ref.last_prescreen_mode)
        modes["torch"].append(inc.last_prescreen_mode)
        snap = inc.encode(batch["torch"], provs["torch"], its["torch"],
                          state_nodes=nodes["torch"])
        log_lens.append(tsolver.solve_geometry(snap, 64)[12])
    assert log_lens[0] != log_lens[1]
    assert modes == {"jax": ["full", "full"], "torch": ["full", "refresh"]}
    assert inc.last_prescreen_delta == {"rows": 0, "cols": 0, "rb": 0, "cb": 0}


def test_solver_arguments_and_defaults():
    """The reference's resolved defaults are constructor arguments: the
    prescreen screen mode with the incremental path on; incremental
    applies only under prescreen."""
    s = tsolver.TorchSolver(device="cpu")
    assert (s.screen_mode, s.incremental) == ("prescreen", "on") and s._inc_enabled()
    assert not tsolver.TorchSolver(device="cpu", incremental="off")._inc_enabled()
    assert not tsolver.TorchSolver(device="cpu", screen_mode="tiered")._inc_enabled()
    for bad in ({"screen_mode": "auto"}, {"incremental": "auto"}):
        with pytest.raises(ValueError):
            tsolver.TorchSolver(device="cpu", **bad)


def test_failed_refresh_degrades_to_full_and_is_counted(monkeypatch):
    """A refresh that raises falls back to the full precompute for that
    solve, is counted as full_deg, keeps the plan's fingerprints (so the
    next solve refreshes again) and places as the full solver does."""
    seq = ChurnSequence(_mods("torch"), 5)
    provs = [_mods("torch").t.make_provisioner(name="default")]
    its = {"default": seq.universe}
    inc = tsolver.TorchSolver(max_nodes=64, device="cpu")
    full = tsolver.TorchSolver(max_nodes=64, device="cpu", incremental="off")
    real = tsolver.screen_refresh
    calls = {"n": 0}

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("refresh failed")
        return real(*args, **kw)

    monkeypatch.setattr(tsolver, "screen_refresh", flaky)
    tinc.reset_outcomes()
    modes = []
    for _ in range(4):
        pods, nodes = seq.step()
        a, _ = _solve(inc, pods, [n.deep_copy() for n in nodes], its, provs)
        b, _ = _solve(full, pods, nodes, its, provs)
        assert a == b
        modes.append(inc.last_prescreen_mode)
    assert modes == ["full", "full", "refresh", "refresh"]
    outcomes = tinc.outcome_counts()
    assert outcomes["full_deg"] == 1 and outcomes["refresh"] == 2
    assert "refresh failed" in inc.last_refresh_error
