"""The port's segmented pack scan against the reference's, on the CPU.

Each workload is built with both packages' builders (pod names, uids and
creation timestamps pinned: they break FFD ties) and solved by
`TorchSolver(device="cpu", pack_scan="segmented")` and the reference's
`TPUSolver(pack_scan="segmented")`. The two must agree on the placements
byte for byte, on `last_segment_stats` (all but its `segment_ms`), on the
segmented phases, on the lane plan (item_sel and exist_open, padding
included) and on what the host merge hands to decode (the merged log,
ptr and slot state); the port's segmented solve must also place every pod
as the port's sequential solve does.

The reference's two kernel-level specs of tests/test_segmented.py have
their counterparts here: `test_partitioner_matches_reference` and
`test_partitioner_components` (the partitioner's labels, neutral mask and
slot labels against the reference's kernel on the same numpy planes), and
`test_lanes_match_reference_frozen_and_refresh_lanes` (the port's lane
scan, which always refreshes its copy of the verdict tensor, against the
reference's read-only lanes and its refresh lanes on an all-neutral
workload).
"""
import copy

import numpy as np
import pytest
import torch

from karpenter_core_tpu import chaos as jchaos
from karpenter_core_tpu.obs import flightrec as jrec
from karpenter_core_tpu.solver import tpu_solver as jsolver
from karpenter_core_tpu_torch import chaos as tchaos
from karpenter_core_tpu_torch.obs import flightrec as trec
from karpenter_core_tpu_torch.ops import compat as tcompat
from karpenter_core_tpu_torch.ops import pack as tpack
from karpenter_core_tpu_torch.solver import encode as tencode
from karpenter_core_tpu_torch.solver import torch_solver as tsolver

from tests.test_torch_cuda import _mods, workload

TEAM = "team"
MAX_NODES = 96


def _pin(pods, tag):
    for i, p in enumerate(pods):
        p.metadata.name = f"{tag}-{i}"
        p.metadata.uid = f"uid-{tag}-{i:05d}"
        p.metadata.creation_timestamp = 1000.0 + (i * 7919) % 97
    return pods


def pool_workload(m, seed, pools=4, n_pods=120, n_nodes=0, limits=None):
    """tests/test_segmented.py's selector-scoped pools, built with m's
    builders; `limits` gives pool-0 a provisioner limit."""
    rng = np.random.default_rng(seed)
    universe = m.fake.instance_types(6)
    provisioners, its = m.t.make_pool_provisioners(pools, universe)
    if limits is not None:
        provisioners[0] = m.t.make_provisioner(
            name="pool-0", limits=limits,
            requirements=[m.o.NodeSelectorRequirement(key=TEAM, operator="In",
                                                      values=["pool-0"])])
    nodes = []
    for e in range(n_nodes):
        it = universe[e % len(universe)]
        pool = f"pool-{e % pools}"
        nodes.append(m.node(m.t.make_node(
            name=f"seg-n-{e}",
            labels={"karpenter.sh/provisioner-name": pool,
                    "karpenter.sh/initialized": "true",
                    "node.kubernetes.io/instance-type": it.name,
                    "karpenter.sh/capacity-type": "on-demand",
                    "topology.kubernetes.io/zone": "test-zone-1", TEAM: pool},
            capacity={k: str(v) for k, v in it.capacity.items()})))
    pods = []
    for _ in range(n_pods):
        p = int(rng.integers(pools))
        pods.append(m.t.make_pod(
            labels={"app": f"dep-{p}-{int(rng.integers(8))}"},
            requests={"cpu": str(0.25 + 0.25 * int(rng.integers(3)))},
            node_selector={TEAM: f"pool-{p}"}))
    return _pin(pods, f"pool{seed}"), provisioners, its, nodes


def single_template_workload(m, _seed):
    pods = [m.t.make_pod(labels={"app": f"gen-{i % 10}"},
                         requests={"cpu": str(0.1 * (1 + i % 4))}) for i in range(60)]
    return (_pin(pods, "single"), [m.t.make_provisioner(name="default")],
            {"default": m.fake.instance_types(5)}, [])


def anti_workload(m, _seed):
    anti = m.o.PodAffinityTerm(topology_key="kubernetes.io/hostname",
                               label_selector=m.o.LabelSelector(match_labels={"app": "anti"}))
    pods = [m.t.make_pod(labels={"app": "anti"}, requests={"cpu": "0.5"},
                         pod_anti_affinity_required=[anti]) for _ in range(24)]
    return (_pin(pods, "anti"), [m.t.make_provisioner(name="default")],
            {"default": m.fake.instance_types(5)}, [])


CASES = {
    "pools-7": (pool_workload, 7, {}),
    "pools-19": (pool_workload, 19, {}),
    "pools-existing-3": (pool_workload, 3, dict(n_pods=160, n_nodes=8)),
    "pools-existing-13": (pool_workload, 13, dict(n_pods=160, n_nodes=8)),
    "single-template": (single_template_workload, 0, {}),
    "anti-affinity": (anti_workload, 0, {}),
    "finite-limits": (pool_workload, 7, dict(limits={"cpu": "1000"})),
}
WANT = {"pools-7": "segmented", "pools-19": "segmented", "pools-existing-3": "segmented",
        "pools-existing-13": "segmented",
        "single-template": "single-segment", "anti-affinity": "structure",
        "finite-limits": "finite-limits"}

# one reference solver per scan, shared across cases (each compiles once
# per geometry); incremental="off" keeps it from carrying one case's label
# dictionary into the next, as the port's fresh solvers do not
_JSOLVERS = {}


def _jsolver(mode):
    return _JSOLVERS.setdefault(mode, jsolver.TPUSolver(
        max_nodes=MAX_NODES, backend="mxu", incremental="off", pack_scan=mode))


def _spy_reference(monkeypatch):
    """Capture the reference's lane plan and merge output."""
    seen = {}
    seg_fn = jsolver.TPUSolver._segment_fn
    try_seg = jsolver.TPUSolver._try_segmented

    def spy_fn(self, *a, **k):
        fn, cold = seg_fn(self, *a, **k)

        def call(item_sel, exist_open, *rest):
            seen["plan"] = (np.asarray(item_sel), np.asarray(exist_open))
            return fn(item_sel, exist_open, *rest)

        return call, cold

    def spy_try(self, *a, **k):
        out = try_seg(self, *a, **k)
        seen["merged"] = out
        return out

    monkeypatch.setattr(jsolver.TPUSolver, "_segment_fn", spy_fn)
    monkeypatch.setattr(jsolver.TPUSolver, "_try_segmented", spy_try)
    return seen


def _spy_port(monkeypatch):
    seen = {}
    make = tsolver.make_device_run
    try_seg = tsolver.TorchSolver._try_segmented

    def spy_make(*a, **k):
        run = make(*a, **k)
        if not k.get("segment_mode"):
            return run

        def seg_run(item_sel, exist_open, *rest, **kw):
            seen["plan"] = (np.asarray(item_sel), np.asarray(exist_open))
            return run(item_sel, exist_open, *rest, **kw)

        return seg_run

    def spy_try(self, *a, **k):
        out = try_seg(self, *a, **k)
        seen["merged"] = out
        return out

    monkeypatch.setattr(tsolver, "make_device_run", spy_make)
    monkeypatch.setattr(tsolver.TorchSolver, "_try_segmented", spy_try)
    return seen


def _stats(solver):
    return {k: v for k, v in (solver.last_segment_stats or {}).items() if k != "segment_ms"}


def _segment_phases(solver):
    return sorted({"segment", "merge"} & set(solver.last_phase_ms))


def _solve(solver, wl):
    pods, provs, its, nodes = wl
    return solver.solve(copy.deepcopy(pods), provs, its,
                        state_nodes=[n.deep_copy() for n in nodes] if nodes else None)


def _assert_merged_equal(got, want):
    (glog, gptr, gstate), (wlog, wptr, wstate) = got, want
    assert gptr == wptr
    for k in ("item", "slot", "ns", "k", "k_last", "bulk_take"):
        assert np.array_equal(np.asarray(glog[k]), np.asarray(wlog[k])), k
    assert glog["bulk_n"] == wlog["bulk_n"]
    for f in ("tmpl", "used", "pods", "tmask", "allow", "out", "defined"):
        a, b = np.asarray(getattr(gstate, f)), np.asarray(getattr(wstate, f))
        assert a.shape == b.shape and np.array_equal(a, b), f


@pytest.mark.parametrize("case", sorted(CASES))
def test_segmented_matches_reference(case, monkeypatch):
    build, seed, kw = CASES[case]
    jwl, twl = build(_mods("jax"), seed, **kw), build(_mods("torch"), seed, **kw)
    jseen, tseen = _spy_reference(monkeypatch), _spy_port(monkeypatch)
    want = _solve(_jsolver("segmented"), jwl)
    port_seg = tsolver.TorchSolver(max_nodes=MAX_NODES, device="cpu", pack_scan="segmented")
    got = _solve(port_seg, twl)
    seq = _solve(tsolver.TorchSolver(max_nodes=MAX_NODES, device="cpu",
                                     pack_scan="sequential"), twl)
    a = trec.placements_json(trec.canonical_placements(got))
    assert a == jrec.placements_json(jrec.canonical_placements(want))
    assert a == trec.placements_json(trec.canonical_placements(seq))
    assert got.rounds == want.rounds == seq.rounds
    stats = _stats(port_seg)
    assert stats == _stats(_jsolver("segmented"))
    assert _segment_phases(port_seg) == _segment_phases(_jsolver("segmented"))
    if WANT[case] == "segmented":
        assert stats["mode"] == "segmented" and stats["fixup_fraction"] == 0.0
        assert stats["segments"] >= 2
        for got_a, want_a in zip(tseen["plan"], jseen["plan"]):
            assert got_a.shape == want_a.shape and np.array_equal(got_a, want_a)
        _assert_merged_equal(tseen["merged"], jseen["merged"])
    else:
        assert stats["mode"] == "sequential-fallback"
        assert stats["reason"] == WANT[case] and stats["fixup_fraction"] == 1.0
        assert "plan" not in tseen and "plan" not in jseen


def test_chaos_degrade_matches_reference():
    jwl, twl = pool_workload(_mods("jax"), 23), pool_workload(_mods("torch"), 23)
    port_seg = tsolver.TorchSolver(max_nodes=MAX_NODES, device="cpu", pack_scan="segmented")
    jchaos.arm(jchaos.SOLVER_SEGMENT, error="runtime", times=1)
    tchaos.arm(tchaos.SOLVER_SEGMENT, error="runtime", times=1)
    try:
        want = _solve(_jsolver("segmented"), jwl)
        got = _solve(port_seg, twl)
    finally:
        jchaos.disarm(jchaos.SOLVER_SEGMENT)
        tchaos.disarm(tchaos.SOLVER_SEGMENT)
    assert trec.placements_json(trec.canonical_placements(got)) == jrec.placements_json(
        jrec.canonical_placements(want))
    assert _stats(port_seg) == _stats(_jsolver("segmented"))
    assert _stats(port_seg)["reason"].startswith("error:")
    assert _segment_phases(port_seg) == _segment_phases(_jsolver("segmented")) == []


def test_kernel_fault_in_lanes_is_raised_not_degraded(monkeypatch):
    """A screen kernel that fails to launch inside the segmented attempt
    (the partitioner's template rows, a lane's re-screen) is raised; any
    other failure there degrades to the sequential scan."""
    from karpenter_core_tpu_torch.ops.cuda_build import KernelError

    twl = pool_workload(_mods("torch"), 7)
    calls = {"n": 0}
    real = tpack.ScreenOps.rows_vs_items

    def failing(exc):
        # the first call is the partitioner's template rows; the sequential
        # scan's own calls after a degrade go through
        def rows_vs_items(self, *a, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise exc
            return real(self, *a, **kw)
        return rows_vs_items

    monkeypatch.setattr(tpack.ScreenOps, "rows_vs_items",
                        failing(KernelError("screen kernel launch failed: CUDA error 700")))
    solver = tsolver.TorchSolver(max_nodes=MAX_NODES, device="cpu", pack_scan="segmented")
    with pytest.raises(KernelError):
        _solve(solver, twl)
    assert calls["n"] == 1
    calls["n"] = 0
    monkeypatch.setattr(tpack.ScreenOps, "rows_vs_items", failing(RuntimeError("partition")))
    solver = tsolver.TorchSolver(max_nodes=MAX_NODES, device="cpu", pack_scan="segmented")
    got = _solve(solver, twl)
    assert _stats(solver)["reason"] == "error:RuntimeError"
    monkeypatch.setattr(tpack.ScreenOps, "rows_vs_items", real)
    seq = _solve(tsolver.TorchSolver(max_nodes=MAX_NODES, device="cpu",
                                     pack_scan="sequential"), twl)
    assert trec.placements_json(trec.canonical_placements(got)) == trec.placements_json(
        trec.canonical_placements(seq))


def test_scan_switch_reads_the_environment(monkeypatch):
    for raw, want in (("segmented", "segmented"), ("sequential", "sequential"),
                      ("auto", "sequential"), ("bogus", "sequential")):
        monkeypatch.setenv("KCT_PACK_SCAN", raw)
        assert tcompat.resolve_pack_scan() == want
    monkeypatch.delenv("KCT_PACK_SCAN")
    assert tcompat.resolve_pack_scan() == "sequential"
    with pytest.raises(ValueError):
        tsolver.TorchSolver(device="cpu", pack_scan="lanes")
    # pack_scan=None reads the variable at each solve
    twl = pool_workload(_mods("torch"), 19)
    solver = tsolver.TorchSolver(max_nodes=MAX_NODES, device="cpu")
    _solve(solver, twl)
    assert solver.last_segment_stats is None
    monkeypatch.setenv("KCT_PACK_SCAN", "segmented")
    _solve(solver, twl)
    assert solver.last_segment_stats["mode"] == "segmented"
    # the tiered screen keeps no verdict tensor: no segmented attempt
    tiered = tsolver.TorchSolver(max_nodes=MAX_NODES, device="cpu", screen_mode="tiered")
    _solve(tiered, twl)
    assert tiered.last_segment_stats is None


@pytest.mark.parametrize("family", ["mixed", "spread", "bulk", "cluster"])
def test_encode_segment_gates_match_reference(family):
    from karpenter_core_tpu.solver import encode as jencode

    jp, jprov, jits, jds, jnodes, mn, jkc, jcl = workload(family, "jax")
    tp, tprov, tits, tds, tnodes, _, tkc, tcl = workload(family, "torch")
    js = jencode.encode_snapshot(jp, jprov, jits, jds, jnodes, kube_client=jkc, cluster=jcl,
                                 max_nodes=mn)
    ts = tencode.encode_snapshot(tp, tprov, tits, tds, tnodes, tkc, tcl, max_nodes=mn)
    assert ts.seg_eligible == js.seg_eligible
    assert np.array_equal(ts.seg_plane_neutral, js.seg_plane_neutral)
    assert tencode.SEGMENT_LANE_BUCKETS == jencode.SEGMENT_LANE_BUCKETS
    for s in range(1, 17):
        assert tencode.segment_lane_pad(s) == jencode.segment_lane_pad(s)
    for m, pad in ((1, 32), (33, 64), (200, 128), (5000, 8192)):
        assert tencode.segment_item_pad(m, pad) == jencode.segment_item_pad(m, pad)


def _partition_both(snap_j, provs, screen0):
    """Both packages' partitioner on the reference snapshot's device_args
    and one [N, C] verdict tensor."""
    import jax.numpy as jnp

    from karpenter_core_tpu.ops.pack import make_segment_partition_kernel

    geom = jsolver.solve_geometry(snap_j, MAX_NODES)
    E, segments, scr_v = geom[3], geom[8], geom[16]
    args = jsolver.device_args(snap_j, provs)
    kern = make_segment_partition_kernel(segments, E, screen_v=scr_v)
    want = [np.asarray(x) for x in kern(jnp.asarray(screen0), args[0], args[1],
                                        jnp.asarray(args[12]))]
    targs = tsolver.args_to_torch(args, "cpu")
    tkern = tpack.make_segment_partition_kernel(segments, E, screen_v=scr_v)
    got = [x.numpy() for x in tkern(torch.from_numpy(screen0), targs[0], targs[1], targs[12])]
    return got, want, args


def test_partitioner_matches_reference():
    """labels, neutral and slot_label on the reference's numpy planes: the
    prescreen's own tensor and a random one whose existing block welds
    classes across pools."""
    pods, provs, its, nodes = pool_workload(_mods("jax"), 3, n_pods=160, n_nodes=8)
    snap = jsolver.TPUSolver(max_nodes=MAX_NODES).encode(pods, provs, its, state_nodes=nodes)
    geom = jsolver.solve_geometry(snap, MAX_NODES)
    args = jsolver.device_args(snap, provs)
    targs = tsolver.args_to_torch(args, "cpu")
    screen0 = tpack.make_prescreen_kernel(geom[8], geom[7], screen_v=geom[16])(
        targs[0], targs[9]).numpy()
    rng = np.random.default_rng(5)
    rand = screen0.copy()
    rand[: geom[3]] = rng.random(rand[: geom[3]].shape) < 0.05
    distinct = []
    for s0 in (screen0, rand):
        got, want, _ = _partition_both(snap, provs, s0)
        for g, w, name in zip(got, want, ("labels", "neutral", "slot_label")):
            assert g.dtype == w.dtype and np.array_equal(g, w), name
        distinct.append(len(set(got[0].tolist())))
    # the pools split on the prescreen's tensor; the random block welds them
    assert distinct[0] > 1 and distinct[1] == 1


def test_partitioner_components():
    """tests/test_segmented.py's component unit on the port: a neutral class
    compatible with both pools' templates welds them into one component;
    without it the pools split. Each output equals the reference kernel's,
    and the port's encode marks the same classes neutral."""
    def four(m):
        return _pin([
            m.t.make_pod(labels={"app": "a"}, requests={"cpu": "0.5"},
                         node_selector={TEAM: "pool-0"}),
            m.t.make_pod(labels={"app": "b"}, requests={"cpu": "0.25"},
                         node_selector={TEAM: "pool-0"}),
            m.t.make_pod(labels={"app": "c"}, requests={"cpu": "0.5"},
                         node_selector={TEAM: "pool-1"}),
            m.t.make_pod(labels={"app": "d"}, requests={"cpu": "0.1"}),
        ], "unit")

    def labels_of(n_pods):
        m, tm = _mods("jax"), _mods("torch")
        provs, its = m.t.make_pool_provisioners(2, m.fake.instance_types(4))
        snap = jsolver.TPUSolver(max_nodes=MAX_NODES).encode(four(m)[:n_pods], provs, its)
        geom = jsolver.solve_geometry(snap, MAX_NODES)
        C = jsolver.device_args(snap, provs)[0]["scls_first"].shape[0]
        got, want, args = _partition_both(snap, provs, np.zeros((geom[7], C), bool))
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        tprovs, tits = tm.t.make_pool_provisioners(2, tm.fake.instance_types(4))
        tsnap = tencode.encode_snapshot(four(tm)[:n_pods], tprovs, tits, max_nodes=MAX_NODES)
        assert np.array_equal(tsnap.seg_plane_neutral, snap.seg_plane_neutral)
        scls = args[0]["scls"]
        return ({p.metadata.labels["app"]: int(got[0][scls[snap.item_of_pod[i]]])
                 for i, p in enumerate(snap.pods)}, int(got[1].sum()))

    lab, neutral = labels_of(4)
    assert lab["a"] == lab["b"] == lab["c"] == lab["d"]
    assert neutral >= 1
    lab, _ = labels_of(3)
    assert lab["a"] == lab["b"] != lab["c"]


def test_lanes_match_reference_frozen_and_refresh_lanes():
    """The port's lane scan on an all-neutral workload, two lanes of halves
    of the items, against the reference's lanes with seg_frozen=True (the
    read-only variant) and with seg_frozen=False, on the same numpy
    inputs."""
    import jax
    import jax.numpy as jnp

    from karpenter_core_tpu.ops import compat as jcompat
    from karpenter_core_tpu.ops.pack import make_screen_ops

    m = _mods("jax")
    pods = _pin([m.t.make_pod(labels={"app": f"g{i % 6}"},
                              requests={"cpu": str(0.2 * (1 + i % 3))}) for i in range(40)],
                "frozen")
    provs = [m.t.make_provisioner(name="default")]
    snap = jsolver.TPUSolver(max_nodes=48).encode(pods, provs, {"default":
                                                               m.fake.instance_types(5)})
    assert snap.seg_plane_neutral.all()
    geom = jsolver.solve_geometry(snap, 48)
    (_P, _J, _T, E, _R, K, V, N, segments, zone_seg, ct_seg, _ts, log_len, _Q, _W, _D,
     scr_v) = geom
    args = jsolver.device_args(snap, provs)
    I = len(snap.item_counts)  # the real items, split in halves
    half = I // 2
    item_sel = np.full((4, max(half + I % 2, I - half)), -1, np.int32)
    item_sel[0, :half] = np.arange(half)
    item_sel[1, : I - half] = np.arange(half, I)
    exist_open = np.zeros((4, E), bool)

    targs = tsolver.args_to_torch(args, "cpu")
    ops = tpack.ScreenOps(segments, V, scr_v)
    items_pl = tpack.class_planes(targs[0], ops)
    screen0 = ops.initial_screen(items_pl, torch.zeros((0, V), dtype=torch.bool),
                                 torch.zeros((0, K), dtype=torch.bool),
                                 torch.zeros((0, K), dtype=torch.bool), N)
    seg_run = tsolver.make_device_run(segments, zone_seg, ct_seg, None, N, log_len,
                                      screen_v=scr_v, segment_mode=True)
    port = seg_run(item_sel, exist_open, screen0, *targs, items_pl=items_pl)
    assert port[2] is None and port[3] is None

    jops = make_screen_ops(list(segments), jcompat.resolve_backend(), scr_v)
    jitems = {k: jnp.asarray(args[0][k])[jnp.asarray(args[0]["scls_first"])]
              for k in ("allow", "out", "defined", "escape", "custom_deny")}
    jscreen0 = jops.initial_screen(jitems, jnp.zeros((0, V), bool), jnp.zeros((0, K), bool),
                                   jnp.zeros((0, K), bool), N)
    assert np.array_equal(np.asarray(jscreen0), screen0.numpy())
    for frozen in (True, False):
        jrun = jsolver.make_device_run(segments, zone_seg, ct_seg, snap.topo_meta, N,
                                       log_len=log_len, screen_v=scr_v,
                                       screen_mode="prescreen", external_prescreen=True,
                                       segment_mode=True, seg_frozen=frozen)
        jlog, jptr, jstate = jax.device_get(jax.jit(jrun)(item_sel, exist_open, jscreen0,
                                                          *args))
        for s in (0, 1):
            log, ptr, state = port[s]
            assert ptr == int(jptr[s]) > 0, frozen
            for k in ("item", "slot", "ns", "k", "k_last"):
                assert np.array_equal(log[k], np.asarray(jlog[k][s])), (frozen, k)
            for f in ("tmpl", "used", "pods"):
                assert np.array_equal(getattr(state, f).numpy(),
                                      np.asarray(getattr(jstate, f)[s])), (frozen, f)
