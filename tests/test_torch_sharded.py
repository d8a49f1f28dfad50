"""The port's device grid (parallel/specs.py, parallel/sharded.py) against
the single device and the reference's mesh, on the CPU.

The grids are logical: every tile's device is the CPU (4 x 2, and 3 x 1
and 1 x 3 so that the item, type, slot and class axes split unevenly).
Held exactly:
- split and gather round trips, and put_args' tiles, against the tensors
  they came from;
- the gathered [N, C] verdict tensor (make_prescreen_kernel(spec_layout=),
  dispatch_prescreen over put_args' tiles) and the gathered static
  feasibility planes (ops/feasibility.feasibility_tiles) against the
  single device's, bool for bool;
- placements (flightrec-canonical bytes) of ShardedSolver against
  TorchSolver on the families of tests/test_sharded.py: the generic mix
  (seeds 3 and 11), hostname anti-affinity (seed 5), relaxation (seed 7,
  rounds too), bulk replicas, and pools over existing nodes, sequential
  and with the segmented lanes split over dp; and, on the generic mix,
  against the reference's ShardedSolver on its 8 virtual CPU devices.
Also: small batches take the single path; the grid's and the single
device's keys never collide; the prewarmed grid tier's live solve is a
compile-cache hit; a lane that fails on the grid fails or degrades as on
the single device; the factory, its start of a world (one process here;
tests/test_torch_dist.py runs several), the solver service over a grid
and the process entry with KARPENTER_SOLVER_MODE=sharded.

`test_scan_inputs_sit_on_the_lead_device` is the port's form of the
reference's `test_mesh_program_has_no_host_roundtrips`,
`test_segmented_mesh_program_fence` and
`test_single_device_program_unchanged_by_layout_plumbing`, which read the
jaxpr of a jit-compiled program the port does not have: every tensor that
enters the scan sits on the grid's lead device, the feasibility planes
and the verdict tensor came through the gather, and the single device
gathers nothing. On the CPU every logical device is the same device; the
card tests (tests/test_torch_cuda.py) hold a tile on a second card.
"""
import copy
import threading

import numpy as np
import pytest
import torch

from karpenter_core_tpu_torch.cloudprovider import fake as tfake
from karpenter_core_tpu_torch.obs.flightrec import canonical_placements, placements_json
from karpenter_core_tpu_torch.ops import feasibility as tfeas
from karpenter_core_tpu_torch.ops import pack as tpack
from karpenter_core_tpu_torch.ops.cuda_build import KernelError
from karpenter_core_tpu_torch.parallel import sharded as tsharded
from karpenter_core_tpu_torch.parallel.specs import DeviceGrid, GridCollectiveError, SpecLayout
from karpenter_core_tpu_torch.solver import factory as tfactory
from karpenter_core_tpu_torch.solver import torch_solver as tsolver
from karpenter_core_tpu_torch.solver.encode import encode_snapshot
from karpenter_core_tpu_torch.testing import make_pod, make_provisioner
from karpenter_core_tpu_torch.utils import compilecache

import tests.test_differential_fuzz as jfuzz
import tests.test_differential_fuzz_wide as jfuzz_wide
from tests.test_torch_cuda import _mods
from tests.test_torch_entry import gc_state, process_state  # noqa: F401  (fixtures)
from tests.test_torch_segmented import pool_workload
from tests.torch_suites import Mapping, cpu_substitutes

CPU = torch.device("cpu")
GRIDS = {"4x2": (4, 2), "3x1": (3, 1), "1x3": (1, 3)}
MAX_NODES = 96
# the reference's fuzz builders, executed again so that they make the
# port's objects
_PORT_SUITES = Mapping(cpu_substitutes())


def grid(shape) -> DeviceGrid:
    ndp, ntp = GRIDS[shape] if isinstance(shape, str) else shape
    return DeviceGrid.of([CPU] * (ndp * ntp), ntp)


@pytest.fixture
def mesh_always(monkeypatch):
    """Every batch clears the routing floor (the families are small)."""
    monkeypatch.setattr(tsharded, "MIN_SPLIT_REPLICAS_PER_SHARD", 0)


def _pin(pods, nodes, tag):
    for i, p in enumerate(pods):
        p.metadata.name = f"{tag}-{i}"
        p.metadata.uid = f"uid-{tag}-{i:05d}"
        p.metadata.creation_timestamp = 1000.0 + (i * 7919) % 97
    for e, n in enumerate(nodes or ()):
        n.node.metadata.uid = f"uid-{tag}-node-{e:03d}"
        n.node.metadata.creation_timestamp = 500.0 + e
    return pods, nodes


def fuzz_family(family, seed, pkg="torch"):
    """(pods, provisioners, instance types, state nodes) of one family of
    tests/test_sharded.py, built with `pkg`'s objects, names and uids
    pinned."""
    if pkg == "torch":
        fuzz = _PORT_SUITES.suite_module("tests.test_differential_fuzz")
        wide = _PORT_SUITES.suite_module("tests.test_differential_fuzz_wide")
        fake = tfake
    else:
        from karpenter_core_tpu.cloudprovider import fake
        fuzz, wide = jfuzz, jfuzz_wide
    rng = np.random.default_rng(seed)
    if family == "generic":
        pods, provs, its, nodes = fuzz._workload(rng, fake.instance_types(6))
    elif family == "anti":
        pods, provs, its, nodes = wide._g5_workload(rng)
    elif family == "relax":
        pods, provs, its, nodes = wide._g3_workload(rng)
    elif family == "bulk":
        m = _mods("torch" if pkg == "torch" else "jax")
        pods = [m.t.make_pod(labels={"app": f"dep-{i % 3}"}, requests={"cpu": "0.5"})
                for i in range(120)]
        nodes = [m.node(m.t.make_node(
            name=f"bulk-node-{e}",
            labels={"karpenter.sh/provisioner-name": "default",
                    "karpenter.sh/initialized": "true"},
            capacity={"cpu": "8", "memory": "16Gi", "pods": "50"})) for e in range(4)]
        provs, its = [m.t.make_provisioner(name="default")], {"default": fake.instance_types(6)}
    else:  # pools over existing nodes
        pods, provs, its, nodes = pool_workload(_mods(pkg), seed, n_pods=160, n_nodes=8)
    pods, nodes = _pin(pods, nodes, f"{family}{seed}")
    return pods, provs, its, nodes


def solve(solver, w):
    pods, provs, its, nodes = w
    return solver.solve(copy.deepcopy(pods), provs, its,
                        state_nodes=[n.deep_copy() for n in nodes] if nodes else None)


def canon(res) -> str:
    return placements_json(canonical_placements(res))


_SINGLE = {}


def single_solve(key, w, **kw):
    """The single device's result of one family (solved once per file)."""
    if key not in _SINGLE:
        _SINGLE[key] = solve(tsolver.TorchSolver(max_nodes=MAX_NODES, device="cpu", **kw), w)
    return _SINGLE[key]


# -- the tiles ---------------------------------------------------------------


@pytest.mark.parametrize("shape", list(GRIDS))
def test_split_gather_round_trip(shape):
    layout = SpecLayout(grid(shape))
    g = torch.Generator().manual_seed(7)
    cases = [
        (torch.rand((2, 7, 5), generator=g), layout.feasibility()),
        (torch.rand((7, 5), generator=g) > 0.5, layout.verdict()),
        (torch.rand((5, 3), generator=g), layout.type_plane()),
        (torch.rand((2, 5), generator=g), layout.type_cols()),
        (torch.rand((1, 4), generator=g), layout.slot_plane()),
        (torch.rand((0, 4), generator=g), layout.verdict()),
        (torch.rand((3,), generator=g), layout.replicated()),
    ]
    for x, spec in cases:
        tiles = layout.split(x, spec)
        assert len(tiles) == layout.ndp and all(len(r) == layout.ntp for r in tiles)
        got = layout.gather(tiles, spec)
        assert got.dtype == x.dtype and torch.equal(got, x), spec
    tiles = layout.split({"a": torch.arange(10).reshape(5, 2)}, layout.slot_plane())
    assert sum(t["a"].shape[0] for t in (r[0] for r in tiles)) == 5


def _snapshot(w, max_nodes=MAX_NODES):
    pods, provs, its, nodes = w
    snap = encode_snapshot(pods, provs, its, state_nodes=nodes, max_nodes=max_nodes)
    geom = tsolver.solve_geometry(snap, max_nodes)
    return snap, geom, tsolver.device_args(snap, provs)


@pytest.mark.parametrize("shape", list(GRIDS))
def test_put_args_follow_the_upload_rule(shape):
    layout = SpecLayout(grid(shape))
    _snap, _geom, args = _snapshot(fuzz_family("generic", 3))
    placed = layout.put_args(tsolver.RUN_ARG_NAMES, args)
    whole = tsolver.args_to_torch(args, CPU)
    for name, a, b in zip(tsolver.RUN_ARG_NAMES, placed, whole):
        pairs = a.items() if isinstance(a, dict) else [(None, a)]
        for k, t in pairs:
            want = b[k] if k is not None else b
            assert torch.equal(t, want), (name, k)
            spec = layout.arg_sharding(name, t)
            pre = placed.tiles.get(name)
            pre = pre.get(k) if isinstance(pre, dict) else pre
            if not spec:
                assert pre is None, (name, k)
                continue
            # a split family's axis divides its grid axis, or it replicates
            axis = 0 if spec[0] is not None else t.dim() - 1
            parts = layout.ndp if spec[axis] == "dp" else layout.ntp
            assert t.shape[axis] % parts == 0
            assert pre[0] == spec and torch.equal(layout.gather(pre[1], spec), t), (name, k)
    assert layout.arg_sharding("pod_arrays", np.zeros((8, 3))) == ()


@pytest.mark.parametrize("shape", list(GRIDS))
@pytest.mark.parametrize("family", ["generic", "pools"])
def test_gathered_tiles_equal_the_single_device(shape, family):
    layout = SpecLayout(grid(shape))
    _snap, geom, args = _snapshot(fuzz_family(family, 3))
    targs = tsolver.args_to_torch(args, CPU)
    N, segs, zone_seg, ct_seg, screen_v = geom[7], geom[8], geom[9], geom[10], geom[16]
    single = tpack.make_prescreen_kernel(segs, N, screen_v=screen_v)(targs[0], targs[9])
    tiled = tpack.make_prescreen_kernel(segs, N, screen_v=screen_v,
                                        spec_layout=layout)(targs[0], targs[9])
    assert tiled.dtype == torch.bool and torch.equal(tiled, single)
    assert len(tpack.LAST_TILES) == layout.ndp * layout.ntp
    placed = layout.put_args(tsolver.RUN_ARG_NAMES, args)
    via_put = tsolver.dispatch_prescreen(segs, screen_v, N, args, placed,
                                         spec_layout=layout)[0]
    assert torch.equal(via_put, single)

    named = dict(zip(tsolver.RUN_ARG_NAMES, targs))
    pods = named["pod_arrays"]
    feas = ({k: pods[k] for k in ("allow", "out", "defined", "escape")}, named["tmpl"],
            named["types"], pods["tol_tmpl"], named["tmpl_type_mask"],
            named["type_offering_ok"], zone_seg, ct_seg, segs, named["well_known"])
    want = tfeas.feasibility_static(*feas)
    for src in (None, placed):
        got = tfeas.feasibility_tiles(layout, *feas, targs=src)
        assert got.dtype == torch.bool and torch.equal(got, want)


# -- placements --------------------------------------------------------------

FAMILIES = [("generic", 3), ("generic", 11), ("anti", 5), ("relax", 7), ("bulk", 0),
            ("pools", 3)]


@pytest.mark.parametrize("shape", list(GRIDS))
@pytest.mark.parametrize("family,seed", FAMILIES, ids=[f"{f}-{s}" for f, s in FAMILIES])
def test_placements_byte_identical(mesh_always, shape, family, seed):
    w = fuzz_family(family, seed)
    want = single_solve((family, seed), w)
    solver = tsharded.ShardedSolver(grid(shape), max_nodes=MAX_NODES)
    got = solve(solver, w)
    assert solver.last_path == "mesh" and solver.last_spec_layout.key == (
        "grid",) + GRIDS[shape]
    assert canon(got) == canon(want)
    assert got.rounds == want.rounds
    if family == "bulk":
        assert got.pod_count_existing() > 0


@pytest.mark.parametrize("shape", ["4x2", "3x1"])
def test_segmented_lanes_split_over_dp(mesh_always, shape):
    """The pools' lanes under the grid (run one after another on the lead
    device, where the reference splits them over dp) merge to the single
    device's segmented and sequential placements."""
    w = fuzz_family("pools", 13)
    seq = single_solve(("pools", 13), w)
    seg = single_solve(("pools", 13, "segmented"), w, pack_scan="segmented")
    solver = tsharded.ShardedSolver(grid(shape), max_nodes=MAX_NODES, pack_scan="segmented")
    got = solve(solver, w)
    st = solver.last_segment_stats
    assert solver.last_path == "mesh"
    assert st["mode"] == "segmented" and st["segments"] == 4 and st["fixup_fraction"] == 0.0
    assert st["lanes"] > 1
    assert canon(got) == canon(seg) == canon(seq)


def test_matches_the_reference_sharded_solver(mesh_always, monkeypatch):
    """The generic mix on the port's 4 x 2 grid and on the reference's
    ShardedSolver over its 8 virtual CPU devices, placements byte for
    byte."""
    import jax
    from jax.sharding import Mesh
    from karpenter_core_tpu.obs import flightrec as jrec
    from karpenter_core_tpu.parallel import sharded as jsharded

    monkeypatch.setattr(jsharded, "MIN_SPLIT_REPLICAS_PER_SHARD", 0)
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("dp", "tp"))
    jw = fuzz_family("generic", 3, pkg="jax")
    jsolver = jsharded.ShardedSolver(jmesh, max_nodes=MAX_NODES)
    jres = solve(jsolver, jw)
    assert jsolver.last_path == "mesh"
    tsolver_ = tsharded.ShardedSolver(grid("4x2"), max_nodes=MAX_NODES)
    tres = solve(tsolver_, fuzz_family("generic", 3))
    assert tsolver_.last_path == "mesh"
    assert canon(tres) == jrec.placements_json(jrec.canonical_placements(jres))


# -- routing, keys, the fence --------------------------------------------------


def _pods(n, tag, apps=4):
    return [make_pod(name=f"{tag}-{i}", labels={"app": f"{tag}{i % apps}"},
                     requests={"cpu": "0.5"}) for i in range(n)]


def test_small_batch_routes_single():
    solver = tsharded.ShardedSolver(grid("4x2"), max_nodes=32)
    res = solver.solve(_pods(6, "s"), [make_provisioner(name="default")],
                       {"default": tfake.instance_types(4)})
    assert solver.last_path == "single" and solver.last_spec_layout is None
    assert res.pod_count_new() == 6
    assert all(key[-1] is None for key in solver._warm_keys)
    assert not tsharded.route_to_mesh(6, 4)
    assert tsharded.route_to_mesh(4 * tsharded.MIN_SPLIT_REPLICAS_PER_SHARD, 4)
    assert tsharded.route_to_mesh(256, 64)


def test_mesh_and_single_keys_never_collide(monkeypatch):
    solver = tsharded.ShardedSolver(grid("4x2"), max_nodes=32)
    provs, its = [make_provisioner(name="default")], {"default": tfake.instance_types(4)}
    pods = _pods(40, "k")
    monkeypatch.setattr(tsharded, "MIN_SPLIT_REPLICAS_PER_SHARD", 0)
    a = solver.solve(copy.deepcopy(pods), provs, its)
    assert solver.last_path == "mesh"
    monkeypatch.setattr(tsharded, "MIN_SPLIT_REPLICAS_PER_SHARD", 10_000)
    b = solver.solve(copy.deepcopy(pods), provs, its)
    assert solver.last_path == "single"
    assert canon(a) == canon(b)
    keys = list(solver._warm_keys)
    mesh_keys = [k for k in keys if k[-1] is not None]
    single_keys = [k for k in keys if k[-1] is None]
    assert len(keys) == 2 and len(mesh_keys) == 1 and len(single_keys) == 1
    assert mesh_keys[0][-1] == ("grid", 4, 2)
    assert mesh_keys[0][:-1] == single_keys[0][:-1]
    # the resident verdict tensors: one per path
    assert sorted(k[-1] is None for k in solver._inc_screens) == [False, True]


@pytest.mark.parametrize("pack_scan", ["sequential", "segmented"])
def test_scan_inputs_sit_on_the_lead_device(mesh_always, monkeypatch, pack_scan):
    layout_devices = grid("4x2")
    gathered, seen = [], []
    real_gather = SpecLayout.gather

    def gather(self, tiles, spec, *a, **kw):
        out = real_gather(self, tiles, spec, *a, **kw)
        gathered.append((spec, out))
        return out

    real_kernel = tsolver.make_pack_kernel

    def make_pack_kernel(*a, **kw):
        pack = real_kernel(*a, **kw)

        def spy(state, item_arrays, f_static, openable, *rest, **kws):
            tensors = [f_static, openable, *state, *rest, *kws.values()]
            tensors += list(item_arrays.values())
            for t in tensors:
                for v in (t.values() if isinstance(t, dict) else [t]):
                    if isinstance(v, torch.Tensor):
                        seen.append(v.device)
            seen.append(("f_static", any(f_static is g or f_static._base is g
                                         for _s, g in gathered)))
            return pack(state, item_arrays, f_static, openable, *rest, **kws)

        return spy

    monkeypatch.setattr(SpecLayout, "gather", gather)
    monkeypatch.setattr(tsolver, "make_pack_kernel", make_pack_kernel)
    w = fuzz_family("pools", 3)
    solve(tsolver.TorchSolver(max_nodes=MAX_NODES, device="cpu", pack_scan=pack_scan), w)
    assert gathered == [] and seen  # the single device gathers nothing
    seen.clear()
    solver = tsharded.ShardedSolver(layout_devices, max_nodes=MAX_NODES, pack_scan=pack_scan)
    solve(solver, w)
    layout = solver.last_spec_layout
    specs = [s for s, _g in gathered]
    assert layout.feasibility() in specs and layout.verdict() in specs
    assert {d for d in seen if isinstance(d, torch.device)} == {layout.lead}
    flags = [d for d in seen if isinstance(d, tuple)]
    # the sequential scan reads the gathered planes themselves; a lane
    # reads its item rows of them (an index copy, on its dp row's device)
    assert flags and (pack_scan == "segmented" or all(ok for _name, ok in flags))


def test_prewarmed_mesh_tier_live_solve_hits(mesh_always):
    """The counterpart of the reference's
    test_sharded_prewarm_aot_hits_live_solve: the prewarm of a tier that
    routes to the grid keys it under the grid's key, and the live solve at
    that geometry is a compile-cache hit."""
    solver = tsharded.ShardedSolver(grid("4x2"), max_nodes=32)
    provs, its = [make_provisioner(name="default")], {"default": tfake.instance_types(4)}
    pods = _pods(40, "w")
    snap = solver.encode(copy.deepcopy(pods), provs, its)
    site = {"site": "tpu_solver"}
    assert solver.prewarm_snapshot(snap, provs) == "compiled"
    keys = list(solver._warm_keys)
    assert len(keys) == 1 and keys[0][-1] == ("grid", 4, 2)
    hits, misses = compilecache.CACHE_HITS.get(site), compilecache.CACHE_MISSES.get(site)
    res = solver.solve(copy.deepcopy(pods), provs, its)
    assert solver.last_path == "mesh" and len(solver._warm_keys) == 1
    assert compilecache.CACHE_HITS.get(site) == hits + 1
    assert compilecache.CACHE_MISSES.get(site) == misses
    assert res.pod_count_new() == 40


@pytest.mark.parametrize("error", [RuntimeError, KernelError, GridCollectiveError])
def test_a_failed_lane_on_the_grid(mesh_always, monkeypatch, error):
    """As on the single device: a lane's KernelError fails the solve, and
    any other error degrades to the sequential scan over the grid, placed
    as the single device places; but a failed collective of a grid over
    processes fails the solve (the other ranks did not take this path)."""
    real = tsolver.make_device_run

    def make_device_run(*a, **kw):
        run = real(*a, **kw)
        if not kw.get("segment_mode"):
            return run

        def broken(*ra, **rk):
            raise error("injected")

        return broken

    monkeypatch.setattr(tsolver, "make_device_run", make_device_run)
    w = fuzz_family("pools", 7)
    solver = tsharded.ShardedSolver(grid("4x2"), max_nodes=MAX_NODES, pack_scan="segmented")
    if error is not RuntimeError:
        with pytest.raises(error):
            solve(solver, w)
        return
    got = solve(solver, w)
    assert solver.last_path == "mesh"
    assert solver.last_segment_stats["mode"] == "sequential-fallback"
    assert canon(got) == canon(single_solve(("pools", 7), w))


# -- the factory, the service, the entry --------------------------------------


def test_factory_builds_the_grid(monkeypatch):
    for k in ("KARPENTER_MESH_TP", "KARPENTER_MESH_LOGICAL_DEVICES", "KARPENTER_SOLVER_MODE"):
        monkeypatch.delenv(k, raising=False)
    cpus = lambda n: [CPU] * n  # noqa: E731
    assert tfactory.detect_mesh(devices=cpus(1)) is None
    assert tfactory.detect_mesh(devices=cpus(8)).shape == {"dp": 4, "tp": 2}
    assert tfactory.detect_mesh(devices=cpus(3)).shape == {"dp": 3, "tp": 1}
    assert tfactory.detect_mesh(devices=cpus(6)).shape == {"dp": 3, "tp": 2}
    assert tfactory.detect_mesh(devices=cpus(4), tp=4).shape == {"dp": 1, "tp": 4}
    with pytest.raises(ValueError):
        tfactory.detect_mesh(devices=cpus(8), tp=3)
    monkeypatch.setenv("KARPENTER_MESH_TP", "4")
    assert tfactory.detect_mesh(devices=cpus(8)).shape == {"dp": 2, "tp": 4}
    monkeypatch.delenv("KARPENTER_MESH_TP")
    assert tfactory.visible_devices("cpu") == [CPU]
    assert tfactory.detect_mesh(device="cpu") is None
    monkeypatch.setenv("KARPENTER_MESH_LOGICAL_DEVICES", "4")
    assert tfactory.visible_devices("cpu") == cpus(4)
    assert tfactory.detect_mesh(device="cpu").shape == {"dp": 2, "tp": 2}
    auto = tfactory.build_solver(max_nodes=64, device="cpu")
    assert isinstance(auto, tsharded.ShardedSolver) and auto.max_nodes == 64
    assert tfactory.describe(auto) == "ShardedSolver(dp=2, tp=2)"
    assert auto.device == CPU and auto.supports_batched_replan
    monkeypatch.delenv("KARPENTER_MESH_LOGICAL_DEVICES")
    with pytest.raises(RuntimeError, match="only one device"):
        tfactory.build_solver(mode="sharded", device="cpu")
    monkeypatch.setenv("KARPENTER_SOLVER_MODE", "single")
    single = tfactory.build_solver(devices=cpus(8), device="cpu")
    assert type(single) is tsolver.TorchSolver
    monkeypatch.delenv("KARPENTER_SOLVER_MODE")
    sharded = tfactory.build_solver(mode="sharded", devices=cpus(3), device="cpu",
                                    pack_scan="segmented")
    assert sharded.mesh.shape == {"dp": 3, "tp": 1} and sharded.pack_scan == "segmented"


def test_ensure_distributed(monkeypatch):
    """No coordinator: a no-op. A coordinator without
    KARPENTER_DIST_NUM_PROCESSES or _PROCESS_ID: KeyError naming it.
    KARPENTER_DIST_COORDINATOR=host:port with a world of one process
    starts the default (gloo) group, idempotently; detection then lays the
    grid over this rank's devices alone, and the service and the entry,
    which take requests in one process, refuse to start under the
    coordinator. tests/test_torch_dist.py runs worlds of 2-4 processes."""
    import socket

    import torch.distributed as dist

    from karpenter_core_tpu_torch.solver.service import SolverService

    for k in ("KARPENTER_DIST_COORDINATOR", "KARPENTER_MESH_LOGICAL_DEVICES",
              "KARPENTER_DIST_NUM_PROCESSES", "KARPENTER_DIST_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert tfactory.ensure_distributed() is False and not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("KARPENTER_DIST_COORDINATOR", f"127.0.0.1:{port}")
    with pytest.raises(KeyError, match="KARPENTER_DIST_NUM_PROCESSES"):
        tfactory.ensure_distributed()
    monkeypatch.setenv("KARPENTER_DIST_NUM_PROCESSES", "1")
    with pytest.raises(KeyError, match="KARPENTER_DIST_PROCESS_ID"):
        tfactory.ensure_distributed()
    monkeypatch.setenv("KARPENTER_DIST_PROCESS_ID", "0")
    monkeypatch.setenv("KARPENTER_MESH_LOGICAL_DEVICES", "2")
    try:
        assert tfactory.ensure_distributed() is True and dist.is_initialized()
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert tfactory.ensure_distributed() is True
        mesh = tfactory.detect_mesh(device="cpu")
        assert mesh.shape == {"dp": 2, "tp": 1} and not mesh.spans_processes
        with pytest.raises(RuntimeError, match="one process"):
            SolverService(device="cpu", mesh=mesh)
        with pytest.raises(RuntimeError, match="one process"):
            tfactory.build_primary(device="cpu")
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


def test_service_serves_the_grid(monkeypatch):
    """serve(mesh=grid) with RemoteSolver: byte-identical to the single
    device, twice (the second solve refreshes the grid's resident tensor),
    at the service_sharded compile-cache site; Health names the grid."""
    from karpenter_core_tpu_torch.solver.service import RemoteSolver, serve

    monkeypatch.setattr(tsharded, "MIN_SPLIT_REPLICAS_PER_SHARD", 0)
    server, port, service = serve(mesh=grid((2, 2)), device="cpu")
    try:
        client = RemoteSolver(f"127.0.0.1:{port}", max_nodes=MAX_NODES)
        assert client.health().device == "cpu x4(dp=2,tp=2)"
        w = fuzz_family("generic", 11)
        want = canon(single_solve(("generic", 11), w))
        site = {"site": "service_sharded"}
        misses = compilecache.CACHE_MISSES.get(site)
        hits = compilecache.CACHE_HITS.get(site)
        assert canon(solve(client, w)) == want
        assert canon(solve(client, w)) == want
        assert service.solves == 2 and service.last_prescreen_mode == "refresh"
        assert compilecache.CACHE_MISSES.get(site) == misses + 1
        assert compilecache.CACHE_HITS.get(site) == hits + 1
        assert all(k[-1] == ("grid", 2, 2) for k in service._compiled)
        client.close()
    finally:
        server.stop(0)


def test_entry_starts_sharded(monkeypatch, process_state):
    """python -m karpenter_core_tpu_torch.operator with
    KARPENTER_SOLVER_MODE=sharded starts over the grid: the in-process
    primary is a ShardedSolver over the logical devices."""
    from karpenter_core_tpu_torch.operator import __main__ as entry
    from karpenter_core_tpu_torch.operator.options import parse_options

    monkeypatch.setenv("KARPENTER_SOLVER_MODE", "sharded")
    monkeypatch.setenv("KARPENTER_MESH_LOGICAL_DEVICES", "4")
    monkeypatch.setenv("KARPENTER_SOLVER_HOST", "0")
    stop = threading.Event()
    stop.set()
    operator = entry.run(tfake.FakeCloudProvider(), stop_event=stop, device="cpu",
                         options=parse_options(["--metrics-port", "0", "--disable-webhook",
                                                "--no-leader-elect"]))
    primary = operator.provisioning.fallback_solver.primary
    assert isinstance(primary, tsharded.ShardedSolver)
    assert primary.mesh.shape == {"dp": 2, "tp": 2}


def test_host_child_serves_the_grid(monkeypatch):
    """The solver host's child builds its service over detect_mesh() under
    KARPENTER_SOLVER_MODE: its solve takes the grid (a miss at the
    service_sharded site of its compile-cache series) and is
    byte-identical to the single device's."""
    from karpenter_core_tpu_torch.solver.host import HostSolver

    w = fuzz_family("bulk", 0)
    want = canon(single_solve(("bulk", 0), w))
    host = HostSolver(max_nodes=MAX_NODES, device="cpu",
                      child_env={"KARPENTER_SOLVER_MODE": "sharded",
                                 "KARPENTER_MESH_LOGICAL_DEVICES": "4"})
    try:
        assert host.health()["status"] == "ok"
        assert canon(solve(host, w)) == want
        assert host.host.stats()["compile_cache_misses"] == {"service_sharded": 1}
    finally:
        host.close()
