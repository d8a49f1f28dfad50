"""The device grid over processes (parallel/specs.world_grid), on the CPU.

Every rank is a process of its own, started through the production switch
KARPENTER_DIST_COORDINATOR (host:port on a free localhost port, with
_NUM_PROCESSES and _PROCESS_ID; `auto` with the launcher's env://
variables for one grid), its collectives over gloo. The worlds:

  2x1   2 ranks x 1 device (auto: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)
  2x2   2 ranks x 2 logical devices: a dp row per rank
  4r    4 ranks x 1 device: a 2 x 2 grid whose tp pairs cross ranks
  3x1   3 ranks x 1 device: rows that do not divide (uneven tiles)

On each, every rank solves the families mixed, cluster, spread, anti and
refmix of tests/test_torch_cuda.workload through
build_solver(mode="sharded") with every batch routed to the grid, and
gathers the static feasibility planes (feasibility_tiles) and the [N, C]
verdict tensor (make_prescreen_kernel(spec_layout=)) of its snapshot.
Held exactly: each rank's gathered tensors against the single device's;
each rank's placements (flightrec-canonical bytes) against every other
rank's, against TorchSolver(device="cpu") and against the reference's
TPUSolver; and selector-scoped pools over existing nodes through the
segmented scan, cold then refreshed, against TorchSolver's. Also: a rank
forced onto another path (its batch routed off the grid) makes the other
raise RuntimeError within the shortened group timeout; the solver
service, the solver host's child and the process entry refuse a grid over
processes; ranks with unequal device counts raise.

    python -m tests.test_torch_dist <spec json>

is one rank (the tests start it).
"""
import copy
import datetime
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from karpenter_core_tpu_torch.obs.flightrec import canonical_placements, placements_json
from karpenter_core_tpu_torch.ops import feasibility as tfeas
from karpenter_core_tpu_torch.ops import pack as tpack
from karpenter_core_tpu_torch.solver import torch_solver as tsolver
from karpenter_core_tpu_torch.solver.encode import encode_snapshot

from tests.test_torch_cuda import workload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("mixed", "cluster", "spread", "anti", "refmix")
# world -> (ranks, logical devices per rank or 0, the coordinator's form,
# the grid's shape)
WORLDS = {
    "2x1": (2, 0, "auto", {"dp": 2, "tp": 1}),
    "2x2": (2, 2, "host", {"dp": 2, "tp": 2}),
    "4r": (4, 0, "host", {"dp": 2, "tp": 2}),
    "3x1": (3, 0, "host", {"dp": 3, "tp": 1}),
}
# the group's timeout in the ranks, shortened from DIST_TIMEOUT
TIMEOUT_S = 20.0
RUN_TIMEOUT_S = 180.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _solve_args(w):
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = w
    return (copy.deepcopy(pods), provs, its), dict(
        daemonset_pods=daemons, state_nodes=[n.deep_copy() for n in nodes] if nodes else None,
        kube_client=client, cluster=cluster)


def canon(res) -> str:
    return placements_json(canonical_placements(res))


def precomputes(w, layout=None):
    """The static feasibility planes and the [N, C] verdict tensor of the
    family's snapshot: on `layout`'s grid (gathered) or on the CPU."""
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = w
    snap = encode_snapshot(pods, provs, its, daemons, nodes, client, cluster,
                           max_nodes=max_nodes)
    geom = tsolver.solve_geometry(snap, max_nodes)
    N, segs, zone_seg, ct_seg, screen_v = geom[7], geom[8], geom[9], geom[10], geom[16]
    targs = tsolver.args_to_torch(tsolver.device_args(snap, provs), "cpu")
    named = dict(zip(tsolver.RUN_ARG_NAMES, targs))
    pa = named["pod_arrays"]
    feas = ({k: pa[k] for k in ("allow", "out", "defined", "escape")}, named["tmpl"],
            named["types"], pa["tol_tmpl"], named["tmpl_type_mask"],
            named["type_offering_ok"], zone_seg, ct_seg, segs, named["well_known"])
    prescreen = tpack.make_prescreen_kernel(segs, N, screen_v=screen_v, spec_layout=layout)
    if layout is None:
        return tfeas.feasibility_static(*feas), prescreen(targs[0], targs[9])
    return tfeas.feasibility_tiles(layout, *feas), prescreen(targs[0], targs[9])


def pools(seed: int = 3, n_pods: int = 160, n_nodes: int = 8):
    """Selector-scoped pools over existing nodes (tests/test_segmented.py's
    partition): a batch the segmented scan splits into lanes."""
    from karpenter_core_tpu_torch import testing as tt
    from karpenter_core_tpu_torch.cloudprovider import fake as tfake
    from karpenter_core_tpu_torch.state.node import StateNode

    rng = np.random.default_rng(seed)
    universe = tfake.instance_types(6)
    provs, its = tt.make_pool_provisioners(4, universe)
    nodes = [StateNode(node=tt.make_node(
        name=f"pool-node-{e}",
        labels={"karpenter.sh/provisioner-name": f"pool-{e % 4}",
                "karpenter.sh/initialized": "true",
                "node.kubernetes.io/instance-type": universe[e % 6].name,
                "karpenter.sh/capacity-type": "on-demand",
                "topology.kubernetes.io/zone": "test-zone-1", "team": f"pool-{e % 4}"},
        capacity={k: str(v) for k, v in universe[e % 6].capacity.items()}))
        for e in range(n_nodes)]
    pods = []
    for i in range(n_pods):
        p = int(rng.integers(4))
        app = f"dep-{p}-{int(rng.integers(8))}"
        pod = tt.make_pod(name=f"pool-pod-{i}", labels={"app": app},
                          requests={"cpu": str(0.25 + 0.25 * int(rng.integers(3)))},
                          node_selector={"team": f"pool-{p}"})
        pod.metadata.uid = f"uid-pool-{i:05d}"
        pods.append(pod)
    return pods, provs, its, None, nodes, 96, None, None


def digest(t: torch.Tensor) -> str:
    a = t.cpu().numpy()
    return hashlib.sha256(repr((a.shape, str(a.dtype))).encode() + a.tobytes()).hexdigest()


# -- one rank ------------------------------------------------------------------


def rank_main(spec: dict) -> dict:
    """One rank of a world: start it through KARPENTER_DIST_* (the
    environment the test set), detect the grid, and run `spec["role"]`."""
    from karpenter_core_tpu_torch.parallel import sharded as tsharded
    from karpenter_core_tpu_torch.parallel.specs import SpecLayout
    from karpenter_core_tpu_torch.solver import factory

    factory.DIST_TIMEOUT = datetime.timedelta(seconds=spec["timeout_s"])
    torch.set_num_threads(1)
    tsharded.MIN_SPLIT_REPLICAS_PER_SHARD = 0
    out = {}
    grid = factory.detect_mesh(device="cpu")
    out["grid"] = {"shape": grid.shape, "ranks": [list(r) for r in grid.ranks],
                   "rank": grid.rank, "backend": grid.backend, "world": grid.world,
                   "lead": str(grid.lead), "distinct": [str(d) for d in grid.distinct()]}
    role = spec["role"]
    if role == "families":
        for family in spec["families"]:
            w = workload(family, "torch")
            f_static, verdict = precomputes(w, SpecLayout(grid))
            solver = factory.build_solver(max_nodes=w[5], mode="sharded", device="cpu")
            a, kw = _solve_args(w)
            res = solver.solve(*a, **kw)
            out[family] = {"f_static": digest(f_static), "verdict": digest(verdict),
                           "placements": canon(res), "path": solver.last_path,
                           "tiles": [list(t[:3]) for t in tpack.LAST_TILES]}
        # the segmented lanes over the grid: twice on one solver (the
        # second refreshes the resident tensor and reuses the partition)
        w = pools()
        solver = factory.build_solver(max_nodes=w[5], mode="sharded", device="cpu",
                                      pack_scan="segmented")
        out["segmented"] = []
        for _turn in range(2):
            a, kw = _solve_args(w)
            res = solver.solve(*a, **kw)
            out["segmented"].append({"placements": canon(res), "path": solver.last_path,
                                     "stats": solver.last_segment_stats,
                                     "prescreen": solver.last_prescreen_mode})
        from karpenter_core_tpu_torch.solver.service import SolverService

        for what, build in (("service", lambda: SolverService(device="cpu", mesh=grid)),
                            ("entry", lambda: factory.build_primary(device="cpu"))):
            try:
                build()
                out[what] = "started"
            except RuntimeError as exc:
                out[what] = f"RuntimeError: {exc}"
    elif role == "diverge":
        w = workload("mixed", "torch")
        if grid.rank == 1:
            # this rank's batches stay off the grid: it never joins the
            # collectives the other rank's solve makes
            tsharded.MIN_SPLIT_REPLICAS_PER_SHARD = 10 ** 9
        solver = factory.build_solver(max_nodes=w[5], mode="sharded", device="cpu")
        a, kw = _solve_args(w)
        t0 = time.monotonic()
        try:
            res = solver.solve(*a, **kw)
            out["outcome"] = "solved"
            out["path"] = solver.last_path
            out["placements"] = canon(res)
        except RuntimeError as exc:
            out["outcome"] = f"RuntimeError: {exc}"
        out["seconds"] = time.monotonic() - t0
        if grid.rank == 1:
            # stay in the world past the other rank's timeout, so that it
            # waits for the collective rather than seeing this rank leave
            time.sleep(spec["timeout_s"] * 1.5)
    return out


def run_world(name: str, role: str, families=FAMILIES, timeout_s: float = TIMEOUT_S,
              counts=None) -> list:
    """Start a world's ranks (WORLDS[name]) on a free port and return each
    rank's result, in rank order; a rank that exits non-zero or outlives
    RUN_TIMEOUT_S fails the test. `counts` gives each rank its own logical
    device count."""
    ranks, logical, form, _shape = WORLDS[name]
    port = _free_port()
    spec = json.dumps({"role": role, "families": list(families), "timeout_s": timeout_s})
    procs = []
    for r in range(ranks):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("KARPENTER_DIST_", "KARPENTER_MESH_", "MASTER_"))}
        env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
        n_logical = counts[r] if counts else logical
        if n_logical:
            env["KARPENTER_MESH_LOGICAL_DEVICES"] = str(n_logical)
        if form == "auto":
            env.update(KARPENTER_DIST_COORDINATOR="auto", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE=str(ranks), RANK=str(r))
        else:
            env.update(KARPENTER_DIST_COORDINATOR=f"127.0.0.1:{port}",
                       KARPENTER_DIST_NUM_PROCESSES=str(ranks),
                       KARPENTER_DIST_PROCESS_ID=str(r))
        procs.append(subprocess.Popen([sys.executable, "-m", "tests.test_torch_dist", spec],
                                      cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    deadline = time.monotonic() + RUN_TIMEOUT_S
    try:
        for r, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            lines = [ln for ln in stdout.splitlines() if ln.startswith("RANK ")]
            outs.append((p.returncode, json.loads(lines[-1][5:]) if lines else None,
                         stderr[-4000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


# -- the worlds ----------------------------------------------------------------

_RUNS = {}


def world(name: str) -> list:
    """Each rank's results of the families on world `name` (run once)."""
    if name not in _RUNS:
        outs = run_world(name, "families")
        for r, (rc, res, err) in enumerate(outs):
            assert rc == 0 and res is not None, f"{name} rank {r}: rc {rc}\n{err}"
        _RUNS[name] = [res for _rc, res, _err in outs]
    return _RUNS[name]


_SINGLE = {}


def single(family: str) -> dict:
    """The single device's tensors and placements of one family."""
    if family not in _SINGLE:
        w = workload(family, "torch")
        f_static, verdict = precomputes(w)
        a, kw = _solve_args(w)
        res = tsolver.TorchSolver(max_nodes=w[5], device="cpu").solve(*a, **kw)
        _SINGLE[family] = {"f_static": digest(f_static), "verdict": digest(verdict),
                           "placements": canon(res)}
    return _SINGLE[family]


@pytest.mark.parametrize("name", list(WORLDS))
def test_world_lays_the_grid_over_every_rank(name):
    ranks, logical, _form, shape = WORLDS[name]
    results = world(name)
    per = max(logical, 1)
    for r, res in enumerate(results):
        g = res["grid"]
        assert g["shape"] == shape and g["rank"] == r and g["world"] == ranks
        assert g["backend"] == "gloo" and g["lead"] == "cpu" and g["distinct"] == ["cpu"]
        flat = [x for row in g["ranks"] for x in row]
        # rank order, then local order
        assert flat == [q for q in range(ranks) for _ in range(per)]
        # the service and the entry take requests in one process
        assert res["service"].startswith("RuntimeError") and "one process" in res["service"]
        assert res["entry"].startswith("RuntimeError") and "one process" in res["entry"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", list(WORLDS))
def test_gathered_tensors_equal_the_single_device(name, family):
    want = single(family)
    for r, res in enumerate(world(name)):
        got = res[family]
        assert got["f_static"] == want["f_static"], (name, r, "f_static")
        assert got["verdict"] == want["verdict"], (name, r, "verdict")
        # each rank screened its own cells' tiles only
        assert {t[2] for t in got["tiles"]} == {r}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", list(WORLDS))
def test_placements_byte_identical_across_ranks(name, family):
    want = single(family)["placements"]
    for r, res in enumerate(world(name)):
        assert res[family]["path"] == "mesh", (name, r)
        assert res[family]["placements"] == want, (name, r)


@pytest.mark.parametrize("name", list(WORLDS))
def test_segmented_lanes_byte_identical_across_ranks(name):
    """Pools over existing nodes through the segmented scan on the grid,
    cold then refreshed: the lanes run on every rank's lead after the
    feasibility tiles' collective, placed as the single device places."""
    w = pools()
    a, kw = _solve_args(w)
    want = canon(tsolver.TorchSolver(max_nodes=w[5], device="cpu",
                                     pack_scan="segmented").solve(*a, **kw))
    for r, res in enumerate(world(name)):
        for turn, got in enumerate(res["segmented"]):
            assert got["path"] == "mesh" and got["stats"]["mode"] == "segmented", (r, turn)
            assert got["placements"] == want, (name, r, turn)
        assert [g["prescreen"] for g in res["segmented"]] == ["full", "refresh"]


@pytest.mark.parametrize("family", FAMILIES)
def test_single_device_matches_reference(family):
    """The placements every rank reproduces are the reference's."""
    from karpenter_core_tpu.obs.flightrec import canonical_placements as jcanon
    from karpenter_core_tpu.obs.flightrec import placements_json as jjson
    from karpenter_core_tpu.solver import tpu_solver as jsolver

    jp, jprov, jits, jds, jnodes, max_nodes, jkc, jcl = workload(family, "jax")
    want = jsolver.TPUSolver(max_nodes=max_nodes, backend="mxu", incremental="off").solve(
        jp, jprov, jits, daemonset_pods=jds, state_nodes=jnodes, kube_client=jkc, cluster=jcl)
    assert single(family)["placements"] == jjson(jcanon(want))


def test_a_rank_on_another_path_raises_within_the_timeout():
    """Rank 1's batch routes off the grid (no collective); rank 0's meets
    the grid's gathers alone and raises RuntimeError at the group's
    timeout, never hanging, never falling back."""
    timeout_s = 4.0
    outs = run_world("2x1", "diverge", timeout_s=timeout_s)
    (rc0, r0, err0), (rc1, r1, err1) = outs
    assert rc0 == 0 and rc1 == 0, (err0, err1)
    assert r1["outcome"] == "solved" and r1["path"] == "single"
    assert r0["outcome"].startswith("RuntimeError") and "grid gather" in r0["outcome"]
    assert r0["seconds"] < timeout_s + 10.0


def test_host_child_refuses_a_grid_over_processes():
    """The solver host's child takes its requests in one process: started
    under KARPENTER_DIST_COORDINATOR it fails before its ready frame, with
    the reason in the error, rather than wait for ranks that never call
    it."""
    from karpenter_core_tpu_torch.solver.host import HostSolver
    from karpenter_core_tpu_torch.solver.service import SolverUnavailableError

    hs = HostSolver(max_nodes=32, device="cpu", spawn_timeout=60.0, child_env={
        "KARPENTER_DIST_COORDINATOR": "127.0.0.1:1", "KARPENTER_DIST_NUM_PROCESSES": "2",
        "KARPENTER_DIST_PROCESS_ID": "0", "KARPENTER_SOLVER_MODE": "sharded"})
    try:
        with pytest.raises(SolverUnavailableError, match="one process"):
            hs.health(timeout=60.0)
        assert not hs.host.alive()
    finally:
        hs.close()


def test_unequal_device_counts_raise():
    outs = run_world("2x1", "families", families=(), counts=[1, 2])
    for rc, res, err in outs:
        assert rc != 0 and res is None
        assert "unequal" in err


if __name__ == "__main__":
    result = rank_main(json.loads(sys.argv[1]))
    print("RANK " + json.dumps(result), flush=True)
    sys.stdout.flush()
    sys.stderr.flush()
    # leave without tearing the process group down: a rank whose peer has
    # gone would wait on the barrier of the teardown
    os._exit(0)
