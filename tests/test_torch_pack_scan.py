"""The pack scan as one device program (ops/pack_scan.py, the kernel's
logic in csrc/pack_scan_body.h) on the CPU.

The kernel runs only on a card; its CPU build (csrc/pack_scan_host.cpp:
the same scan body with the block primitives as serial loops, built with
g++ into csrc/build/) is held here against the reference's jitted solve
program, fed the SAME device_args arrays and prescreen tensor (moved with
args_to_torch): the commit log, ptr and every PackState field (the
topology groups' counts included) must be equal, floats bit for bit, on
every parity family, topology groups or none, with the log cut until it
overflows too. A segmented solve's lanes go through the CPU
build as one batch, and its placements, lane plan and merged state must
equal the reference's segmented solve. The routing predicate, the CPU
solve's eager route and the wrapper's argument checks are held here too;
tests/test_torch_cuda.py holds the kernel itself on the card.
"""
import copy
import functools

import jax
import numpy as np
import pytest
import torch

from karpenter_core_tpu.obs import flightrec as jrec
from karpenter_core_tpu.ops.pack import make_prescreen_kernel as j_prescreen
from karpenter_core_tpu.solver import encode as jencode
from karpenter_core_tpu.solver import tpu_solver as jsolver

from karpenter_core_tpu_torch.obs import flightrec as trec
from karpenter_core_tpu_torch.ops import cuda_build
from karpenter_core_tpu_torch.ops import pack as tpack
from karpenter_core_tpu_torch.ops import pack_scan
from karpenter_core_tpu_torch.ops import screen
from karpenter_core_tpu_torch.solver import encode as tencode
from karpenter_core_tpu_torch.solver import torch_solver as tsolver

from tests.test_torch_cuda import FAMILIES, _mods, workload
from tests.test_torch_segmented import (
    CASES,
    MAX_NODES,
    _assert_merged_equal,
    _jsolver,
    _solve,
    _spy_port,
    _spy_reference,
)
from tests.test_torch_solver import _assert_tree_equal

# every parity family: the kernel's route takes topology groups too
SCAN_FAMILIES = FAMILIES + ("ports_vols",)


def _reference(family, log_len=None):
    """The reference's prescreen and solve program on one family's inputs;
    log_len cuts the commit log's budget."""
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload(family, "jax")
    snap = jencode.encode_snapshot(pods, provs, its, daemons, nodes, kube_client=client,
                                   cluster=cluster, max_nodes=max_nodes)
    geom = jsolver.solve_geometry(snap, max_nodes)
    N, segs, zs, cs, L, sv = geom[7], geom[8], geom[9], geom[10], geom[12], geom[16]
    L = L if log_len is None else log_len
    args = jsolver.device_args(snap, provs)
    j_screen = jax.jit(j_prescreen(segs, N, backend="mxu", screen_v=sv))(args[0], args[9])
    run = jax.jit(jsolver.make_device_run(
        segs, zs, cs, snap.topo_meta, N, log_len=L, backend="mxu", screen_v=sv,
        screen_mode="prescreen", external_prescreen=True))
    j_log, j_ptr, j_state = jax.device_get(run(j_screen, *args))
    return {"snap": snap, "geom": (N, segs, zs, cs, L, sv), "args": args,
            "screen": np.asarray(j_screen), "log": j_log, "ptr": int(j_ptr), "state": j_state}


def _host_scan(ref, host_kernel=True):
    """The port's solve program on the reference's arrays, its scan through
    the kernel's CPU build (host_kernel=False: the eager scan), with the
    scan's final verdict tensor."""
    N, segs, zs, cs, L, sv = ref["geom"]
    targs = tsolver.args_to_torch(ref["args"], "cpu")
    run = tsolver.make_device_run(segs, zs, cs, ref["snap"].topo_meta, N, L, screen_v=sv,
                                  host_kernel=host_kernel)
    verdicts = []
    log, ptr, state = run(torch.from_numpy(ref["screen"].copy()), *targs, verdicts=verdicts)
    return log, ptr, state, dict(tpack.LAST_SCAN), verdicts


def _assert_scan_equal(ref, got):
    log, ptr, state, *_ = got
    assert ptr == ref["ptr"]
    want = {k: np.asarray(v) for k, v in ref["log"].items()}
    have = {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v, np.int32))
            for k, v in log.items()}
    _assert_tree_equal(want, have, "log")
    for name in ref["state"]._fields:
        _assert_tree_equal(np.asarray(getattr(ref["state"], name)),
                           getattr(state, name).numpy(), f"state.{name}")


@pytest.fixture(scope="module", params=SCAN_FAMILIES)
def scans(request):
    ref = _reference(request.param)
    return {"family": request.param, "ref": ref, "host": _host_scan(ref)}


def test_host_build_log_matches_reference(scans):
    ref, (log, ptr, _state, scan, _v) = scans["ref"], scans["host"]
    assert scan["impl"] == "kernel" and scan["items"] > 0
    assert ptr == ref["ptr"]
    want = {k: np.asarray(v) for k, v in ref["log"].items()}
    have = {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v, np.int32))
            for k, v in log.items()}
    _assert_tree_equal(want, have, "log")
    if scans["family"] in ("bulk", "ports_vols"):
        assert int(want["bulk_n"]) > 0  # the bulk fill ran


def test_host_build_state_matches_reference(scans):
    ref, (_log, _ptr, state, _scan, _v) = scans["ref"], scans["host"]
    assert ref["state"]._fields == state._fields
    for name in ref["state"]._fields:
        _assert_tree_equal(np.asarray(getattr(ref["state"], name)),
                           getattr(state, name).numpy(), f"state.{name}")
    if scans["family"] == "ports_vols":
        # the host-port and attach-limit lanes are live
        assert state.ports.shape[1] > 0 and state.ports.any()
        assert state.vols.shape[1] > 0 and state.vols.any()


def test_host_build_verdicts_match_eager_scan(scans):
    """The scan's final verdict tensor (the prescreen tensor as the
    in-scan re-screens left it) equals the eager scan's on the same
    inputs, bit for bit; the re-screens changed it where planes mutate."""
    got = scans["host"][4]
    want = _host_scan(scans["ref"], host_kernel=False)[4]
    assert len(got) == len(want) == 1
    assert got[0].dtype == want[0].dtype == torch.bool
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("family", ["bulk", "ports_vols", "anti", "cluster"])
def test_host_build_small_bulk_budget_matches_reference(family, monkeypatch):
    """A bulk take budget of one row: after the first bulk commit the
    existing slots go through candidate verify (replica_cap on the slot's
    own capacity), and the log, ptr and state still equal the reference's
    under the same budget, the verdicts the eager scan's. The anti family's
    bulk region is the whole slot axis (hostname anti-affinity), so its one
    row spans every slot."""
    from karpenter_core_tpu.ops import pack as jpack

    def one_row(make):
        def factory(*a, **k):
            pack = make(*a, **k)
            return lambda *pa, **pk: pack(*pa, **dict(pk, bulk_len=1))
        return factory

    monkeypatch.setattr(jpack, "make_pack_kernel", one_row(jpack.make_pack_kernel))
    monkeypatch.setattr(tsolver, "make_pack_kernel", one_row(tsolver.make_pack_kernel))
    real_run = pack_scan.run
    monkeypatch.setattr(pack_scan, "run", lambda *a, **k: real_run(*a, **dict(k, bulk_len=1)))
    ref = _reference(family)
    got = _host_scan(ref)
    _assert_scan_equal(ref, got)
    log, ptr, state, _scan, verdicts = got
    assert log["bulk_n"] == 1 and tuple(log["bulk_take"].shape)[0] == 1
    if family == "anti":
        assert tuple(log["bulk_take"].shape)[1] == state.used.shape[0]
    slot, ns = (np.asarray(log[k])[:ptr] for k in ("slot", "ns"))
    # candidate commits on existing slots ran
    assert ((ns == 1) & state.is_existing.numpy()[slot]).any()
    eager = _host_scan(ref, host_kernel=False)
    _assert_scan_equal(ref, eager)
    assert torch.equal(verdicts[0], eager[4][0])


@pytest.mark.parametrize("family", ["mixed", "ports_vols", "refmix"])
def test_host_build_overflowing_log_matches_reference(family):
    """A log that fills stops the scan's commits where the reference's
    does: the log, ptr and state under a budget of half the entries."""
    full = _reference(family)
    assert full["ptr"] >= 4
    ref = _reference(family, log_len=full["ptr"] // 2)
    got = _host_scan(ref)
    assert got[1] == ref["ptr"] == full["ptr"] // 2
    _assert_scan_equal(ref, got)


@pytest.mark.parametrize("case", ["pools-7", "pools-existing-3"])
def test_segmented_lanes_in_one_host_batch_match_reference(case, monkeypatch):
    """The segmented solve's lanes through the CPU build as one batch: the
    placements, the lane plan and the merged log and state equal the
    reference's segmented solve, and every lane with items is a scan of
    one launch."""
    build, seed, kw = CASES[case]
    jwl, twl = build(_mods("jax"), seed, **kw), build(_mods("torch"), seed, **kw)
    monkeypatch.setattr(tsolver, "make_device_run",
                        functools.partial(tsolver.make_device_run, host_kernel=True))
    batches = []
    real_run = pack_scan.run

    def counted(states, *a, **k):
        batches.append(len(states))
        return real_run(states, *a, **k)

    monkeypatch.setattr(pack_scan, "run", counted)
    jseen, tseen = _spy_reference(monkeypatch), _spy_port(monkeypatch)
    want = _solve(_jsolver("segmented"), jwl)
    solver = tsolver.TorchSolver(max_nodes=MAX_NODES, device="cpu", pack_scan="segmented")
    got = _solve(solver, twl)
    assert trec.placements_json(trec.canonical_placements(got)) == jrec.placements_json(
        jrec.canonical_placements(want))
    assert solver.last_segment_stats["mode"] == "segmented"
    for got_a, want_a in zip(tseen["plan"], jseen["plan"]):
        assert got_a.shape == want_a.shape and np.array_equal(got_a, want_a)
    _assert_merged_equal(tseen["merged"], jseen["merged"])
    lanes = int(sum((np.asarray(sel) >= 0).any() for sel in tseen["plan"][0]))
    assert batches == [lanes] and lanes >= 2
    assert tpack.LAST_SCAN["impl"] == "kernel"


@pytest.mark.parametrize("family", FAMILIES + ("ports_vols",))
def test_routing_predicate(family, monkeypatch):
    """The kernel takes every scan on a card under the prescreen with a
    log, topology groups or none; the replan's rung mode, the tiered
    screen and CPU tensors stay eager. The solve program decides it from
    the geometry alone: each family's scan reaches the CPU build when the
    program routes as on a card."""
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload(family, "torch")
    snap = tencode.encode_snapshot(pods, provs, its, daemons, nodes, client, cluster,
                                   max_nodes=max_nodes)
    topo = tsolver.topo_meta_from(snap.topo_meta)
    assert (topo is not None and bool(topo.groups)) == (
        family in ("spread", "affinity", "anti", "refmix", "cluster"))
    assert tpack.kernel_routes(torch.device("cuda"), "prescreen", True)
    assert not tpack.kernel_routes(torch.device("cuda"), "tiered", True)
    assert not tpack.kernel_routes(torch.device("cuda"), "prescreen", False)
    assert not tpack.kernel_routes(torch.device("cpu"), "prescreen", True)
    calls = []
    monkeypatch.setattr(pack_scan, "run", lambda states, *a, **k: calls.append(k) or [])
    geom = tsolver.solve_geometry(snap, max_nodes)
    N, segs, zs, cs, L, sv = geom[7], geom[8], geom[9], geom[10], geom[12], geom[16]
    targs = tsolver.args_to_torch(tsolver.device_args(snap, provs), "cpu")
    run = tsolver.make_device_run(segs, zs, cs, snap.topo_meta, N, L, screen_v=sv,
                                  host_kernel=True)
    scr = tpack.make_prescreen_kernel(segs, N, screen_v=sv)(targs[0], targs[9])
    with pytest.raises(IndexError):  # the stub returns no scan
        run(scr, *targs)
    (kw,) = calls
    assert (kw["topo"] is not None and bool(kw["topo"].groups)) == bool(
        topo is not None and topo.groups)


def test_cpu_solve_never_loads_the_kernel():
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload("mixed", "torch")
    screen.reset_launches()
    for mode in ("sequential", "segmented"):
        tsolver.TorchSolver(max_nodes=max_nodes, device="cpu", pack_scan=mode).solve(
            copy.deepcopy(pods), provs, its, daemonset_pods=daemons, state_nodes=nodes)
        assert tpack.LAST_SCAN["impl"] == "eager"
    assert "pack_scan" not in cuda_build.loaded_names()
    assert screen.LAUNCHES["pack_scan"] == 0


def test_prewarm_asks_for_both_libraries(monkeypatch):
    """The prewarm loads the pack scan's library beside the screen's, and
    counts a fresh load of either as a miss: load_solve_libraries (which
    TorchSolver.prewarm_snapshot, the service's prewarm and the host's
    child call) asks cuda_build.load for both on the card, and reports
    True only while one was not loaded yet."""
    asked = []
    monkeypatch.setattr(cuda_build, "load", lambda name, host=False: asked.append(name))
    monkeypatch.setattr(cuda_build, "loaded_names", lambda: sorted(set(asked)))
    assert tsolver.load_solve_libraries(torch.device("cuda")) is True
    assert asked == ["screen", "pack_scan"]
    assert tsolver.load_solve_libraries("cuda:0") is False
    assert not tsolver.load_solve_libraries("cpu") and len(asked) == 4
    # the solver's prewarm goes through it (here with the card's device)
    real = tsolver.load_solve_libraries
    monkeypatch.setattr(tsolver, "load_solve_libraries", lambda device: real("cuda"))
    asked.clear()
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload("mixed", "torch")
    snap = tencode.encode_snapshot(pods, provs, its, daemons, nodes, client, cluster,
                                   max_nodes=max_nodes)
    assert tsolver.TorchSolver(max_nodes=max_nodes, device="cpu").prewarm_snapshot(
        snap, provs) == "compiled"
    assert asked == ["screen", "pack_scan"]


def test_wrapper_rejects_bad_inputs(monkeypatch):
    """A wrong dtype raises TypeError, a tensor on another device
    ValueError, and CPU tensors without the CPU build ValueError."""
    calls = []
    real_run = pack_scan.run

    def capture(*a, **k):
        calls.append((a, k))
        return real_run(*a, **k)

    monkeypatch.setattr(pack_scan, "run", capture)
    ref = _reference("bulk")
    _host_scan(ref)
    (args, kw), = calls
    states, item_arrays, f_static = args[0], args[1], args[2]
    with pytest.raises(TypeError):
        real_run(states, dict(item_arrays, requests=item_arrays["requests"].double()),
                 *args[2:], **kw)
    with pytest.raises(TypeError):
        real_run(states, item_arrays, f_static.to(torch.uint8), *args[3:], **kw)
    with pytest.raises(ValueError):
        real_run(states, dict(item_arrays, valid=item_arrays["valid"].to("meta")),
                 *args[2:], **kw)
    with pytest.raises(ValueError):
        real_run(states, item_arrays, *args[2:], **dict(kw, item_sel=np.zeros((3, 2))))
    # CPU tensors are the CPU build's only: the plain version is the
    # solver's eager scan, not the wrapper's
    with pytest.raises(ValueError):
        real_run(states, item_arrays, *args[2:], **dict(kw, host=False))


def test_wrapper_rejects_bad_topology_inputs(monkeypatch):
    """The topology fields keep the wrapper's checks: a group flag plane
    or a count of the wrong dtype raises TypeError, one of the wrong shape
    ValueError, and groups without their term planes ValueError."""
    calls = []
    real_run = pack_scan.run

    def capture(*a, **k):
        calls.append((a, k))
        return real_run(*a, **k)

    monkeypatch.setattr(pack_scan, "run", capture)
    _host_scan(_reference("refmix"))
    (args, kw), = calls
    states, item_arrays = args[0], args[1]
    assert kw["topo"].groups and states[0].tcounts.shape[0] == len(kw["topo"].groups)
    with pytest.raises(TypeError):
        real_run(states, dict(item_arrays, topo_own=item_arrays["topo_own"].to(torch.uint8)),
                 *args[2:], **kw)
    with pytest.raises(TypeError):
        real_run([states[0]._replace(tcounts=states[0].tcounts.double())], *args[1:], **kw)
    with pytest.raises(ValueError):
        real_run(states, dict(item_arrays, topo_sel=item_arrays["topo_sel"][:, :1]),
                 *args[2:], **kw)
    with pytest.raises(ValueError):
        real_run([states[0]._replace(thost=states[0].thost[:, :1])], *args[1:], **kw)
    with pytest.raises(ValueError):
        real_run(states, *args[1:], **dict(kw, topo_terms=None))
