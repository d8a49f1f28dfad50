"""The batched consolidation replan of the PyTorch port against the JAX
reference, on the CPU: the candidate-axis ladder (encode.replan_k_pad,
replan_chunks), TorchSolver(device="cpu").replan_screen against
TPUSolver(backend="mxu").replan_screen on the shared parity workloads in
both screen modes (verdicts and per-slot counts exactly equal), the rung
scan's disabled log, the resident tensor after a replan, and the port's
gc_paused window."""
import gc

import jax
import numpy as np
import pytest
import torch

from karpenter_core_tpu.solver import encode as jencode
from karpenter_core_tpu.solver import tpu_solver as jsolver
from karpenter_core_tpu.solver.tpu_solver import TPUSolver
from karpenter_core_tpu_torch.ops.pack import ScreenOps, class_planes
from karpenter_core_tpu_torch.solver import encode as tencode
from karpenter_core_tpu_torch.solver import torch_solver as tsolver
from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver, placements_json
from karpenter_core_tpu_torch.testing import subset_planes
from karpenter_core_tpu_torch.utils import gctuning

from tests.test_torch_cuda import workload

# -- the candidate-axis ladder ---------------------------------------------


@pytest.mark.parametrize("k", [0, 1, 2, 7, 8, 9, 16, 17, 31, 32, 33, 63, 64])
def test_replan_k_pad_matches_reference(k):
    assert tencode.REPLAN_K_BUCKETS == jencode.REPLAN_K_BUCKETS
    assert tencode.replan_k_pad(k) == jencode.replan_k_pad(k)


@pytest.mark.parametrize("k", [65, 130])
def test_replan_k_pad_rejects_past_the_top_bucket(k):
    with pytest.raises(ValueError):
        jencode.replan_k_pad(k)
    with pytest.raises(ValueError):
        tencode.replan_k_pad(k)


@pytest.mark.parametrize("K, I, E", [(0, 32, 8), (1, 32, 8), (3, 64, 8), (64, 32, 16),
                                     (65, 32, 8), (130, 128, 32), (200, 32, 0)])
def test_replan_chunks_match_reference(K, I, E):
    rng = np.random.default_rng(K * 1000 + I + E)
    counts = rng.integers(0, 5, size=(K, I)).astype(np.int32)
    opened = rng.random((K, E)) < 0.7
    ref = list(jencode.replan_chunks(counts, opened))
    port = list(tencode.replan_chunks(counts, opened))
    assert len(ref) == len(port) == -(-K // 64)
    for (k1, kp1, c1, o1), (k2, kp2, c2, o2) in zip(ref, port):
        assert (k1, kp1) == (k2, kp2)
        assert c1.dtype == c2.dtype and o1.dtype == o2.dtype
        assert np.array_equal(c1, c2) and np.array_equal(o1, o2)
        # pad rungs: no active pod, nothing closed
        assert not c2[k2:].any() and o2[k2:].all()


# -- replan_screen against the reference ----------------------------------

_SNAPS = {}


def _snapshot(family, pkg, screen_mode):
    """(solver, snapshot, provisioners) of one family, encoded by `pkg`'s
    own solver; built once per module."""
    key = (family, pkg, screen_mode)
    if key not in _SNAPS:
        pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload(family, pkg)
        if pkg == "jax":
            solver = TPUSolver(max_nodes=max_nodes, backend="mxu", screen_mode=screen_mode)
        else:
            solver = TorchSolver(max_nodes=max_nodes, device="cpu", screen_mode=screen_mode)
        snap = solver.encode(pods, provs, its, daemons, nodes, client, cluster)
        _SNAPS[key] = (solver, snap, provs)
    return _SNAPS[key]


def _replan_both(family, screen_mode, K, seed=0, uninit_fn=None):
    out = {}
    for pkg in ("jax", "torch"):
        solver, snap, provs = _snapshot(family, pkg, screen_mode)
        count_rows, exist_open = subset_planes(snap, K, seed)
        uninit = uninit_fn(snap) if uninit_fn is not None else None
        out[pkg] = solver.replan_screen(snap, provs, count_rows, exist_open,
                                        uninitialized=uninit, want_slots=True)
    return out


@pytest.mark.parametrize("screen_mode", ["prescreen", "tiered"])
@pytest.mark.parametrize("family", ["mixed", "spread", "anti", "cluster"])
def test_replan_screen_matches_reference(family, screen_mode):
    out = _replan_both(family, screen_mode, K=3)
    (jv, jp), (tv, tp) = out["jax"], out["torch"]
    assert tv.dtype == np.int32 and tv.shape == (3, 4)
    assert np.array_equal(jv, tv), (jv.tolist(), tv.tolist())
    assert tp.dtype == np.int32 and np.array_equal(jp, tp)
    # the zero subset re-packs nothing
    assert tv[-1].tolist() == [0, 0, 0, 0] and not tp[-1].any()
    # something re-packed, every subset's expected is its rows' sum
    assert tv[:, 0].sum() > 0
    _solver, snap, _provs = _snapshot(family, "torch", screen_mode)
    count_rows, _ = subset_planes(snap, 3)
    assert tv[:, 1].tolist() == count_rows.sum(axis=1).tolist()


def test_replan_screen_single_subset_matches_reference():
    out = _replan_both("mixed", "prescreen", K=1, seed=3)
    assert np.array_equal(out["jax"][0], out["torch"][0])
    assert np.array_equal(out["jax"][1], out["torch"][1])
    assert out["torch"][0].shape == (1, 4)


def test_replan_screen_over_the_top_bucket_matches_reference():
    """65 subsets: a full chunk of 64 and one more padded to 8."""
    out = _replan_both("mixed", "prescreen", K=65, seed=5)
    (jv, jp), (tv, tp) = out["jax"], out["torch"]
    assert tv.shape == (65, 4) and tp.shape[0] == 65
    assert np.array_equal(jv, tv) and np.array_equal(jp, tp)


def test_replan_screen_inconclusive_on_uninitialized_node_matches_reference():
    """An uninitialized existing node that takes pods makes the verdict
    inconclusive; the padded existing rows are never uninitialized."""

    def uninit(snap):
        mask = np.zeros(len(snap.state_nodes), bool)
        mask[0] = True
        return mask

    out = _replan_both("cluster", "prescreen", K=3, seed=7, uninit_fn=uninit)
    (jv, jp), (tv, tp) = out["jax"], out["torch"]
    assert np.array_equal(jv, tv) and np.array_equal(jp, tp)
    incon = tv[:, 3]
    took = tp[:, 0] > 0
    assert incon.tolist() == took.astype(np.int32).tolist()
    assert incon.any()


def test_replan_screen_victim_slot_closed_takes_nothing():
    """A closed existing slot is neither open nor existing: it takes no
    pod, whatever fits there."""
    out = _replan_both("cluster", "prescreen", K=3, seed=1)
    _solver, snap, _provs = _snapshot("cluster", "torch", "prescreen")
    _counts, exist_open = subset_planes(snap, 3, seed=1)
    tp = out["torch"][1]
    E = exist_open.shape[1]
    assert not exist_open.all()
    assert not (tp[:, :E] * ~exist_open).any()
    assert np.array_equal(out["jax"][1], tp)


def test_replan_screen_reports_phases_and_reuses_the_resident_tensor():
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload("cluster", "torch")
    solver = TorchSolver(max_nodes=max_nodes, device="cpu")
    snap = solver.encode(pods, provs, its, daemons, nodes, client, cluster)
    count_rows, exist_open = subset_planes(snap, 3)
    v1, p1 = solver.replan_screen(snap, provs, count_rows, exist_open, cluster=cluster)
    assert p1 is None
    assert set(solver.last_replan_phase_ms) == {"args", "upload", "prescreen", "device",
                                                "fetch"}
    stats = solver.last_replan_stats
    assert stats["K"] == 3 and stats["chunks"] == [8] and stats["prescreen"] == "full"
    # the same snapshot again, nothing changed in the cluster's feed: the
    # resident tensor is refreshed, not rebuilt
    v2, _ = solver.replan_screen(snap, provs, count_rows, exist_open, cluster=cluster)
    assert solver.last_replan_stats["prescreen"] == "refresh"
    assert np.array_equal(v1, v2)


@pytest.mark.parametrize("family", ["cluster", "anti"])
def test_solve_after_replan_places_like_a_fresh_solver(family):
    """The replan's scans work on copies: a solve at the same residency
    key after a replan places byte-identically to a fresh solver's."""
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload(family, "torch")
    warm = TorchSolver(max_nodes=max_nodes, device="cpu")
    snap = warm.encode(pods, provs, its, daemons, nodes, client, cluster)
    count_rows, exist_open = subset_planes(snap, 5, seed=2)
    count_rows[:4, : len(snap.item_counts)] = snap.item_counts  # every pod, some slots shut
    verdicts, _ = warm.replan_screen(snap, provs, count_rows, exist_open, cluster=cluster)
    assert verdicts[:4, 0].sum() > 0
    key_replan = next(iter(warm._inc_screens))
    after = warm.solve(pods, provs, its, daemons, nodes, kube_client=client, cluster=cluster)
    assert warm.last_prescreen_mode == "refresh"
    assert next(reversed(warm._inc_screens)) == key_replan  # the same residency key
    fresh = TorchSolver(max_nodes=max_nodes, device="cpu").solve(
        pods, provs, its, daemons, nodes, kube_client=client, cluster=cluster)
    assert placements_json(after) == placements_json(fresh)


# -- the rung scan's disabled log -----------------------------------------


def test_rung_scan_commits_past_the_log_budget_like_the_reference():
    """With no log, no commit waits on log space: at a log budget of 2 the
    rung scan places every pod a full-size scan places, where a logging
    scan at the same budget stops after two commits; both packages'
    rung scans agree slot for slot."""
    jax.config.update("jax_platforms", "cpu")
    _solver, snap, provs = _snapshot("bulk", "torch", "prescreen")
    geom = tsolver.solve_geometry(snap, 128)
    N, segments, zone_seg, ct_seg, screen_v = geom[7], geom[8], geom[9], geom[10], geom[16]
    E = geom[3]
    args = tsolver.device_args(snap, provs)
    targs = tsolver.args_to_torch(args, "cpu")
    ops = ScreenOps(segments, targs[0]["allow"].shape[1], screen_v)
    screen0 = ops.initial_screen(class_planes(targs[0], ops), targs[9]["allow"],
                                 targs[9]["out"], targs[9]["defined"], N)
    count_row = np.asarray(args[0]["count"])
    exist_open = np.ones(E, bool)
    exist_open[1] = False
    rung = tsolver.make_device_run(segments, zone_seg, ct_seg, snap.topo_meta, N, 2,
                                   screen_v=screen_v, rung_mode=True)
    _log, ptr, state = rung(count_row, torch.from_numpy(exist_open), screen0, *targs)
    assert ptr == 0
    logging_run = tsolver.make_device_run(segments, zone_seg, ct_seg, snap.topo_meta, N, 2,
                                          screen_v=screen_v)
    _log, ptr_l, state_l = logging_run(screen0, *targs)
    assert ptr_l == 2 and int(state_l.pods.sum()) < int(state.pods.sum())
    assert int(state.pods.sum()) == int(count_row.sum())

    jrung = jax.jit(jsolver.make_device_run(
        segments, zone_seg, ct_seg, snap.topo_meta, N, log_len=2, rung_mode=True,
        backend="mxu", screen_v=screen_v, screen_mode="prescreen",
        external_prescreen=True))
    _jl, _jp, jstate = jrung(count_row, exist_open, screen0.numpy(), *args)
    assert np.array_equal(np.asarray(jstate.pods), state.pods.numpy())
    assert np.array_equal(np.asarray(jstate.used), state.used.numpy())


# -- gc_paused ---------------------------------------------------------------


@pytest.fixture
def gc_clock(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(gctuning, "_monotonic", lambda: now[0])
    was = gc.isenabled()
    gc.enable()
    yield now
    assert gctuning.depth() == 0
    (gc.enable if was else gc.disable)()


def test_gc_paused_nests_and_reenables_at_depth_zero(gc_clock):
    assert gc.isenabled()
    with gctuning.gc_paused():
        assert not gc.isenabled() and gctuning.depth() == 1
        with gctuning.gc_paused():
            assert gctuning.depth() == 2
        assert not gc.isenabled(), "an inner exit must not re-enable collection"
    assert gc.isenabled()
    # a window opened with collection off leaves it off
    gc.disable()
    with gctuning.gc_paused():
        pass
    assert not gc.isenabled()
    gc.enable()


def test_gc_paused_bounds_the_deferral_on_entry(gc_clock, monkeypatch):
    """A window left open (an abandoned solve thread) is abandoned by the
    next window that opens past MAX_DEFERRED_SPAN_S: collection runs, and
    closes with that window; the stale exit changes nothing."""
    collected = []
    real_collect = gc.collect

    def collect(*a):
        # the collection runs with the lock free: another window may open
        assert not gctuning._lock.locked()
        collected.append(1)
        return real_collect()

    monkeypatch.setattr(gctuning.gc, "collect", collect)
    stale = gctuning.gc_paused()
    stale.__enter__()
    assert not gc.isenabled() and gctuning.depth() == 1
    gc_clock[0] += gctuning.MAX_DEFERRED_SPAN_S / 2
    with gctuning.gc_paused():  # inside the span: plain nesting
        assert gctuning.depth() == 2
    assert not collected and not gc.isenabled()
    gc_clock[0] += gctuning.MAX_DEFERRED_SPAN_S
    with gctuning.gc_paused():
        assert collected == [1]
        assert gctuning.depth() == 1 and not gc.isenabled()
    assert gc.isenabled(), "the abandoned window must not hold collection off"
    stale.__exit__(None, None, None)
    assert gc.isenabled() and gctuning.depth() == 0


def test_solve_runs_inside_gc_paused(monkeypatch):
    seen = []
    real = tsolver.TorchSolver._solve_once

    def spy(self, *a, **kw):
        seen.append((gc.isenabled(), gctuning.depth()))
        return real(self, *a, **kw)

    monkeypatch.setattr(tsolver.TorchSolver, "_solve_once", spy)
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload("relax", "torch")
    was = gc.isenabled()
    gc.enable()
    try:
        res = TorchSolver(max_nodes=max_nodes, device="cpu").solve(
            pods, provs, its, daemons, nodes)
        assert gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()
    assert seen and all(not on and d >= 1 for on, d in seen)
    assert res.rounds == len(seen) > 1
