"""The port's tiered screen mode against the reference's, on the CPU.

Under screen_mode="tiered" the pack scan keeps no [N, C] prescreen tensor:
each item screens every open slot row against its own class row on the
screen kernel's B = 1 form (`screen_row`, the reference's
slot_compat_screen). Placements must be byte-identical to
TPUSolver(backend="mxu", screen_mode="tiered") and to the port's own
prescreen mode on every shared family, and the commit log, ptr and every
PackState field equal the reference's tiered scan on the reference's
arrays.
"""
import jax
import numpy as np
import pytest
import torch

from karpenter_core_tpu.obs.flightrec import canonical_placements, placements_json
from karpenter_core_tpu.solver import encode as jencode
from karpenter_core_tpu.solver import tpu_solver as jsolver

from karpenter_core_tpu_torch.ops import pack as tpack
from karpenter_core_tpu_torch.ops import screen
from karpenter_core_tpu_torch.solver import torch_solver as tsolver

from tests.test_torch_cuda import FAMILIES, _mods, workload
from tests.test_torch_solver import _assert_tree_equal


def _placed(result):
    return placements_json(canonical_placements(result))


@pytest.mark.parametrize("family", FAMILIES)
def test_tiered_placements_match_reference_and_prescreen(family):
    jp, jprov, jits, jds, jnodes, max_nodes, jkc, jcl = workload(family, "jax")
    tp, tprov, tits, tds, tnodes, _, tkc, tcl = workload(family, "torch")
    want = jsolver.TPUSolver(max_nodes=max_nodes, backend="mxu", screen_mode="tiered",
                             incremental="off").solve(
        jp, jprov, jits, daemonset_pods=jds, state_nodes=jnodes, kube_client=jkc,
        cluster=jcl)
    got = {}
    for mode in ("tiered", "prescreen"):
        solver = tsolver.TorchSolver(max_nodes=max_nodes, device="cpu", screen_mode=mode)
        got[mode] = solver.solve(tp, tprov, tits, daemonset_pods=tds, state_nodes=tnodes,
                                 kube_client=tkc, cluster=tcl)
        # a relaxation round of the prescreen solve may refresh round 1's
        # tensor; the tiered solve keeps none
        assert (solver.last_prescreen_mode is None) == (mode == "tiered")
    assert _placed(got["tiered"]) == _placed(want)
    assert _placed(got["tiered"]) == _placed(got["prescreen"])
    assert got["tiered"].rounds == want.rounds


@pytest.fixture(scope="module", params=["mixed", "wide", "spread", "anti", "cluster"])
def tiered_runs(request):
    """One tiered scan of a family's reference arrays in both packages."""
    family = request.param
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload(family, "jax")
    snap = jencode.encode_snapshot(pods, provs, its, daemons, nodes, kube_client=client,
                                   cluster=cluster, max_nodes=max_nodes)
    geom = jsolver.solve_geometry(snap, max_nodes)
    N, segs, zs, cs, log_len, screen_v = (
        geom[7], geom[8], geom[9], geom[10], geom[12], geom[16]
    )
    args = jsolver.device_args(snap, provs)
    run = jax.jit(jsolver.make_device_run(
        segs, zs, cs, snap.topo_meta, N, log_len=log_len, backend="mxu",
        screen_v=screen_v, screen_mode="tiered",
    ))
    j_log, j_ptr, j_state = jax.device_get(run(*args))
    screen.reset_launches()
    targs = tsolver.args_to_torch(args, "cpu")
    t_log, t_ptr, t_state = tsolver.make_device_run(
        segs, zs, cs, tsolver.topo_meta_from(snap.topo_meta), N, log_len,
        screen_v=screen_v, screen_mode="tiered")(None, *targs)
    return {"family": family, "jax": (j_log, int(j_ptr), j_state),
            "torch": (t_log, t_ptr, t_state), "targs": targs, "segs": segs,
            "screen_v": screen_v, "launches": dict(screen.LAUNCHES)}


def test_tiered_log_and_state_match_reference(tiered_runs):
    j_log, j_ptr, j_state = tiered_runs["jax"]
    t_log, t_ptr, t_state = tiered_runs["torch"]
    assert t_ptr == j_ptr > 0
    _assert_tree_equal(
        {k: np.asarray(v) for k, v in j_log.items()},
        {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v, np.int32))
         for k, v in t_log.items()}, "log")
    assert j_state._fields == t_state._fields
    for name in j_state._fields:
        _assert_tree_equal(np.asarray(getattr(j_state, name)),
                           getattr(t_state, name).numpy(), f"state.{name}")
    # the CPU path uses the plain versions only
    assert tiered_runs["launches"] == {"screen": 0, "screen_prep": 0, "pack_scan": 0}


def test_tiered_prefix_screen_equals_the_full_slot_axis(tiered_runs):
    """The scan screens the prefix [:nopen] and scores the rest BIG; the
    reference's tiers screen wider prefixes. Slots at or past nopen are
    closed, so every prefix that covers nopen yields the same candidates:
    checked on the scan's final slot state, for every class column."""
    _log, _ptr, state = tiered_runs["torch"]
    pod_arrays = tiered_runs["targs"][0]
    N, V = state.allow.shape
    nopen = int(state.nopen)
    assert 0 < nopen < N
    ops = tpack.ScreenOps(tiered_runs["segs"], V, tiered_runs["screen_v"])
    items = tpack.class_planes(pod_arrays, ops)
    for b in range(items.B):
        full = screen.screen_row(state.allow, state.out, state.defined, items, b,
                                 ops.row_layout) & state.open
        for lim in sorted({nopen, (nopen + N) // 2, N}):
            part = screen.screen_row(state.allow[:lim], state.out[:lim],
                                     state.defined[:lim], items, b, ops.row_layout)
            cand = torch.zeros(N, dtype=torch.bool)
            cand[:lim] = part & state.open[:lim]
            assert torch.equal(cand, full), (b, lim)
        assert not full[nopen:].any()


KEY = "zzz.example.com/flag"


def _width_case(pkg):
    """A key with no values sorted last (no hostname key: no existing
    node, no hostname topology), so its segment starts at the screen
    width: one provisioner requires it to exist, and half the pods require
    it to exist, half that it does not."""
    m = _mods(pkg)
    pods = []
    for i in range(8):
        op = "Exists" if i % 2 == 0 else "DoesNotExist"
        term = m.o.NodeSelectorTerm([m.o.NodeSelectorRequirement(KEY, op, [])])
        p = m.t.make_pod(name=f"w-{i}", requests={"cpu": "2" if i % 2 == 0 else "1"},
                         node_affinity_required=[term])
        p.metadata.uid = f"uid-w-{i}"
        p.metadata.creation_timestamp = 1000.0 + i
        pods.append(p)
    its = m.fake.instance_types(4)
    flagged = m.t.make_provisioner(name="flagged", weight=10, requirements=[
        m.o.NodeSelectorRequirement(KEY, "Exists", [])])
    return pods, [flagged, m.t.make_provisioner(name="default")], {
        "default": its, "flagged": its}


def test_key_at_the_screen_width_matches_reference():
    """An item that defines a key whose segment starts at the screen width
    (ROADMAP Queue C): the tiered screen evaluates the key (every_key),
    as the reference's rows_compat_m does, so the pods that require the
    key absent never reach the flagged machines as candidates; the
    prescreen's template rows skip it and leave the verify to refuse
    them. Placements are byte-identical across both packages and both
    modes; the scans differ only in those failed candidate iterations."""
    jp, jprov, jits = _width_case("jax")
    tp, tprov, tits = _width_case("torch")
    snap = tsolver.encode_snapshot(tp, tprov, tits)
    assert snap.dictionary.keys[-1] == KEY
    assert snap.dictionary.segment(KEY)[0] == snap.screen_v == snap.dictionary.V
    placed, scans = {}, {}
    for mode in ("tiered", "prescreen"):
        placed["jax", mode] = _placed(jsolver.TPUSolver(
            max_nodes=32, backend="mxu", screen_mode=mode, incremental="off").solve(
            jp, jprov, jits))
        placed["torch", mode] = _placed(tsolver.TorchSolver(
            max_nodes=32, device="cpu", screen_mode=mode).solve(tp, tprov, tits))
        scans[mode] = dict(tpack.LAST_SCAN)
    assert len(set(placed.values())) == 1
    assert '"failed":[]' in placed["torch", "tiered"]
    assert scans["tiered"]["candidate"] == 0 < scans["prescreen"]["candidate"]
