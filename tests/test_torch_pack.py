"""The port's prescreen and pack scan against the reference's compiled
programs, fed the SAME device_args arrays (the reference's own, moved with
args_to_torch): the [N, C] verdict tensor, the full commit log, ptr and
every PackState field must be equal, floats bit for bit (the topology
counts included: the reference's own TopoMeta drives the port's scan
through topo_meta_from)."""
import jax
import numpy as np
import pytest

from karpenter_core_tpu.ops.pack import make_prescreen_kernel as j_prescreen
from karpenter_core_tpu.solver import encode as jencode
from karpenter_core_tpu.solver import tpu_solver as jsolver

from karpenter_core_tpu_torch.ops import pack as tpack
from karpenter_core_tpu_torch.ops import screen
from karpenter_core_tpu_torch.solver import torch_solver as tsolver

from tests.test_torch_cuda import workload
from tests.test_torch_solver import _assert_tree_equal


@pytest.fixture(scope="module", params=["mixed", "bulk", "wide", "spread", "affinity",
                                        "anti", "refmix", "cluster", "ports_vols"])
def runs(request):
    family = request.param
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload(family, "jax")
    snap = jencode.encode_snapshot(pods, provs, its, daemons, nodes, kube_client=client,
                                   cluster=cluster, max_nodes=max_nodes)
    geom = jsolver.solve_geometry(snap, max_nodes)
    N, segs, zs, cs, log_len, screen_v = (
        geom[7], geom[8], geom[9], geom[10], geom[12], geom[16]
    )
    args = jsolver.device_args(snap, provs)

    pre = jax.jit(j_prescreen(segs, N, backend="mxu", screen_v=screen_v))
    j_screen = pre(args[0], args[9])
    run = jax.jit(jsolver.make_device_run(
        segs, zs, cs, snap.topo_meta, N, log_len=log_len, backend="mxu",
        screen_v=screen_v, screen_mode="prescreen", external_prescreen=True,
    ))
    j_log, j_ptr, j_state = jax.device_get(run(j_screen, *args))

    screen.reset_launches()
    targs = tsolver.args_to_torch(args, "cpu")
    t_screen = tpack.make_prescreen_kernel(segs, N, screen_v=screen_v)(
        targs[0], targs[9])
    t_log, t_ptr, t_state = tsolver.make_device_run(
        segs, zs, cs, tsolver.topo_meta_from(snap.topo_meta), N, log_len,
        screen_v=screen_v)(t_screen.clone(), *targs)
    return {
        "family": family,
        "jax": (np.asarray(j_screen), j_log, int(j_ptr), j_state),
        "torch": (t_screen.numpy(), t_log, t_ptr, t_state),
        "launches": dict(screen.LAUNCHES),
    }


def test_prescreen_tensor_matches(runs):
    j_screen, t_screen = runs["jax"][0], runs["torch"][0]
    assert j_screen.shape == t_screen.shape
    np.testing.assert_array_equal(j_screen, t_screen)
    if runs["family"] == "mixed":
        # selectors and custom keys: both verdicts occur
        assert j_screen.any() and not j_screen.all()


def test_commit_log_matches(runs):
    _j, j_log, j_ptr, _s = runs["jax"]
    _t, t_log, t_ptr, _s2 = runs["torch"]
    assert t_ptr == j_ptr > 0
    want = {k: np.asarray(v) for k, v in j_log.items()}
    got = {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v, np.int32))
           for k, v in t_log.items()}
    _assert_tree_equal(want, got, "log")
    if runs["family"] in ("bulk", "anti", "refmix"):
        assert int(want["bulk_n"]) > 0  # the bulk fill ran


def test_pack_state_matches(runs):
    j_state, t_state = runs["jax"][3], runs["torch"][3]
    assert j_state._fields == t_state._fields
    for name in j_state._fields:
        _assert_tree_equal(np.asarray(getattr(j_state, name)),
                           getattr(t_state, name).numpy(), f"state.{name}")
    if runs["family"] in ("spread", "affinity", "anti", "refmix"):
        assert t_state.tcounts.shape[0] > 0 and t_state.thost.any()


def test_cpu_path_never_launches_the_kernel(runs):
    assert runs["launches"] == {"screen": 0, "screen_prep": 0, "pack_scan": 0}
