"""The port's native packer against the reference's, on the CPU.

The four cases of tests/test_native.py run on the port's fast_pack and
NativeSolver(device="cpu"); fast_pack's five outputs equal the
reference's on seeded inputs, and NativeSolver places the shared
workloads byte-identically to the reference's NativeSolver. g++ builds
the port's own fast_pack.cpp into its gitignored build directory.
"""
import os
import time

import numpy as np
import pytest
import torch

from karpenter_core_tpu import native as jnative
from karpenter_core_tpu.obs.flightrec import placements_json as jplacements

from karpenter_core_tpu_torch import native as tnative
from karpenter_core_tpu_torch import testing as tt
from karpenter_core_tpu_torch.cloudprovider import fake as tfake
from karpenter_core_tpu_torch.kube import objects as tobj
from karpenter_core_tpu_torch.solver import torch_solver as tsolver

from tests.test_torch_cuda import workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fast_pack_basic():
    pod_requests = np.ones((4, 1), dtype=np.float32)
    f_static = np.ones((4, 1), dtype=np.uint8)
    type_alloc = np.array([[2.0]], dtype=np.float32)
    daemon = np.zeros(1, dtype=np.float32)
    assigned, tmask, used, pods, nopen = tnative.fast_pack(pod_requests, f_static, type_alloc,
                                                           daemon, 8)
    assert nopen == 2
    assert (assigned >= 0).all()
    assert pods[:2].tolist() == [2, 2]


def test_native_solver_matches_host():
    pods = [tt.make_pod(requests={"cpu": "1", "memory": "1Gi"}) for _ in range(30)] + [
        tt.make_pod(requests={"cpu": "2"}) for _ in range(10)]
    provisioners = [tt.make_provisioner(name="default")]
    its = {"default": tfake.instance_types(10)}
    native = tnative.NativeSolver(device="cpu").solve(pods, provisioners, its)
    host = tsolver.GreedySolver().solve(pods, provisioners, its)
    assert not native.failed_pods
    assert native.pod_count_new() == 40
    assert len(native.new_machines) <= len(host.new_machines)
    for m in native.new_machines:
        assert m.instance_type_options


def test_native_solver_rejects_topology():
    spread = tobj.TopologySpreadConstraint(
        max_skew=1, topology_key=tobj.LABEL_TOPOLOGY_ZONE, when_unsatisfiable="DoNotSchedule",
        label_selector=tobj.LabelSelector(match_labels={"a": "b"}))
    pods = [tt.make_pod(labels={"a": "b"}, topology_spread=[spread])]
    with pytest.raises(NotImplementedError):
        tnative.NativeSolver(device="cpu").solve(pods, [tt.make_provisioner(name="d")],
                                                 {"d": tfake.instance_types(3)})


def test_native_pack_throughput():
    """The C++ loop beats the reference's 100 pods/s floor by orders of
    magnitude on the raw packing path."""
    P, T, R = 5000, 100, 4
    rng = np.random.default_rng(0)
    pod_requests = rng.uniform(0.5, 2.0, (P, R)).astype(np.float32)
    f_static = np.ones((P, T), dtype=np.uint8)
    type_alloc = np.linspace(4, 64, T)[:, None].repeat(R, 1).astype(np.float32)
    daemon = np.zeros(R, dtype=np.float32)
    tnative.fast_pack(pod_requests[:1], f_static[:1], type_alloc, daemon, 4)
    t0 = time.perf_counter()
    assigned, *_ = tnative.fast_pack(pod_requests, f_static, type_alloc, daemon, 1024)
    dt = time.perf_counter() - t0
    assert (assigned >= 0).all()
    assert P / dt > 10_000, f"native pack too slow: {P / dt:.0f} pods/sec"


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_fast_pack_outputs_match_reference(seed):
    """All five outputs equal, on ragged feasibility, negative (absent)
    allocatable entries, daemon overhead and a slot budget that binds."""
    rng = np.random.default_rng(seed)
    P, T, R = 400, 24, 3
    pod_requests = rng.uniform(0.1, 3.0, (P, R)).astype(np.float32)
    f_static = (rng.random((P, T)) < 0.6).astype(np.uint8)
    type_alloc = rng.uniform(2.0, 24.0, (T, R)).astype(np.float32)
    type_alloc[rng.random((T, R)) < 0.05] = -1.0
    daemon = rng.uniform(0.0, 0.5, R).astype(np.float32)
    for max_nodes in (8, 400):
        want = jnative.fast_pack(pod_requests, f_static, type_alloc, daemon, max_nodes)
        got = tnative.fast_pack(pod_requests, f_static, type_alloc, daemon, max_nodes)
        for a, b in zip(got[:4], want[:4]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[4] == want[4]


@pytest.mark.parametrize("family", ["bulk", "wide", "relax"])
def test_native_solver_matches_reference(family):
    jp, jprov, jits, jds, _jn, mn, _c, _cl = workload(family, "jax")
    tp, tprov, tits, tds, _tn, _, _c, _cl = workload(family, "torch")
    want = jnative.NativeSolver(mn).solve(jp, jprov, jits, jds)
    got = tnative.NativeSolver(mn, device="cpu").solve(tp, tprov, tits, tds)
    assert tsolver.placements_json(got) == jplacements(want)
    assert [repr(m.requirements) for m in got.new_machines] == [
        repr(m.requirements) for m in want.new_machines]
    assert got.rounds == want.rounds


def test_native_solver_refuses_what_the_reference_refuses():
    """More than one template, existing nodes and provisioner limits raise
    NotImplementedError in both packages; a card is required unless the
    caller asks for the CPU."""
    for family, nodes in (("mixed", False), ("bulk", True)):
        jp, jprov, jits, jds, jn, mn, _c, _cl = workload(family, "jax")
        tp, tprov, tits, tds, tn, _, _c, _cl = workload(family, "torch")
        with pytest.raises(NotImplementedError) as want:
            jnative.NativeSolver(mn).solve(jp, jprov, jits, jds, jn if nodes else None)
        with pytest.raises(NotImplementedError) as got:
            tnative.NativeSolver(mn, device="cpu").solve(tp, tprov, tits, tds,
                                                         tn if nodes else None)
        assert str(got.value) == str(want.value)
    limited = [tt.make_provisioner(name="default", limits={"cpu": "100"})]
    with pytest.raises(NotImplementedError, match="limits"):
        tnative.NativeSolver(device="cpu").solve([tt.make_pod(requests={"cpu": "1"})], limited,
                                                 {"default": tfake.instance_types(3)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnative.NativeSolver()


def test_packer_builds_from_its_own_source_into_an_ignored_directory():
    tnative.build()
    assert os.path.dirname(tnative.LIB) == tnative.BUILD_DIR
    assert tnative.SRC == os.path.join(REPO, "karpenter_core_tpu_torch", "native",
                                       "fast_pack.cpp")
    assert os.path.getmtime(tnative.LIB) >= os.path.getmtime(tnative.SRC)
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = {line.strip() for line in f}
    assert os.path.relpath(tnative.BUILD_DIR, REPO) + "/" in ignored
