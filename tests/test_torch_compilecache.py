"""The port's compile-cache counterpart and the repairs the reference's
suites showed, held against the reference where it has the same object.

- utils/compilecache: the first dispatch at a solve geometry is a miss and
  records its seconds, every later one a hit, at the reference's sites;
  a prewarmed geometry's live solve is a hit; the tenant label rides a
  bound request context into /debug/tenants; enable_persistent_cache
  names the kernels' build directory, or a temporary one when disabled.
- a CPU solve records the reference's solver.phase.* span set, plus the
  port's own `decode` and `prescreen`, with `compile_cache` on `device`.
- fake.instance_types_assorted equals the reference's, type by type.
- a PDB's min_available / max_unavailable and its status counts survive
  kube/serialization and the apiserver over HTTP.
"""
import os

import numpy as np
import pytest

from karpenter_core_tpu.cloudprovider import fake as rfake
from karpenter_core_tpu.kube import objects as robjects
from karpenter_core_tpu.kube import serialization as rserialization
from karpenter_core_tpu_torch.cloudprovider import fake as tfake
from karpenter_core_tpu_torch.kube import objects as tobjects
from karpenter_core_tpu_torch.kube import serialization as tserialization
from karpenter_core_tpu_torch.obs import TRACER, reqctx
from karpenter_core_tpu_torch.ops import cuda_build
from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver
from karpenter_core_tpu_torch.testing import make_pod, make_provisioner
from karpenter_core_tpu_torch.utils import compilecache
from karpenter_core_tpu_torch.utils.compilecache import (
    CACHE_HITS,
    CACHE_MISSES,
    COMPILE_SECONDS,
)


def _count(counter, **labels):
    return counter.get(labels)


def _batch(n=16, cpu="1"):
    return [make_pod(requests={"cpu": cpu}) for _ in range(n)]


def _solve(solver, pods):
    return solver.solve(pods, [make_provisioner(name="default")],
                        {"default": tfake.instance_types(4)})


# -- the compile-cache series ------------------------------------------------


def test_first_dispatch_misses_then_every_solve_hits():
    solver = TorchSolver(max_nodes=32, device="cpu")
    hits0, misses0 = _count(CACHE_HITS, site="tpu_solver"), _count(CACHE_MISSES, site="tpu_solver")
    seconds0 = COMPILE_SECONDS.snapshot()[1]
    for _ in range(3):
        _solve(solver, _batch())
    assert _count(CACHE_MISSES, site="tpu_solver") == misses0 + 1
    assert _count(CACHE_HITS, site="tpu_solver") == hits0 + 2
    assert COMPILE_SECONDS.snapshot()[1] == seconds0 + 1
    # another geometry is a new miss
    _solve(solver, _batch(n=200, cpu="0.1"))
    assert _count(CACHE_MISSES, site="tpu_solver") == misses0 + 2
    assert len(solver._warm_keys) == 2


def test_device_span_carries_the_lookup():
    solver = TorchSolver(max_nodes=32, device="cpu")
    was = TRACER.enabled
    TRACER.enable()
    try:
        seen = []
        for _ in range(2):
            seq = TRACER.mark()
            _solve(solver, _batch())
            (device,) = [s for s in TRACER.spans_since(seq) if s.name == "solver.phase.device"]
            seen.append(device.attrs["compile_cache"])
    finally:
        TRACER.enabled = was
    assert seen == ["miss", "hit"]


@pytest.fixture
def small_ladder():
    """tests/test_bucket_ladder.py's one-rung ladder, installed as the
    process's Settings for one test."""
    from karpenter_core_tpu_torch.api import settings as api_settings

    tier = api_settings.GeometryTier("S", pods=128, items=32, instance_types=16,
                                     existing_nodes=8)
    prev = api_settings.current()
    api_settings.set_current(api_settings.Settings(bucket_ladder=(tier,)))
    yield tier
    api_settings.set_current(prev)


def test_prewarmed_geometry_live_solve_hits(small_ladder):
    """tests/test_bucket_ladder.py's prewarm-then-live-solve case on the
    port's series: the prewarm pays the miss, the live solve of the same
    geometry is a hit and mints no second entry."""
    from karpenter_core_tpu_torch.solver.prewarm import prewarm, synthetic_workload

    tier = small_ladder
    provisioners = [make_provisioner(name="default")]
    its = {"default": tfake.instance_types(5)}
    solver = TorchSolver(max_nodes=48, device="cpu")
    pre0 = _count(CACHE_MISSES, site="prewarm")
    seconds0 = COMPILE_SECONDS.snapshot()[1]
    assert prewarm(solver, provisioners, its) == {"S": "compiled"}
    assert _count(CACHE_MISSES, site="prewarm") == pre0 + 1
    assert COMPILE_SECONDS.snapshot()[1] == seconds0 + 1
    hits0, misses0 = _count(CACHE_HITS, site="tpu_solver"), _count(CACHE_MISSES, site="tpu_solver")
    pods, nodes = synthetic_workload(tier, provisioners, its)
    res = solver.solve(pods[:40], provisioners, its, state_nodes=nodes)
    assert res.pod_count_new() + res.pod_count_existing() == 40
    assert len(solver._warm_keys) == 1
    assert _count(CACHE_HITS, site="tpu_solver") == hits0 + 1
    assert _count(CACHE_MISSES, site="tpu_solver") == misses0


def test_tenant_pays_the_miss_in_debug_tenants():
    from karpenter_core_tpu_torch.operator.__main__ import _tenants_digest

    solver = TorchSolver(max_nodes=32, device="cpu")
    with reqctx.bind(reqctx.RequestContext(tenant="team-cc")):
        _solve(solver, _batch())
        _solve(solver, _batch())
    digest = _tenants_digest()["tenants"]["team-cc"]
    assert digest["compile_misses"] == 1
    assert digest["compile_seconds"] > 0.0
    assert _count(CACHE_HITS, site="tpu_solver", tenant="team-cc") == 1


def test_replan_chunks_miss_once_per_pad():
    from tests.test_torch_cuda import workload
    from tests.test_torch_replan import subset_planes

    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload("mixed", "torch")
    solver = TorchSolver(max_nodes=max_nodes, device="cpu")
    snap = solver.encode(pods, provs, its, daemons, nodes, client, cluster)
    count_rows, exist_open = subset_planes(snap, 3, 0)
    misses0, hits0 = _count(CACHE_MISSES, site="replan"), _count(CACHE_HITS, site="replan")
    for _ in range(2):
        solver.replan_screen(snap, provs, count_rows, exist_open)
    assert _count(CACHE_MISSES, site="replan") - misses0 == 1
    assert _count(CACHE_HITS, site="replan") - hits0 == 1


def test_enable_persistent_cache_names_the_build_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.delenv("KARPENTER_COMPILE_CACHE_DIR", raising=False)
    assert compilecache.enable_persistent_cache() == cuda_build.DEFAULT_BUILD_DIR
    assert cuda_build.BUILD_DIR == cuda_build.DEFAULT_BUILD_DIR
    monkeypatch.setenv("KARPENTER_COMPILE_CACHE_DIR", str(tmp_path / "kernels"))
    assert compilecache.enable_persistent_cache() == str(tmp_path / "kernels")
    assert cuda_build.BUILD_DIR == str(tmp_path / "kernels") and os.path.isdir(cuda_build.BUILD_DIR)
    explicit = str(tmp_path / "explicit")
    assert compilecache.enable_persistent_cache(explicit) == explicit
    for off in ("0", "off", "disabled"):
        monkeypatch.setenv("KARPENTER_COMPILE_CACHE_DIR", off)
        assert compilecache.enable_persistent_cache() is None
        # a directory of this process's own, not the shared one
        assert cuda_build.BUILD_DIR not in (cuda_build.DEFAULT_BUILD_DIR, explicit)
        assert os.path.isdir(cuda_build.BUILD_DIR)
        os.rmdir(cuda_build.BUILD_DIR)


def test_series_names_are_the_references():
    from karpenter_core_tpu.utils import compilecache as rcompilecache

    for name in ("CACHE_HITS", "CACHE_MISSES", "COMPILE_SECONDS"):
        assert getattr(compilecache, name).name == getattr(rcompilecache, name).name


# -- the solver's phase spans ----------------------------------------------


def _span_names(pkg):
    if pkg == "jax":
        from karpenter_core_tpu.obs import TRACER as tracer
        from karpenter_core_tpu.solver.tpu_solver import TPUSolver
        from karpenter_core_tpu.testing import make_pod as mp, make_provisioner as mprov

        solver, fake = TPUSolver(max_nodes=32), rfake
    else:
        tracer, mp, mprov, fake = TRACER, make_pod, make_provisioner, tfake
        solver = TorchSolver(max_nodes=32, device="cpu")
    was = tracer.enabled
    tracer.enable()
    try:
        seq = tracer.mark()
        solver.solve([mp(requests={"cpu": "1"}) for _ in range(16)],
                     [mprov(name="default")], {"default": fake.instance_types(4)})
        spans = tracer.spans_since(seq)
    finally:
        tracer.enabled = was
    root = next(s for s in spans if s.name == "solver.solve")
    assert all(s.trace_id == root.trace_id for s in spans)
    return {s.name for s in spans}


def test_cpu_solve_span_set_is_the_references_plus_the_ports():
    ref, port = _span_names("jax"), _span_names("torch")
    assert ref <= port
    assert port - ref == {"solver.phase.decode"} | ({"solver.phase.prescreen"} - ref)


# -- the assorted universe -------------------------------------------------


def _type_row(it):
    return (it.name, sorted((k, float(v)) for k, v in it.capacity.items()),
            sorted((r.key, r.complement, sorted(r.values), r.greater_than, r.less_than)
                   for r in it.requirements.values()),
            [(o.capacity_type, o.zone, np.float64(o.price), o.available) for o in it.offerings])


def test_instance_types_assorted_equal_to_the_references():
    ref, port = rfake.instance_types_assorted(), tfake.instance_types_assorted()
    assert len(port) == len(ref) == 1344
    for r, t in zip(ref, port):
        assert _type_row(t) == _type_row(r)


# -- the PDB's fields ----------------------------------------------------------


def _pdb(objects, min_available):
    return objects.PodDisruptionBudget(
        metadata=objects.ObjectMeta(name="web", namespace="prod"),
        spec=objects.PodDisruptionBudgetSpec(
            selector=objects.LabelSelector(match_labels={"app": "web"}),
            min_available=min_available, max_unavailable=1),
        status=objects.PodDisruptionBudgetStatus(
            disruptions_allowed=1, current_healthy=3, desired_healthy=2, expected_pods=3))


@pytest.mark.parametrize("min_available", [2, "50%", None])
def test_pdb_round_trips_through_serialization(min_available):
    ref = rserialization.to_k8s_dict(_pdb(robjects, min_available))
    port_obj = _pdb(tobjects, min_available)
    wire = tserialization.to_k8s_dict(port_obj)
    assert (wire["spec"], wire["status"]) == (ref["spec"], ref["status"])
    back = tserialization.from_k8s_dict(tobjects.PodDisruptionBudget, wire)
    assert back.spec == port_obj.spec and back.status == port_obj.status


def test_pdb_round_trips_over_http():
    from karpenter_core_tpu_torch.kube.apiserver import ApiServerKubeClient, UrllibTransport
    from karpenter_core_tpu_torch.testing.apiserver import ApiHTTPServer, ApiStore

    srv = ApiHTTPServer(ApiStore())
    kube = ApiServerKubeClient(UrllibTransport(srv.url))
    try:
        sent = _pdb(tobjects, "50%")
        kube.create(sent)
        got = kube.get("PodDisruptionBudget", "prod", "web")
        kube.update_status(got)
        listed = kube.list("PodDisruptionBudget", namespace="prod")
    finally:
        kube.close()
        srv.close()
    assert got.spec == sent.spec
    assert got.status == sent.status
    assert [p.spec.min_available for p in listed] == ["50%"]
