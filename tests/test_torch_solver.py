"""The PyTorch port's Solve() against the JAX reference, on the CPU.

Workloads are built twice, once with each package's builders, with pod
names, uids and creation timestamps pinned (they break FFD ties). The port
must encode to the same arrays and place every pod byte-identically under
the reference's canonical placement serializer.
"""
import ast
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from karpenter_core_tpu.obs.flightrec import canonical_placements, placements_json
from karpenter_core_tpu.solver import encode as jencode
from karpenter_core_tpu.solver import tpu_solver as jsolver

from karpenter_core_tpu_torch.solver import encode as tencode
from karpenter_core_tpu_torch.solver import torch_solver as tsolver

from tests.test_torch_cuda import FAMILIES, ZONE, workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_tree_equal(a, b, path="args"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{path}: {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{path}: {a.shape} != {b.shape}"
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a.view(np.uint32 if a.itemsize == 4 else np.uint64),
                                      b.view(np.uint32 if b.itemsize == 4 else np.uint64),
                                      err_msg=path)
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("family", FAMILIES)
def test_encode_and_device_args_match_reference(family):
    jp, jprov, jits, jds, jnodes, max_nodes, jkc, jcl = workload(family, "jax")
    tp, tprov, tits, tds, tnodes, _, tkc, tcl = workload(family, "torch")
    js = jencode.encode_snapshot(jp, jprov, jits, jds, jnodes, kube_client=jkc,
                                 cluster=jcl, max_nodes=max_nodes)
    ts = tencode.encode_snapshot(tp, tprov, tits, tds, tnodes, tkc, tcl,
                                 max_nodes=max_nodes)
    assert js.dictionary.keys == ts.dictionary.keys
    assert [js.dictionary.values_of(k) for k in js.dictionary.keys] == [
        ts.dictionary.values_of(k) for k in ts.dictionary.keys
    ]
    assert [p.metadata.name for p in js.pods] == [p.metadata.name for p in ts.pods]
    assert js.item_members == ts.item_members
    if js.topo_meta is None:
        assert ts.topo_meta is None
    else:
        np.testing.assert_array_equal(js.item_of_pod, ts.item_of_pod)
        assert tsolver.topo_meta_from(js.topo_meta) == ts.topo_meta
    assert jsolver.solve_geometry(js, max_nodes) == tsolver.solve_geometry(ts, max_nodes)
    _assert_tree_equal(
        dict(zip(jsolver.RUN_ARG_NAMES, jsolver.device_args(js, jprov))),
        dict(zip(tsolver.RUN_ARG_NAMES, tsolver.device_args(ts, tprov))),
    )


@pytest.mark.parametrize("family", FAMILIES)
def test_torch_solver_placements_match_reference(family):
    jp, jprov, jits, jds, jnodes, max_nodes, jkc, jcl = workload(family, "jax")
    tp, tprov, tits, tds, tnodes, _, tkc, tcl = workload(family, "torch")
    want = jsolver.TPUSolver(max_nodes=max_nodes, backend="mxu",
                             incremental="off").solve(
        jp, jprov, jits, daemonset_pods=jds, state_nodes=jnodes, kube_client=jkc,
        cluster=jcl)
    got = tsolver.TorchSolver(max_nodes=max_nodes, device="cpu").solve(
        tp, tprov, tits, daemonset_pods=tds, state_nodes=tnodes, kube_client=tkc,
        cluster=tcl)
    assert placements_json(canonical_placements(got)) == placements_json(
        canonical_placements(want))
    # the port's own serializer (chip_smoke.py's comparison unit) agrees
    assert tsolver.placements_json(got) == placements_json(canonical_placements(got))
    assert got.rounds == want.rounds
    # each family opens machines; some leave pods unschedulable on purpose
    assert got.new_machines
    if family in ("mixed", "relax", "spread", "affinity", "anti"):
        assert got.failed_pods
    if family != "relax":
        assert got.pod_count_existing() > 0


def _refused_before(m, what):
    """The three constraint kinds the first slices refused, on a pod with
    no selector match besides itself, beside a plain pod."""
    sel = m.o.LabelSelector(match_labels={"app": "a"})
    term = m.o.PodAffinityTerm(topology_key=ZONE, label_selector=sel)
    kw = {
        "spread": {"topology_spread": [m.o.TopologySpreadConstraint(
            1, ZONE, "DoNotSchedule", sel)]},
        "pod_affinity": {"pod_affinity_required": [term]},
        "anti_affinity": {"pod_anti_affinity_required": [term]},
    }[what]
    pods = []
    for i in range(4):
        p = m.t.make_pod(name=f"{what}-{i}", labels={"app": "a"},
                         requests={"cpu": "1"}, **(kw if i else {}))
        p.metadata.uid = f"uid-{what}-{i}"
        p.metadata.creation_timestamp = 1000.0 + i
        pods.append(p)
    return pods, [m.t.make_provisioner(name="default")], {
        "default": m.fake.instance_types(4)}


@pytest.mark.parametrize("what", ["spread", "pod_affinity", "anti_affinity"])
def test_formerly_refused_constraints_match_reference(what):
    from tests.test_torch_cuda import _mods

    jp, jprov, jits = _refused_before(_mods("jax"), what)
    tp, tprov, tits = _refused_before(_mods("torch"), what)
    want = jsolver.TPUSolver(max_nodes=32, backend="mxu", incremental="off").solve(
        jp, jprov, jits)
    got = tsolver.TorchSolver(max_nodes=32, device="cpu").solve(tp, tprov, tits)
    assert placements_json(canonical_placements(got)) == placements_json(
        canonical_placements(want))
    assert got.new_machines


@pytest.mark.parametrize("case", ["host_port", "volume", "kube_client_seeding",
                                  "cluster_inverse_anti"])
def test_formerly_refused_cluster_inputs_match_reference(case):
    """Host ports, volume claims, a kube client and a cluster, which the
    earlier slices refused: device_args, scan state and placements equal
    the reference's (tests/test_torch_cluster.py's check_case)."""
    from tests.test_torch_cluster import FORMERLY_REFUSED, check_case

    got, snap = check_case(FORMERLY_REFUSED[case])
    assert not got.failed_pods
    if case == "host_port":
        assert snap.pod_ports_u.shape[1] > 0
        assert all(sum(bool(p.spec.containers[0].ports) for p in mc.pods) <= 1
                   for mc in got.new_machines)
    elif case == "volume":
        assert snap.pod_vols_u.shape[1] > 0
        # the two nodes' attach limits (1 and 2) take three of the claims
        assert got.pod_count_existing() == 3
    elif case == "kube_client_seeding":
        assert snap.topo_arrays.counts0.sum() > 0 and snap.topo_arrays.hcounts0.sum() > 0
    else:
        assert len(snap.topo_meta.groups) == 1 and snap.topo_meta.groups[0].is_inverse


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert tsolver.TorchSolver().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsolver.TorchSolver()


def test_relaxation_never_mutates_caller_pods():
    tp, tprov, tits, tds, tnodes, max_nodes, _, _ = workload("relax", "torch")
    before = copy.deepcopy(tp)
    tsolver.TorchSolver(max_nodes=max_nodes, device="cpu").solve(tp, tprov, tits)
    assert tp == before


def _port_sources():
    root = os.path.join(REPO, "karpenter_core_tpu_torch")
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_reference():
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "karpenter_core_tpu"), (path, name)
    code = (
        "import sys, pkgutil, importlib, karpenter_core_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'karpenter_core_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
