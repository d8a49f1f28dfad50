"""The port's cluster inputs against the reference, on the CPU: the kube
client, Cluster, host ports, CSI volume limits and cluster-seeded topology.

Every solve case is built twice, once with each package's builders, and
must match at three levels: the encoder's device_args, the scan's commit
log, ptr and every PackState field (`ports` and `vols` included) on the
reference's own arrays, and byte-identical placements from
`TorchSolver(device="cpu")` and `TPUSolver(backend="mxu",
incremental="off")`. The cases rebuild tests/test_device_ports_volumes.py,
tests/test_topology.py's inverse anti-affinity case and
tests/test_topology_suite.py's bound-pod counting through both solvers.
"""
import copy
import itertools

import jax
import numpy as np
import pytest

from karpenter_core_tpu.obs.flightrec import canonical_placements, placements_json
from karpenter_core_tpu.ops.pack import make_prescreen_kernel as j_prescreen
from karpenter_core_tpu.solver import encode as jencode
from karpenter_core_tpu.solver import tpu_solver as jsolver

from karpenter_core_tpu_torch.ops import pack as tpack
from karpenter_core_tpu_torch.solver import encode as tencode
from karpenter_core_tpu_torch.solver import torch_solver as tsolver

from tests.test_torch_cuda import CT, PROV, ZONE, _mods, _pod, _sel
from tests.test_torch_solver import _assert_tree_equal

EBS = "ebs.csi.aws.com"


def _case(m, kw):
    kw.setdefault("provs", [m.t.make_provisioner(name="default")])
    kw.setdefault("its", {"default": m.fake.instance_types(8)})
    for k in ("nodes", "client", "cluster"):
        kw.setdefault(k, None)
    kw.setdefault("max_nodes", 64)
    return kw


def _node(m, name, zone=None, cpu="8"):
    labels = {PROV: "default", "karpenter.sh/initialized": "true", CT: "on-demand"}
    if zone:
        labels[ZONE] = zone
    return m.t.make_node(name=name, labels=labels,
                         capacity={"cpu": cpu, "memory": "16Gi", "pods": "50"})


def _bound(m, tag, i, node, **kw):
    return _pod(m, tag, i, node_name=node, unschedulable=False,
                phase=kw.pop("phase", "Running"), **kw)


def _claim_pod(m, client, tag, i, claim, create=True):
    if create:
        client.create(m.t.make_pvc(claim, storage_class="ebs"))
    p = _pod(m, tag, i, requests={"cpu": "0.1"})
    p.spec.volumes.append(m.t.pvc_volume(claim))
    return p


def _ebs_client(m):
    client = m.client()
    client.create(m.t.make_storage_class("ebs", provisioner=EBS))
    return client


# -- cases ---------------------------------------------------------------------

def case_same_hostport(m):
    pods = [_pod(m, "samep", i, requests={"cpu": "0.1"}, host_ports=[8080])
            for i in range(6)]
    return _case(m, dict(pods=pods))


def case_distinct_hostports(m):
    pods = [_pod(m, "distp", i, requests={"cpu": "0.1"}, host_ports=[8080 + i])
            for i in range(4)]
    return _case(m, dict(pods=pods))


def case_hostport_blocked_by_running_pod(m):
    state = m.node(_node(m, "busy"))
    state.update_for_pod(_bound(m, "busy", 0, "busy", host_ports=[443]))
    pods = [_pod(m, "blocked", i, requests={"cpu": "0.1"}, host_ports=[443 + (i == 2)])
            for i in range(3)]
    return _case(m, dict(pods=pods, nodes=[state]))


def case_wildcard_ip(m):
    p1 = _pod(m, "wild", 0, requests={"cpu": "0.1"})
    p1.spec.containers[0].ports.append(m.o.ContainerPort(host_port=9000, host_ip="10.0.0.1"))
    p2 = _pod(m, "wild", 1, requests={"cpu": "0.1"})
    p2.spec.containers[0].ports.append(m.o.ContainerPort(host_port=9000))
    p3 = _pod(m, "wild", 2, requests={"cpu": "0.1"})
    p3.spec.containers[0].ports.append(m.o.ContainerPort(host_port=9000, host_ip="10.0.0.2"))
    return _case(m, dict(pods=[p1, p2, p3]))


def case_attach_limit_full(m):
    client = _ebs_client(m)
    state = m.node(_node(m, "full"))
    state.volume_limits[EBS] = 2
    state.volume_usage.volumes = {EBS: {"default/m-0", "default/m-1"}}
    pods = [_claim_pod(m, client, "full", 0, "data-0"),
            _pod(m, "full", 1, requests={"cpu": "0.1"})]
    return _case(m, dict(pods=pods, nodes=[state], client=client))


def case_attach_limit_headroom(m):
    client = _ebs_client(m)
    state = m.node(_node(m, "roomy"))
    state.volume_limits[EBS] = 3
    state.volume_usage.volumes = {EBS: {"default/m-0"}}
    pods = [_claim_pod(m, client, "roomy", i, f"data-{i}") for i in range(4)]
    return _case(m, dict(pods=pods, nodes=[state], client=client))


def case_shared_claim(m):
    client = _ebs_client(m)
    client.create(m.t.make_pvc("shared", storage_class="ebs"))
    state = m.node(_node(m, "one-slot"))
    state.volume_limits[EBS] = 1
    pods = [_claim_pod(m, client, "shared", i, "shared", create=False) for i in range(2)]
    return _case(m, dict(pods=pods, nodes=[state], client=client))


def case_csinode_without_cluster(m):
    client = m.client()
    client.create(m.t.make_storage_class("sc", provisioner="x.csi"))
    pods = []
    for i in range(5):
        client.create(m.t.make_pvc(f"c{i}", storage_class="sc"))
        p = _pod(m, "csin", i, requests={"cpu": "1"})
        p.spec.volumes.append(m.t.pvc_volume(f"c{i}"))
        pods.append(p)
    universe = m.fake.instance_types(12)
    it = universe[8]  # 9 cpu: capacity alone would admit all five
    node = m.t.make_node(name="e0", labels={
        PROV: "default", "karpenter.sh/initialized": "true",
        "node.kubernetes.io/instance-type": it.name, CT: "on-demand",
        ZONE: "test-zone-1"}, capacity={k: str(v) for k, v in it.capacity.items()})
    client.create(m.t.make_csinode("e0", "x.csi", allocatable=3))
    return _case(m, dict(pods=pods, nodes=[m.node(node)], client=client,
                         its={"default": universe}, max_nodes=8))


def case_volumes_without_nodes(m, blocked_node=False):
    """Claim pods and no existing node: W > 0 with an empty existing
    prefix (EV = 0), where a clamped row index would wrap. The reference
    cannot trace this case (ROADMAP Queue C), so its parity runs with one
    existing node that no pod tolerates, which must place alike."""
    client = _ebs_client(m)
    pods = [_claim_pod(m, client, "novol", i, f"d-{i // 2}", create=i % 2 == 0)
            for i in range(6)]
    nodes = None
    if blocked_node:
        node = _node(m, "tainted")
        node.spec.taints = [m.o.Taint(key="dedicated", value="x", effect="NoSchedule")]
        nodes = [m.node(node)]
    return _case(m, dict(pods=pods, client=client, nodes=nodes))


class _FakeCluster:
    """The one method of Cluster the topology reads."""

    def __init__(self, pairs):
        self.pairs = pairs

    def for_pods_with_anti_affinity(self, visit):
        for pod, node in self.pairs:
            if not visit(pod, node):
                return


def case_inverse_anti_affinity(m):
    """tests/test_topology.py:413-428: a running pod with zonal
    anti-affinity against app=web keeps new web pods out of its zone."""
    term = m.o.PodAffinityTerm(topology_key=ZONE, label_selector=_sel(m, "web"))
    existing = _bound(m, "inv", 0, "existing-node", labels={"app": "db"},
                      pod_anti_affinity_required=[term])
    node = m.t.make_node(name="existing-node", labels={ZONE: "test-zone-3"})
    pods = [_pod(m, "inv", 1 + i, labels={"app": "web"}, requests={"cpu": "1"})
            for i in range(3)]
    return _case(m, dict(pods=pods, cluster=_FakeCluster([(existing, node)]),
                         its={"default": m.fake.instance_types(10)}))


def case_only_matching_bound_pods(m):
    """tests/test_topology_suite.py:146-180: of the bound pods only the
    running, matching ones in the spread's namespace on a node with a zone
    count (pending, terminal, terminating, wrong-namespace, label-less and
    zone-less pods do not)."""
    client = m.client()
    cluster = m.cluster(client)
    for name, zone in (("first", "test-zone-1"), ("second", "test-zone-2"), ("third", None)):
        node = m.t.make_node(name=name, labels={ZONE: zone} if zone else {},
                             capacity={"cpu": "100", "pods": "100"})
        client.create(node)
        cluster.update_node(node)
    lab = {"test": "test"}
    bound = [
        _bound(m, "cnt", 0, "first"),
        _pod(m, "cnt", 1, labels=lab),
        _bound(m, "cnt", 2, "third", labels=lab),
        _bound(m, "cnt", 3, "first", labels=lab, namespace="wrong-ns"),
        _bound(m, "cnt", 4, "first", labels=lab, phase="Failed"),
        _bound(m, "cnt", 5, "first", labels=lab, phase="Succeeded"),
        _bound(m, "cnt", 6, "first", labels=lab),
        _bound(m, "cnt", 7, "first", labels=lab),
        _bound(m, "cnt", 8, "second", labels=lab),
    ]
    terminating = _pod(m, "cnt", 9, labels=lab)
    terminating.metadata.deletion_timestamp = 1.0
    for p in bound + [terminating]:
        client.create(p)
        cluster.update_pod(p)
    topo = m.o.TopologySpreadConstraint(1, ZONE, "DoNotSchedule",
                                        m.o.LabelSelector(match_labels=lab))
    pods = [_pod(m, "cnt", 10 + i, labels=lab, topology_spread=[topo],
                 requests={"cpu": "1"}) for i in range(2)]
    return _case(m, dict(pods=pods, nodes=cluster.nodes(), client=client, cluster=cluster))


# the formerly refused inputs (tests/test_torch_solver.py)

def case_host_port(m):
    pods = [_pod(m, "hp", i, requests={"cpu": "1"}, **({"host_ports": [8080]} if i % 2 else {}))
            for i in range(8)]
    return _case(m, dict(pods=pods, its={"default": m.fake.instance_types(4)}))


def case_volume(m):
    client = _ebs_client(m)
    nodes = []
    for e in range(2):
        client.create(m.t.make_csinode(f"vn-{e}", EBS, allocatable=1 + e))
        nodes.append(m.node(_node(m, f"vn-{e}")))
    pods = [_claim_pod(m, client, "vol", i, f"v-{i}") for i in range(5)]
    return _case(m, dict(pods=pods, nodes=nodes, client=client))


def case_kube_client_seeding(m):
    """Bound pods listed through the client seed a zonal spread (skewed
    2 : 1 : 0), a hostname spread and a zonal pod affinity; no cluster."""
    client = m.client()
    nodes = []
    for e in range(3):
        node = _node(m, f"sn-{e}", zone=f"test-zone-{1 + e}", cpu="2")
        client.create(node)
        nodes.append(m.node(node))
    i = 0
    for e, n_spread in ((0, 2), (1, 1)):
        for _ in range(n_spread):
            client.create(_bound(m, "seedb", i, f"sn-{e}", labels={"app": "spread"}))
            i += 1
    client.create(_bound(m, "seedb", i, "sn-2", labels={"app": "hspread"}))
    client.create(_bound(m, "seedb", i + 1, "sn-1", labels={"app": "aff"}))
    zonal = m.o.TopologySpreadConstraint(1, ZONE, "DoNotSchedule", _sel(m, "spread"))
    host = m.o.TopologySpreadConstraint(1, "kubernetes.io/hostname", "DoNotSchedule",
                                        _sel(m, "hspread"))
    aff = m.o.PodAffinityTerm(topology_key=ZONE, label_selector=_sel(m, "aff"))
    pods = []
    for j in range(12):
        kw = [dict(labels={"app": "spread"}, topology_spread=[zonal]),
              dict(labels={"app": "hspread"}, topology_spread=[host]),
              dict(labels={"app": "aff"}, pod_affinity_required=[aff])][j % 3]
        pods.append(_pod(m, "seed", j, requests={"cpu": "1"}, **kw))
    return _case(m, dict(pods=pods, nodes=nodes, client=client))


def case_cluster_inverse_anti(m):
    """A Cluster's bound pod with zonal anti-affinity against app=web, a
    namespace selector resolved through the client, and web pods in both
    namespaces."""
    client = m.client()
    cluster = m.cluster(client)
    client.create(m.o.Namespace(metadata=m.o.ObjectMeta(name="team-a",
                                                        labels={"team": "a"})))
    for e in range(3):
        node = _node(m, f"an-{e}", zone=f"test-zone-{1 + e}", cpu="4")
        client.create(node)
        cluster.update_node(node)
    term = m.o.PodAffinityTerm(topology_key=ZONE, label_selector=_sel(m, "web"),
                               namespace_selector=m.o.LabelSelector(
                                   match_labels={"team": "a"}))
    guard = _bound(m, "anti", 0, "an-0", labels={"app": "db"},
                   pod_anti_affinity_required=[term], requests={"cpu": "0.5"})
    client.create(guard)
    cluster.update_pod(guard)
    pods = [_pod(m, "anti", 1 + i, labels={"app": "web"}, requests={"cpu": "1"},
                 namespace=("default", "team-a")[i % 2]) for i in range(8)]
    return _case(m, dict(pods=pods, nodes=cluster.nodes(), client=client, cluster=cluster))


PORT_VOLUME_CASES = {
    "same_hostport": case_same_hostport,
    "distinct_hostports": case_distinct_hostports,
    "hostport_blocked_by_running_pod": case_hostport_blocked_by_running_pod,
    "wildcard_ip": case_wildcard_ip,
    "attach_limit_full": case_attach_limit_full,
    "attach_limit_headroom": case_attach_limit_headroom,
    "shared_claim": case_shared_claim,
    "csinode_without_cluster": case_csinode_without_cluster,
    "volumes_without_nodes": lambda m: case_volumes_without_nodes(m, blocked_node=True),
    "inverse_anti_affinity": case_inverse_anti_affinity,
    "only_matching_bound_pods": case_only_matching_bound_pods,
}
FORMERLY_REFUSED = {
    "host_port": case_host_port,
    "volume": case_volume,
    "kube_client_seeding": case_kube_client_seeding,
    "cluster_inverse_anti": case_cluster_inverse_anti,
}


def check_case(build):
    """device_args, the scan's log and state, and placements of one case,
    port against reference. Returns the port's SolveResult."""
    j, t = build(_mods("jax")), build(_mods("torch"))
    mn = j["max_nodes"]
    js = jencode.encode_snapshot(j["pods"], j["provs"], j["its"], None, j["nodes"],
                                 kube_client=j["client"], cluster=j["cluster"], max_nodes=mn)
    ts = tencode.encode_snapshot(t["pods"], t["provs"], t["its"], None, t["nodes"],
                                 t["client"], t["cluster"], max_nodes=mn)
    assert jsolver.solve_geometry(js, mn) == tsolver.solve_geometry(ts, mn)
    args = jsolver.device_args(js, j["provs"])
    _assert_tree_equal(dict(zip(jsolver.RUN_ARG_NAMES, args)),
                       dict(zip(tsolver.RUN_ARG_NAMES, tsolver.device_args(ts, t["provs"]))))

    geom = jsolver.solve_geometry(js, mn)
    N, segs, zs, cs, log_len, screen_v = (geom[7], geom[8], geom[9], geom[10], geom[12],
                                          geom[16])
    j_screen = jax.jit(j_prescreen(segs, N, backend="mxu", screen_v=screen_v))(
        args[0], args[9])
    run = jax.jit(jsolver.make_device_run(
        segs, zs, cs, js.topo_meta, N, log_len=log_len, backend="mxu", screen_v=screen_v,
        screen_mode="prescreen", external_prescreen=True))
    j_log, j_ptr, j_state = jax.device_get(run(j_screen, *args))
    targs = tsolver.args_to_torch(args, "cpu")
    t_screen = tpack.make_prescreen_kernel(segs, N, screen_v=screen_v)(targs[0], targs[9])
    t_log, t_ptr, t_state = tsolver.make_device_run(
        segs, zs, cs, tsolver.topo_meta_from(js.topo_meta), N, log_len,
        screen_v=screen_v)(t_screen, *targs)
    assert t_ptr == int(j_ptr)
    _assert_tree_equal({k: np.asarray(v) for k, v in j_log.items()},
                       {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v, np.int32))
                        for k, v in t_log.items()}, "log")
    for name in j_state._fields:
        _assert_tree_equal(np.asarray(getattr(j_state, name)),
                           getattr(t_state, name).numpy(), f"state.{name}")

    j, t = build(_mods("jax")), build(_mods("torch"))
    want = jsolver.TPUSolver(max_nodes=mn, backend="mxu", incremental="off").solve(
        j["pods"], j["provs"], j["its"], state_nodes=j["nodes"], kube_client=j["client"],
        cluster=j["cluster"])
    got = tsolver.TorchSolver(max_nodes=mn, device="cpu").solve(
        t["pods"], t["provs"], t["its"], state_nodes=t["nodes"], kube_client=t["client"],
        cluster=t["cluster"])
    assert placements_json(canonical_placements(got)) == placements_json(
        canonical_placements(want))
    assert got.rounds == want.rounds
    return got, ts


def _zone_of(machine):
    r = machine.requirements.get_requirement(ZONE)
    return r.values_list()[0] if r.len() == 1 else None


@pytest.mark.parametrize("case", sorted(PORT_VOLUME_CASES))
def test_port_volume_and_seeding_cases_match_reference(case):
    got, snap = check_case(PORT_VOLUME_CASES[case])
    assert not got.failed_pods
    new = sorted(len(mc.pods) for mc in got.new_machines)
    existing = got.pod_count_existing()
    # the reference suite's own expectations hold for the port
    if case == "same_hostport":
        assert new == [1] * 6
    elif case == "distinct_hostports":
        assert new == [4]
    elif case == "hostport_blocked_by_running_pod":
        assert existing == 1 and got.pod_count_new() == 2  # only port 444 fits "busy"
    elif case == "wildcard_ip":
        assert new == [1, 2]  # the wildcard conflicts with both specific IPs
    elif case == "attach_limit_full":
        assert existing == 1 and got.pod_count_new() == 1  # the claimless pod fits
    elif case == "attach_limit_headroom":
        assert existing == 2 and got.pod_count_new() == 2
    elif case == "shared_claim":
        assert existing == 2
    elif case == "csinode_without_cluster":
        assert [len(p) for _n, p in got.existing_assignments] == [3]
    elif case == "volumes_without_nodes":
        assert snap.pod_vols_u.shape[1] > 0 and existing == 0
        t = case_volumes_without_nodes(_mods("torch"))
        bare = tencode.encode_snapshot(t["pods"], t["provs"], t["its"], None, None,
                                       t["client"], max_nodes=64)
        assert bare.exist_vols.shape == (0, snap.pod_vols_u.shape[1])
        t = case_volumes_without_nodes(_mods("torch"))
        alone = tsolver.TorchSolver(max_nodes=64, device="cpu").solve(
            t["pods"], t["provs"], t["its"], kube_client=t["client"])
        assert tsolver.placements_json(alone) == tsolver.placements_json(got)
    elif case == "inverse_anti_affinity":
        assert all(_zone_of(mc) != "test-zone-3" for mc in got.new_machines)
    elif case == "only_matching_bound_pods":
        # seeded zone counts 2 : 1 (the suite's [1, 2, 2] skew after two pods)
        counts = {}
        for mc in got.new_machines:
            counts[_zone_of(mc)] = counts.get(_zone_of(mc), 0) + len(mc.pods)
        assert counts.get("test-zone-1", 0) == 0 and sum(counts.values()) == 2


# -- host modules against the reference's --------------------------------------

def test_host_port_entry_matches_reference():
    from karpenter_core_tpu.scheduling import hostportusage as jh
    from karpenter_core_tpu_torch.scheduling import hostportusage as th

    ips, ports, protos = ("", "0.0.0.0", "::", "10.0.0.1", "10.0.0.2"), (80, 443), ("TCP", "UDP")
    entries = list(itertools.product(ips, ports, protos))
    for a, b in itertools.product(entries, entries):
        assert th.HostPortEntry(*a).matches(th.HostPortEntry(*b)) == \
            jh.HostPortEntry(*a).matches(jh.HostPortEntry(*b)), (a, b)


def _port_pods(m, rng, n):
    pods = []
    for i in range(n):
        p = _pod(m, "hpu", i, requests={"cpu": "1"})
        for _ in range(int(rng.integers(0, 3))):
            p.spec.containers[0].ports.append(m.o.ContainerPort(
                host_port=int(rng.choice([0, 80, 443])),
                host_ip=str(rng.choice(["", "10.0.0.1", "10.0.0.2"])),
                protocol=str(rng.choice(["TCP", "UDP"]))))
        pods.append(p)
    return pods


@pytest.mark.parametrize("seed", range(4))
def test_host_port_usage_matches_reference(seed):
    from karpenter_core_tpu.scheduling import hostportusage as jh
    from karpenter_core_tpu_torch.scheduling import hostportusage as th

    usage = {}
    for pkg, mod in (("jax", jh), ("torch", th)):
        rng = np.random.default_rng(seed)
        m = _mods(pkg)
        u = mod.HostPortUsage()
        trace = []
        for p in _port_pods(m, rng, 12):
            trace.append(([str(e) for e in mod.host_ports(p)], u.validate(p)))
            if trace[-1][1] is None:
                u.add(p)
            if rng.random() < 0.2:
                u.delete_pod(next(iter(u.reserved), ("", "")))
        c = u.deep_copy()
        usage[pkg] = (trace, {tuple(k): [str(e) for e in v] for k, v in c.reserved.items()})
    assert usage["torch"] == usage["jax"]


def _storage(m):
    client = m.client()
    client.create(m.t.make_storage_class("ebs", provisioner=EBS))
    client.create(m.t.make_pv("pv-csi", driver="efs.csi.aws.com"))
    client.create(m.t.make_pv("pv-nfs"))
    client.create(m.t.make_pvc("a", storage_class="ebs"))
    client.create(m.t.make_pvc("b", storage_class="ebs", volume_name="pv-csi"))
    client.create(m.t.make_pvc("c", storage_class="ebs", volume_name="pv-nfs"))
    client.create(m.t.make_pvc("d", storage_class="ghost"))
    client.create(m.t.make_pvc("e"))
    client.create(m.t.make_pvc("a", namespace="other", storage_class="ebs"))
    return client


def test_volume_usage_resolve_matches_reference():
    from karpenter_core_tpu.scheduling import volumeusage as jv
    from karpenter_core_tpu_torch.scheduling import volumeusage as tv

    out = {}
    for pkg, mod in (("jax", jv), ("torch", tv)):
        m = _mods(pkg)
        client = _storage(m)
        u = mod.VolumeUsage(client)
        rows = []
        for i, claims in enumerate([["a"], ["b", "c"], ["d", "e", "missing"], ["a", "b"],
                                    ["a"]]):
            p = _pod(m, "vu", i, namespace="other" if i == 4 else "default")
            p.spec.volumes += [m.t.pvc_volume(c) for c in claims]
            p.spec.volumes.append(m.o.Volume(name="scratch"))
            rows.append((u._resolve(p), dict(u.validate(p))))
            u.add(p)
        u.delete_pod(("default", "vu-1"))
        count = mod.VolumeCount(u.validate(p))
        rows.append((u.volumes, count.exceeds({EBS: 1}), count.exceeds({EBS: 2}),
                     u.deep_copy().pod_volumes, mod.VolumeUsage()._resolve(p)))
        out[pkg] = rows
    assert out["torch"] == out["jax"]


def test_resolve_volume_limits_matches_reference():
    from karpenter_core_tpu.state import node as jn
    from karpenter_core_tpu_torch.state import node as tn

    out = {}
    for pkg, mod in (("jax", jn), ("torch", tn)):
        m = _mods(pkg)
        client = m.client()
        client.create(m.t.make_csinode("n0", EBS, allocatable=25))
        client.create(m.t.make_csinode("n1", EBS))  # no allocatable count
        csi = m.t.make_csinode("n2", EBS, allocatable=7)
        csi.drivers.append(m.o.CSINodeDriver(name="x.csi", allocatable_count=3))
        client.create(csi)
        client.create(m.t.make_csinode("n3", EBS, allocatable=9))
        nodes = [m.node(_node(m, f"n{e}")) for e in range(5)]
        nodes[3].volume_limits[EBS] = 2  # populated: left as it is
        mod.resolve_volume_limits(nodes, client)
        mod.resolve_volume_limits(nodes, None)
        out[pkg] = [dict(n.volume_limits) for n in nodes]
    assert out["torch"] == out["jax"] == [{EBS: 25}, {}, {EBS: 7, "x.csi": 3}, {EBS: 2}, {}]


def test_cluster_bindings_match_reference():
    """update_node / update_pod / delete_pod keep bindings, per-node
    requests, host ports, volumes, CSINode limits and the anti-affinity
    index as the reference's Cluster does."""
    out = {}
    for pkg in ("jax", "torch"):
        m = _mods(pkg)
        client = _storage(m)
        cluster = m.cluster(client)
        client.create(m.t.make_csinode("c0", EBS, allocatable=4))
        for e in range(2):
            node = _node(m, f"c{e}")
            client.create(node)
            cluster.update_node(node)
        term = m.o.PodAffinityTerm(topology_key=ZONE, label_selector=_sel(m, "web"))
        pods = [
            _bound(m, "cl", 0, "c0", host_ports=[443], requests={"cpu": "1"}),
            _bound(m, "cl", 1, "c0", pod_anti_affinity_required=[term]),
            _bound(m, "cl", 2, "c1", requests={"cpu": "2"}),
            _bound(m, "cl", 3, "ghost-node"),
        ]
        pods[2].spec.volumes.append(m.t.pvc_volume("a"))
        for p in pods:
            cluster.update_pod(p)
        moved = copy.deepcopy(pods[2])
        moved.spec.node_name = "c0"  # rebinds: c1 forgets it
        cluster.update_pod(moved)
        done = copy.deepcopy(pods[0])
        done.status.phase = "Succeeded"  # terminal: unbound
        cluster.update_pod(done)
        cluster.delete_pod(("default", "cl-1"))
        visited = []
        cluster.for_pods_with_anti_affinity(lambda p, n: visited.append(p.metadata.name))
        out[pkg] = (
            [(n.name(), sorted(n.pod_requests), {tuple(k): [str(e) for e in v]
                                                 for k, v in n.hostport_usage.reserved.items()},
              n.volume_usage.volumes, dict(n.volume_limits), n.available())
             for n in cluster.nodes()],
            dict(cluster.bindings), visited, cluster.node_for("c1").name(),
            cluster.node_for("nowhere"),
        )
    assert out["torch"] == out["jax"]


def test_kube_client_matches_reference():
    out = {}
    for pkg in ("jax", "torch"):
        m = _mods(pkg)
        client = m.client()
        for i in range(6):
            p = _pod(m, "kc", i, labels={"app": f"a{i % 2}"},
                     namespace=("default", "other")[i % 3 == 0])
            client.create(p)
        p.metadata.labels["app"] = "changed"  # the store kept its own copy
        got = client.get("Pod", "other", "kc-3")
        got.metadata.labels["app"] = "changed"  # and hands out copies
        sel = m.o.LabelSelector(match_labels={"app": "a1"})
        out[pkg] = (
            [q.metadata.name for q in client.list("Pod")],
            [q.metadata.name for q in client.list("Pod", namespace="other")],
            [q.metadata.name for q in client.list("Pod", selector=sel)],
            [q.metadata.name for q in client.list("Pod", namespace="default", selector=sel)],
            client.get("Pod", "other", "kc-3").metadata.labels,
            client.get("Pod", "default", "kc-3"), client.list("Node"),
        )
        with pytest.raises(Exception, match="already exists"):
            client.create(p)
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("seed", range(3))
def test_count_domains_matches_reference(seed):
    """The host Topology's seeded counts: random bound pods (phases,
    namespaces, nodes with and without a zone, a node filter) against the
    reference's."""
    from karpenter_core_tpu.controllers.provisioning.scheduling.topology import (
        Topology as JTopology,
    )
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (
        Topology as TTopology,
    )

    out = {}
    for pkg, topo_cls in (("jax", JTopology), ("torch", TTopology)):
        rng = np.random.default_rng(seed)
        m = _mods(pkg)
        client = m.client()
        cluster = m.cluster(client)
        for e in range(6):
            labels = {"disk": ("ssd", "hdd")[e % 2]}
            if e % 5:
                labels[ZONE] = f"test-zone-{1 + e % 3}"
            node = m.t.make_node(name=f"cd-{e}", labels=labels)
            client.create(node)
            cluster.update_node(node)
        anti = m.o.PodAffinityTerm(topology_key=ZONE, label_selector=_sel(m, "a"))
        for i in range(40):
            kw = dict(labels={"app": str(rng.choice(["a", "b"]))},
                      namespace=str(rng.choice(["default", "default", "other"])),
                      phase=str(rng.choice(["Running", "Running", "Succeeded", "Pending"])))
            if rng.random() < 0.15:
                kw["pod_anti_affinity_required"] = [anti]
            if rng.random() < 0.8:
                p = _bound(m, "cdb", i, f"cd-{int(rng.integers(0, 7))}", **kw)
            else:
                p = _pod(m, "cdb", i, **kw)
            if rng.random() < 0.1:
                p.metadata.deletion_timestamp = 1.0
            client.create(p)
            cluster.update_pod(p)
        sel = _sel(m, "a")
        tscs = [m.o.TopologySpreadConstraint(1, ZONE, "DoNotSchedule", sel),
                m.o.TopologySpreadConstraint(1, "kubernetes.io/hostname", "DoNotSchedule", sel)]
        batch = [
            _pod(m, "cdp", 0, labels={"app": "a"}, topology_spread=tscs),
            _pod(m, "cdp", 1, labels={"app": "a"}, topology_spread=tscs[:1],
                 node_selector={"disk": "ssd"}),
            _pod(m, "cdp", 2, labels={"app": "b"}, pod_affinity_required=[
                m.o.PodAffinityTerm(topology_key=ZONE, label_selector=_sel(m, "b"))]),
        ]
        host = topo_cls(client, cluster, {ZONE: {"test-zone-1", "test-zone-2"}}, batch)
        out[pkg] = (
            [(tg.type, tg.key, dict(tg.domains), sorted(tg.owners))
             for tg in host.topologies.values()],
            [(tg.type, tg.key, dict(tg.domains), sorted(tg.owners))
             for tg in host.inverse_topologies.values()],
            sorted(host.excluded_pods),
        )
    assert out["torch"] == out["jax"]
    assert any(sum(d.values()) for _t, _k, d, _o in out["torch"][0])
