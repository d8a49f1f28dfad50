"""Tests of the PyTorch port that need a CUDA card, and the parity
workloads shared by the port's CPU tests.

This file imports nothing of JAX at module level, so it runs where only
PyTorch is installed. On the card, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(--noconftest: the suite's conftest pins JAX to the CPU). Without a card
the `cuda` tests skip.
"""
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from karpenter_core_tpu_torch import testing as tt
from karpenter_core_tpu_torch.cloudprovider import fake as tfake
from karpenter_core_tpu_torch.cloudprovider import types as ttypes
from karpenter_core_tpu_torch.kube import objects as tobj
from karpenter_core_tpu_torch.kube.client import InMemoryKubeClient as TClient
from karpenter_core_tpu_torch.ops import screen
from karpenter_core_tpu_torch.solver import torch_solver as tsolver
from karpenter_core_tpu_torch.state.cluster import Cluster as TCluster
from karpenter_core_tpu_torch.state.node import StateNode as TStateNode

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
CT = "karpenter.sh/capacity-type"
PROV = "karpenter.sh/provisioner-name"


def _mods(pkg):
    """Builders of one package: "jax" (the reference, imported only here)
    or "torch" (the port)."""
    if pkg == "jax":
        from karpenter_core_tpu import testing as jt
        from karpenter_core_tpu.cloudprovider import fake as jfake
        from karpenter_core_tpu.cloudprovider import types as jtypes
        from karpenter_core_tpu.kube import objects as jobj
        from karpenter_core_tpu.kube.client import InMemoryKubeClient as JClient
        from karpenter_core_tpu.state.cluster import Cluster as JCluster
        from karpenter_core_tpu.state.node import StateNode as JStateNode

        return SimpleNamespace(t=jt, o=jobj, fake=jfake, types=jtypes,
                               node=lambda n: JStateNode(node=n), client=JClient,
                               cluster=JCluster)
    return SimpleNamespace(t=tt, o=tobj, fake=tfake, types=ttypes, node=TStateNode,
                           client=TClient, cluster=TCluster)


def _term(m, *exprs):
    return m.o.NodeSelectorTerm(
        [m.o.NodeSelectorRequirement(k, op, list(v)) for k, op, v in exprs]
    )


def _pref(m, weight, *exprs):
    return m.o.PreferredSchedulingTerm(weight=weight, preference=_term(m, *exprs))


def _pod(m, family, i, **kw):
    p = m.t.make_pod(name=f"{family}-{i}", **kw)
    p.metadata.uid = f"uid-{family}-{i:05d}"
    p.metadata.creation_timestamp = 1000.0 + (i * 7919) % 97
    return p


def _nodes(m, its, n, bound=(), daemons_on=(), labels=None):
    """n initialized nodes of the provisioner "default"; `bound` lists
    (node index, cpu) pods already running there, `daemons_on` the nodes
    that already run a daemonset pod, `labels(e)` extra labels of node e."""
    out = []
    for e in range(n):
        it = its[(3 * e) % len(its)]
        node = m.t.make_node(
            name=f"node-{e}",
            labels={PROV: "default", "karpenter.sh/initialized": "true",
                    "node.kubernetes.io/instance-type": it.name,
                    ZONE: f"test-zone-{1 + e % 3}", CT: "on-demand",
                    **(labels(e) if labels else {})},
            capacity={k: str(v) for k, v in it.capacity.items()},
        )
        sn = m.node(node)
        for b, (e_b, cpu) in enumerate(bound):
            if e_b == e:
                running = m.t.make_pod(name=f"running-{e}-{b}", requests={"cpu": cpu})
                sn.update_for_pod(running)
        if e in daemons_on:
            sn.update_for_pod(m.t.make_pod(
                name=f"ds-pod-{e}", owner_kind="DaemonSet",
                requests={"cpu": "0.25", "memory": "128Mi"}))
        out.append(sn)
    return out


def workload(family, pkg):
    """(pods, provisioners, instance types, daemonset pods, state nodes,
    max_nodes, kube client, cluster) for one family, built with `pkg`'s
    builders; the client and cluster are None but for the cluster
    family."""
    if family in ("cluster", "ports_vols"):
        return cluster_workload(_mods(pkg), family, topology=family == "cluster")
    return _workload(family, pkg) + (None, None)


def _workload(family, pkg):
    m = _mods(pkg)
    its = m.fake.instance_types(16)
    if family == "mixed":
        taint = m.o.Taint(key="dedicated", value="batch", effect="NoSchedule")
        tol = m.o.Toleration(key="dedicated", operator="Equal", value="batch")
        provs = [
            m.t.make_provisioner(
                name="spot", weight=100, limits={"cpu": "24"},
                requirements=[m.o.NodeSelectorRequirement(CT, "In", ["spot"])]),
            m.t.make_provisioner(name="batch", weight=50, taints=[taint],
                                 labels={"team": "batch"}),
            m.t.make_provisioner(name="default", weight=10),
        ]
        pods = []
        for i in range(96):
            kind = i % 8
            kw = {"requests": {"cpu": str(0.5 * (1 + i % 4)), "memory": f"{1 + i % 3}Gi"}}
            if kind == 1:
                kw["node_selector"] = {ZONE: f"test-zone-{1 + i % 3}"}
            elif kind == 2:
                kw["node_affinity_required"] = [_term(m, (ZONE, "NotIn", ["test-zone-1"]))]
            elif kind == 3:
                kw["node_affinity_required"] = [_term(m, ("special", "DoesNotExist", []))]
            elif kind == 4:
                kw["node_affinity_required"] = [
                    _term(m, ("integer", "Gt", ["4"]), ("integer", "Lt", ["12"]))]
            elif kind == 5:
                kw["tolerations"] = [tol]
                kw["node_selector"] = {"team": "batch"}
            elif kind == 6:
                kw["init_requests"] = {"cpu": "3"}
            elif kind == 7 and i % 16 == 7:
                kw["requests"] = {"cpu": "100"}  # fits no type
            pods.append(_pod(m, family, i, **kw))
        daemons = [
            m.t.make_pod(name="ds-a", requests={"cpu": "0.25", "memory": "128Mi"}),
            m.t.make_pod(name="ds-b", requests={"cpu": "0.5"}, tolerations=[tol]),
        ]
        nodes = _nodes(m, its, 6, bound=[(0, "1000m"), (2, "15")], daemons_on=(1, 3))
        its_map = {"spot": its, "batch": its, "default": its}
        return pods, provs, its_map, daemons, nodes, 64
    if family == "relax":
        soft = m.o.Taint(key="soft", value="", effect="PreferNoSchedule")
        provs = [m.t.make_provisioner(name="default", taints=[soft])]
        pods = []
        for i in range(40):
            kind = i % 4
            kw = {"requests": {"cpu": "1", "memory": "1Gi"}}
            if kind == 0:
                kw["node_affinity_required"] = [
                    _term(m, (ZONE, "In", ["nowhere"])),
                    _term(m, (ZONE, "In", ["test-zone-2"])),
                ]
            elif kind == 1:
                kw["node_affinity_preferred"] = [
                    _pref(m, 10, ("integer", "In", ["99"])),
                    _pref(m, 5, (ZONE, "In", ["test-zone-3"])),
                ]
            elif kind == 2:
                kw["node_selector"] = {"team": "ghost"}  # unschedulable
            pods.append(_pod(m, family, i, **kw))
        return pods, provs, {"default": its}, [], [], 32
    if family == "bulk":
        provs = [m.t.make_provisioner(name="default")]
        pods = [
            _pod(m, family, i, labels={"app": f"gen-{i % 12}"},
                 requests={"cpu": str(1 + i % 12 % 3), "memory": "1Gi"})
            for i in range(240)
        ]
        nodes = _nodes(m, its, 9, bound=[(1, "1"), (4, "7")])
        return pods, provs, {"default": its}, [], nodes, 128
    if family == "wide":
        # selector-scoped replicas (their commits rewrite verdict rows) on
        # tiny types: one bulk commit touches more than 32 existing rows,
        # and one open spans more than 64 fresh slots
        small = m.fake.instance_types(3)
        provs = [m.t.make_provisioner(name="default")]
        pods = [
            _pod(m, family, i, node_selector={CT: "on-demand"},
                 requests={"cpu": "1", "memory": "256Mi"})
            for i in range(400)
        ] + [_pod(m, family, 400 + i, requests={"cpu": "0.5"}) for i in range(30)]
        nodes = _nodes(m, small, 48)
        return pods, provs, {"default": small}, [], nodes, 512
    if family == "spread":
        return _spread(m, family, its)
    if family == "affinity":
        return _affinity(m, family, its)
    if family == "anti":
        return _anti(m, family, its)
    if family == "refmix":
        pods, provs, its_map = reference_mix(m, 280, 16, distinct=12, tag=family)
        return pods, provs, its_map, [], _nodes(m, its_map["default"], 9), 128
    raise ValueError(family)


def _sel(m, app):
    return m.o.LabelSelector(match_labels={"app": app})


def _spread(m, family, its):
    """Zonal and hostname spreads with maxSkew 1 and 2; a ScheduleAnyway
    spread over a key no provisioner offers (blocked, then relaxed away);
    big pods whose only fitting type is offered in two of the three zones
    (the third zone is retired as dead); a spread whose node filter
    (nodeSelector) excludes some of the pods it selects; a provisioner
    limit (the water-fill runs degraded)."""
    big = m.fake.new_instance_type(
        "big-2z", resources={"cpu": 40.0, "memory": float(80 * 2**30), "pods": 50.0},
        offerings=[m.types.Offering("on-demand", "test-zone-1", 4.0),
                   m.types.Offering("on-demand", "test-zone-2", 4.0)])
    its = its[:12] + [big]
    provs = [m.t.make_provisioner(name="default", limits={"cpu": "400"})]
    tsc = m.o.TopologySpreadConstraint
    z1 = tsc(1, ZONE, "DoNotSchedule", _sel(m, "z1"))
    z2 = tsc(2, ZONE, "DoNotSchedule", _sel(m, "z2"))
    h1 = tsc(1, HOST, "DoNotSchedule", _sel(m, "h1"))
    h2 = tsc(2, HOST, "DoNotSchedule", _sel(m, "h2"))
    rack = tsc(1, "rack", "ScheduleAnyway", _sel(m, "rack"))
    zbig = tsc(2, ZONE, "DoNotSchedule", _sel(m, "zbig"))
    zsel = tsc(1, ZONE, "DoNotSchedule", _sel(m, "zsel"))
    pods = []
    for i in range(150):
        kind = i % 10
        if kind in (0, 1):
            kw = dict(labels={"app": "z1"}, topology_spread=[z1],
                      requests={"cpu": str(1 + i % 3)})
        elif kind == 2:
            kw = dict(labels={"app": "z2"}, topology_spread=[z2],
                      requests={"cpu": "1", "memory": "1Gi"})
        elif kind == 3:
            kw = dict(labels={"app": "h1"}, topology_spread=[h1], requests={"cpu": "2"})
        elif kind == 4:
            kw = dict(labels={"app": "h2"}, topology_spread=[h2], requests={"cpu": "1"})
        elif kind == 5:
            kw = dict(labels={"app": "rack"}, topology_spread=[rack],
                      requests={"cpu": "1"})
        elif kind == 6 and i % 20 == 6:
            kw = dict(labels={"app": "zbig"}, topology_spread=[zbig],
                      requests={"cpu": "20"})
        elif kind == 7:
            # selected by z1's group without owning it
            kw = dict(labels={"app": "z1"}, requests={"cpu": "3"},
                      node_selector={ZONE: "test-zone-2"})
        elif kind == 8 and i % 20 == 8:
            kw = dict(labels={"app": "zsel"}, topology_spread=[zsel],
                      node_selector={CT: "on-demand"}, requests={"cpu": "1"})
        elif kind == 8:
            # selected by zsel's group, outside its node filter
            kw = dict(labels={"app": "zsel"}, node_selector={CT: "spot"},
                      requests={"cpu": "1"})
        else:
            kw = dict(labels={"app": f"gen-{i % 4}"}, requests={"cpu": "1"})
        pods.append(_pod(m, family, i, **kw))
    nodes = _nodes(m, its, 6, labels=lambda e: {"rack": f"r{e % 2}"})
    return pods, provs, {"default": its}, [], nodes, 96


def _affinity(m, family, its):
    """Zonal and hostname pod affinity whose pods select themselves (the
    first placement seeds the domain), zonal and hostname followers of a
    plain deployment, and a preferred term that relaxes."""
    provs = [m.t.make_provisioner(name="default")]
    term = m.o.PodAffinityTerm
    zaff = term(topology_key=ZONE, label_selector=_sel(m, "za"))
    haff = term(topology_key=HOST, label_selector=_sel(m, "ha"))
    web = term(topology_key=ZONE, label_selector=_sel(m, "web"))
    hweb = term(topology_key=HOST, label_selector=_sel(m, "web"))
    ghost = m.o.WeightedPodAffinityTerm(
        weight=10, pod_affinity_term=term(topology_key=ZONE,
                                          label_selector=_sel(m, "ghost")))
    pods = []
    for i in range(140):
        kind = i % 7
        if kind in (0, 1):
            kw = dict(labels={"app": "za"}, pod_affinity_required=[zaff],
                      requests={"cpu": "1"})
        elif kind == 2:
            kw = dict(labels={"app": "ha"}, pod_affinity_required=[haff],
                      requests={"cpu": "0.5"})
        elif kind == 3:
            kw = dict(labels={"app": "web"}, requests={"cpu": "2", "memory": "1Gi"})
        elif kind == 4:
            kw = dict(labels={"app": "follow"},
                      pod_affinity_required=[web if i % 2 else hweb],
                      requests={"cpu": "1"})
        elif kind == 5:
            kw = dict(labels={"app": "pref"}, pod_affinity_preferred=[ghost],
                      requests={"cpu": "1"})
        else:
            kw = dict(labels={"app": f"gen-{i % 3}"}, requests={"cpu": "1"})
        pods.append(_pod(m, family, i, **kw))
    return pods, provs, {"default": its}, [], _nodes(m, its, 6), 96


def _anti(m, family, its):
    """A hostname anti-affinity service that selects itself (bulk over the
    machine region), an owner that does not match its own selector
    (expanded to one item per pod), a zonal anti group, followers that
    are selected only, and beside them (in the machine-region geometry) a
    zonal spread cohort and hostname pod affinity."""
    provs = [m.t.make_provisioner(name="default")]
    term = m.o.PodAffinityTerm
    svc = term(topology_key=HOST, label_selector=_sel(m, "svc"))
    other = term(topology_key=HOST, label_selector=_sel(m, "svc"))
    zanti = term(topology_key=ZONE, label_selector=_sel(m, "zanti"))
    haff = term(topology_key=HOST, label_selector=_sel(m, "ha"))
    zonal = m.o.TopologySpreadConstraint(1, ZONE, "DoNotSchedule", _sel(m, "spread"))
    pods = []
    for i in range(150):
        kind = i % 8
        if kind in (0, 1):
            kw = dict(labels={"app": "svc"}, pod_anti_affinity_required=[svc],
                      requests={"cpu": "1"})
        elif kind == 2:
            kw = dict(labels={"app": "loner"}, pod_anti_affinity_required=[other],
                      requests={"cpu": "0.5"})
        elif kind == 3 and i % 24 == 3:
            kw = dict(labels={"app": "zanti"}, pod_anti_affinity_required=[zanti],
                      requests={"cpu": "1"})
        elif kind == 4:
            kw = dict(labels={"app": "svc"}, requests={"cpu": "0.5"})
        elif kind == 5:
            kw = dict(labels={"app": "spread"}, topology_spread=[zonal],
                      requests={"cpu": "1"})
        elif kind == 6 and i % 16 == 6:
            kw = dict(labels={"app": "ha"}, pod_affinity_required=[haff],
                      requests={"cpu": "0.5"})
        else:
            kw = dict(labels={"app": f"gen-{i % 5}"}, requests={"cpu": "1"})
        pods.append(_pod(m, family, i, **kw))
    return pods, provs, {"default": its}, [], _nodes(m, its, 6), 128


def reference_mix(m, n_pods, n_types, distinct=1, tag="mix"):
    """The upstream benchmark's diverse mix (scheduling_benchmark_test.go:
    187-199), as bench.py's _reference_mix builds it: 1/7 zonal spread,
    1/7 hostname spread, 2/7 zonal pod affinity, 3/7 generic pods in
    `distinct` label classes; names, uids and creation times pinned."""
    tsc = m.o.TopologySpreadConstraint
    zonal = tsc(1, ZONE, "DoNotSchedule", _sel(m, "spread"))
    hostname = tsc(1, HOST, "DoNotSchedule", _sel(m, "hspread"))
    affinity = m.o.PodAffinityTerm(topology_key=ZONE, label_selector=_sel(m, "aff"))
    pods = []
    for i in range(n_pods):
        kind = i % 7
        if kind == 0:
            kw = dict(labels={"app": "spread"}, requests={"cpu": "1"},
                      topology_spread=[zonal])
        elif kind == 1:
            kw = dict(labels={"app": "hspread"}, requests={"cpu": "1"},
                      topology_spread=[hostname])
        elif kind in (2, 3):
            kw = dict(labels={"app": "aff"}, requests={"cpu": "1"},
                      pod_affinity_required=[affinity])
        else:
            kw = dict(labels={"app": f"gen-0-{i % max(distinct, 1)}"},
                      requests={"cpu": "1", "memory": "1Gi"})
        p = m.t.make_pod(name=f"{tag}-{i}", **kw)
        p.metadata.uid = f"uid-{tag}-{i:06d}"
        p.metadata.creation_timestamp = 1000.0
        pods.append(p)
    return pods, [m.t.make_provisioner(name="default")], {
        "default": m.fake.instance_types(n_types)}


EBS = "ebs.csi.aws.com"


def cluster_workload(m, family, n_nodes=9, n_pending=280, n_types=16, topology=True):
    """A live cluster: nodes registered through a Cluster with CSINode
    attach limits, bound pods in the kube client (claims, host ports,
    spread and affinity cohorts skewed over the zones, a pod in another
    namespace, terminal and terminating pods, a bound copy of one batch
    pod, zonal anti-affinity against one generic class), and a pending
    batch of the reference mix plus host-port pods (wildcard, specific
    IP, UDP), StatefulSet-like claim pods, a shared claim, a claim bound
    to a PV of another driver, a claim of an unknown class and a missing
    claim. topology=False (the ports_vols family) leaves out every spread,
    affinity and anti-affinity pod, bound or pending: the pending batch is
    the mix's generic classes, so the solve has no topology group."""
    client = m.client()
    cluster = m.cluster(client)
    client.create(m.t.make_storage_class("ebs", provisioner=EBS))
    client.create(m.t.make_pv("pv-efs", driver="efs.csi.aws.com"))
    its = m.fake.instance_types(n_types)
    for e in range(n_nodes):
        it = its[(3 * e + 5) % len(its)]
        node = m.t.make_node(
            name=f"node-{e}",
            labels={PROV: "default", "karpenter.sh/initialized": "true",
                    "node.kubernetes.io/instance-type": it.name,
                    ZONE: f"test-zone-{1 + e % 3}", CT: "on-demand"},
            capacity={k: str(v) for k, v in it.capacity.items()},
        )
        client.create(node)
        if e % 4 != 3:
            client.create(m.t.make_csinode(f"node-{e}", EBS, allocatable=2 + e % 3))
        cluster.update_node(node)

    def bound(e, j, **kw):
        p = m.t.make_pod(name=f"bound-{e}-{j}", node_name=f"node-{e}",
                         unschedulable=False, phase=kw.pop("phase", "Running"),
                         requests={"cpu": "0.25"}, **kw)
        p.metadata.uid = f"uid-bound-{e}-{j}"
        p.metadata.creation_timestamp = 900.0
        return p

    zonal_spread = m.o.TopologySpreadConstraint(1, ZONE, "DoNotSchedule", _sel(m, "spread"))
    guard = m.o.PodAffinityTerm(topology_key=ZONE, label_selector=_sel(m, "gen-0-1"))
    running = []
    for e in range(n_nodes):
        zone = e % 3
        for j in range(e % 4):  # e % 4 claims; node 2 sits at its limit of 2
            claim = f"data-{e}-{j}"
            client.create(m.t.make_pvc(claim, storage_class="ebs"))
            p = bound(e, f"v{j}")
            p.spec.volumes.append(m.t.pvc_volume(claim))
            running.append(p)
        if e % 3 == 0:
            p = bound(e, "port", host_ports=[443])
            if e == 3:
                p.spec.containers[0].ports[0].host_ip = "10.0.0.3"
            running.append(p)
        if not topology:
            continue
        # zonal-spread cohort skewed 3 : 2 : 1, hostname spread on one node,
        # the affinity cohort's matches in zone 2 only
        running += [bound(e, f"s{j}", labels={"app": "spread"}) for j in range(3 - zone)]
        if e == 4:
            running.append(bound(e, "h", labels={"app": "hspread"}))
        if zone == 1:
            running.append(bound(e, "a", labels={"app": "aff"}))
        if e == 5:
            running.append(bound(e, "guard", labels={"app": "guard"},
                                 pod_anti_affinity_required=[guard]))
    # not counted: another namespace, terminal, terminating
    running.append(bound(0, "ns", labels={"app": "spread"}, namespace="other"))
    running.append(bound(1, "done", labels={"app": "spread"}, phase="Succeeded"))
    term = bound(2, "term", labels={"app": "spread"})
    term.metadata.deletion_timestamp = 1.0
    running.append(term)

    pods, provs, its_map = reference_mix(m, n_pending, n_types, distinct=3, tag=family)
    if not topology:
        pods = [p for p in pods if p.metadata.labels.get("app", "").startswith("gen-")]
    udp = m.o.ContainerPort(host_port=53, protocol="UDP")
    extra = []
    for i in range(32):
        kind = i % 8
        # larger than the mix: first in FFD order, onto the existing nodes
        kw = {"requests": {"cpu": "2", "memory": "2Gi"}}
        if kind in (0, 1):
            kw["host_ports"] = [443]
        elif kind == 2:
            kw["host_ports"] = [8080]
        p = _pod(m, f"{family}-x", i, labels={"app": f"sts-{i % 3}"}, **kw)
        if kind == 3:
            p.spec.containers[0].ports.append(udp)
        elif kind == 2 and i % 16 == 2:
            p.spec.containers[0].ports[0].host_ip = "10.0.0.9"
        elif kind in (4, 5):
            claim = f"sts-{i}"
            client.create(m.t.make_pvc(claim, storage_class="ebs"))
            p.spec.volumes.append(m.t.pvc_volume(claim))
        elif kind == 6:
            p.spec.volumes.append(m.t.pvc_volume("shared"))
        elif kind == 7:
            p.spec.volumes.append(m.t.pvc_volume(
                ("efs-claim", "no-class", "missing")[i // 8 % 3]))
        extra.append(p)
    client.create(m.t.make_pvc("shared", storage_class="ebs"))
    client.create(m.t.make_pvc("efs-claim", storage_class="ebs", volume_name="pv-efs"))
    client.create(m.t.make_pvc("no-class", storage_class="ghost"))
    pods = pods + extra
    # a batch pod the client still shows bound: excluded from the counts
    stale = copy.deepcopy(pods[0])
    stale.spec.node_name = "node-1"
    stale.status.phase = "Running"
    running.append(stale)
    for p in running:
        client.create(p)
        cluster.update_pod(p)
    return pods, provs, its_map, [], cluster.nodes(), 128, client, cluster


FAMILIES = ("mixed", "relax", "bulk", "wide", "spread", "affinity", "anti", "refmix",
            "cluster")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _random_case(rng, n_slots, n_items, segments):
    V, K = segments[-1][1], len(segments)
    slot = {"allow": rng.random((n_slots, V)) < 0.7,
            "out": rng.random((n_slots, K)) < 0.3,
            "defined": rng.random((n_slots, K)) < 0.6}
    items = {"allow": rng.random((n_items, V)) < 0.6,
             "out": rng.random((n_items, K)) < 0.3,
             "defined": rng.random((n_items, K)) < 0.7,
             "escape": rng.random((n_items, K)) < 0.2,
             "custom_deny": rng.random((n_items, K)) < 0.2}
    return ({k: torch.from_numpy(v) for k, v in slot.items()},
            {k: torch.from_numpy(v) for k, v in items.items()})


def _segments(lengths):
    b = np.cumsum([0] + list(lengths))
    return [(int(x), int(y)) for x, y in zip(b[:-1], b[1:])]


# empty keys and a 1,300-value key: 48 words, many double-buffered stages
WIDE = _segments([3, 0, 7, 30, 1, 1300, 2, 0, 90])
# 40 keys: two-word key bitmasks
MANY = _segments(np.random.default_rng(4).integers(0, 40, size=40))
# the forms' shapes: block, J x C template rows, N = 1 against C items, B = 1
SCREEN_SHAPES = [(1037, 333), (3, 2048), (1, 2048), (1024, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("every_key", [False, True])
def test_screen_kernel_matches_plain_on_card(every_key):
    _card()
    rng = np.random.default_rng(11)
    for segments in (WIDE, MANY):
        V = segments[-1][1]
        for N, B in SCREEN_SHAPES:
            slot, items = _random_case(rng, N, B, segments)
            cuda = {k: v.cuda() for k, v in slot.items()}
            for width in (V, V - 95, 40):
                layout = screen.ScreenLayout(segments, width, every_key=every_key)
                c_items = screen.ScreenItems({k: v.cuda() for k, v in items.items()}, layout)
                want = screen.screen_block(slot["allow"], slot["out"], slot["defined"],
                                           screen.ScreenItems(items, layout), layout)
                got = screen.screen_block(cuda["allow"], cuda["out"], cuda["defined"],
                                          c_items, layout)
                torch.cuda.synchronize()
                np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(),
                                              err_msg=f"{N}x{B} width {width}")
                for b in {0, B // 2, B - 1}:
                    row = screen.screen_row(cuda["allow"], cuda["out"], cuda["defined"],
                                            c_items, b, layout)
                    np.testing.assert_array_equal(row.cpu().numpy(), want[:, b].numpy())


@pytest.mark.cuda
def test_screen_prep_matches_plain_on_card():
    _card()
    rng = np.random.default_rng(12)
    for segments in (WIDE, MANY):
        V = segments[-1][1]
        slot, items = _random_case(rng, 517, 203, segments)
        for width in (V, V // 2):
            layout = screen.ScreenLayout(segments, width)
            for planes, item_side in ((slot, False), (items, True)):
                extra = ({"escape": planes["escape"], "custom_deny": planes["custom_deny"]}
                         if item_side else {})
                want = screen.screen_prep_plain(planes["allow"], planes["out"],
                                                planes["defined"], layout, **extra)
                cuda = {k: v.cuda() for k, v in planes.items()}
                got = screen.screen_prep(cuda["allow"], cuda["out"], cuda["defined"], layout,
                                         **{k: cuda[k] for k in extra})
                torch.cuda.synchronize()
                for name in ("words", "bytes", "flags"):
                    assert torch.equal(got[name].cpu(), want[name]), (name, item_side, width)
                part = screen.screen_prep(cuda["allow"], cuda["out"], cuda["defined"],
                                          layout, words=False, **{k: cuda[k] for k in extra})
                assert part["words"] is None
                assert torch.equal(part["flags"].cpu(), want["flags"])


@pytest.mark.cuda
def test_screen_launches_per_form_on_card():
    """Every form issues at most two launches per call (prep of the slot
    side, then the screen); the item side is prepared once, when its
    ScreenItems is made."""
    _card()
    rng = np.random.default_rng(13)
    layout = screen.ScreenLayout(WIDE, WIDE[-1][1])
    for (N, B), form in zip(SCREEN_SHAPES, ("block", "block", "row_n1", "row_b1")):
        slot, items = _random_case(rng, N, B, WIDE)
        cuda = {k: v.cuda() for k, v in slot.items()}
        screen.reset_launches()
        c_items = screen.ScreenItems({k: v.cuda() for k, v in items.items()}, layout)
        assert screen.LAUNCHES == {"screen": 0, "screen_prep": 1, "pack_scan": 0}
        screen.screen_block(cuda["allow"], cuda["out"], cuda["defined"], c_items, layout)
        assert screen.LAUNCHES == {"screen": 1, "screen_prep": 2, "pack_scan": 0}
        assert screen.FORM_LAUNCHES[form] == 1 and sum(screen.FORM_LAUNCHES.values()) == 1
        screen.screen_row(cuda["allow"], cuda["out"], cuda["defined"], c_items, B - 1, layout)
        assert screen.LAUNCHES == {"screen": 2, "screen_prep": 3, "pack_scan": 0}
        assert screen.FORM_LAUNCHES["row_b1"] == 1 + (form == "row_b1")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_screen_wrapper_rejects_bad_inputs_on_card():
    _card()
    layout = screen.ScreenLayout([(0, 4)], 4)
    items = screen.ScreenItems({k: torch.zeros((2, 4 if k == "allow" else 1),
                                               dtype=torch.bool, device="cuda")
                                for k in screen.ITEM_KEYS}, layout)
    allow = torch.ones((3, 4), dtype=torch.bool, device="cuda")
    defined = torch.zeros((3, 1), dtype=torch.bool, device="cuda")
    with pytest.raises(TypeError):
        screen.screen_block(allow, defined.to(torch.uint8), defined, items, layout)
    with pytest.raises(ValueError):
        screen.screen_block(allow[:, :2], defined, defined, items, layout)
    with pytest.raises(IndexError):
        screen.screen_row(allow, defined, defined, items, 2, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_card_and_cpu_scan_state_bit_identical(family):
    """The prescreen tensor, commit log and every PackState field of one
    device solve, on the card and on the CPU from the same arrays; float
    slot state compares bit for bit."""
    _card()
    from karpenter_core_tpu_torch.ops.pack import make_prescreen_kernel
    from karpenter_core_tpu_torch.solver.encode import encode_snapshot

    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload(family, "torch")
    snap = encode_snapshot(pods, provs, its, daemons, nodes, client, cluster,
                           max_nodes=max_nodes)
    geom = tsolver.solve_geometry(snap, max_nodes)
    N, segs, zs, cs, log_len, screen_v = (geom[7], geom[8], geom[9], geom[10],
                                          geom[12], geom[16])
    args = tsolver.device_args(snap, provs)
    out = {}
    for dev in ("cpu", "cuda"):
        targs = tsolver.args_to_torch(args, dev)
        scr = make_prescreen_kernel(segs, N, screen_v=screen_v)(targs[0], targs[9])
        log, ptr, state = tsolver.make_device_run(
            segs, zs, cs, snap.topo_meta, N, log_len, screen_v=screen_v)(scr, *targs)
        out[dev] = (scr.cpu(), log, ptr, state)
    (s_cpu, l_cpu, p_cpu, st_cpu), (s_gpu, l_gpu, p_gpu, st_gpu) = out["cpu"], out["cuda"]
    assert torch.equal(s_cpu, s_gpu)
    assert p_cpu == p_gpu and l_cpu["bulk_n"] == l_gpu["bulk_n"]
    for k in ("item", "slot", "ns", "k", "k_last"):
        np.testing.assert_array_equal(l_cpu[k], l_gpu[k], err_msg=k)
    assert torch.equal(l_cpu["bulk_take"], l_gpu["bulk_take"].cpu())
    for name in st_cpu._fields:
        a, b = getattr(st_cpu, name), getattr(st_gpu, name).cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_card_and_cpu_placements_identical(family):
    _card()
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload(family, "torch")
    got = {}
    for dev in ("cpu", "cuda"):
        result = tsolver.TorchSolver(max_nodes=max_nodes, device=dev).solve(
            copy.deepcopy(pods), provs, its, daemonset_pods=daemons, state_nodes=nodes,
            kube_client=client, cluster=cluster)
        got[dev] = tsolver.placements_json(result)
    assert got["cpu"] == got["cuda"]


@pytest.mark.cuda
def test_card_segmented_scan_matches_cpu():
    """The segmented scan on the card against the CPU over selector-scoped
    pools with existing nodes per pool (tests/test_segmented.py's shape):
    equal placements and last_segment_stats (segment_ms aside), and equal
    to the card's sequential scan."""
    _card()
    m = _mods("torch")
    universe = m.fake.instance_types(6)
    provs, its = m.t.make_pool_provisioners(4, universe)
    rng = np.random.default_rng(3)
    nodes = [m.node(m.t.make_node(
        name=f"seg-n-{e}",
        labels={PROV: f"pool-{e % 4}", "karpenter.sh/initialized": "true",
                "node.kubernetes.io/instance-type": universe[e % 6].name, CT: "on-demand",
                ZONE: "test-zone-1", "team": f"pool-{e % 4}"},
        capacity={k: str(v) for k, v in universe[e % 6].capacity.items()}))
        for e in range(8)]
    pods = []
    for i in range(160):
        p = int(rng.integers(4))
        pods.append(_pod(m, "seg", i, labels={"app": f"dep-{p}-{int(rng.integers(8))}"},
                         requests={"cpu": str(0.25 + 0.25 * int(rng.integers(3)))},
                         node_selector={"team": f"pool-{p}"}))
    got, stats = {}, {}
    for dev, scan in (("cpu", "segmented"), ("cuda", "segmented"), ("cuda", "sequential")):
        solver = tsolver.TorchSolver(max_nodes=96, device=dev, pack_scan=scan)
        result = solver.solve(copy.deepcopy(pods), provs, its,
                              state_nodes=[n.deep_copy() for n in nodes])
        got[(dev, scan)] = tsolver.placements_json(result)
        stats[(dev, scan)] = {k: v for k, v in (solver.last_segment_stats or {}).items()
                              if k != "segment_ms"}
    assert len(set(got.values())) == 1
    assert stats[("cpu", "segmented")] == stats[("cuda", "segmented")]
    assert stats[("cuda", "segmented")]["mode"] == "segmented"


@pytest.mark.cuda
@pytest.mark.parametrize("rb, cb", [(8, 8), (16, 0), (0, 16), (8, 1)])
def test_card_and_cpu_refresh_identical(rb, cb):
    """The delta refresh of a stale resident tensor on seeded planes, on
    the card and on the CPU: rb changed rows and cb changed columns, with
    indices outside the tensor that must be dropped."""
    _card()
    from karpenter_core_tpu_torch.ops.pack import ScreenOps, class_planes, screen_refresh

    rng = np.random.default_rng(21 + rb + cb)
    segments = _segments([3, 0, 40, 1, 300, 7, 90])
    E, I, C, N = 300, 200, 150, 700
    slot, items = _random_case(rng, E, I, segments)
    items["scls_first"] = torch.from_numpy(rng.permutation(I)[:C].astype(np.int32))
    prev = torch.from_numpy(rng.random((N, C)) < 0.5)
    rows = np.r_[rng.integers(0, E, size=rb), E, N - 1, -1][: rb + 3 * (rb > 0)]
    cols = np.r_[rng.integers(0, C, size=cb), C, -1][: cb + 2 * (cb > 0)]

    def refresh(scr, its, exist, screen_v):
        ops = ScreenOps(segments, its["allow"].shape[1], screen_v)
        return screen_refresh(scr, ops, class_planes(its, ops), exist, rows, cols)

    for screen_v in (None, 350):
        want = refresh(prev.clone(), items, slot, screen_v)
        got = refresh(prev.cuda(), {k: v.cuda() for k, v in items.items()},
                      {k: v.cuda() for k, v in slot.items()}, screen_v)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), screen_v
        assert not torch.equal(want, prev), screen_v


@pytest.mark.cuda
def test_card_tiered_solve_matches_cpu():
    """A tiered solve on the card (the row_b1 form once per item) places
    as the CPU's tiered and prescreen solves do."""
    _card()
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload("cluster", "torch")
    got = {}
    for dev, mode in (("cuda", "tiered"), ("cpu", "tiered"), ("cpu", "prescreen")):
        screen.reset_launches()
        result = tsolver.TorchSolver(max_nodes=max_nodes, device=dev, screen_mode=mode).solve(
            copy.deepcopy(pods), provs, its, daemonset_pods=daemons, state_nodes=nodes,
            kube_client=client, cluster=cluster)
        got[dev, mode] = tsolver.placements_json(result)
        if dev == "cuda":
            assert screen.FORM_LAUNCHES["row_b1"] > 0
            assert screen.FORM_LAUNCHES["block"] == 0
    assert len(set(got.values())) == 1


@pytest.mark.cuda
def test_card_incremental_resolve_matches_cpu_full():
    """Two solves of one cluster on the card with the incremental path on,
    a pod bound between them: the second refreshes the changed row and
    places as a full solve on the CPU does."""
    _card()
    from karpenter_core_tpu_torch.solver import incremental

    pods, provs, its, daemons, _nodes_, max_nodes, client, cluster = workload(
        "cluster", "torch")
    m = _mods("torch")
    inc = tsolver.TorchSolver(max_nodes=max_nodes, device="cuda")
    incremental.reset_outcomes()
    for step in range(2):
        if step:
            # a pod binds to node-0 and node-1 moves zone: one changed row
            p = m.t.make_pod(name="late", node_name="node-0", unschedulable=False,
                             phase="Running", requests={"cpu": "0.5"})
            client.create(p)
            cluster.update_pod(p)
            node = client.get("Node", "", "node-1")
            node.metadata.labels[ZONE] = "test-zone-3"
            cluster.update_node(client.update(node))
        kw = dict(daemonset_pods=daemons, state_nodes=cluster.nodes(), kube_client=client,
                  cluster=cluster)
        a = tsolver.placements_json(inc.solve(copy.deepcopy(pods), provs, its, **kw))
        b = tsolver.placements_json(tsolver.TorchSolver(
            max_nodes=max_nodes, device="cpu", incremental="off").solve(
            copy.deepcopy(pods), provs, its, **kw))
        assert a == b, step
    assert inc.last_prescreen_mode == "refresh"
    assert inc.last_prescreen_delta["rows"] == 1
    assert incremental.outcome_counts()["full_deg"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("screen_mode", ["prescreen", "tiered"])
def test_card_replan_matches_cpu(screen_mode):
    """replan_screen on the card gives the CPU port's verdicts and per-slot
    counts exactly, with an uninitialized node among the existing ones;
    the card's replan launches the screen."""
    _card()
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload("cluster", "torch")
    got = []
    for dev in ("cuda", "cpu"):
        solver = tsolver.TorchSolver(max_nodes=max_nodes, device=dev, screen_mode=screen_mode)
        snap = solver.encode(pods, provs, its, daemons, nodes, client, cluster)
        count_rows, exist_open = tt.subset_planes(snap, 11)
        uninit = np.zeros(len(snap.state_nodes), bool)
        uninit[1] = True
        screen.reset_launches()
        got.append(solver.replan_screen(snap, provs, count_rows, exist_open,
                                        uninitialized=uninit, want_slots=True))
        if dev == "cuda":
            form = "block" if screen_mode == "prescreen" else "row_b1"
            assert screen.FORM_LAUNCHES[form] > 0
    (cv, cp), (hv, hp) = got
    assert cv.shape == (11, 4) and np.array_equal(cv, hv)
    assert np.array_equal(cp, hp)
    assert cv[:, 0].sum() > 0


def _deprovisioning_run(device):
    """Expiration then consolidation through testing.ControlLoop on
    `device`: 8 nodes with bound pods, the oldest two expired, one node
    holding a spot-only pod (its expiry needs a replacement machine). Each
    pass's Command (deprovisioner, action, removed nodes, the
    replacements' options) and the final cluster, with launched machines
    compared by type, zone and capacity type."""
    from karpenter_core_tpu_torch.api.labels import LABEL_NODE_INITIALIZED
    from karpenter_core_tpu_torch.kube.objects import LABEL_INSTANCE_TYPE_STABLE

    clock = tt.FakeClock()
    client = TClient()
    cp = tfake.FakeCloudProvider(tfake.instance_types(10))
    loop = tt.ControlLoop(client, cp, tsolver.TorchSolver(max_nodes=64, device=device),
                          clock=clock, validation_ttl=0.0)
    client.create(tt.make_provisioner(name="default", ttl_seconds_until_expired=3600,
                                      consolidation_enabled=True))
    for e in range(8):
        it = f"fake-it-{3 + e % 7}"
        node = tt.make_node(name=f"node-{e}", labels={
            PROV: "default", LABEL_NODE_INITIALIZED: "true", LABEL_INSTANCE_TYPE_STABLE: it,
            CT: "on-demand", ZONE: f"test-zone-{1 + e % 3}"},
            capacity={"cpu": str(4 + e % 7), "memory": "20Gi", "pods": "100"})
        node.metadata.creation_timestamp = clock() - (9000 - e if e < 2 else 100)
        client.create(node)
        for j in range(1 + e % 3):
            p = _pod(_mods("torch"), f"run-{e}", j, node_name=node.name, unschedulable=False,
                     phase="Running", requests={"cpu": "0.5"}, owner_kind="ReplicaSet")
            if e == 0 and j == 0:
                p.spec.node_selector = {CT: "spot"}
            client.create(p)
    commands = []
    real = loop.deprovisioning.execute_command

    def execute(dep, cmd):
        commands.append((str(dep), cmd.action, [n.name for n in cmd.nodes_to_remove],
                         [sorted(it.name for it in m.instance_type_options)
                          for m in cmd.replacement_machines]))
        real(dep, cmd)

    loop.deprovisioning.execute_command = execute
    loop.step()  # the termination finalizers
    for _ in range(3):
        loop.sync()
        loop.deprovisioning.reconcile()
        for _ in range(3):
            loop.step()
            for node in client.list("Node"):  # the kubelet of launched nodes
                if node.name.startswith("fake-machine-") and not node.ready():
                    machine = client.get("Machine", "", node.name)
                    node.status.allocatable = dict(machine.status.allocatable)
                    node.status.conditions = [tobj.Condition(type="Ready", status="True")]
                    client.update_status(node)
    loop.sync()
    launched = lambda n: "<launched>" if n.startswith("fake-machine-") else n  # noqa: E731
    state = (
        sorted((launched(n.name), n.metadata.labels.get(LABEL_INSTANCE_TYPE_STABLE),
                n.metadata.labels.get(ZONE), n.metadata.labels.get(CT), n.spec.unschedulable)
               for n in client.list("Node")),
        sorted((p.metadata.name, launched(p.spec.node_name)) for p in client.list("Pod")),
        sorted((m.metadata.labels.get(LABEL_INSTANCE_TYPE_STABLE), m.metadata.labels.get(ZONE))
               for m in client.list("Machine")),
    )
    return commands, state


@pytest.mark.cuda
def test_card_deprovisioning_sequence_matches_cpu():
    """The deprovisioning chain executed on the card (its simulate solves
    and replan launch the screen) gives the CPU's Commands and leaves the
    CPU's cluster."""
    _card()
    screen.reset_launches()
    card = _deprovisioning_run("cuda")
    assert screen.FORM_LAUNCHES["block"] > 0 and screen.LAUNCHES["screen_prep"] > 0
    cpu = _deprovisioning_run("cpu")
    assert card == cpu
    assert card[0][0][:2] == ("expiration", "replace")


def _operator_run(device):
    """Two operator steps over a 6-node cluster and 40 pending pods (a
    zonal spread cohort and plain pods) on `device`, the kubelet played
    between them: the nodes, pods, launches' instance-type options, event
    reasons, counters and the counter's resources, launched nodes named by
    what they are."""
    from karpenter_core_tpu_torch.api.labels import LABEL_NODE_INITIALIZED
    from karpenter_core_tpu_torch.controllers.provisioning import provisioner
    from karpenter_core_tpu_torch.kube.objects import LABEL_INSTANCE_TYPE_STABLE
    from karpenter_core_tpu_torch.operator import new_operator

    provisioner.reset_counts()
    clock = tt.FakeClock()
    cp = tfake.FakeCloudProvider(tfake.instance_types(10))
    op = new_operator(cp, solver=tsolver.TorchSolver(max_nodes=64, device=device,
                                                     incremental="off"), clock=clock)
    client = op.kube_client
    client.create(tt.make_provisioner(name="default"))
    for e in range(6):
        node = tt.make_node(name=f"node-{e}", labels={
            PROV: "default", LABEL_NODE_INITIALIZED: "true",
            LABEL_INSTANCE_TYPE_STABLE: "fake-it-3", CT: "on-demand",
            ZONE: f"test-zone-{1 + e % 3}"},
            capacity={"cpu": "4", "memory": "8Gi", "pods": "40"})
        client.create(node)
    spread = [tobj.TopologySpreadConstraint(
        max_skew=1, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
        label_selector=tobj.LabelSelector(match_labels={"app": "web"}))]
    for i in range(40):
        kw = dict(labels={"app": "web"}, topology_spread=spread) if i % 2 else {}
        client.create(_pod(_mods("torch"), "op", i, requests={"cpu": "0.75"}, **kw))
    nominated = {}
    op.provisioning.bind_listeners.append(
        lambda p, n: nominated.setdefault(p.metadata.name, n))
    op.step()
    for node in client.list("Node"):  # the kubelet
        machine = client.get("Machine", "", node.name)
        if machine is not None and not node.ready():
            node.status.capacity = dict(machine.status.capacity)
            node.status.allocatable = dict(machine.status.allocatable)
            node.status.conditions = [tobj.Condition(type="Ready", status="True")]
            client.update_status(node)
    for pod in client.list("Pod"):
        if pod.metadata.name in nominated:
            pod.spec.node_name = nominated[pod.metadata.name]
            client.update(pod)
    op.step()

    def named(n):
        if not n.startswith("fake-machine-"):
            return n
        pods = sorted(k for k, v in nominated.items() if v == n)
        node = client.get("Node", "", n)
        return (node.metadata.labels.get(LABEL_INSTANCE_TYPE_STABLE), tuple(pods))

    return (
        sorted((str(named(n.name)), n.metadata.labels.get(LABEL_NODE_INITIALIZED))
               for n in client.list("Node")),
        sorted((p.metadata.name, str(named(p.spec.node_name))) for p in client.list("Pod")),
        sorted(sorted(r.values) for c in cp.create_calls for r in c.spec.requirements
               if r.key == "node.kubernetes.io/instance-type"),
        sorted((e.involved_kind, e.reason) for e in op.recorder.events),
        sorted((tuple(sorted(k.items())), v) for k, v in provisioner.LAUNCH_FAILURES.series()),
        provisioner.NODES_CREATED.get({"reason": "provisioning"}),
        sorted(client.get("Provisioner", "", "default").status.resources.items()),
    )


@pytest.mark.cuda
def test_card_operator_step_matches_cpu():
    """new_operator stepped with a TorchSolver on the card (its solve
    launches the screen) leaves the cluster the CPU's solver leaves."""
    _card()
    screen.reset_launches()
    card = _operator_run("cuda")
    assert screen.FORM_LAUNCHES["block"] > 0 and screen.LAUNCHES["screen_prep"] > 0
    cpu = _operator_run("cpu")
    assert card == cpu
    assert card[5] > 0 and not any(v for _labels, v in card[4])


@pytest.mark.cuda
def test_card_replays_a_cpu_flight_record():
    """A flight record of the cluster family taken on the CPU (begin, the
    solve, finish, JSON and back) replays on the card to the placements
    its replay on the CPU gives, byte for byte; the replay solver runs on
    the card by default."""
    import json

    from karpenter_core_tpu_torch.obs import flightrec

    _card()
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload("cluster", "torch")
    recorder = flightrec.FlightRecorder().enable()
    live = recorder.begin(pods, provs, its, daemons, nodes, kube_client=client,
                          max_nodes=max_nodes)
    live.finish("torch", tsolver.TorchSolver(max_nodes=max_nodes, device="cpu").solve(
        pods, provs, its, daemonset_pods=daemons, state_nodes=nodes, kube_client=client,
        cluster=cluster))
    record = json.loads(json.dumps(recorder.last()))
    assert record["inputs"]["clusterPods"]
    screen.reset_launches()
    card, result = flightrec.replay(record)
    assert screen.LAUNCHES["screen_prep"] > 0
    cpu, _ = flightrec.replay(record, device="cpu")
    assert flightrec.placements_json(card) == flightrec.placements_json(cpu)
    assert not result.failed_pods


@pytest.mark.cuda
def test_card_process_entry_serves_a_backlog():
    """operator/__main__.run() on the card at a small size: the S and M
    tiers prewarmed on the card (the screen launched), a 240-pod backlog
    over 101 types (past the small-batch bound, so the card's solver
    serves it) nominated through the ResilientSolver and the card probe,
    the endpoints served, and a clean stop."""
    import gc
    import json
    import os
    import threading
    import time
    import urllib.request

    from karpenter_core_tpu_torch.operator import __main__ as entry
    from karpenter_core_tpu_torch.operator.options import parse_options
    from karpenter_core_tpu_torch.solver import prewarm
    from karpenter_core_tpu_torch.utils import gctuning

    _card()
    threshold = gc.get_threshold()
    env = {k: os.environ.get(k) for k in ("KARPENTER_PREWARM", "KARPENTER_PREWARM_TIERS")}
    os.environ.update(KARPENTER_PREWARM="1", KARPENTER_PREWARM_TIERS="S,M")
    client = TClient()
    client.create(tt.make_provisioner(name="default"))
    stop, got = threading.Event(), {}
    screen.reset_launches()
    th = threading.Thread(target=lambda: got.update(op=entry.run(
        tfake.FakeCloudProvider(tfake.instance_types(101)), kube_client=client,
        stop_event=stop, options=parse_options(["--metrics-port", "0", "--enable-profiling",
                                                "--disable-webhook"]),
        on_start=lambda proc: got.update(proc=proc))))
    th.start()
    try:
        deadline = time.monotonic() + 300
        while prewarm.PREWARM_READY.get() != 1.0 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert prewarm.PREWARM_READY.get() == 1.0
        assert screen.LAUNCHES["screen_prep"] > 0
        proc = got["proc"]
        bound = {}
        proc.operator.provisioning.bind_listeners.append(
            lambda pod, node: bound.__setitem__(pod.metadata.name, node))
        names = [f"bl-{i}" for i in range(240)]
        for i, name in enumerate(names):
            client.create(tt.make_pod(name=name, requests={"cpu": ["250m", "1"][i % 2]},
                                      uid=f"uid-bl-{i}"))
        while not set(names) <= set(bound) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert set(names) <= set(bound)
        port = proc.health_port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/health") as r:
            assert json.loads(r.read())["solver"]["healthy"] is True
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/backend") as r:
            backend = json.loads(r.read())
        assert backend["loaded"] == ["screen"] and backend["compute_capability"] == "9.0"
    finally:
        stop.set()
        th.join(timeout=120)
        gc.unfreeze()
        gc.set_threshold(*threshold)
        gctuning._applied = False
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert not th.is_alive() and got["proc"].alive == []


@pytest.mark.cuda
def test_verdict_tile_on_a_second_card_matches_plain():
    """A verdict tile of the device grid on cuda:1, launched while cuda:0
    is the calling thread's current card: the screen kernels run under
    the tile's card's guard and stream (ops/screen.py), so the tile equals
    the plain version; and the whole grid's gathered verdict tensor equals
    the single card's."""
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from karpenter_core_tpu_torch.ops import pack
    from karpenter_core_tpu_torch.parallel.specs import DeviceGrid, SpecLayout

    rng = np.random.default_rng(13)
    segments = MANY
    slot, items = _random_case(rng, 301, 257, segments)
    layout = screen.ScreenLayout(segments, segments[-1][1])
    want = screen.screen_block(slot["allow"], slot["out"], slot["defined"],
                               screen.ScreenItems(items, layout), layout)
    torch.cuda.set_device(0)
    second = torch.device("cuda:1")
    with torch.cuda.device(0):
        got = screen.screen_block(*(slot[k].to(second) for k in ("allow", "out", "defined")),
                                  screen.ScreenItems({k: v.to(second) for k, v in items.items()},
                                                     layout), layout)
        torch.cuda.synchronize(second)
    assert got.device == second
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())

    n = torch.cuda.device_count()
    grid = DeviceGrid.of([torch.device(f"cuda:{i}") for i in range(n)], 2 if n % 2 == 0 else 1)
    ops = pack.ScreenOps(segments, segments[-1][1], None)
    exist = {k: slot[k].cuda() for k in ("allow", "out", "defined")}
    planes = screen.ScreenItems({k: v.cuda() for k, v in items.items()}, ops.rows_layout)
    single = ops.initial_screen(planes, exist["allow"], exist["out"], exist["defined"], 400)
    tiled = pack.grid_initial_screen(ops, SpecLayout(grid), planes, exist, 400)
    assert tiled.device == grid.lead
    assert {d for _i, _j, _r, d, _c in pack.LAST_TILES} == {str(d) for d in grid.distinct()}
    np.testing.assert_array_equal(tiled.cpu().numpy(), single.cpu().numpy())


# -- the pack scan kernel (ops/pack_scan.py, csrc/pack_scan.cu) ---------------

# every parity family: the kernel's route takes topology groups too
SCAN_FAMILIES = FAMILIES + ("ports_vols",)


def _scan_on_card(family, kernel, log_len=None, bulk_len=None):
    """One device solve of a family on the card, its scan through the
    pack_scan kernel or (kernel=False) the eager scan; with the screen's
    and the scan's launches counted around the scan alone, and the scan's
    final verdict tensor. bulk_len cuts the bulk take budget on both
    routes."""
    from karpenter_core_tpu_torch.ops import pack as tpack
    from karpenter_core_tpu_torch.ops import pack_scan
    from karpenter_core_tpu_torch.ops.pack import make_prescreen_kernel
    from karpenter_core_tpu_torch.solver.encode import encode_snapshot

    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload(family, "torch")
    snap = encode_snapshot(pods, provs, its, daemons, nodes, client, cluster,
                           max_nodes=max_nodes)
    geom = tsolver.solve_geometry(snap, max_nodes)
    N, segs, zs, cs, L, screen_v = (geom[7], geom[8], geom[9], geom[10], geom[12], geom[16])
    targs = tsolver.args_to_torch(tsolver.device_args(snap, provs), "cuda")
    scr = make_prescreen_kernel(segs, N, screen_v=screen_v)(targs[0], targs[9])
    routes, make, real_run = tpack.kernel_routes, tsolver.make_pack_kernel, pack_scan.run
    if bulk_len is not None:
        def make_cut(*a, **k):
            pack = make(*a, **k)
            return lambda *pa, **pk: pack(*pa, **dict(pk, bulk_len=bulk_len))

        tsolver.make_pack_kernel = make_cut
        pack_scan.run = lambda *a, **k: real_run(*a, **dict(k, bulk_len=bulk_len))
    if not kernel:
        tpack.kernel_routes = lambda *a: False
    try:
        run = tsolver.make_device_run(segs, zs, cs, snap.topo_meta, N,
                                      L if log_len is None else log_len, screen_v=screen_v)
        before = screen.launch_counts()
        verdicts = []
        log, ptr, state = run(scr, *targs, verdicts=verdicts)
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in screen.launch_counts().items()}
    finally:
        tpack.kernel_routes, tsolver.make_pack_kernel, pack_scan.run = routes, make, real_run
    return log, ptr, state, launches, dict(tpack.LAST_SCAN), targs[2].shape[0], verdicts


def _assert_scans_equal(a, b):
    (la, pa, sa, *_), (lb, pb, sb, *_) = a, b
    assert len(a[6]) == len(b[6]) == 1
    assert torch.equal(a[6][0].cpu(), b[6][0].cpu()), "verdicts"
    assert pa == pb and la["bulk_n"] == lb["bulk_n"]
    for k in ("item", "slot", "ns", "k", "k_last"):
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    assert torch.equal(la["bulk_take"].cpu(), lb["bulk_take"].cpu())
    for name in sa._fields:
        x, y = getattr(sa, name).cpu(), getattr(sb, name).cpu()
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("family", SCAN_FAMILIES)
def test_pack_scan_kernel_matches_plain_on_card(family):
    """The commit log, ptr and every PackState field of the kernel's scan
    (the topology groups' counts included) equal the eager scan's on the
    card, floats bit for bit; the kernel's scan is one launch and
    re-screens without a row_n1 launch (one template's verdict row,
    screened before the scan, is the one row_n1 of a single-template
    solve)."""
    _card()
    got = _scan_on_card(family, kernel=True)
    want = _scan_on_card(family, kernel=False)
    _assert_scans_equal(got, want)
    assert got[4]["impl"] == "kernel" and want[4]["impl"] == "eager"
    assert got[3]["pack_scan"] == 1 and got[3]["row_n1"] == int(got[5] == 1)
    assert {k: got[4][k] for k in ("items", "bulk", "candidate", "open")} == {
        k: want[4][k] for k in ("items", "bulk", "candidate", "open")}


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["mixed", "ports_vols", "refmix"])
def test_pack_scan_kernel_overflowing_log_on_card(family):
    """A log cut to half the commits fills where the eager scan's does."""
    _card()
    full = _scan_on_card(family, kernel=False)
    assert full[1] >= 4
    cut = full[1] // 2
    got = _scan_on_card(family, kernel=True, log_len=cut)
    _assert_scans_equal(got, _scan_on_card(family, kernel=False, log_len=cut))
    assert got[1] == cut


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["bulk", "ports_vols", "anti", "cluster"])
def test_pack_scan_kernel_small_bulk_budget_on_card(family):
    """A bulk take budget of one row sends the existing slots through
    candidate verify after the first bulk commit; the kernel still equals
    the eager scan, verdicts included (anti: the machine-region bulk,
    over the whole slot axis, under that budget)."""
    _card()
    got = _scan_on_card(family, kernel=True, bulk_len=1)
    _assert_scans_equal(got, _scan_on_card(family, kernel=False, bulk_len=1))
    log, ptr, state = got[0], got[1], got[2]
    slot, ns = (np.asarray(log[k])[:ptr] for k in ("slot", "ns"))
    assert log["bulk_n"] == 1
    assert ((ns == 1) & state.is_existing.cpu().numpy()[slot]).any()


@pytest.mark.cuda
def test_pack_scan_segmented_lanes_in_one_launch_on_card():
    """The segmented solve's lanes as the kernel's batch: one launch, the
    placements and merged state of the eager lanes on the card."""
    _card()
    from karpenter_core_tpu_torch.ops import pack as tpack

    m = _mods("torch")
    universe = m.fake.instance_types(6)
    provs, its = m.t.make_pool_provisioners(4, universe)
    rng = np.random.default_rng(5)
    nodes = [m.node(m.t.make_node(
        name=f"seg-n-{e}",
        labels={PROV: f"pool-{e % 4}", "karpenter.sh/initialized": "true",
                "node.kubernetes.io/instance-type": universe[e % 6].name, CT: "on-demand",
                ZONE: "test-zone-1", "team": f"pool-{e % 4}"},
        capacity={k: str(v) for k, v in universe[e % 6].capacity.items()}))
        for e in range(8)]
    pods = []
    for i in range(160):
        p = int(rng.integers(4))
        pods.append(_pod(m, "seg", i, labels={"app": f"dep-{p}-{int(rng.integers(8))}"},
                         requests={"cpu": str(0.25 + 0.25 * int(rng.integers(3)))},
                         node_selector={"team": f"pool-{p}"}))
    got = {}
    routes = tpack.kernel_routes
    for kernel in (True, False):
        if not kernel:
            tpack.kernel_routes = lambda *a: False
        try:
            screen.reset_launches()
            solver = tsolver.TorchSolver(max_nodes=96, device="cuda", pack_scan="segmented")
            result = solver.solve(copy.deepcopy(pods), provs, its,
                                  state_nodes=[n.deep_copy() for n in nodes])
            got[kernel] = (tsolver.placements_json(result), dict(screen.LAUNCHES),
                           dict(solver.last_segment_stats), dict(tpack.LAST_SCAN))
        finally:
            tpack.kernel_routes = routes
    assert got[True][0] == got[False][0]
    assert got[True][2]["mode"] == "segmented" and got[True][2]["lanes"] >= 2
    assert got[True][1]["pack_scan"] == 1 and got[False][1]["pack_scan"] == 0
    assert got[True][3]["impl"] == "kernel"


@pytest.mark.cuda
def test_pack_scan_build_failure_raises(tmp_path, monkeypatch):
    """A kernel that does not build raises KernelError; nothing falls back
    to the eager scan."""
    _card()
    from karpenter_core_tpu_torch.ops import cuda_build

    screen._c_kernels()  # the screen's library is loaded: only the scan's build fails
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ["--no-such-flag"])
    monkeypatch.delitem(cuda_build._LIBS, "pack_scan", raising=False)
    before = screen.launch_counts()
    with pytest.raises(cuda_build.KernelError):
        _scan_on_card("bulk", kernel=True)
    assert screen.launch_counts()["pack_scan"] == before["pack_scan"]
