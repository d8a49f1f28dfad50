"""ops/topology.py of the port against the reference's, on seeded inputs:
every device function over groups of every kind (spread, affinity,
anti-affinity; hostname and value-key; direct and inverse), equal exactly;
encode_topology equal on the topology families; topo_meta_from carrying
the reference's meta over."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_core_tpu.ops import topology as jt
from karpenter_core_tpu.solver import encode as jencode

from karpenter_core_tpu_torch.ops import topology as tt
from karpenter_core_tpu_torch.solver import encode as tencode
from karpenter_core_tpu_torch.solver.torch_solver import topo_meta_from

from tests.test_torch_cuda import workload

SEGMENTS = [(0, 4), (4, 7), (7, 7), (7, 10), (10, 16)]  # key 4: hostname
V, K, N = 16, len(SEGMENTS), 24
SEEDS = range(12)


def _meta(mod):
    G = mod.TopoGroupMeta
    S, A, X = mod.TOPO_SPREAD, mod.TOPO_AFFINITY, mod.TOPO_ANTI
    return mod.TopoMeta(groups=[
        G(S, (0, 4), 0, 1, False, False, [0]),
        G(S, (7, 10), 3, 2, False, False, []),
        G(A, (0, 4), 0, 2**31 - 1, False, False, []),
        G(X, (4, 7), 1, 2**31 - 1, False, False, []),
        G(S, (10, 16), 4, 1, True, False, [1, 2]),
        G(S, (10, 16), 4, 2, True, False, []),
        G(A, (10, 16), 4, 2**31 - 1, True, False, []),
        G(X, (10, 16), 4, 2**31 - 1, True, False, []),
        G(X, (10, 16), 4, 2**31 - 1, True, True, []),
        G(X, (4, 7), 1, 2**31 - 1, False, True, []),
    ])


G = len(_meta(tt).groups)


def _case(seed):
    rng = np.random.default_rng(seed)
    tcounts = (rng.integers(0, 4, (G, V)) * (rng.random((G, V)) < 0.6)).astype(np.float32)
    thost = (rng.integers(0, 3, (G, N)) * (rng.random((G, N)) < 0.4)).astype(np.float32)
    if seed % 3 == 0:
        thost[:] = 0.0  # no host holds a matching pod yet: affinity seeds
    tdoms = rng.random((G, V)) < 0.7
    own = rng.random(G) < 0.6
    selp = rng.random(G) < 0.6
    pod_allow = rng.random(V) < 0.7
    slot_allow = rng.random((N, V)) < 0.6
    force = rng.random(V) < 0.5
    m_allow_rows = rng.random((N, V)) < 0.5
    m_out_rows = rng.random((N, K)) < 0.3
    k_row = (rng.integers(0, 3, N) * (rng.random(N) < 0.5)).astype(np.int32)
    nf_ok = rng.random(G) < 0.7
    return dict(tcounts=tcounts, thost=thost, tdoms=tdoms, own=own, selp=selp,
                pod_allow=pod_allow, slot_allow=slot_allow, force=force,
                m_allow_rows=m_allow_rows, m_out_rows=m_out_rows, k_row=k_row,
                nf_ok=nf_ok)


def _j(c):
    return {k: jnp.asarray(v) for k, v in c.items()}


def _t(c):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in c.items()}


def _eq(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind == "f":
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=what)


def test_topo_screen_matches():
    jm, tm = _meta(jt), _meta(tt)
    for seed in SEEDS:
        c = _case(seed)
        j, t = _j(c), _t(c)
        want = jt.topo_screen(jm, j["tcounts"], j["thost"], j["tdoms"], j["own"],
                              j["selp"], j["pod_allow"], j["slot_allow"])
        got = tt.topo_screen(tm, t["tcounts"], t["thost"], t["tdoms"], t["own"],
                             t["selp"], t["pod_allow"], t["slot_allow"])
        _eq(got, want, f"seed {seed}")


@pytest.mark.parametrize("forced", [False, True])
def test_topo_narrow_single_matches(forced):
    jm, tm = _meta(jt), _meta(tt)
    for seed in SEEDS:
        c = _case(seed)
        j, t = _j(c), _t(c)
        for n in (0, seed % N, N - 1):
            want = jt.topo_narrow_single(
                jm, j["tcounts"], j["thost"], j["tdoms"], j["own"], j["selp"],
                j["pod_allow"], j["slot_allow"][n], n, K,
                spread_force=j["force"] if forced else None)
            got = tt.topo_narrow_single(
                tm, t["tcounts"], t["thost"], t["tdoms"], t["own"], t["selp"],
                t["pod_allow"], t["slot_allow"][n], torch.tensor(n), K,
                spread_force=t["force"] if forced else None)
            for name, g, w in zip(("viable", "narrow", "applied", "k_cap"), got, want):
                _eq(g, w, f"seed {seed} slot {n} {name}")


def test_bulk_item_flags_match():
    jm, tm = _meta(jt), _meta(tt)
    for seed in range(64):
        c = _case(seed)
        own, selp = c["own"], c["selp"]
        for jf, tf in ((jt.topo_bulk_item_ok, tt.topo_bulk_item_ok),
                       (jt.topo_mach_bulk_item_ok, tt.topo_mach_bulk_item_ok)):
            want = bool(jf(jm, jnp.asarray(own), jnp.asarray(selp)))
            assert tf(tm, torch.from_numpy(own), torch.from_numpy(selp)) == want
            assert tf(tm, own.tolist(), selp.tolist()) == want


def test_topo_bulk_need_seed_matches():
    jm, tm = _meta(jt), _meta(tt)
    for seed in SEEDS:
        c = _case(seed)
        j, t = _j(c), _t(c)
        want = jt.topo_bulk_need_seed(jm, j["tcounts"], j["tdoms"], j["own"], j["pod_allow"])
        got = tt.topo_bulk_need_seed(tm, t["tcounts"], t["tdoms"], t["own"], t["pod_allow"])
        _eq(got, want, f"seed {seed}")


@pytest.mark.parametrize("forced", [False, True])
def test_topo_bulk_narrow_matches(forced):
    jm, tm = _meta(jt), _meta(tt)
    for seed in SEEDS:
        c = _case(seed)
        j, t = _j(c), _t(c)
        want = jt.topo_bulk_narrow(
            jm, j["tcounts"], j["thost"], j["tdoms"], j["own"], j["selp"],
            j["pod_allow"], K, spread_force=j["force"] if forced else None)
        got = tt.topo_bulk_narrow(
            tm, t["tcounts"], t["thost"], t["tdoms"], t["own"], t["selp"],
            t["pod_allow"], K, spread_force=t["force"] if forced else None)
        for name, g, w in zip(("narrow", "applied", "k_cap"), got, want):
            _eq(g, w, f"seed {seed} {name}")


@pytest.mark.parametrize("prefix", [N, N // 2])
def test_topo_record_bulk_matches(prefix):
    jm, tm = _meta(jt), _meta(tt)
    for seed in SEEDS:
        c = _case(seed)
        j, t = _j(c), _t(c)
        want = jt.topo_record_bulk(
            jm, j["tcounts"], j["thost"], j["tdoms"], j["own"], j["selp"],
            j["m_allow_rows"][:prefix], j["m_out_rows"][:prefix], j["k_row"][:prefix])
        got = tt.topo_record_bulk(
            tm, t["tcounts"].clone(), t["thost"].clone(), t["tdoms"].clone(), t["own"],
            t["selp"], t["m_allow_rows"][:prefix], t["m_out_rows"][:prefix],
            t["k_row"][:prefix])
        for name, g, w in zip(("tcounts", "thost", "tdoms"), got, want):
            _eq(g, w, f"seed {seed} {name}")


@pytest.mark.parametrize("rows", ["one", "run", "none"])
def test_topo_record_matches(rows):
    """One slot (a candidate commit), a run of slots (an open), and no slot
    at all (a commit that placed nothing changes nothing)."""
    jm, tm = _meta(jt), _meta(tt)
    for seed in SEEDS:
        c = _case(seed)
        mask = np.zeros(N, dtype=bool)
        if rows == "one":
            mask[seed % N] = True
        elif rows == "run":
            mask[3:3 + seed % 7 + 1] = True
        c["row_mask"] = mask
        c["k_row"] = np.where(mask, 1 + seed % 3, 0).astype(np.int32)
        j, t = _j(c), _t(c)
        want = jt.topo_record(
            jm, j["tcounts"], j["thost"], j["tdoms"], j["own"], j["selp"], j["nf_ok"],
            j["m_allow_rows"][0], j["m_out_rows"][0], j["row_mask"], j["k_row"])
        got = tt.topo_record(
            tm, t["tcounts"].clone(), t["thost"].clone(), t["tdoms"].clone(), t["own"],
            t["selp"], t["nf_ok"], t["m_allow_rows"][0], t["m_out_rows"][0],
            t["row_mask"], t["k_row"])
        for name, g, w in zip(("tcounts", "thost", "tdoms"), got, want):
            _eq(g, w, f"seed {seed} {name}")
        if rows == "none":
            _eq(got[0], c["tcounts"], "a placement of nothing records nothing")


def test_topo_node_filter_ok_matches():
    jm, tm = _meta(jt), _meta(tt)
    rng = np.random.default_rng(5)
    well_known = np.array([True, False, True, False, True])
    for seed in SEEDS:
        terms = {"allow": rng.random((3, V)) < 0.6, "out": rng.random((3, K)) < 0.3,
                 "defined": rng.random((3, K)) < 0.5, "escape": rng.random((3, K)) < 0.2}
        m = {"allow": rng.random(V) < 0.6, "out": rng.random(K) < 0.3,
             "defined": rng.random(K) < 0.6}
        want = jt.topo_node_filter_ok(
            jm, {k: jnp.asarray(v) for k, v in terms.items()}, SEGMENTS,
            jnp.asarray(well_known), *(jnp.asarray(m[k]) for k in ("allow", "out", "defined")))
        got = tt.topo_node_filter_ok(
            tm, {k: torch.from_numpy(v) for k, v in terms.items()}, SEGMENTS,
            torch.from_numpy(well_known),
            *(torch.from_numpy(m[k]) for k in ("allow", "out", "defined")))
        _eq(got, want, f"seed {seed}")


def test_first_true_onehot_matches():
    rng = np.random.default_rng(3)
    mask = rng.random((9, 7)) < 0.2
    mask[0] = False
    _eq(tt._first_true_onehot(torch.from_numpy(mask)),
        jt._first_true_onehot(jnp.asarray(mask)), "onehot")


@pytest.mark.parametrize("family", ["spread", "affinity", "anti", "refmix", "cluster"])
def test_encode_topology_matches(family):
    jp, jprov, jits, jds, jnodes, max_nodes, jkc, jcl = workload(family, "jax")
    tp, tprov, tits, tds, tnodes, _, tkc, tcl = workload(family, "torch")
    js = jencode.encode_snapshot(jp, jprov, jits, jds, jnodes, kube_client=jkc,
                                 cluster=jcl, max_nodes=max_nodes)
    ts = tencode.encode_snapshot(tp, tprov, tits, tds, tnodes, tkc, tcl,
                                 max_nodes=max_nodes)
    assert topo_meta_from(js.topo_meta) == ts.topo_meta
    kinds = {(g.gtype, g.is_hostname, g.is_inverse) for g in ts.topo_meta.groups}
    assert len(kinds) >= 2
    for name in ("counts0", "hcounts0", "domain_mask0", "owner", "sel", "term_allow",
                 "term_out", "term_defined", "term_escape"):
        _eq(getattr(ts.topo_arrays, name), getattr(js.topo_arrays, name), name)
    # the per-pod path (no class gather) gives the same arrays
    from karpenter_core_tpu.controllers.provisioning.scheduling.scheduler import (
        build_domains as j_build_domains,
    )
    from karpenter_core_tpu.controllers.provisioning.scheduling.topology import (
        Topology as JTopology,
    )
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (
        Topology as TTopology,
        build_domains,
    )

    assert build_domains(tprov, tits) == j_build_domains(jprov, jits)
    t_host = TTopology(tkc, tcl, build_domains(tprov, tits), ts.pods)
    j_host = JTopology(jkc, jcl, j_build_domains(jprov, jits), js.pods)
    hostnames = [n.hostname() for n in ts.state_nodes]
    tmeta, tarr = tt.encode_topology(t_host, ts.pods, ts.dictionary, ts.n_slots, hostnames)
    jmeta, jarr = jt.encode_topology(j_host, js.pods, js.dictionary, js.n_slots, hostnames)
    assert topo_meta_from(jmeta) == tmeta
    for name in ("owner", "sel", "counts0", "domain_mask0"):
        _eq(getattr(tarr, name), getattr(jarr, name), name)


def test_topo_meta_from_round_trips():
    jm = _meta(jt)
    tm = topo_meta_from(jm)
    assert tm == _meta(tt)
    assert topo_meta_from(tm) == tm
    assert topo_meta_from(None) is None
    for jg, tg in zip(jm.groups, tm.groups):
        assert tuple(jg.seg) == tg.seg and jg.filter_term_rows == tg.filter_term_rows
