"""ops/feasibility.py of the port against the reference's, on the arrays
the reference's own encoder produces for the parity workloads."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_core_tpu.ops import feasibility as jf
from karpenter_core_tpu.solver import encode as jencode
from karpenter_core_tpu.solver import tpu_solver as jsolver

from karpenter_core_tpu_torch.ops import feasibility as tf
from karpenter_core_tpu_torch.solver.torch_solver import args_to_torch

from tests.test_torch_cuda import FAMILIES, workload


@pytest.mark.parametrize("family", FAMILIES)
def test_feasibility_static_and_openable_match(family):
    pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload(family, "jax")
    snap = jencode.encode_snapshot(pods, provs, its, daemons, nodes, kube_client=client,
                                   cluster=cluster, max_nodes=max_nodes)
    args = jsolver.device_args(snap, provs)
    segments = [snap.dictionary.segment(k) for k in snap.dictionary.keys]
    pa, tmpl, daemon, tmask, types = args[0], args[1], args[2], args[3], args[4]
    alloc, offer, well_known = args[5], args[7], args[12]
    keys = ("allow", "out", "defined", "escape")

    want = jf.feasibility_static(
        {k: jnp.asarray(pa[k]) for k in keys}, {k: jnp.asarray(v) for k, v in tmpl.items()},
        {k: jnp.asarray(v) for k, v in types.items()}, jnp.asarray(pa["tol_tmpl"]),
        jnp.asarray(tmask), jnp.asarray(offer), snap.zone_seg, snap.ct_seg,
        segments, jnp.asarray(well_known),
    )
    want_open = jf.openable_mask(want, jnp.asarray(pa["requests"]),
                                 jnp.asarray(daemon), jnp.asarray(alloc))

    targs = args_to_torch(args, "cpu")
    tpa = targs[0]
    got = tf.feasibility_static(
        {k: tpa[k] for k in keys}, targs[1], targs[4], tpa["tol_tmpl"], targs[3],
        targs[7], snap.zone_seg, snap.ct_seg, segments, targs[12],
    )
    got_open = tf.openable_mask(got, tpa["requests"], targs[2], targs[5])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_open.numpy(), np.asarray(want_open))
    if family == "mixed":  # (relax's round 1 tolerates no template)
        assert got.any() and not got.all()
    m = {k: tmpl[k][:1] for k in ("allow", "out", "defined")}
    merged_t = tf.merge_reqsets({k: torch.from_numpy(v) for k, v in m.items()},
                                {k: tpa[k] for k in ("allow", "out", "defined")})
    merged_j = jf.merge_reqsets({k: jnp.asarray(v) for k, v in m.items()},
                                {k: jnp.asarray(pa[k]) for k in ("allow", "out", "defined")})
    for k in merged_j:
        np.testing.assert_array_equal(merged_t[k].numpy(), np.asarray(merged_j[k]))
