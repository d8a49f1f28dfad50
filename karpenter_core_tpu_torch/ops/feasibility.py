"""Static pod x instance-type feasibility, per machine template j:

  F_static[j, P, T] = Compatible(template_j, pod)                (machine.go:77)
                    ∧ Intersects(template_j ∩ pod, instance_type) (machine.go:137-145)
                    ∧ hasOffering(type, zones/cts of template∩pod) (machine.go:152-159)
                    ∧ pod tolerates template taints                (machine.go:63-65)
                    ∧ template offers the type

plus openable[j, P] = F_static ∧ fits(daemon_j + pod): a fresh machine from
template j could host this pod alone. Resource fit against accumulated
machine usage is left to the pack scan (ops/pack.py).

On a device grid (parallel/specs.py) F_static is computed as tiles
(feasibility_tiles): item rows over dp, type columns over tp, each tile on
its own device, gathered on the lead device. Every entry depends only on
its own item row and type column, so the gathered tensor equals
feasibility_static's. openable_mask, a reduction over the type axis, runs
on the lead device after the gather.
"""
from __future__ import annotations

from typing import Tuple

import torch

from karpenter_core_tpu_torch.ops import compat


def merge_reqsets(a, b):
    """Intersection of two requirement rows/batches (Requirements.Add on
    masks, requirement.go:117-150)."""
    return {
        "allow": a["allow"] & b["allow"],
        "out": a["out"] & b["out"],
        "defined": a["defined"] | b["defined"],
    }


def feasibility_static(
    pod_reqs: dict,  # allow [P, V], out/defined/escape [P, K]
    tmpl_reqs: dict,  # [J, ...]
    type_reqs: dict,  # [T, ...]
    pod_tol: torch.Tensor,  # [P, J]
    tmpl_type_mask: torch.Tensor,  # [J, T]
    type_offering_ok: torch.Tensor,  # [T, Z, C]
    zone_seg: Tuple[int, int],
    ct_seg: Tuple[int, int],
    segments,
    well_known: torch.Tensor,
) -> torch.Tensor:
    """F_static [J, P, T] bool."""
    J = tmpl_reqs["allow"].shape[0]
    zlo, zhi = zone_seg
    clo, chi = ct_seg
    offer = type_offering_ok.to(torch.float32)
    outs = []
    for j in range(J):  # J is the provisioner count
        tmpl = {k: v[j: j + 1] for k, v in tmpl_reqs.items()}
        comp_tp = compat.pairwise_compatible(tmpl, pod_reqs, segments, well_known)[0]
        merged = merge_reqsets(
            {k: tmpl_reqs[k][j][None, :] for k in ("allow", "out", "defined")},
            {k: pod_reqs[k] for k in ("allow", "out", "defined")},
        )  # [P, ...]
        merged["escape"] = compat.escape_flags(
            merged["allow"], merged["out"], merged["defined"], segments
        )
        inter_ok = compat.pairwise_intersects(merged, type_reqs, segments)  # [P, T]
        offer_ok = torch.einsum(
            "tzc,pz,pc->pt",
            offer,
            merged["allow"][:, zlo:zhi].to(torch.float32),
            merged["allow"][:, clo:chi].to(torch.float32),
        ) > 0.5
        outs.append(
            comp_tp[:, None]
            & pod_tol[:, j][:, None]
            & tmpl_type_mask[j][None, :]
            & inter_ok
            & offer_ok
        )
    return torch.stack(outs, dim=0)


def feasibility_tiles(layout, pod_reqs: dict, tmpl_reqs: dict, type_reqs: dict,
                      pod_tol: torch.Tensor, tmpl_type_mask: torch.Tensor,
                      type_offering_ok: torch.Tensor, zone_seg: Tuple[int, int],
                      ct_seg: Tuple[int, int], segments, well_known: torch.Tensor,
                      targs=None) -> torch.Tensor:
    """F_static [J, P, T] on `layout`'s grid (make_device_run with
    spec_layout=): tile (i, j) runs feasibility_static on grid device
    (i, j) over item rows P_i and type columns T_j, templates whole, for
    this process's cells; the tiles are gathered on its lead device
    (every rank's, on a grid over processes). `targs`, when given, may
    carry the type planes' tiles its upload made (SpecLayout.put_args)."""
    rows = layout.slot_plane()
    pods_t = layout.split(pod_reqs, rows)
    tol_t = layout.split(pod_tol, rows)
    types_t = layout.split_arg(targs, "types", type_reqs, layout.type_plane())
    mask_t = layout.split_arg(targs, "tmpl_type_mask", tmpl_type_mask, layout.type_cols())
    offer_t = layout.split_arg(targs, "type_offering_ok", type_offering_ok,
                               layout.type_plane(3))
    whole = layout.split(tmpl_reqs, layout.replicated())
    wk = layout.split(well_known, layout.replicated())
    tiles = [[None] * layout.ntp for _ in range(layout.ndp)]
    for i, j in layout.mesh.cells():
        tiles[i][j] = feasibility_static(pods_t[i][j], whole[i][j], types_t[i][j], tol_t[i][j],
                                         mask_t[i][j], offer_t[i][j], zone_seg, ct_seg,
                                         segments, wk[i][j])
    shape = (tmpl_reqs["allow"].shape[0], pod_tol.shape[0], tmpl_type_mask.shape[1])
    return layout.gather(tiles, layout.feasibility(), shape=shape, dtype=torch.bool)


def openable_mask(
    f_static: torch.Tensor,  # [J, P, T]
    pod_requests: torch.Tensor,  # [P, R]
    tmpl_daemon: torch.Tensor,  # [J, R]
    type_alloc: torch.Tensor,  # [T, R]
) -> torch.Tensor:
    """[J, P]: a fresh machine from template j can host the pod alone."""
    req = tmpl_daemon[:, None, :] + pod_requests[None, :, :]  # [J, P, R]
    fit = compat.fits(req[:, :, None, :], type_alloc[None, None, :, :])  # [J, P, T]
    return (f_static & fit).any(dim=-1)
