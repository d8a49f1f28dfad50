"""The multi-device solve: TorchSolver over a device grid (parallel/
sharded.py of the reference).

The reference runs its single-device program as one GSPMD program on a
('dp', 'tp') mesh, sharding constraints at the precompute seams. The port
has no GSPMD; its ShardedSolver is TorchSolver with a parallel/specs.
SpecLayout over a DeviceGrid, so that

  * the [N, C] prescreen verdict tensor computes as (dp x tp) tiles of
    existing-slot rows by class columns, one screen-kernel launch per tile
    on the tile's device (ops/pack.grid_initial_screen);
  * static feasibility [J, I, T] computes as tiles of item rows by type
    columns (ops/feasibility.feasibility_tiles);
  * the tiles are copied to the lead device and concatenated there, and
    the pack scan runs once, on the lead device; so do the segmented
    scan's lanes, one after another (the reference splits them over dp).

On a grid over processes (parallel/specs.world_grid) every rank computes
its own tiles, the gathers are collectives after which every rank holds
the whole tensors on its lead, and every rank runs the scan there: the
reference's SPMD contract, where every process calls solve() with the same
inputs and gets the same placements. Every branch taken before a
collective is a function of the inputs (route_to_mesh, the segmented
attempt, the resident tensor's refresh, the relaxation rounds), so the
ranks meet the same collectives; a rank that meets another, or none,
raises at the group's timeout (solver/factory.DIST_TIMEOUT).

The tiles split output axes only, so the gathered tensors equal the single
device's and placements are byte-identical (flightrec-canonical) to
TorchSolver's: tests/test_torch_sharded.py holds them so across the
reference's parity families. Everything else is TorchSolver's, inherited:
encode()/solve(encoded=), relaxation, the incremental refresh (on the lead
device), prewarm_snapshot and the batched consolidation replan, which runs
on the lead device as the reference's runs its single-device program.

Small batches skip the grid: below MIN_SPLIT_REPLICAS_PER_SHARD replicas
per dp row the tiles' launches and gathers cost more than they split, so
_layout_for routes the solve through the single-device path on the lead
device, under the single device's keys.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from karpenter_core_tpu_torch.parallel.specs import DeviceGrid, SpecLayout, layout_for
from karpenter_core_tpu_torch.solver.torch_solver import DEFAULT_MAX_RELAX_ROUNDS, TorchSolver

__all__ = [
    "ShardedSolver",
    "MIN_SPLIT_REPLICAS_PER_SHARD",
    "route_to_mesh",
    "snapshot_replicas",
    "SpecLayout",
    "layout_for",
]


# below this many replicas per dp row the grid costs more than it splits:
# the whole batch takes the single-device path (read at each call)
MIN_SPLIT_REPLICAS_PER_SHARD = 32


def route_to_mesh(total_replicas: int, ndp: int) -> bool:
    """Grid or single device for a batch's total replica count: the grid
    once the batch clears the per-dp-row floor, with an absolute cap so a
    tall grid does not demand thousands of replicas first."""
    return total_replicas >= min(ndp * MIN_SPLIT_REPLICAS_PER_SHARD, 256)


def snapshot_replicas(snap) -> int:
    """Total replica count of an encoded snapshot (the routing signal)."""
    if snap.item_counts is not None:
        return int(np.asarray(snap.item_counts).sum())
    return len(snap.pods)


class ShardedSolver(TorchSolver):
    """The multi-device Solver: TorchSolver whose precomputes tile over
    `mesh` (a parallel/specs.DeviceGrid) and whose scan runs on its lead
    device. `last_path` says which path the last solve took ("mesh" or
    "single")."""

    # the replan runs on the lead device
    supports_batched_replan = True

    def __init__(self, mesh: DeviceGrid, max_nodes: int = 1024,
                 max_relax_rounds: Optional[int] = None, screen_mode: str = "prescreen",
                 incremental: str = "on", pack_scan: Optional[str] = None):
        super().__init__(
            max_nodes=max_nodes,
            max_relax_rounds=(DEFAULT_MAX_RELAX_ROUNDS if max_relax_rounds is None
                              else max_relax_rounds),
            device=mesh.lead, screen_mode=screen_mode, incremental=incremental,
            pack_scan=pack_scan,
        )
        self.mesh = mesh
        self._mesh_layout = SpecLayout(mesh)
        self.last_path: Optional[str] = None

    def _layout_for(self, snap):
        """The grid's layout for batches worth splitting; None (the single
        device, its own keys) for small ones."""
        mesh = route_to_mesh(snapshot_replicas(snap), self._mesh_layout.ndp)
        self._publish(last_path="mesh" if mesh else "single")
        return self._mesh_layout if mesh else None

    def _sync(self) -> None:
        """Every card of this process's cells: a phase ends when its tiles
        and lanes have."""
        for dev in self.mesh.distinct():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
