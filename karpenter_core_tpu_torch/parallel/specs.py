"""The device grid and the tiling of every solver tensor family
(parallel/specs.py of the reference).

The reference's multi-chip solve is one GSPMD program on a ('dp', 'tp')
mesh, with sharding constraints at its precompute seams. The port is eager
PyTorch and has no GSPMD. Its counterpart is a grid of torch devices inside
one process (DeviceGrid), and a SpecLayout that says, per tensor family,
which axis splits over which grid axis:

  'dp'  splits the slot rows (the existing-slot prefix of the [N, C]
        verdict tensor) and, in the feasibility precompute, the item rows;
  'tp'  splits the instance-type columns of the feasibility precompute and
        the class columns of the verdict tensor.

Only those two precomputes are tiled. Tile (i, j) runs on grid device
(i, j); `gather` copies the tiles to the lead device grid[0][0] and
concatenates them in grid order. Every tensor the pack scan reads lives on
the lead device (the port's form of the reference's replication fence),
and the scan runs once, there; so do the segmented scan's lanes, one
after another, where the reference splits them over dp (segment_axis;
torch_solver.make_device_run says why). Since the tiles split output axes only
(no reduction crosses a tile), the gathered tensors equal the
single-device ones exactly, and placements are byte-identical.

A spec is a tuple naming, per tensor axis, the grid axis that splits it
('dp', 'tp') or None; the empty tuple is replicated. An axis that does not
divide its grid axis splits unevenly (torch.tensor_split's rule), since
the tiles are always gathered and no tile has to match another's shape.

A device may appear more than once in a grid: a logical grid, several
tiles on one card or on the CPU, runs the same tiling, launches and
gathers (the tests' 4 x 2 grid of CPU devices; chip_smoke's 2 x 2 grid on
one card), the port's counterpart of the reference's virtual devices.

The reference's `cache_salt` has no counterpart: it works around XLA:CPU's
nondeterministic deserialization of multi-device executables from the
persistent cache, and the port serializes no program.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# what gather() has moved since the last reset: calls, tile bytes gathered
# and those of them that came from another device than the lead
GATHER: Dict[str, float] = {"calls": 0, "bytes": 0, "moved_bytes": 0, "host_ms": 0.0}


def reset_gather() -> None:
    for k in GATHER:
        GATHER[k] = 0


@dataclass(frozen=True)
class DeviceGrid:
    """A frozen dp x tp grid of torch devices (the reference's jax Mesh
    with axes ('dp', 'tp')): `devices[i][j]` is the device of dp row i and
    tp column j, and `devices[0][0]` the lead device."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @classmethod
    def of(cls, devices: Sequence, tp: int = 1) -> "DeviceGrid":
        """A grid of len(devices) / tp rows of `tp` devices, row-major."""
        devs = [torch.device(d) for d in devices]
        if tp < 1 or not devs or len(devs) % tp:
            raise ValueError(f"tp={tp} does not divide device count {len(devs)}")
        return cls(tuple(tuple(devs[r * tp:(r + 1) * tp]) for r in range(len(devs) // tp)))

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": len(self.devices), "tp": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def lead(self) -> torch.device:
        return self.devices[0][0]

    def distinct(self) -> List[torch.device]:
        """Each device of the grid once, in grid order."""
        out: List[torch.device] = []
        for row in self.devices:
            for d in row:
                if d not in out:
                    out.append(d)
        return out


def _bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """torch.tensor_split's chunk bounds of n rows into `parts`."""
    q, r = divmod(n, parts)
    out, lo = [], 0
    for k in range(parts):
        hi = lo + q + (1 if k < r else 0)
        out.append((lo, hi))
        lo = hi
    return out


class GridArgs(tuple):
    """args_to_torch's tuple on the lead device (what the scan reads), and
    `tiles`: for each argument whose family splits evenly, its tiles,
    uploaded from the host straight to their devices (SpecLayout.put_args):
    name -> (spec, tiles), or name -> {leaf: (spec, tiles)} for a dict
    argument."""

    tiles: Dict[str, object]


@dataclass(frozen=True, eq=False)
class SpecLayout:
    """The tiling of solver tensors on a DeviceGrid. Hashable by its key,
    which joins the solver's warm-state and residency keys, so the grid's
    entries and the single-device ones (layout None) never collide."""

    mesh: DeviceGrid
    dp_axis: str = "dp"
    tp_axis: str = "tp"

    # -- identity ------------------------------------------------------------

    @property
    def ndp(self) -> int:
        return self.mesh.shape["dp"]

    @property
    def ntp(self) -> int:
        return self.mesh.shape["tp"]

    @property
    def key(self) -> tuple:
        """The grid's shape, not its devices: one key per shape, as the
        reference's ("gspmd", ndp, ntp)."""
        return ("grid", self.ndp, self.ntp)

    @property
    def lead(self) -> torch.device:
        return self.mesh.lead

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, SpecLayout) and self.key == other.key

    # -- per-family specs ----------------------------------------------------

    def replicated(self) -> tuple:
        """Item planes, template planes, the scan's state and log, scalars:
        everything the scan reads, on the lead device."""
        return ()

    def item_plane(self) -> tuple:
        """[I, ...] item rows as the scan reads them: replicated."""
        return ()

    def type_plane(self, rank: int = 2) -> tuple:
        """[T, ...] instance-type rows: split over tp, whole over dp."""
        return (self.tp_axis,) + (None,) * (rank - 1)

    def type_cols(self, rank: int = 2) -> tuple:
        """[..., T] planes whose last axis is the type axis
        (tmpl_type_mask [J, T])."""
        return (None,) * (rank - 1) + (self.tp_axis,)

    def slot_plane(self, rank: int = 2) -> tuple:
        """[E, ...] existing-slot rows, and the item rows of the
        feasibility precompute: split over dp."""
        return (self.dp_axis,) + (None,) * (rank - 1)

    def segment_axis(self, rank: int = 2) -> tuple:
        """[S, ...] segmented-scan lane planes: the reference splits the
        lane axis over dp, every input whole within a lane. The port's
        lanes run on the lead device (ROADMAP Queue B item 4)."""
        return self.slot_plane(rank)

    def verdict(self) -> tuple:
        """The [E, C] existing block of the verdict tensor: slot rows over
        dp, class columns over tp."""
        return (self.dp_axis, self.tp_axis)

    def feasibility(self) -> tuple:
        """[J, I, T] static feasibility: item rows over dp, type columns
        over tp, templates whole."""
        return (None, self.dp_axis, self.tp_axis)

    # -- tiles ----------------------------------------------------------------

    def _parts(self, axis) -> int:
        return self.ndp if axis == self.dp_axis else self.ntp

    def _tile(self, x, spec, i: int, j: int):
        idx = []
        for d, axis in enumerate(spec):
            if axis is None:
                idx.append(slice(None))
                continue
            lo, hi = _bounds(x.shape[d], self._parts(axis))[i if axis == self.dp_axis else j]
            idx.append(slice(lo, hi))
        return x[tuple(idx)]

    def split(self, x, spec: tuple) -> List[list]:
        """The tiles of `x` under `spec`: tiles[i][j] on grid device (i, j)
        (a view where that is x's own device). A dict splits leaf by
        leaf, each tile a dict."""
        grid = self.mesh.devices
        if isinstance(x, dict):
            per = {k: self.split(v, spec) for k, v in x.items()}
            return [[{k: per[k][i][j] for k in x} for j in range(self.ntp)]
                    for i in range(self.ndp)]
        return [[self._tile(x, spec, i, j).to(grid[i][j]) for j in range(self.ntp)]
                for i in range(self.ndp)]

    def split_arg(self, targs, name: str, x, spec: tuple) -> List[list]:
        """`x`'s tiles under `spec`: those put_args uploaded for argument
        `name` where their spec is this one, else split from `x`."""
        pre = getattr(targs, "tiles", None)
        pre = pre.get(name) if pre else None
        if isinstance(x, dict):
            got = {k: (pre[k][1] if pre and k in pre and pre[k][0] == spec
                       else self.split(v, spec)) for k, v in x.items()}
            return [[{k: got[k][i][j] for k in x} for j in range(self.ntp)]
                    for i in range(self.ndp)]
        if pre is not None and pre[0] == spec:
            return pre[1]
        return self.split(x, spec)

    def gather(self, tiles: List[list], spec: tuple) -> torch.Tensor:
        """The tiles copied to the lead device and concatenated in grid
        order: the whole tensor, equal to the one the tiles were split
        from. A grid axis the spec does not split reads its first tile."""
        t0 = time.perf_counter()
        lead = self.lead
        dp_dim = spec.index(self.dp_axis) if self.dp_axis in spec else None
        tp_dim = spec.index(self.tp_axis) if self.tp_axis in spec else None
        rows = []
        for i in range(self.ndp if dp_dim is not None else 1):
            row = []
            for j in range(self.ntp if tp_dim is not None else 1):
                t = tiles[i][j]
                nbytes = t.numel() * t.element_size()
                GATHER["bytes"] += nbytes
                if t.device != lead:
                    GATHER["moved_bytes"] += nbytes
                row.append(t.to(lead))
            rows.append(torch.cat(row, dim=tp_dim) if tp_dim is not None else row[0])
        out = torch.cat(rows, dim=dp_dim) if dp_dim is not None else rows[0]
        GATHER["calls"] += 1
        GATHER["host_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    # -- the service's pre-split upload ---------------------------------------

    def arg_sharding(self, name: str, arr) -> tuple:
        """The spec of one device_args tensor (by its RUN_ARG_NAMES name):
        its family's where the split axis divides the grid axis, else
        replicated, as the reference's upload rule (specs.py:191-205)."""
        family = RUN_ARG_FAMILIES.get(name, "replicated")
        shape = tuple(getattr(arr, "shape", ()))
        rank = max(len(shape), 1)
        if family == "type_rows" and shape and shape[0] % self.ntp == 0:
            return self.type_plane(rank)
        if family == "type_cols" and shape and shape[-1] % self.ntp == 0:
            return self.type_cols(rank)
        if family == "slot_rows" and shape and shape[0] % self.ndp == 0:
            return self.slot_plane(rank)
        return self.replicated()

    def put_args(self, names: Sequence[str], args) -> GridArgs:
        """device_args' arrays (either package's, or the solver service's
        wire tensors) onto the grid: each on the lead device, where the
        scan reads it, and each one whose spec splits also as tiles
        uploaded from the host straight to their devices, where the tiled
        precomputes read them (split_arg)."""
        lead = self.lead
        grid = self.mesh.devices

        def host(a):
            a = np.ascontiguousarray(a)
            return torch.from_numpy(a.copy() if not a.flags.writeable else a)

        def tiles_of(t, spec):
            return [[self._tile(t, spec, i, j).contiguous().to(grid[i][j])
                     for j in range(self.ntp)] for i in range(self.ndp)]

        def place(name, a):
            t = host(a)
            spec = self.arg_sharding(name, t)
            return t.to(lead), ((spec, tiles_of(t, spec)) if spec else None)

        whole, tiles = [], {}
        for name, arg in zip(names, args):
            if isinstance(arg, dict):
                got = {k: place(name, v) for k, v in arg.items()}
                whole.append({k: w for k, (w, _t) in got.items()})
                split = {k: t for k, (_w, t) in got.items() if t is not None}
            else:
                w, split = place(name, arg)
                whole.append(w)
            if split:
                tiles[name] = split
        out = GridArgs(whole)
        out.tiles = tiles
        return out


# device_args tensor name -> tiling family (names as torch_solver.
# RUN_ARG_NAMES; anything absent is replicated), the reference's table:
# the reqset dict under 'types' splits leaf by leaf as type rows, the
# 'exist*' planes are slot rows
RUN_ARG_FAMILIES = {
    "types": "type_rows",
    "type_alloc": "type_rows",
    "type_capacity": "type_rows",
    "type_offering_ok": "type_rows",
    "tmpl_type_mask": "type_cols",
    "exist": "slot_rows",
    "exist_used": "slot_rows",
    "exist_cap": "slot_rows",
    "exist_ports": "slot_rows",
    "exist_vols": "slot_rows",
    "exist_vol_limits": "slot_rows",
}


def layout_for(mesh: Optional[DeviceGrid]) -> Optional[SpecLayout]:
    """The SpecLayout of a grid (None passes through: the single-device
    path)."""
    return None if mesh is None else SpecLayout(mesh)
