"""The device grid and the tiling of every solver tensor family
(parallel/specs.py of the reference).

The reference's multi-chip solve is one GSPMD program on a ('dp', 'tp')
mesh, with sharding constraints at its precompute seams. The port is eager
PyTorch and has no GSPMD. Its counterpart is a grid of torch devices
(DeviceGrid), and a SpecLayout that says, per tensor family, which axis
splits over which grid axis:

  'dp'  splits the slot rows (the existing-slot prefix of the [N, C]
        verdict tensor) and, in the feasibility precompute, the item rows;
  'tp'  splits the instance-type columns of the feasibility precompute and
        the class columns of the verdict tensor.

Only those two precomputes are tiled. Tile (i, j) runs on grid device
(i, j); `gather` brings the tiles to the lead device and concatenates them
in grid order. Every tensor the pack scan reads lives on the lead device
(the port's form of the reference's replication fence), and the scan runs
there; so do the segmented scan's lanes, one after another, where the
reference splits them over dp (segment_axis; torch_solver.make_device_run
says why). Since the tiles split output axes only (no reduction crosses a
tile), the gathered tensors equal the single-device ones exactly, and
placements are byte-identical.

A grid may span processes (world_grid, under a torch.distributed world;
solver/factory.py starts it): each cell then carries its rank beside its
device, in rank order and then in local order. A process computes only
its own cells' tiles, `gather` is a collective (all_gather of every rank's
tiles, each padded to the largest tile and trimmed again from the same
bounds) after which every rank holds the whole tensor on its own lead, and
every rank runs the scan: the reference's replicated scan, where every
process holds the whole output. The contract is SPMD: every rank makes
the same solves with the same inputs, so each meets the same collectives
in the same order; a rank that meets another raises at the group's
timeout. The collectives go over NCCL where every rank's cards are its own
and over gloo otherwise (ranks that share a card; the CPU), the grid's
`backend`.

A spec is a tuple naming, per tensor axis, the grid axis that splits it
('dp', 'tp') or None; the empty tuple is replicated. An axis that does not
divide its grid axis splits unevenly (torch.tensor_split's rule).

A device may appear more than once in a grid: a logical grid, several
tiles on one card or on the CPU, runs the same tiling, launches and
gathers (the tests' 4 x 2 grid of CPU devices; chip_smoke's 2 x 2 grid on
one card), the port's counterpart of the reference's virtual devices.

The reference's `cache_salt` has no counterpart: it works around XLA:CPU's
nondeterministic deserialization of multi-device executables from the
persistent cache, and the port serializes no program.
"""
from __future__ import annotations

import datetime
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# what gather() has moved since the last reset: calls, tile bytes gathered,
# those of them that came from another device than the lead, those that
# came from another rank, the host ms of the gathers and the ms of their
# collectives (a grid over processes)
GATHER: Dict[str, float] = {"calls": 0, "bytes": 0, "moved_bytes": 0, "rank_bytes": 0,
                            "host_ms": 0.0, "collective_ms": 0.0}


class GridCollectiveError(RuntimeError):
    """A gather's collective failed or timed out: the ranks did not meet at
    the same collective, or one is gone. Raised through the solve: it
    never degrades to another path."""


def reset_gather() -> None:
    for k in GATHER:
        GATHER[k] = 0


@dataclass(frozen=True)
class DeviceGrid:
    """A frozen dp x tp grid of torch devices (the reference's jax Mesh
    with axes ('dp', 'tp')): `devices[i][j]` is the device of dp row i and
    tp column j. On a grid over processes (world_grid) `ranks[i][j]` is
    the rank that owns cell (i, j), whose own name for its device
    `devices[i][j]` is; `rank` is this process's, `backend` the
    collectives' ("gloo" or "nccl"; "local" in one process), and `group`
    the NCCL subgroup (None: the default group)."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    ranks: Optional[Tuple[Tuple[int, ...], ...]] = None
    rank: int = 0
    backend: str = "local"
    group: object = field(default=None, compare=False, repr=False)
    timeout: Optional[datetime.timedelta] = field(default=None, compare=False, repr=False)

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
    def world(self) -> int:
        """The number of processes the grid spans."""
        return 1 if self.ranks is None else len({r for row in self.ranks for r in row})

    @property
    def spans_processes(self) -> bool:
        return self.world > 1

    def owner(self, i: int, j: int) -> int:
        return self.rank if self.ranks is None else self.ranks[i][j]

    def is_local(self, i: int, j: int) -> bool:
        return self.ranks is None or self.ranks[i][j] == self.rank

    def cells(self) -> List[Tuple[int, int]]:
        """This process's cells, in grid order."""
        return [(i, j) for i in range(len(self.devices)) for j in range(len(self.devices[0]))
                if self.is_local(i, j)]

    @property
    def lead(self) -> torch.device:
        """This process's first device: where its gathers land and its
        scan runs."""
        i, j = self.cells()[0]
        return self.devices[i][j]

    def distinct(self) -> List[torch.device]:
        """Each of this process's devices once, in grid order."""
        out: List[torch.device] = []
        for i, j in self.cells():
            if self.devices[i][j] not in out:
                out.append(self.devices[i][j])
        return out


# this process's NCCL subgroup of the default world: (the world's group,
# the subgroup), made once by world_grid (every rank makes the same calls)
_NCCL: List[object] = [None, None]


def _card_ids(devices: Sequence[torch.device]) -> Optional[List[str]]:
    """The UUIDs of the cards among `devices`; None when any is not a card."""
    if not devices or any(d.type != "cuda" for d in devices):
        return None
    return [str(torch.cuda.get_device_properties(d).uuid) for d in devices]


def world_grid(local: Sequence, tp_of: Callable[[int], int],
               timeout: datetime.timedelta) -> DeviceGrid:
    """The grid over every rank's devices under the default process group:
    rank order, then each rank's `local` order; `tp_of(n)` gives tp for n
    devices in all, and `timeout` bounds each gather's collective. One
    all_gather_object collects every rank's devices (ranks with unequal
    counts raise) and their cards' UUIDs: where every device is a card and
    no card is seen by two ranks, the tiles go over an NCCL subgroup made
    here once per world (every rank makes it, as new_group requires);
    otherwise over the default (gloo) group."""
    import torch.distributed as dist

    local = [torch.device(d) for d in local]
    rank, world = dist.get_rank(), dist.get_world_size()
    every: List[object] = [None] * world
    dist.all_gather_object(every, ([str(d) for d in local], _card_ids(local)))
    counts = [len(names) for names, _ids in every]
    if len(set(counts)) != 1 or not counts[0]:
        raise RuntimeError(f"detect_mesh: the ranks see unequal or no device counts {counts}; "
                           f"a grid over processes needs as many devices on every rank")
    tp = tp_of(sum(counts))
    devs = [torch.device(n) for names, _ids in every for n in names]
    owners = [r for r, (names, _ids) in enumerate(every) for _n in names]
    card_sets = [set(ids) if ids is not None else None for _names, ids in every]
    own_cards = (all(c is not None for c in card_sets)
                 and sum(len(c) for c in card_sets) == len(set().union(*card_sets)))
    backend, group = "gloo", None
    if own_cards and dist.is_nccl_available():
        if _NCCL[0] is not dist.group.WORLD:
            # made once per world, and its communicator's set-up (seconds
            # on several cards) paid here, at build time, not in the
            # first solve's gather
            sub = dist.new_group(backend="nccl", timeout=timeout)
            dist.all_reduce(torch.zeros(1, device=local[0]), group=sub)
            torch.cuda.synchronize(local[0])
            _NCCL[:] = [dist.group.WORLD, sub]
        backend, group = "nccl", _NCCL[1]
    rows = len(devs) // tp
    return DeviceGrid(tuple(tuple(devs[r * tp:(r + 1) * tp]) for r in range(rows)),
                      tuple(tuple(owners[r * tp:(r + 1) * tp]) for r in range(rows)),
                      rank, backend, group, timeout)


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

    def _tile_shape(self, shape: Sequence[int], spec, i: int, j: int) -> Tuple[int, ...]:
        out = list(shape)
        for d, axis in enumerate(spec):
            if axis is not None:
                lo, hi = _bounds(shape[d], self._parts(axis))[i if axis == self.dp_axis else j]
                out[d] = hi - lo
        return tuple(out)

    def split(self, x, spec: tuple) -> List[list]:
        """The tiles of `x` under `spec`: tiles[i][j] on grid device (i, j)
        (a view where that is x's own device) for this process's cells,
        None for another rank's. A dict splits leaf by leaf, each tile a
        dict."""
        grid = self.mesh.devices
        if isinstance(x, dict):
            per = {k: self.split(v, spec) for k, v in x.items()}
            return [[{k: per[k][i][j] for k in x} if self.mesh.is_local(i, j) else None
                     for j in range(self.ntp)] for i in range(self.ndp)]
        return [[self._tile(x, spec, i, j).to(grid[i][j]) if self.mesh.is_local(i, j) else None
                 for j in range(self.ntp)] for i in range(self.ndp)]

    def split_arg(self, targs, name: str, x, spec: tuple) -> List[list]:
        """`x`'s tiles under `spec`: those put_args uploaded for argument
        `name` where their spec is this one, else split from `x`."""
        pre = getattr(targs, "tiles", None)
        pre = pre.get(name) if pre else None
        if isinstance(x, dict):
            got = {k: (pre[k][1] if pre and k in pre and pre[k][0] == spec
                       else self.split(v, spec)) for k, v in x.items()}
            return [[{k: got[k][i][j] for k in x} if self.mesh.is_local(i, j) else None
                     for j in range(self.ntp)] for i in range(self.ndp)]
        if pre is not None and pre[0] == spec:
            return pre[1]
        return self.split(x, spec)

    def gather(self, tiles: List[list], spec: tuple, shape: Optional[Sequence[int]] = None,
               dtype: Optional[torch.dtype] = None, row: int = 0) -> torch.Tensor:
        """The whole tensor on this process's lead device, its tiles
        concatenated in grid order: equal to the one the tiles were split
        from. `tiles[i][j]` is cell (i, j)'s tile, present for this
        process's cells. A grid axis the spec does not split reads one
        tile: column 0, and dp row `row`. On a grid over processes the
        tiles of every rank arrive through one all_gather, which every
        rank must make with the same `spec` and the whole tensor's `shape`
        and `dtype` (each rank's tiles are padded to the largest and
        trimmed again from the same bounds); a collective that fails or
        times out raises GridCollectiveError (a RuntimeError)."""
        t0 = time.perf_counter()
        dp_dim = spec.index(self.dp_axis) if self.dp_axis in spec else None
        tp_dim = spec.index(self.tp_axis) if self.tp_axis in spec else None
        cells = [(i, j) for i in (range(self.ndp) if dp_dim is not None else (row,))
                 for j in (range(self.ntp) if tp_dim is not None else (0,))]
        if self.mesh.spans_processes:
            if shape is None or dtype is None:
                raise ValueError("gather over processes needs the whole tensor's shape and "
                                 "dtype")
            got = self._collect(tiles, cells, spec, tuple(shape), dtype)
        else:
            got = {}
            for i, j in cells:
                t = tiles[i][j]
                nbytes = t.numel() * t.element_size()
                GATHER["bytes"] += nbytes
                if t.device != self.lead:
                    GATHER["moved_bytes"] += nbytes
                got[(i, j)] = t.to(self.lead)
        rows = []
        for i in sorted({c[0] for c in cells}):
            row_t = [got[(i, j)] for j in sorted({c[1] for c in cells})]
            rows.append(torch.cat(row_t, dim=tp_dim) if tp_dim is not None else row_t[0])
        out = torch.cat(rows, dim=dp_dim) if dp_dim is not None else rows[0]
        GATHER["calls"] += 1
        GATHER["host_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def _collect(self, tiles, cells, spec, shape, dtype) -> Dict[Tuple[int, int], torch.Tensor]:
        """`cells`' tiles on this rank's lead, every rank's through one
        all_gather of a byte buffer per rank: its cells' tiles in grid
        order, each zero-padded to the largest tile's shape, in as many
        slots as the rank that owns the most of `cells`."""
        import torch.distributed as dist

        grid, lead = self.mesh, self.lead
        elsize = torch.empty((), dtype=dtype).element_size()
        shapes = {c: self._tile_shape(shape, spec, *c) for c in cells}
        nbytes = {c: int(np.prod(sh, dtype=np.int64)) * elsize for c, sh in shapes.items()}
        pad = tuple(max(sh[d] for sh in shapes.values()) for d in range(len(shape)))
        slot = int(np.prod(pad, dtype=np.int64)) * elsize
        by_rank: Dict[int, List[Tuple[int, int]]] = {}
        for c in cells:
            by_rank.setdefault(grid.owner(*c), []).append(c)
            GATHER["bytes"] += nbytes[c]
            if grid.devices[c[0]][c[1]] != lead or grid.owner(*c) != grid.rank:
                GATHER["moved_bytes"] += nbytes[c]
            if grid.owner(*c) != grid.rank:
                GATHER["rank_bytes"] += nbytes[c]
        mine = by_rank.get(grid.rank, [])
        got = {c: tiles[c[0]][c[1]].to(lead) for c in mine}
        k = max(len(v) for v in by_rank.values())
        if not slot:
            return {c: got.get(c, torch.empty(shapes[c], dtype=dtype, device=lead))
                    for c in cells}
        via = lead if grid.backend == "nccl" else torch.device("cpu")
        buf = torch.zeros((k, slot), dtype=torch.uint8, device=via)
        for n, c in enumerate(mine):
            padded = torch.zeros(pad, dtype=dtype, device=via)
            padded[tuple(slice(0, s) for s in shapes[c])] = got[c]
            buf[n] = padded.reshape(-1).view(torch.uint8)
        outs = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
        t0 = time.perf_counter()
        try:
            dist.all_gather(outs, buf, group=grid.group, async_op=True).wait(
                timeout=grid.timeout)
        except Exception as exc:  # noqa: BLE001 — raised as the solve's failure
            raise GridCollectiveError(f"grid gather of {list(shape)} {dtype} over {grid.world} "
                               f"ranks ({grid.backend}) failed: {exc}") from exc
        GATHER["collective_ms"] += (time.perf_counter() - t0) * 1e3
        for r, owned in by_rank.items():
            if r == grid.rank:
                continue
            for n, c in enumerate(owned):
                t = outs[r][n].view(dtype).reshape(pad)
                got[c] = t[tuple(slice(0, s) for s in shapes[c])].to(lead)
        return got

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
        precomputes read them (split_arg): this process's tiles only."""
        lead = self.lead
        grid = self.mesh.devices

        def host(a):
            a = np.ascontiguousarray(a)
            return torch.from_numpy(a.copy() if not a.flags.writeable else a)

        def tiles_of(t, spec):
            return [[self._tile(t, spec, i, j).contiguous().to(grid[i][j])
                     if self.mesh.is_local(i, j) else None
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
