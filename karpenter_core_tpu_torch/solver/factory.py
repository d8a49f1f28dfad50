"""The one place that decides which solver serves a Solve()
(solver/factory.py of the reference).

    build_solver(max_nodes=1024, mode=None, device=None, devices=None)

mode (KARPENTER_SOLVER_MODE when None, default "auto"):
  auto     more than one visible device -> ShardedSolver over a dp x tp
           DeviceGrid (parallel/); otherwise TorchSolver;
  single   TorchSolver whatever the device count;
  sharded  ShardedSolver; raises RuntimeError with one device.
device: "cuda" by default; with no card the factory raises, and it never
falls back to the CPU unless the caller passes device="cpu". `devices`
names the grid's devices directly (the tests pass logical CPU devices).

The visible devices (visible_devices) are the process's CUDA cards, or the
one CPU device for device="cpu"; KARPENTER_MESH_LOGICAL_DEVICES=N makes
them N logical devices on the first card (on the CPU for device="cpu"),
the port's counterpart of the reference's virtual devices (XLA's host
platform device count): the grid's tiles, launches and gathers then all
run on that one card.

Grid shape: tp = KARPENTER_MESH_TP when set; else 2 when the device count
is even and at least 4, else 1 (the reference's rule); dp takes the rest.

Several processes (the reference's multi-host mesh): with
KARPENTER_DIST_COORDINATOR=host:port, ensure_distributed() starts the
default torch.distributed group (gloo) over tcp://host:port with
KARPENTER_DIST_NUM_PROCESSES and KARPENTER_DIST_PROCESS_ID; "auto" takes
the launcher's environment instead (env://: MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, as torchrun or a JobSet sets them). The group's timeout
is DIST_TIMEOUT, so a rank that is never met raises instead of hanging.
Under a world of several processes detect_mesh lays the grid over every
rank's visible devices, in rank order and then in local order (as
jax.devices() orders processes); ranks with unequal device counts raise.
A tp pair may then span two ranks. The collectives take NCCL where every
rank's cards are its own (a subgroup made after the ranks compared their
cards' UUIDs), gloo otherwise: NCCL refuses two ranks on one card, and
the CPU has only gloo. The grid (parallel/specs.DeviceGrid) names the
backend. Every rank calls solve() with the same inputs and gets the same
placements (the reference's SPMD contract); see parallel/specs.py.

    build_primary(max_nodes=1024, host_default=False, device=None)

is the process entry's primary: with KARPENTER_SOLVER_HOST on (the
entry passes host_default=True, so the host is its default) a HostSolver,
whose supervised child process (solver/host.py) builds its service over
detect_mesh() under KARPENTER_SOLVER_MODE on `device`; otherwise
build_solver's in-process solver. The out-of-process primaries
(HostSolver, service.RemoteSolver) answer health(), the probe
ResilientSolver's breaker re-admits them through.
"""
from __future__ import annotations

import datetime
from typing import Optional

from karpenter_core_tpu_torch.obs import envflags

MODES = ("auto", "single", "sharded")
# how long a rank waits at the rendezvous or in a collective for the others
# before it raises: a rank that is never met, or that meets another
# collective, fails the solve instead of hanging it
DIST_TIMEOUT = datetime.timedelta(seconds=300)


def ensure_distributed() -> bool:
    """Start the default process group from KARPENTER_DIST_* when it is
    set (the module docstring); idempotent. Returns whether a group is up,
    this call's or one the caller made; False, and nothing started,
    without a coordinator. A coordinator without _NUM_PROCESSES or
    _PROCESS_ID raises KeyError naming the variable."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    coordinator = envflags.raw("KARPENTER_DIST_COORDINATOR")
    if not coordinator:
        return False
    if coordinator == "auto":
        dist.init_process_group("gloo", init_method="env://", timeout=DIST_TIMEOUT)
    else:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}",
            world_size=int(envflags.require("KARPENTER_DIST_NUM_PROCESSES")),
            rank=int(envflags.require("KARPENTER_DIST_PROCESS_ID")), timeout=DIST_TIMEOUT)
    return True


def refuse_spanning(what: str, mesh=None) -> None:
    """RuntimeError when `what` (a server or an entry that takes requests
    in one process) would serve a grid over processes: `mesh` spans
    several, or KARPENTER_DIST_COORDINATOR is set, or the caller's process
    group has more than one rank. The other ranks would never call the
    grid's collectives, and the solve would wait on them."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if ((mesh is not None and mesh.spans_processes) or world > 1
            or envflags.raw("KARPENTER_DIST_COORDINATOR")):
        raise RuntimeError(f"{what} takes requests in one process and cannot serve a device "
                           f"grid over processes: every rank must call solve() itself "
                           f"(build_solver under KARPENTER_DIST_COORDINATOR)")


def visible_devices(device: Optional[str] = None) -> list:
    """The devices a grid may span (see the module docstring): every CUDA
    card for device None or "cuda", the CPU for "cpu", or
    KARPENTER_MESH_LOGICAL_DEVICES logical devices on the first of them."""
    import torch

    kind = torch.device(device or "cuda").type
    logical = int(envflags.raw("KARPENTER_MESH_LOGICAL_DEVICES", "0") or 0)
    if kind == "cpu":
        return [torch.device("cpu")] * max(logical, 1)
    cards = [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
    if logical and cards:
        return [cards[0]] * logical
    return cards


def _grid_tp(n: int, tp: Optional[int]) -> int:
    """KARPENTER_MESH_TP, else the reference's rule; checked against n."""
    if tp is None:
        tp_env = envflags.raw("KARPENTER_MESH_TP")
        tp = int(tp_env) if tp_env else (2 if n % 2 == 0 and n >= 4 else 1)
    if tp < 1 or n % tp != 0:
        raise ValueError(f"tp={tp} does not divide device count {n}")
    return tp


def detect_mesh(devices=None, tp: Optional[int] = None, device: Optional[str] = None):
    """The dp x tp DeviceGrid over `devices` (default: visible_devices(
    device), after ensure_distributed(); under a world of several
    processes, every rank's, parallel/specs.world_grid); None below two
    devices."""
    from karpenter_core_tpu_torch.parallel import specs

    if devices is None:
        devices = visible_devices(device)
        if ensure_distributed():
            import torch.distributed as dist

            if dist.get_world_size() > 1:
                return specs.world_grid(devices, lambda n: _grid_tp(n, tp), DIST_TIMEOUT)
    n = len(devices)
    if n < 2:
        return None
    return specs.DeviceGrid.of(devices, _grid_tp(n, tp))


def describe(solver) -> str:
    """One line naming the chosen solver, for the start-up log: its grid's
    shape, or else its device."""
    name = type(solver).__name__
    mesh = getattr(solver, "mesh", None)
    if mesh is not None:
        return f"{name}(dp={mesh.shape['dp']}, tp={mesh.shape['tp']})"
    device = getattr(solver, "device", None)
    return f"{name}({device})" if device is not None else name


def build_solver(max_nodes: int = 1024, mode: Optional[str] = None,
                 device: Optional[str] = None, devices=None, **solver_kwargs):
    """The primary solver; `solver_kwargs` go to TorchSolver or
    ShardedSolver (screen_mode, incremental, max_relax_rounds, pack_scan).
    The port's detection reads only the device counts, which cannot wedge,
    so a detection that raises (a tp that does not divide, ranks with
    unequal counts) raises in every mode."""
    import torch

    mode = (mode or envflags.raw("KARPENTER_SOLVER_MODE", "auto") or "auto").lower()
    if mode not in MODES:
        raise ValueError(f"unknown solver mode {mode!r}; expected one of {MODES}")
    mesh = detect_mesh(devices, device=device) if mode != "single" else None
    if mesh is not None:
        from karpenter_core_tpu_torch.parallel.sharded import ShardedSolver

        return ShardedSolver(mesh, max_nodes=max_nodes, **solver_kwargs)
    if mode == "sharded":
        raise RuntimeError("KARPENTER_SOLVER_MODE=sharded but only one device is visible")
    from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

    device = device or "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_solver: no CUDA card is available; pass device='cpu' "
                           "to solve on the CPU")
    return TorchSolver(max_nodes=max_nodes, device=device, **solver_kwargs)


def host_mode_enabled(default: bool = False) -> bool:
    """KARPENTER_SOLVER_HOST: run the device dispatch in a supervised
    solver host process instead of in-process."""
    return envflags.get_bool("KARPENTER_SOLVER_HOST", default)


def build_primary(max_nodes: int = 1024, host_default: bool = False,
                  device: Optional[str] = None, **kwargs):
    """The process entry's primary: the hard-killable HostSolver when
    KARPENTER_SOLVER_HOST resolves on (a wedge kills and respawns its
    child), build_solver's in-process solver otherwise. `kwargs` go to the
    solver built. The entry takes requests in one process, so it refuses a
    grid over processes (refuse_spanning)."""
    refuse_spanning("the process entry")
    if host_mode_enabled(host_default):
        from karpenter_core_tpu_torch.solver.host import HostSolver

        return HostSolver(max_nodes=max_nodes, device=device or "cuda", **kwargs)
    return build_solver(max_nodes=max_nodes, device=device, **kwargs)
