"""The one place that decides which solver serves a Solve()
(solver/factory.py of the reference).

    build_solver(max_nodes=1024, mode=None, device=None)

mode (default "auto"): "auto" and "single" give a TorchSolver on the CUDA
card; "sharded" raises NotImplementedError until the multi-GPU slice
(ROADMAP Queue A). With more than one card "auto" stays single until then.
device: "cuda" by default; with no card the factory raises, and it never
falls back to the CPU unless the caller passes device="cpu".

    build_primary(max_nodes=1024, host_default=False, device=None)

is the process entry's primary: with KARPENTER_SOLVER_HOST on (the
entry passes host_default=True, so the host is its default) a HostSolver,
whose supervised child process (solver/host.py) solves on `device`;
otherwise build_solver's in-process TorchSolver. The out-of-process
primaries (HostSolver, service.RemoteSolver) answer health(), the probe
ResilientSolver's breaker re-admits them through.
"""
from __future__ import annotations

from typing import Optional

from karpenter_core_tpu_torch.obs import envflags

MODES = ("auto", "single", "sharded")


def build_solver(max_nodes: int = 1024, mode: Optional[str] = None,
                 device: Optional[str] = None, **solver_kwargs):
    """The primary solver; `solver_kwargs` go to TorchSolver
    (screen_mode, incremental, max_relax_rounds)."""
    import torch

    from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

    mode = (mode or "auto").lower()
    if mode not in MODES:
        raise ValueError(f"unknown solver mode {mode!r}; expected one of {MODES}")
    if mode == "sharded":
        raise NotImplementedError(
            "the sharded solver is not ported yet (ROADMAP Queue A: multi-GPU)")
    device = device or "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_solver: no CUDA card is available; pass device='cpu' "
                           "to solve on the CPU")
    return TorchSolver(max_nodes=max_nodes, device=device, **solver_kwargs)



def describe(solver) -> str:
    """One line naming the chosen solver, for the start-up log."""
    name = type(solver).__name__
    device = getattr(solver, "device", None)
    return f"{name}({device})" if device is not None else name


def host_mode_enabled(default: bool = False) -> bool:
    """KARPENTER_SOLVER_HOST: run the device dispatch in a supervised
    solver host process instead of in-process."""
    return envflags.get_bool("KARPENTER_SOLVER_HOST", default)


def build_primary(max_nodes: int = 1024, host_default: bool = False,
                  device: Optional[str] = None, **kwargs):
    """The process entry's primary: the hard-killable HostSolver when
    KARPENTER_SOLVER_HOST resolves on (a wedge kills and respawns its
    child), build_solver's in-process TorchSolver otherwise. `kwargs` go
    to the solver built."""
    if host_mode_enabled(host_default):
        from karpenter_core_tpu_torch.solver.host import HostSolver

        return HostSolver(max_nodes=max_nodes, device=device or "cuda", **kwargs)
    return build_solver(max_nodes=max_nodes, device=device, **kwargs)
