"""The one place that decides which solver serves a Solve()
(solver/factory.py of the reference).

    build_solver(max_nodes=1024, mode=None, device=None)

mode (default "auto"): "auto" and "single" give a TorchSolver on the CUDA
card; "sharded" raises NotImplementedError until the multi-GPU slice
(ROADMAP Queue A). With more than one card "auto" stays single until then.
device: "cuda" by default; with no card the factory raises, and it never
falls back to the CPU unless the caller passes device="cpu".

    build_primary(max_nodes=1024, host_default=False, device=None)

is the process entry's primary: the in-process solver of build_solver.
KARPENTER_SOLVER_HOST on (the reference entry's default, its supervised
solver host) raises NotImplementedError until the solver host is ported
(ROADMAP Queue A item 7), so the port's entry passes host_default=False.
"""
from __future__ import annotations

from typing import Optional

from karpenter_core_tpu_torch.obs import envflags

SOLVER_HOST_ITEM = "ROADMAP Queue A item 7: the solver service and host"

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
                  device: Optional[str] = None, **solver_kwargs):
    """The process entry's primary solver: build_solver's in-process
    TorchSolver; refuse_host_mode first."""
    refuse_host_mode(host_default)
    return build_solver(max_nodes=max_nodes, device=device, **solver_kwargs)


def refuse_host_mode(host_default: bool = False) -> None:
    """Raise NotImplementedError when host mode is on: the solver host is
    not ported, and the entry never runs in-process in its place."""
    if host_mode_enabled(host_default):
        raise NotImplementedError(
            f"KARPENTER_SOLVER_HOST is on, but the solver host is not ported yet "
            f"({SOLVER_HOST_ITEM}); unset it or set it off to solve in-process")
