"""The one place that decides which solver serves a Solve()
(solver/factory.py of the reference).

    build_solver(max_nodes=1024, mode=None, device=None)

mode (default "auto"): "auto" and "single" give a TorchSolver on the CUDA
card; "sharded" raises NotImplementedError until the multi-GPU slice
(ROADMAP Queue A). With more than one card "auto" stays single until then.
device: "cuda" by default; with no card the factory raises, and it never
falls back to the CPU unless the caller passes device="cpu".
"""
from __future__ import annotations

from typing import Optional

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

