"""The reference's multi-device suites, run on the port over logical CPU
devices.

Each case runs from its suite's own source, executed under an `__import__`
that maps every import of the reference package to the port's module of
the same path (tests/torch_suites.py), and must pass on the port; the
reference's own run of each case is its own file's. The reference's suites
run on 8 virtual CPU devices (tests/conftest.py); their counterpart here is
a grid of 8 logical CPU devices: `factory.visible_devices` returns
`[torch.device("cpu")] * 8` while a case runs, so `detect_mesh()` gives a
4 x 2 grid, and the `mesh` fixture of tests/test_sharded.py is that grid.

The suites: tests/test_solver_factory.py, all 16 cases (the factory, the
ShardedSolver surface, `serve(mesh=True)` with RemoteSolver, the entry's
`run()` building the sharded primary), and tests/test_sharded.py's parity
families and solver-surface cases (7 of 12).

Where the port's counterpart has another name or needs the CPU:
- `TPUSolver(...)` is `TorchSolver(..., device="cpu")`, and `isinstance`
  against either of `TPUSolver` and `ShardedSolver` checks the port's class
  of that role (TorchSolver, parallel/sharded.ShardedSolver); `_compiled`
  reads the solver's warm keys, (solve geometry, screen mode, grid key);
- `build_solver` and `run` get `device="cpu"`;
- `describe` names the single-device solver "TorchSolver(cpu)", which the
  suite's "TPUSolver" stands for.

Left out of tests/test_sharded.py (LEFT_OUT), each with its counterpart in
tests/test_torch_sharded.py:
- `test_mesh_and_single_keys_never_collide`: its mesh key is the
  reference's ("gspmd", 4, 2); the port's is ("grid", 4, 2)
  (`test_mesh_and_single_keys_never_collide`);
- `test_mesh_program_has_no_host_roundtrips`,
  `test_segmented_mesh_program_fence` and
  `test_single_device_program_unchanged_by_layout_plumbing`: they read the
  jaxpr of a jit-compiled program, which the port does not have; the
  port's fence is that every tensor entering the scan sits on the lead
  device and came through the gather, and that the single device gathers
  nothing (`test_scan_inputs_sit_on_the_lead_device`);
- `test_sharded_prewarm_aot_hits_live_solve`: reads `fn.aot`, an XLA AOT
  executable; the port's is "the prewarmed mesh tier's live solve is a
  compile-cache hit" (`test_prewarmed_mesh_tier_live_solve_hits`).
"""
import functools
import re

import pytest
import torch

# each package's fake provider registers its well-known labels on import
from karpenter_core_tpu.cloudprovider import fake as _ref_fake  # noqa: F401
from karpenter_core_tpu_torch.cloudprovider import fake as _port_fake  # noqa: F401
from karpenter_core_tpu_torch.operator import __main__ as tentry
from karpenter_core_tpu_torch.parallel.sharded import ShardedSolver
from karpenter_core_tpu_torch.parallel.specs import DeviceGrid
from karpenter_core_tpu_torch.solver import factory as tfactory
from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

import tests.test_sharded as sharded
import tests.test_solver_factory as solver_factory
from tests.test_torch_entry import gc_state, process_state  # noqa: F401  (fixtures)
from tests.torch_suites import (  # noqa: F401  (restore_process_state: autouse)
    PORT,
    Mapping,
    PortSuites,
    cases,
    cpu_substitutes,
    reference_owned,
    restore_process_state,
)

SUITES = {"solver_factory": solver_factory, "sharded": sharded}
LEFT_OUT = {
    "sharded": {
        "test_mesh_and_single_keys_never_collide":
            "the reference's mesh key is ('gspmd', 4, 2), the port's ('grid', 4, 2): "
            "test_torch_sharded.py's case of that name",
        "test_mesh_program_has_no_host_roundtrips":
            "reads a jaxpr: test_torch_sharded.py's test_scan_inputs_sit_on_the_lead_device",
        "test_segmented_mesh_program_fence":
            "reads a jaxpr: test_torch_sharded.py's test_scan_inputs_sit_on_the_lead_device",
        "test_single_device_program_unchanged_by_layout_plumbing":
            "reads a jaxpr: test_torch_sharded.py's test_scan_inputs_sit_on_the_lead_device",
        "test_sharded_prewarm_aot_hits_live_solve":
            "reads fn.aot, an XLA AOT executable: test_torch_sharded.py's "
            "test_prewarmed_mesh_tier_live_solve_hits",
    },
}
LOGICAL_DEVICES = 8


class _PortRole(type):
    """isinstance against a suite's name checks the port's class of that
    role (the class's first base)."""

    def __instancecheck__(cls, obj):
        return isinstance(obj, cls.__mro__[1])


class SuiteTPUSolver(TorchSolver, metaclass=_PortRole):
    def __init__(self, max_nodes: int = 1024, **_kw):
        super().__init__(max_nodes=max_nodes, device="cpu")

    @property
    def _compiled(self):
        return self._warm_keys


class SuiteShardedSolver(ShardedSolver, metaclass=_PortRole):
    @property
    def _compiled(self):
        return self._warm_keys


def _describe(solver) -> str:
    return re.sub(r"^TorchSolver\(cpu\)$", "TPUSolver", tfactory.describe(solver))


def _substitutes() -> dict:
    subs = cpu_substitutes()
    subs.update({
        (f"{PORT}.solver.torch_solver", "TPUSolver"): SuiteTPUSolver,
        (f"{PORT}.parallel.sharded", "ShardedSolver"): SuiteShardedSolver,
        (f"{PORT}.solver.factory", "build_solver"):
            functools.partial(tfactory.build_solver, device="cpu"),
        (f"{PORT}.solver.factory", "describe"): _describe,
        (f"{PORT}.operator.__main__", "run"): functools.partial(tentry.run, device="cpu"),
    })
    return subs


MAPPING = Mapping(_substitutes(), mapped_suites={"tests.test_differential_fuzz",
                                                 "tests.test_differential_fuzz_wide"})
PORT_SUITES = PortSuites(MAPPING)


@pytest.fixture(scope="module")
def _logical_mesh():
    """The `mesh` of tests/test_sharded.py: a 4 x 2 grid of CPU devices."""
    return DeviceGrid.of([torch.device("cpu")] * LOGICAL_DEVICES, 2)


CASES = [c for name, suite in SUITES.items()
         for c in cases(name, suite, left_out=LEFT_OUT.get(name, ()))]


@pytest.fixture(scope="module", autouse=True)
def _module_fixtures():
    yield
    PORT_SUITES.finish()


@pytest.mark.parametrize("suite,case,params", [c[:3] for c in CASES],
                         ids=[f"{c[0]}-{c[3]}" for c in CASES])
def test_case_passes_on_the_port(suite, case, params, tmp_path, monkeypatch, process_state):
    monkeypatch.setattr(tfactory, "visible_devices",
                        lambda device=None: [torch.device("cpu")] * LOGICAL_DEVICES)
    ns = PORT_SUITES.namespace(SUITES[suite])
    if "mesh" in ns:
        ns["mesh"] = _logical_mesh
    PORT_SUITES.run(SUITES[suite], case, params, tmp_path)


def test_cases_cover_the_suites():
    counts = {name: sum(1 for c in CASES if c[0] == name) for name in SUITES}
    assert counts == {"solver_factory": 16, "sharded": 7}
    for name, left in LEFT_OUT.items():
        for case in left:
            assert case in vars(SUITES[name]), (name, case)


def test_port_run_reaches_no_reference_object():
    """Every name a suite takes from the reference package resolves in the
    port (the builders of the suites it imports included), but the jax
    Mesh the sharded suite's own fixture would build, which is replaced."""
    for suite in SUITES.values():
        for k, v in PORT_SUITES.namespace(suite).items():
            if k in ("__builtins__",):
                continue
            assert not reference_owned(v), (suite.__name__, k)
