"""The reference's segmented-scan specs, run on the port.

Each case runs from its suite's own source, executed under an `__import__`
that maps every import of the reference package to the port's module of
the same path (tests/test_torch_entry_suites.py's method), and must pass
on the port. The reference's own run of each case is its own file's.

The cases:
- every spec of tests/test_segmented.py but the two written at the JAX
  kernel level (`test_partitioner_components_unit` and
  `test_frozen_lane_kernel_byte_identical`, on `jnp` and
  `build_device_solve`), whose counterparts are
  tests/test_torch_segmented.py's `test_partitioner_matches_reference`,
  `test_partitioner_components` and
  `test_lanes_match_reference_frozen_and_refresh_lanes`;
- the segmented cases of tests/test_screen_parity.py (the G1, G5 and G3
  families, the deployment-shaped batch and the pinned record's replay);
- `test_fuzz_sequential_vs_segmented` of tests/test_differential_fuzz.py
  and `test_fuzz_g3_/g4_sequential_vs_segmented` of
  tests/test_differential_fuzz_wide.py.

A suite that imports another reference suite for its workload builders
(`from tests.test_differential_fuzz import _workload`) gets that suite's
source executed under the same mapping, so its builders make the port's
objects.

Where the port's counterpart has another name or needs the CPU:
- `TPUSolver(...)` is `TorchSolver(..., device="cpu")` with the same
  max_nodes, screen mode, incremental mode and pack scan (the reference's
  backend and donation options have no counterpart);
- `solve_scan_parity` and `flightrec.replay` get `device="cpu"`.

Left out: tests/test_perf_floor.py's segmented tripwire, which counts the
reference's XLA compile-cache entries (`_segment_compiled`); the port
compiles no program.
"""
import builtins
import functools
import inspect
import types

import pytest

# each package's fake provider registers its well-known labels on import
from karpenter_core_tpu.cloudprovider import fake as _ref_fake  # noqa: F401
from karpenter_core_tpu_torch import testing as ttesting
from karpenter_core_tpu_torch.cloudprovider import fake as _port_fake  # noqa: F401
from karpenter_core_tpu_torch.obs import flightrec as tflightrec
from karpenter_core_tpu_torch.solver.torch_solver import DEFAULT_MAX_RELAX_ROUNDS, TorchSolver

import tests.test_differential_fuzz as fuzz
import tests.test_differential_fuzz_wide as fuzz_wide
import tests.test_screen_parity as screen_parity
import tests.test_segmented as segmented
from tests.test_torch_entry_suites import PORT, _reference_owned, port_module_name

SUITES = {
    "segmented": segmented,
    "screen_parity": screen_parity,
    "fuzz": fuzz,
    "fuzz_wide": fuzz_wide,
}
# the cases run, by suite (None: every test_ function but LEFT_OUT's)
SELECTED = {
    "segmented": None,
    "screen_parity": ("test_scan_parity_generic_mix",
                      "test_scan_parity_hostname_anti_affinity",
                      "test_scan_parity_relaxation_rounds",
                      "test_scan_parity_bulk_replica_groups",
                      "test_replay_lockstep_pinned_record"),
    "fuzz": ("test_fuzz_sequential_vs_segmented",),
    "fuzz_wide": ("test_fuzz_g3_sequential_vs_segmented",
                  "test_fuzz_g4_sequential_vs_segmented"),
}
LEFT_OUT = {
    "segmented": {
        "test_partitioner_components_unit":
            "JAX kernel level: test_torch_segmented.py's partitioner cases",
        "test_frozen_lane_kernel_byte_identical":
            "JAX kernel level: test_torch_segmented.py's lane case",
    },
}
# reference suites whose builders a selected suite imports: imported under
# the port's mapping too
MAPPED_SUITES = {f"tests.{m.__name__.split('.')[-1]}" for m in SUITES.values()} | {
    "tests.test_flightrec"}


class SuiteTPUSolver(TorchSolver):
    """TPUSolver's counterpart in these suites: TorchSolver on the CPU with
    the reference's strategy options."""

    def __init__(self, max_nodes: int = 1024, max_relax_rounds: int = DEFAULT_MAX_RELAX_ROUNDS,
                 screen_mode=None, incremental=None, pack_scan=None, **_kw):
        super().__init__(max_nodes=max_nodes, max_relax_rounds=max_relax_rounds,
                         device="cpu", screen_mode=screen_mode or "prescreen",
                         incremental=incremental or "on", pack_scan=pack_scan)


def _cpu_flightrec() -> types.ModuleType:
    """obs/flightrec with replay on the CPU (the suites import the module)."""
    mod = types.ModuleType(tflightrec.__name__)
    mod.__dict__.update(vars(tflightrec))
    mod.replay = functools.partial(tflightrec.replay, device="cpu")
    return mod


SUBSTITUTES = {
    (f"{PORT}.solver.torch_solver", "TPUSolver"): SuiteTPUSolver,
    (f"{PORT}.testing", "solve_scan_parity"):
        functools.partial(ttesting.solve_scan_parity, device="cpu"),
    (f"{PORT}.obs", "flightrec"): _cpu_flightrec(),
}


def _proxy(module, mapped):
    subs = {attr: v for (m, attr), v in SUBSTITUTES.items() if m == mapped}
    if not subs:
        return module
    proxy = types.ModuleType(module.__name__)
    proxy.__dict__.update(vars(module))
    proxy.__dict__.update(subs)
    return proxy


_MODULES = {}


def _port_suite_module(name: str) -> types.ModuleType:
    """A reference suite's module executed afresh under the port's
    mapping (once per name)."""
    mod = _MODULES.get(name)
    if mod is None:
        ref = __import__(name, fromlist=["_"])
        with open(ref.__file__) as f:
            code = compile(f.read(), ref.__file__, "exec")
        mod = _MODULES[name] = types.ModuleType(name)
        mod.__dict__.update(__name__=name, __file__=ref.__file__,
                            __builtins__=PORT_BUILTINS)
        exec(code, mod.__dict__)
    return mod


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and name in MAPPED_SUITES:
        return _port_suite_module(name)
    mapped = port_module_name(name) if level == 0 else None
    module = builtins.__import__(mapped or name, globals, locals, fromlist, level)
    if mapped and fromlist:
        return _proxy(module, mapped)
    return module


PORT_BUILTINS = dict(vars(builtins), __import__=_port_import)


def run_case(suite, case: str, params: dict) -> None:
    """One case on the port, its monkeypatch fixture undone after it."""
    ns = vars(_port_suite_module(suite.__name__))
    fn = ns[case]
    mp = pytest.MonkeyPatch()
    kwargs = dict(params)
    if "monkeypatch" in inspect.signature(fn).parameters:
        kwargs["monkeypatch"] = mp
    try:
        fn(**kwargs)
    finally:
        mp.undo()


def _cases(name, suite):
    out = []
    wanted = SELECTED[name]
    for attr, v in sorted(vars(suite).items()):
        if not (attr.startswith("test_") and isinstance(v, types.FunctionType)):
            continue
        if (wanted is not None and attr not in wanted) or attr in LEFT_OUT.get(name, {}):
            continue
        marks = [m for m in getattr(v, "pytestmark", []) if m.name == "parametrize"]
        if not marks:
            out.append((name, attr, {}, attr))
            continue
        argname, values = marks[0].args[:2]
        for i, val in enumerate(values):
            out.append((name, attr, {argname: val}, f"{attr}[{i}]"))
    return out


CASES = [c for name, suite in SUITES.items() for c in _cases(name, suite)]


@pytest.mark.parametrize("suite,case,params", [c[:3] for c in CASES],
                         ids=[f"{c[0]}-{c[3]}" for c in CASES])
def test_case_passes_on_the_port(suite, case, params):
    run_case(SUITES[suite], case, params)


def test_cases_cover_the_suites():
    counts = {name: sum(1 for c in CASES if c[0] == name) for name in SUITES}
    assert counts == {"segmented": 11, "screen_parity": 8, "fuzz": 3, "fuzz_wide": 6}
    for name, cases in LEFT_OUT.items():
        for case in cases:
            assert case in vars(SUITES[name]), (name, case)
    for name, cases in SELECTED.items():
        for case in cases or ():
            assert case in vars(SUITES[name]), (name, case)


def test_port_run_reaches_no_reference_object():
    """Every name a suite takes from the reference package resolves in the
    port (the builders of the suites it imports included)."""
    for suite in SUITES.values():
        for k, v in vars(_port_suite_module(suite.__name__)).items():
            if k in ("__builtins__", "validate_machines"):
                continue
            assert not _reference_owned(v), (suite.__name__, k)
