"""The reference's suites of the solver service, the solver host, the
program inventory, fair-share admission and tenant attribution, run on the
port.

Each case runs from its suite's own source, executed under an `__import__`
that maps every import of the reference package to the port's module of
the same path (tests/test_torch_entry_suites.py's method), and must pass.
These suites spawn solver children and gRPC servers, so each case runs on
the port only: the reference's own run is its own file's. A suite's
module-scoped fixtures (its gRPC server, its HostSolver) are made once per
suite here too, and torn down when this file ends.

Where the port's counterpart needs the CPU or has another name:
- `TPUSolver(...)` is `TorchSolver(..., device="cpu")` (as in the entry
  suites), `HostSolver(...)` and `serve(...)` get `device="cpu"`,
  `new_operator` without a solver gets `TorchSolver(device="cpu")`, and
  `SoakDriver` without a solver gets `TorchSolver(max_nodes,
  screen_mode="prescreen", device="cpu")`;
- `karpenter_core_tpu.chaos` is the port's `chaos`: the cases that arm
  faults (the host's crash, the wedge's hang, the gate's overload and
  flood, the RPC's retry budget) arm the port's points.

Left out, by case (LEFT_OUT): the two timing-dependent cases ROADMAP
Queue C names as the reference's own reds.

tests/test_torch_chaos_suites.py runs the chaos and loadgen suites with
this file's runner.
"""
import builtins
import functools
import inspect
import types

import pytest

# each package's fake provider registers its well-known labels on import
from karpenter_core_tpu.cloudprovider import fake as _ref_fake  # noqa: F401
from karpenter_core_tpu_torch.cloudprovider import fake as _port_fake  # noqa: F401
from karpenter_core_tpu_torch.solver import host as thost
from karpenter_core_tpu_torch.solver import service as tservice

import tests.test_admission_fairshare as admission_fairshare
import tests.test_proghealth as proghealth_suite
import tests.test_solver_host as solver_host
import tests.test_solver_service as solver_service
import tests.test_tenant_attribution as tenant_attribution
from tests.test_torch_entry_suites import (
    PORT,
    PortTPUSolver,
    _cpu_new_operator,
    _reference_owned,
    port_module_name,
)

SUITES = {
    "solver_service": solver_service,
    "solver_host": solver_host,
    "proghealth": proghealth_suite,
    "admission_fairshare": admission_fairshare,
    "tenant_attribution": tenant_attribution,
}
LEFT_OUT = {
    "solver_host": {
        "test_warm_respawn_fraction_of_cold_start":
            "timing-dependent: a reference red (ROADMAP Queue C)",
        "test_residency_rebuilt_after_respawn":
            "timing-dependent: a reference red (ROADMAP Queue C)",
    },
}


def _cpu_host_solver(*a, **kw):
    kw.setdefault("device", "cpu")
    return thost.HostSolver(*a, **kw)


def _cpu_soak_driver(config, *a, **kw):
    from karpenter_core_tpu_torch.loadgen.driver import SoakDriver
    from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

    if kw.get("solver") is None:
        kw["solver"] = TorchSolver(max_nodes=kw.get("max_nodes", 256),
                                   screen_mode="prescreen", device="cpu")
    return SoakDriver(config, *a, **kw)


SUBSTITUTES = {
    (f"{PORT}.operator", "new_operator"): _cpu_new_operator,
    (f"{PORT}.solver.torch_solver", "TPUSolver"): PortTPUSolver,
    (f"{PORT}.solver.host", "HostSolver"): _cpu_host_solver,
    (f"{PORT}.solver.service", "serve"): functools.partial(tservice.serve, device="cpu"),
    (f"{PORT}.loadgen", "SoakDriver"): _cpu_soak_driver,
    (f"{PORT}.loadgen.driver", "SoakDriver"): _cpu_soak_driver,
}


def _proxy(module, mapped):
    subs = {attr: v for (m, attr), v in SUBSTITUTES.items() if m == mapped}
    if not subs:
        return module
    proxy = types.ModuleType(module.__name__)
    proxy.__dict__.update(vars(module))
    proxy.__dict__.update(subs)
    return proxy


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    mapped = port_module_name(name) if level == 0 else None
    module = builtins.__import__(mapped or name, globals, locals, fromlist, level)
    if mapped and fromlist:
        return _proxy(module, mapped)
    return module


PORT_BUILTINS = dict(vars(builtins), __import__=_port_import)

_NAMESPACES = {}
# (suite, fixture) -> its value, for the module-scoped fixtures; the
# generators to finish when this file ends
_MODULE_FIXTURES = {}
_MODULE_FINALIZERS = []


def _namespace(suite) -> dict:
    ns = _NAMESPACES.get(suite.__name__)
    if ns is None:
        with open(suite.__file__) as f:
            code = compile(f.read(), suite.__file__, "exec")
        ns = _NAMESPACES[suite.__name__] = {"__name__": suite.__name__,
                                            "__file__": suite.__file__,
                                            "__builtins__": PORT_BUILTINS}
        exec(code, ns)
    return ns


def _fixtures(ns) -> dict:
    out = {}
    for k, v in ns.items():
        wrapped = getattr(v, "_get_wrapped_function", None)
        if wrapped is not None:
            marker = getattr(v, "_fixture_function_marker", None)
            out[k] = (wrapped(), getattr(marker, "scope", "function"),
                      getattr(marker, "autouse", False))
    return out


def run_case(suite, case: str, params: dict, tmp_path) -> None:
    """One case on the port: its fixtures resolved (module-scoped ones
    shared across the suite's cases), the function called, the
    function-scoped fixtures finished."""
    ns = _namespace(suite)
    fixtures = _fixtures(ns)
    finalizers = []
    mp = pytest.MonkeyPatch()

    def resolve(fn):
        kwargs = {}
        for pname in inspect.signature(fn).parameters:
            if pname in params:
                kwargs[pname] = params[pname]
            elif pname == "monkeypatch":
                kwargs[pname] = mp
            elif pname == "tmp_path":
                kwargs[pname] = tmp_path
            elif pname in fixtures:
                kwargs[pname] = value(pname)
            else:
                raise LookupError(f"no fixture {pname!r}")
        return kwargs

    def value(pname):
        fx, scope, _auto = fixtures[pname]
        key = (suite.__name__, pname)
        if scope == "module" and key in _MODULE_FIXTURES:
            return _MODULE_FIXTURES[key]
        got = fx(**resolve(fx))
        if inspect.isgenerator(got):
            gen, got = got, next(got)
            (_MODULE_FINALIZERS if scope == "module" else finalizers).append(gen)
        if scope == "module":
            _MODULE_FIXTURES[key] = got
        return got

    if "::" in case:
        cls, meth = case.split("::")
        fn = getattr(ns[cls](), meth)
    else:
        fn = ns[case]
    try:
        try:
            for pname, (_fx, _scope, auto) in fixtures.items():
                if auto:
                    value(pname)
            fn(**resolve(fn))
        finally:
            for gen in reversed(finalizers):
                for _ in gen:
                    pass
    finally:
        mp.undo()


def _cases(name, suite):
    out = []
    for attr, v in sorted(vars(suite).items()):
        if attr.startswith("test_") and isinstance(v, types.FunctionType):
            methods = [(attr, v)]
        elif attr.startswith("Test") and isinstance(v, type):
            methods = [(f"{attr}::{m}", f) for m, f in sorted(vars(v).items())
                       if m.startswith("test_")]
        else:
            continue
        for case, fn in methods:
            if case in LEFT_OUT.get(name, {}):
                continue
            marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
            if not marks:
                out.append((name, case, {}, case))
                continue
            argnames, values = marks[0].args[:2]
            argnames = [a.strip() for a in argnames.split(",")] if isinstance(
                argnames, str) else list(argnames)
            for i, vals in enumerate(values):
                vals = vals if len(argnames) > 1 else (vals,)
                out.append((name, case, dict(zip(argnames, vals)), f"{case}[{i}]"))
    return out


CASES = [c for name, suite in SUITES.items() for c in _cases(name, suite)]


@pytest.fixture(scope="module", autouse=True)
def _module_fixtures():
    yield
    for gen in reversed(_MODULE_FINALIZERS):
        for _ in gen:
            pass
    _MODULE_FINALIZERS.clear()
    _MODULE_FIXTURES.clear()


@pytest.mark.parametrize("suite,case,params", [c[:3] for c in CASES],
                         ids=[f"{c[0]}-{c[3]}" for c in CASES])
def test_case_passes_on_the_port(suite, case, params, tmp_path):
    run_case(SUITES[suite], case, params, tmp_path)


def test_cases_cover_the_suites():
    counts = {name: sum(1 for c in CASES if c[0] == name) for name in SUITES}
    assert counts == {"solver_service": 10, "solver_host": 17, "proghealth": 23,
                      "admission_fairshare": 16, "tenant_attribution": 10}
    for name, cases in LEFT_OUT.items():
        for case in cases:
            assert case in vars(SUITES[name]), (name, case)


def test_port_run_reaches_no_reference_object():
    """Every name a suite takes from the reference package resolves in the
    port."""
    for suite in SUITES.values():
        for k, v in _namespace(suite).items():
            assert k == "__builtins__" or not _reference_owned(v), (suite.__name__, k)
