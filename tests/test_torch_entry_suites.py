"""The reference's suites of the process entry's modules, run on the port.

Each case below runs twice from its own source: once as written, on the
reference package, and once with the suite's source executed afresh under
an `__import__` that maps every import of the reference package to the
port's module of the same path (the imports inside test bodies included),
so that each name resolves to the port's object of the same name. Both
runs must end in the same outcome: passed, or the same exception; and for
the validation suites every call of a validation function must return the
same errors.

The suites: tests/test_api_validation.py (27), tests/test_api_suite.py
(65), tests/test_webhook_server.py (7), tests/test_debug_surface.py (10),
tests/test_operator_runtime.py's options (4), leader-election
(6), scheme (2), injection (1) and threaded-start (1) cases, and
tests/test_bucket_ladder.py (12 of 13).

Where the port's counterpart has another name or needs the CPU:
- `solver/tpu_solver` is the port's `solver/torch_solver`;
- `TPUSolver(...)` is `TorchSolver(..., device="cpu")`, whose `_compiled`
  reads the solve geometries the solver has met (`_warm_keys`, keyed
  (solve_geometry, screen mode) as the reference's cache keys are);
- `new_operator` without a solver gets `TorchSolver(device="cpu")`, since
  the port's default solver raises without a card.

Left out, by case (LEFT_OUT): the one ladder case whose observable is an
XLA compile-cache entry (ROADMAP Queue A item 3).
"""
import builtins
import inspect
import types

import pytest

# each package's fake provider registers its well-known labels when it is
# imported: both are imported here so that the two label sets agree from
# the first case on, whichever suite imports its own first
from karpenter_core_tpu.cloudprovider import fake as _ref_fake  # noqa: F401
from karpenter_core_tpu.api import settings as jsettings
from karpenter_core_tpu_torch.api import settings as tsettings
from karpenter_core_tpu_torch.cloudprovider import fake as _port_fake  # noqa: F401
from karpenter_core_tpu_torch.operator import injection as tinjection
from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

import tests.test_api_suite as api_suite
import tests.test_api_validation as api_validation
import tests.test_bucket_ladder as bucket_ladder
import tests.test_debug_surface as debug_surface
import tests.test_operator_runtime as operator_runtime
import tests.test_webhook_server as webhook_server

REF, PORT = "karpenter_core_tpu", "karpenter_core_tpu_torch"
MODULE_RENAMES = {f"{REF}.solver.tpu_solver": f"{PORT}.solver.torch_solver"}

SUITES = {
    "api_validation": api_validation,
    "api_suite": api_suite,
    "webhook_server": webhook_server,
    "debug_surface": debug_surface,
    "operator_runtime": operator_runtime,
    "bucket_ladder": bucket_ladder,
}
# the operator-runtime cases this port runs (its other cases are the
# operator's, held by tests/test_torch_operator.py)
OPERATOR_RUNTIME = ("TestOptions::", "TestLeaderElection::", "TestThreadedStart::",
                    "test_scheme_registers_all_consumed_kinds",
                    "test_client_strict_scheme_rejects_unknown_kind",
                    "test_injection_context_values")
LEFT_OUT = {
    "bucket_ladder": {
        "test_prewarm_then_live_solve_hits_cache":
            "reads the XLA compile cache (the AOT executable, karpenter_compile_cache_*): "
            "no port counterpart until item 3",
    },
}
# the validation functions whose every result both runs must agree on
RECORDED = ("validate_provisioner", "validate_requirement", "validate_or_raise",
            "is_qualified_name", "is_valid_label_value")


# -- the port's counterparts --------------------------------------------------


class PortTPUSolver(TorchSolver):
    """TPUSolver's counterpart: TorchSolver on the CPU."""

    def __init__(self, max_nodes: int = 1024, **_kw):
        super().__init__(max_nodes=max_nodes, device="cpu")

    @property
    def _compiled(self):
        return self._warm_keys


def _cpu_new_operator(*a, **kw):
    from karpenter_core_tpu_torch.operator import new_operator

    if kw.get("solver") is None:
        kw["solver"] = TorchSolver(device="cpu")
    return new_operator(*a, **kw)


SUBSTITUTES = {
    (f"{PORT}.operator", "new_operator"): _cpu_new_operator,
    (f"{PORT}.solver.torch_solver", "TPUSolver"): PortTPUSolver,
}


def port_module_name(name: str):
    if name in MODULE_RENAMES:
        return MODULE_RENAMES[name]
    if name == REF or name.startswith(REF + "."):
        return PORT + name[len(REF):]
    return None


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


_CODE = {}


def _namespace(suite, port: bool) -> dict:
    """The suite's module namespace, executed afresh from its source: under
    the port's `__import__` for the port's run."""
    code = _CODE.get(suite.__name__)
    if code is None:
        with open(suite.__file__) as f:
            code = _CODE[suite.__name__] = compile(f.read(), suite.__file__, "exec")
    ns = {"__name__": suite.__name__, "__file__": suite.__file__,
          "__builtins__": PORT_BUILTINS if port else builtins}
    exec(code, ns)
    return ns


class _Run:
    """One package's run of one case: the suite's namespace (the port's
    names under the port's imports), its fixtures, and the validation
    calls recorded."""

    def __init__(self, suite, port: bool):
        g = self.globals = _namespace(suite, port)
        self.log = []
        for k in RECORDED:
            if callable(g.get(k)):
                g[k] = self._recorded(k, g[k])
        self.fixtures = {}
        for k, v in g.items():
            wrapped = getattr(v, "_get_wrapped_function", None)
            if wrapped is not None:
                self.fixtures[k] = wrapped()
        self.finalizers = []

    def _recorded(self, name, fn):
        def call(*a, **kw):
            try:
                out = fn(*a, **kw)
            except Exception as exc:
                self.log.append((name, type(exc).__name__, str(exc)))
                raise
            self.log.append((name, out))
            return out

        return call

    def _resolve(self, fn, params, monkeypatch):
        kwargs = {}
        for pname in inspect.signature(fn).parameters:
            if pname in params:
                kwargs[pname] = params[pname]
            elif pname == "monkeypatch":
                kwargs[pname] = monkeypatch
            elif pname in self.fixtures:
                fx = self.fixtures[pname]
                value = fx(**self._resolve(fx, params, monkeypatch))
                if inspect.isgenerator(value):
                    gen, value = value, next(value)
                    self.finalizers.append(gen)
                kwargs[pname] = value
            else:
                raise LookupError(f"no fixture {pname!r}")
        return kwargs

    def __call__(self, case, params):
        if "::" in case:
            cls, meth = case.split("::")
            fn = getattr(self.globals[cls](), meth)
        else:
            fn = self.globals[case]
        mp = pytest.MonkeyPatch()
        try:
            try:
                fn(**self._resolve(fn, params, mp))
                outcome = ("passed",)
            except Exception as exc:  # the outcome both runs must share
                outcome = (type(exc).__name__, str(exc))
            finally:
                for gen in reversed(self.finalizers):
                    for _ in gen:
                        pass
        finally:
            mp.undo()
        return outcome, self.log


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
            if name == "operator_runtime" and not any(
                    case.startswith(p) if p.endswith("::") else case == p
                    for p in OPERATOR_RUNTIME):
                continue
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


@pytest.fixture(autouse=True)
def _restore_process_state():
    yield
    jsettings.set_current(jsettings.Settings())
    tsettings.set_current(tsettings.Settings())
    tinjection._default_options = tinjection._default_settings = None


@pytest.mark.parametrize("suite,case,params", [c[:3] for c in CASES],
                         ids=[f"{c[0]}-{c[3]}" for c in CASES])
def test_case_outcome_matches_reference(suite, case, params):
    want = _Run(SUITES[suite], port=False)(case, params)
    got = _Run(SUITES[suite], port=True)(case, params)
    assert want[0] == ("passed",), f"the reference's run: {want[0]}"
    assert got == want


def test_cases_cover_the_suites():
    counts = {name: sum(1 for c in CASES if c[0] == name) for name in SUITES}
    assert counts == {"api_validation": 27, "api_suite": 65, "webhook_server": 7,
                      "debug_surface": 10, "operator_runtime": 14, "bucket_ladder": 12}
    for name, cases in LEFT_OUT.items():
        for case in cases:
            assert case in vars(SUITES[name]), (name, case)


def _reference_owned(v) -> bool:
    if isinstance(v, (tuple, list, frozenset, set)):
        return any(_reference_owned(x) for x in v)
    if isinstance(v, dict):
        return any(_reference_owned(x) for x in v.values())
    if isinstance(v, types.ModuleType):
        owner = v.__name__
    elif isinstance(v, (types.FunctionType, type)):
        owner = v.__module__ or ""
    else:
        owner = type(v).__module__ or ""
    return owner == REF or owner.startswith(REF + ".")


def test_port_run_reaches_no_reference_object():
    """The port's run builds only port objects: every name a suite takes
    from the reference package, and every value it builds at import,
    resolves in the port."""
    for suite in SUITES.values():
        g = _Run(suite, port=True).globals
        for k, v in g.items():
            assert k == "__builtins__" or not _reference_owned(v), (suite.__name__, k)
