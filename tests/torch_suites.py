"""The harness that runs the reference's own suites on the port.

A suite's source is executed afresh under an `__import__` that maps every
import of the reference package to the port's module of the same path
(the imports inside test bodies included), so that each name resolves to
the port's object of the same name. A `Mapping` holds that import and the
port's counterparts where one needs the CPU or has another name:
- `MODULE_RENAMES` maps a reference module to the port's module of another
  name (`solver/tpu_solver` is `solver/torch_solver`);
- `substitutes` replace one name of one port module, as seen by the
  suite's imports (`TPUSolver` is `TorchSolver(device="cpu")`);
- `mapped_suites` are other test modules a suite imports its workload
  functions or fixtures from (`from test_deprovisioning import env`): they
  are executed afresh under the same mapping, so that those make the
  port's objects.

`Case` runs one test function of a namespace the way pytest would: its
parametrize values, its fixtures (each function-scoped one made once per
case, module-scoped ones shared through the dict the caller keeps, autouse
ones first, generators finished after the case), and `monkeypatch`,
`tmp_path` and `capsys`. Its outcome is ("passed",) or the exception's
type name and message: a suite runs in compare mode when both packages'
runs must end in the same outcome, or on the port alone where a case
spawns processes or servers and the reference's own run is its own file's.

The test files tests/test_torch_*_suites.py use it.
"""
from __future__ import annotations

import builtins
import inspect
import os
import sys
import types
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import pytest

REF, PORT = "karpenter_core_tpu", "karpenter_core_tpu_torch"
MODULE_RENAMES = {f"{REF}.solver.tpu_solver": f"{PORT}.solver.torch_solver"}
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
# a suite that imports a sibling by its plain name (`from test_x import`)
# finds it the way pytest's own run does
if TESTS_DIR not in sys.path:
    sys.path.insert(0, TESTS_DIR)


def port_module_name(name: str, renames: Optional[Dict[str, str]] = None) -> Optional[str]:
    """The port's module for a reference module name; None for any other."""
    renames = MODULE_RENAMES if renames is None else renames
    if name in renames:
        return renames[name]
    if name == REF or name.startswith(REF + "."):
        return PORT + name[len(REF):]
    return None


class Mapping:
    """One mapping of the reference's imports to the port's."""

    def __init__(self, substitutes: Optional[dict] = None,
                 renames: Optional[Dict[str, str]] = None,
                 mapped_suites: Iterable[str] = ()):
        self.substitutes = dict(substitutes or {})
        self.renames = {**MODULE_RENAMES, **(renames or {})}
        self.mapped_suites = set(mapped_suites)
        self._suite_modules: Dict[str, types.ModuleType] = {}
        self.builtins = dict(vars(builtins), __import__=self._import)

    def _proxy(self, module, mapped):
        subs = {attr: v for (m, attr), v in self.substitutes.items() if m == mapped}
        if not subs:
            return module
        proxy = types.ModuleType(module.__name__)
        proxy.__dict__.update(vars(module))
        proxy.__dict__.update(subs)
        return proxy

    def _import(self, name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and name in self.mapped_suites:
            return self.suite_module(name)
        mapped = port_module_name(name, self.renames) if level == 0 else None
        module = builtins.__import__(mapped or name, globals, locals, fromlist, level)
        if mapped and fromlist:
            return self._proxy(module, mapped)
        if mapped and "." not in name:
            # `import lint as m` of a module renamed to a dotted one binds
            # the module itself, not its top package
            return sys.modules[mapped]
        return module

    def suite_module(self, name: str) -> types.ModuleType:
        """A test module executed afresh under this mapping (once per
        name)."""
        mod = self._suite_modules.get(name)
        if mod is None:
            ref = __import__(name, fromlist=["_"])
            mod = self._suite_modules[name] = types.ModuleType(name)
            mod.__dict__.update(namespace(ref, self))
        return mod


_CODE: Dict[str, types.CodeType] = {}


def namespace(suite: types.ModuleType, mapping: Optional[Mapping]) -> dict:
    """The suite's module namespace, executed afresh from its source:
    under `mapping`'s `__import__` for the port's run, as written when
    `mapping` is None."""
    code = _CODE.get(suite.__file__)
    if code is None:
        with open(suite.__file__) as f:
            code = _CODE[suite.__file__] = compile(f.read(), suite.__file__, "exec")
    ns = {"__name__": suite.__name__, "__file__": suite.__file__,
          "__builtins__": mapping.builtins if mapping is not None else builtins}
    exec(code, ns)
    return ns


def fixtures_of(ns: dict) -> Dict[str, Tuple[Callable, str, bool]]:
    """name -> (the fixture's function, its scope, autouse) of every
    fixture the namespace defines or imports."""
    out = {}
    for k, v in ns.items():
        wrapped = getattr(v, "_get_wrapped_function", None)
        if wrapped is not None:
            marker = getattr(v, "_fixture_function_marker", None)
            out[k] = (wrapped(), getattr(marker, "scope", "function"),
                      getattr(marker, "autouse", False))
    return out


class Case:
    """One case of a namespace: `run(case, params)` returns its outcome.

    `builtin` holds the pytest fixtures the caller hands in (tmp_path,
    capsys, ...); `module_fixtures` (name -> value) and `module_finalizers`
    outlive the case when the caller keeps them."""

    def __init__(self, ns: dict, builtin: Optional[dict] = None,
                 module_fixtures: Optional[dict] = None,
                 module_finalizers: Optional[list] = None):
        self.ns = ns
        self.fixtures = fixtures_of(ns)
        self.builtin = dict(builtin or {})
        self.module_fixtures = {} if module_fixtures is None else module_fixtures
        self.module_finalizers = [] if module_finalizers is None else module_finalizers

    def run(self, case: str, params: dict, reraise: bool = False) -> tuple:
        """The case's outcome; with `reraise`, its exception itself (a
        case run on the port alone fails with its own traceback)."""
        values: dict = {}
        finalizers: list = []
        mp = pytest.MonkeyPatch()
        builtin = dict(self.builtin, monkeypatch=mp)

        def value(pname):
            if pname in params:
                return params[pname]
            if pname in values:
                return values[pname]
            if pname in builtin:
                return builtin[pname]
            if pname not in self.fixtures:
                raise LookupError(f"no fixture {pname!r}")
            fx, scope, _auto = self.fixtures[pname]
            if scope != "function" and pname in self.module_fixtures:
                return self.module_fixtures[pname]
            got = fx(**kwargs_for(fx))
            if inspect.isgenerator(got):
                gen, got = got, next(got)
                (finalizers if scope == "function" else self.module_finalizers).append(gen)
            if scope == "function":
                values[pname] = got
            else:
                self.module_fixtures[pname] = got
            return got

        def kwargs_for(fn):
            return {p: value(p) for p in inspect.signature(fn).parameters}

        if "::" in case:
            cls, meth = case.split("::")
            fn = getattr(self.ns[cls](), meth)
        else:
            fn = self.ns[case]
        try:
            try:
                for pname, (_fx, _scope, auto) in self.fixtures.items():
                    if auto:
                        value(pname)
                fn(**kwargs_for(fn))
                outcome = ("passed",)
            except Exception as exc:  # the outcome both runs must share
                if reraise:
                    raise
                outcome = (type(exc).__name__, str(exc))
            finally:
                finish(finalizers)
        finally:
            mp.undo()
        return outcome


class PortSuites:
    """Suites run on the port alone (their cases spawn children or
    servers; the reference's own run is its own file's): each suite's
    namespace executed once under `mapping`, as pytest imports a module
    once, its module-scoped fixtures shared across its cases until
    `finish()`, which the test file calls when it ends."""

    def __init__(self, mapping: Mapping):
        self.mapping = mapping
        self.module_fixtures: Dict[str, dict] = {}
        self.finalizers: list = []

    def namespace(self, suite: types.ModuleType) -> dict:
        return vars(self.mapping.suite_module(suite.__name__))

    def run(self, suite: types.ModuleType, case: str, params: dict, tmp_path) -> None:
        Case(self.namespace(suite), {"tmp_path": tmp_path},
             self.module_fixtures.setdefault(suite.__name__, {}),
             self.finalizers).run(case, params, reraise=True)

    def finish(self) -> None:
        finish(self.finalizers)
        self.module_fixtures.clear()


def finish(generators: list) -> None:
    """Run fixture generators' teardowns, last made first."""
    for gen in reversed(generators):
        for _ in gen:
            pass
    generators.clear()


def _is_slow(fn) -> bool:
    return any(m.name == "slow" for m in getattr(fn, "pytestmark", []))


def cases(name: str, suite: types.ModuleType, left_out: Iterable[str] = (),
          selected: Optional[Iterable[str]] = None,
          keep: Optional[Callable[[str], bool]] = None) -> List[tuple]:
    """(suite name, case, params, id, slow) of every test function and
    Test-class method of `suite`, parametrize values expanded, but
    `left_out`'s (and, where given, only `selected`'s or those `keep`
    accepts)."""
    left_out, selected = set(left_out), (set(selected) if selected is not None else None)
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
            if case in left_out or (selected is not None and case not in selected):
                continue
            if keep is not None and not keep(case):
                continue
            marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
            if not marks:
                out.append((name, case, {}, case, _is_slow(fn)))
                continue
            argnames, values = marks[0].args[:2]
            argnames = [a.strip() for a in argnames.split(",")] if isinstance(
                argnames, str) else list(argnames)
            for i, vals in enumerate(values):
                if hasattr(vals, "values") and hasattr(vals, "marks"):  # pytest.param
                    vals = vals.values if len(argnames) > 1 else vals.values[0]
                vals = vals if len(argnames) > 1 else (vals,)
                out.append((name, case, dict(zip(argnames, vals)), f"{case}[{i}]",
                            _is_slow(fn)))
    return out


def params_of(all_cases: List[tuple]) -> list:
    """pytest.param(suite, case, params) per case, with its id, marked
    slow where the reference marks the case slow (deselected alike)."""
    return [pytest.param(*c[:3], id=f"{c[0]}-{c[3]}",
                         marks=[pytest.mark.slow] if c[4] else [])
            for c in all_cases]


def reference_owned(v) -> bool:
    """Whether a value is a reference module, or a function, class or
    object of one (through containers)."""
    if isinstance(v, (tuple, list, frozenset, set)):
        return any(reference_owned(x) for x in v)
    if isinstance(v, dict):
        return any(reference_owned(x) for x in v.values())
    if isinstance(v, types.ModuleType):
        owner = v.__name__
    elif isinstance(v, (types.FunctionType, type)):
        owner = v.__module__ or ""
    else:
        owner = type(v).__module__ or ""
    return owner == REF or owner.startswith(REF + ".")


def reference_names(ns: dict, skip: Iterable[str] = ()) -> List[str]:
    """The names of a port namespace that still resolve in the
    reference."""
    skip = {"__builtins__", *skip}
    return [k for k, v in ns.items() if k not in skip and reference_owned(v)]


def cpu_substitutes() -> dict:
    """The CPU counterparts every suite file shares: TPUSolver is
    TorchSolver on the CPU, and `new_operator`, `Env` and SolverService
    default to the CPU (the port's defaults raise without a card)."""
    from karpenter_core_tpu_torch.solver import service as tservice
    from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver
    from karpenter_core_tpu_torch.testing import expectations as texpect

    class PortTPUSolver(TorchSolver):
        """TPUSolver's counterpart: TorchSolver on the CPU; `_compiled`
        reads the solve geometries the solver has met."""

        def __init__(self, max_nodes: int = 1024, **_kw):
            super().__init__(max_nodes=max_nodes, device="cpu")

        @property
        def _compiled(self):
            return self._warm_keys

    def cpu_new_operator(*a, **kw):
        from karpenter_core_tpu_torch.operator import new_operator

        if kw.get("solver") is None:
            kw["solver"] = TorchSolver(device="cpu")
        return new_operator(*a, **kw)

    class CpuEnv(texpect.Env):
        def __init__(self, universe=None, settings=None, solver=None):
            super().__init__(universe, settings,
                             solver if solver is not None else TorchSolver(device="cpu"))

    class CpuSolverService(tservice.SolverService):
        def __init__(self, *a, **kw):
            kw.setdefault("device", "cpu")
            super().__init__(*a, **kw)

    return {
        (f"{PORT}.operator", "new_operator"): cpu_new_operator,
        (f"{PORT}.solver.torch_solver", "TPUSolver"): PortTPUSolver,
        (f"{PORT}.testing", "Env"): CpuEnv,
        (f"{PORT}.testing.expectations", "Env"): CpuEnv,
        (f"{PORT}.solver.service", "SolverService"): CpuSolverService,
    }


@pytest.fixture(autouse=True)
def restore_process_state():
    """No case leaves a process-wide Settings, injection default or armed
    fault to the next (the suite files import this fixture)."""
    yield
    from karpenter_core_tpu.api import settings as jsettings
    from karpenter_core_tpu_torch import chaos as tchaos
    from karpenter_core_tpu_torch.api import settings as tsettings
    from karpenter_core_tpu_torch.operator import injection as tinjection

    jsettings.set_current(jsettings.Settings())
    tsettings.set_current(tsettings.Settings())
    tinjection._default_options = tinjection._default_settings = None
    tchaos.reset()


def compare(suite, mapping: Mapping, case: str, params: dict, tmp_path,
            port_names: Optional[dict] = None, **builtin) -> None:
    """Run one case on each package, each in a tmp_path of its own; the
    reference's run must pass and the port's must end alike.
    `port_names` replace names of the port's namespace (a helper of the
    suite's own whose port counterpart is another command)."""
    outcomes = []
    for side, m in (("reference", None), ("port", mapping)):
        path = tmp_path / side
        path.mkdir()
        ns = namespace(suite, m)
        if m is not None:
            ns.update(port_names or {})
        outcomes.append(Case(ns, dict(builtin, tmp_path=path)).run(case, params))
    want, got = outcomes
    assert want == ("passed",), f"the reference's run: {want}"
    assert got == want
