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

The harness is tests/torch_suites.py's. Left out, by case (LEFT_OUT): the
one ladder case whose observable is the AOT executable of an XLA
compile-cache entry.
"""
import pytest

# each package's fake provider registers its well-known labels when it is
# imported: both are imported here so that the two label sets agree from
# the first case on, whichever suite imports its own first
from karpenter_core_tpu.cloudprovider import fake as _ref_fake  # noqa: F401
from karpenter_core_tpu_torch.cloudprovider import fake as _port_fake  # noqa: F401

import tests.test_api_suite as api_suite
import tests.test_api_validation as api_validation
import tests.test_bucket_ladder as bucket_ladder
import tests.test_debug_surface as debug_surface
import tests.test_operator_runtime as operator_runtime
import tests.test_webhook_server as webhook_server
from tests.torch_suites import (  # noqa: F401  (restore_process_state: autouse)
    Case,
    Mapping,
    cases,
    cpu_substitutes,
    namespace,
    reference_names,
    restore_process_state,
)

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
            "reads `fn.aot`, the AOT executable XLA attaches to a compiled program: the "
            "port compiles none, so its warm entry has no executable to answer it (its "
            "hit and miss counts are tests/test_torch_compilecache.py's "
            "test_prewarmed_geometry_live_solve_hits)",
    },
}
# the validation functions whose every result both runs must agree on
RECORDED = ("validate_provisioner", "validate_requirement", "validate_or_raise",
            "is_qualified_name", "is_valid_label_value")
MAPPING = Mapping(cpu_substitutes())


def _operator_runtime_case(case: str) -> bool:
    return any(case.startswith(p) if p.endswith("::") else case == p
               for p in OPERATOR_RUNTIME)


def _run(suite, port: bool, case: str, params: dict):
    """One package's run of one case: its outcome, and every call of a
    validation function with its result."""
    ns = namespace(suite, MAPPING if port else None)
    log = []

    def recorded(name, fn):
        def call(*a, **kw):
            try:
                out = fn(*a, **kw)
            except Exception as exc:
                log.append((name, type(exc).__name__, str(exc)))
                raise
            log.append((name, out))
            return out

        return call

    for k in RECORDED:
        if callable(ns.get(k)):
            ns[k] = recorded(k, ns[k])
    return Case(ns).run(case, params), log


CASES = [c for name, suite in SUITES.items()
         for c in cases(name, suite, left_out=LEFT_OUT.get(name, ()),
                        keep=_operator_runtime_case if name == "operator_runtime" else None)]


@pytest.mark.parametrize("suite,case,params", [c[:3] for c in CASES],
                         ids=[f"{c[0]}-{c[3]}" for c in CASES])
def test_case_outcome_matches_reference(suite, case, params):
    want = _run(SUITES[suite], False, case, params)
    got = _run(SUITES[suite], True, case, params)
    assert want[0] == ("passed",), f"the reference's run: {want[0]}"
    assert got == want


def test_cases_cover_the_suites():
    counts = {name: sum(1 for c in CASES if c[0] == name) for name in SUITES}
    assert counts == {"api_validation": 27, "api_suite": 65, "webhook_server": 7,
                      "debug_surface": 10, "operator_runtime": 14, "bucket_ladder": 12}
    for name, left in LEFT_OUT.items():
        for case in left:
            assert case in vars(SUITES[name]), (name, case)


def test_port_run_reaches_no_reference_object():
    """The port's run builds only port objects: every name a suite takes
    from the reference package, and every value it builds at import,
    resolves in the port."""
    for suite in SUITES.values():
        assert reference_names(namespace(suite, MAPPING)) == [], suite.__name__
