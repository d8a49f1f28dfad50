"""The reference's suites of fault injection and load generation, run on
the port.

Each case runs from its suite's own source, executed under an `__import__`
that maps every import of the reference package to the port's module of
the same path (tests/torch_suites.py's `PortSuites`, which shares a suite's
module-scoped fixtures across its cases), and must pass on the port. The
suites start operators with their threads, a gRPC server and soaks, so
each case runs on the port only: the reference's own run is its own
file's.

The suites: tests/test_chaos_registry.py, tests/test_chaos_operator.py,
tests/test_chaos_solver.py and tests/test_loadgen.py. Their
`karpenter_core_tpu.chaos` is the port's `chaos`, so every fault they arm
is consulted at the port's points. The counterparts that need the CPU are
the host suites' (`TPUSolver` is `TorchSolver(device="cpu")`, `serve` and
`new_operator` run on the CPU, `SoakDriver` without a solver gets a
`TorchSolver` on the CPU). A case the reference marks slow is marked slow
here too, so it is deselected alike. Nothing is left out.
"""
import pytest

from karpenter_core_tpu_torch import chaos as tchaos

import tests.test_chaos_operator as chaos_operator
import tests.test_chaos_registry as chaos_registry
import tests.test_chaos_solver as chaos_solver
import tests.test_loadgen as loadgen_suite
from tests.test_torch_host_suites import host_substitutes
from tests.torch_suites import Mapping, PortSuites, cases, params_of, reference_names

SUITES = {
    "chaos_registry": chaos_registry,
    "chaos_operator": chaos_operator,
    "chaos_solver": chaos_solver,
    "loadgen": loadgen_suite,
}


PORT_SUITES = PortSuites(Mapping(host_substitutes()))
CASES = [c for name, suite in SUITES.items() for c in cases(name, suite)]


@pytest.fixture(scope="module", autouse=True)
def _module_fixtures():
    yield
    PORT_SUITES.finish()


@pytest.fixture(autouse=True)
def _disarmed():
    """No fault outlives its case, whatever the case's own teardown did."""
    yield
    tchaos.reset()


@pytest.mark.parametrize("suite,case,params", params_of(CASES))
def test_case_passes_on_the_port(suite, case, params, tmp_path):
    PORT_SUITES.run(SUITES[suite], case, params, tmp_path)


def test_cases_cover_the_suites():
    counts = {name: sum(1 for c in CASES if c[0] == name) for name in SUITES}
    assert counts == {"chaos_registry": 24, "chaos_operator": 9, "chaos_solver": 13,
                      "loadgen": 12}


def test_port_run_reaches_no_reference_object():
    """Every name a suite takes from the reference package resolves in the
    port."""
    for suite in SUITES.values():
        assert reference_names(PORT_SUITES.namespace(suite)) == [], suite.__name__
