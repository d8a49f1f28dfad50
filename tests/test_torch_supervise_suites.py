"""The reference's supervisor suite (tests/test_supervise.py), run on the
port's utils/supervise.py.

Each case runs from the suite's own source, executed under an `__import__`
that maps every import of the reference package to the port's module of
the same path (tests/torch_suites.py), and must pass. The cases spawn
process groups, heartbeat files and grandchildren, so they run on the port
only: the reference's own run is its own file's.

The port's module is stdlib-only, as the reference's is, so no case needs
a counterpart; LEFT_OUT is empty.
"""
import pytest

import tests.test_supervise as supervise_suite
from tests.torch_suites import Mapping, PortSuites, cases, reference_names

SUITES = {"supervise": supervise_suite}
LEFT_OUT: dict = {}

PORT_SUITES = PortSuites(Mapping())
CASES = [c for name, suite in SUITES.items()
         for c in cases(name, suite, left_out=LEFT_OUT.get(name, ()))]


@pytest.fixture(scope="module", autouse=True)
def _module_fixtures():
    yield
    PORT_SUITES.finish()


@pytest.mark.parametrize("suite,case,params", [c[:3] for c in CASES],
                         ids=[f"{c[0]}-{c[3]}" for c in CASES])
def test_case_passes_on_the_port(suite, case, params, tmp_path):
    PORT_SUITES.run(SUITES[suite], case, params, tmp_path)


def test_cases_cover_the_suites():
    assert {name: sum(1 for c in CASES if c[0] == name) for name in SUITES} == {
        "supervise": 21}


def test_port_run_reaches_no_reference_object():
    """Every name the suite takes from the reference package resolves in
    the port."""
    for suite in SUITES.values():
        assert reference_names(PORT_SUITES.namespace(suite)) == [], suite.__name__
