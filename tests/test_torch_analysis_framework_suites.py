"""The reference's static-analysis framework suite, its in-process
cases, run on the port's analysis package.

Each case of tests/test_analysis_framework.py runs twice from its own
source (tests/torch_suites.py): once as written, on the reference's
`karpenter_core_tpu.analysis` and `hack/lint.py`, and once with every
import of the reference package mapped to the port's module of the same
path. On the port the suite's `run_lint` is `python -m
karpenter_core_tpu_torch.analysis` with the same arguments, and its
`import lint` (hack/lint.py, for `sarif_payload`) is the port's
`analysis/__main__`, so the command-line cases run the port's CLI over the
port's tree. Both runs must end in the same outcome.

The suite's 22 cases are split between two files so that each stays short
under the test run's workers: this one runs the 11 cases that drive the
passes in process, tests/test_torch_analysis_cli_suites.py the 11
command-line cases (`is_cli_case`). tests/test_torch_analysis_suites.py runs
the pass suite.
"""
import pytest

import tests.test_analysis_framework as analysis_framework
from tests.test_torch_analysis_cli_suites import MAPPING, PORT_NAMES, is_cli_case
from tests.torch_suites import (  # noqa: F401  (restore_process_state: autouse)
    cases,
    compare,
    namespace,
    params_of,
    reference_names,
    restore_process_state,
)

SUITES = {"analysis_framework": analysis_framework}
CASES = [c for name, suite in SUITES.items()
         for c in cases(name, suite, keep=lambda case: not is_cli_case(case))]


@pytest.mark.parametrize("suite,case,params", params_of(CASES))
def test_case_outcome_matches_reference(suite, case, params, tmp_path):
    compare(SUITES[suite], MAPPING, case, params, tmp_path, port_names=PORT_NAMES)


def test_cases_cover_the_suites():
    counts = {name: sum(1 for c in CASES if c[0] == name) for name in SUITES}
    assert counts == {"analysis_framework": 11}


def test_port_run_reaches_no_reference_object():
    """Every name the suite takes from the reference package resolves in
    the port."""
    for suite in SUITES.values():
        assert reference_names(namespace(suite, MAPPING)) == [], suite.__name__
