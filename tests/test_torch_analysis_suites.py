"""The reference's static-analysis pass suite, run on the port's passes.

Each case of tests/test_analysis_passes.py runs twice from its own source
(tests/torch_suites.py): once as written, on the reference's
`karpenter_core_tpu.analysis`, and once with every import of the
reference package mapped to the port's module of the same path, so that
each pass is the port's `karpenter_core_tpu_torch.analysis` pass of the
same name over the same fixtures (tests/analysis_fixtures). Both runs must
end in the same outcome. The suite's two whole-package cases lint the
tree their `package_name` names, the reference's, with either package's
passes.

tests/test_torch_analysis_framework_suites.py runs the framework suite;
tests/test_torch_self_lint.py holds the port's own tree to the passes.
"""
import pytest

import tests.test_analysis_passes as analysis_passes
from tests.torch_suites import (  # noqa: F401  (restore_process_state: autouse)
    Mapping,
    cases,
    compare,
    namespace,
    params_of,
    reference_names,
    restore_process_state,
)

SUITES = {"analysis_passes": analysis_passes}
MAPPING = Mapping()
CASES = [c for name, suite in SUITES.items() for c in cases(name, suite)]


@pytest.mark.parametrize("suite,case,params", params_of(CASES))
def test_case_outcome_matches_reference(suite, case, params, tmp_path):
    compare(SUITES[suite], MAPPING, case, params, tmp_path)


def test_cases_cover_the_suites():
    counts = {name: sum(1 for c in CASES if c[0] == name) for name in SUITES}
    assert counts == {"analysis_passes": 38}


def test_port_run_reaches_no_reference_object():
    """Every name the suite takes from the reference package resolves in
    the port."""
    for suite in SUITES.values():
        assert reference_names(namespace(suite, MAPPING)) == [], suite.__name__
