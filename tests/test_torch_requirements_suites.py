"""The reference's suites of requirements, resources and taints, and its
small controller suites, run on the port.

Each case runs twice from its suite's own source (tests/torch_suites.py):
once as written, on the reference package, and once with every import of
the reference package mapped to the port's module of the same path. Both
runs must end in the same outcome.

The suites: tests/test_requirement_suite.py, tests/test_requirements_suite.py,
tests/test_requirements.py, tests/test_small_suites.py and
tests/test_resources_taints.py, every parametrized value a case of its
own. Nothing is left out.
"""
import pytest

# each package's fake provider registers its well-known labels on import
from karpenter_core_tpu.cloudprovider import fake as _ref_fake  # noqa: F401
from karpenter_core_tpu_torch.cloudprovider import fake as _port_fake  # noqa: F401

import tests.test_requirement_suite as requirement_suite
import tests.test_requirements_suite as requirements_suite
import tests.test_requirements as requirements
import tests.test_small_suites as small_suites
import tests.test_resources_taints as resources_taints
from tests.torch_suites import (  # noqa: F401  (restore_process_state: autouse)
    Mapping,
    cases,
    compare,
    cpu_substitutes,
    namespace,
    params_of,
    reference_names,
    restore_process_state,
)

SUITES = {
    "requirement_suite": requirement_suite,
    "requirements_suite": requirements_suite,
    "requirements": requirements,
    "small_suites": small_suites,
    "resources_taints": resources_taints,
}
MAPPING = Mapping(cpu_substitutes())
CASES = [c for name, suite in SUITES.items() for c in cases(name, suite)]


@pytest.mark.parametrize("suite,case,params", params_of(CASES))
def test_case_outcome_matches_reference(suite, case, params, tmp_path):
    compare(SUITES[suite], MAPPING, case, params, tmp_path)


def test_cases_cover_the_suites():
    counts = {name: sum(1 for c in CASES if c[0] == name) for name in SUITES}
    assert counts == {"requirement_suite": 25, "requirements_suite": 28, "requirements": 21,
                      "small_suites": 30, "resources_taints": 8}


def test_port_run_reaches_no_reference_object():
    """Every name a suite takes from the reference package, and every
    value it builds at import, resolves in the port."""
    for suite in SUITES.values():
        assert reference_names(namespace(suite, MAPPING)) == [], suite.__name__
