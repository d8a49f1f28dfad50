"""The reference's suites of cluster state, deprovisioning, machines and
node termination, run on the port.

Each case runs twice from its suite's own source (tests/torch_suites.py):
once as written, on the reference package, and once with every import of
the reference package mapped to the port's module of the same path. Both
runs must end in the same outcome. tests/test_deprovisioning_suite.py
takes its `env` and `provisioner` fixtures and its workload functions from
tests/test_deprovisioning.py, which its port run executes under the same
mapping.

The suites: tests/test_state_suite.py (27), tests/test_deprovisioning_suite.py
(14), tests/test_machine_suite.py (9) and tests/test_termination_node_suite.py
(13). Nothing is left out.
"""
import pytest

# each package's fake provider registers its well-known labels on import
from karpenter_core_tpu.cloudprovider import fake as _ref_fake  # noqa: F401
from karpenter_core_tpu_torch.cloudprovider import fake as _port_fake  # noqa: F401

import tests.test_deprovisioning_suite as deprovisioning_suite
import tests.test_machine_suite as machine_suite
import tests.test_state_suite as state_suite
import tests.test_termination_node_suite as termination_node_suite
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
    "state": state_suite,
    "deprovisioning": deprovisioning_suite,
    "machine": machine_suite,
    "termination_node": termination_node_suite,
}
MAPPING = Mapping(cpu_substitutes(), mapped_suites={"test_deprovisioning"})
CASES = [c for name, suite in SUITES.items() for c in cases(name, suite)]


@pytest.mark.parametrize("suite,case,params", params_of(CASES))
def test_case_outcome_matches_reference(suite, case, params, tmp_path):
    compare(SUITES[suite], MAPPING, case, params, tmp_path)


def test_cases_cover_the_suites():
    counts = {name: sum(1 for c in CASES if c[0] == name) for name in SUITES}
    assert counts == {"state": 27, "deprovisioning": 14, "machine": 9, "termination_node": 13}


def test_port_run_reaches_no_reference_object():
    """Every name a suite takes from the reference package, and every
    value it builds at import, resolves in the port."""
    for suite in SUITES.values():
        assert reference_names(namespace(suite, MAPPING)) == [], suite.__name__
