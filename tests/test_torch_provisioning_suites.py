"""The reference's provisioning-depth, instance-selection and cloud
provider suites, run on the port.

Each case runs twice from its suite's own source (tests/torch_suites.py):
once as written, on the reference package, and once with every import of
the reference package mapped to the port's module of the same path. Both
runs must end in the same outcome. The suites' `Env()` solves on
`TorchSolver(device="cpu")` on the port, as `TPUSolver` does.

The suites: tests/test_provisioning_suite_depth.py (29 functions, 31 cases
with its parameters), tests/test_instance_selection.py (15) over the
assorted universe (`fake.instance_types_assorted`, 1,344 types),
tests/test_instance_selection_suite.py (6) and tests/test_cloudprovider.py
(8). Nothing is left out.
"""
import pytest

# each package's fake provider registers its well-known labels on import
from karpenter_core_tpu.cloudprovider import fake as _ref_fake  # noqa: F401
from karpenter_core_tpu_torch.cloudprovider import fake as _port_fake  # noqa: F401

import tests.test_provisioning_suite_depth as provisioning_depth
import tests.test_instance_selection as instance_selection
import tests.test_instance_selection_suite as instance_selection_suite
import tests.test_cloudprovider as cloudprovider
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
    "provisioning_depth": provisioning_depth,
    "instance_selection": instance_selection,
    "instance_selection_suite": instance_selection_suite,
    "cloudprovider": cloudprovider,
}
MAPPING = Mapping(cpu_substitutes())
CASES = [c for name, suite in SUITES.items() for c in cases(name, suite)]


@pytest.mark.parametrize("suite,case,params", params_of(CASES))
def test_case_outcome_matches_reference(suite, case, params, tmp_path):
    compare(SUITES[suite], MAPPING, case, params, tmp_path)


def test_cases_cover_the_suites():
    counts = {name: sum(1 for c in CASES if c[0] == name) for name in SUITES}
    assert counts == {"provisioning_depth": 31, "instance_selection": 15,
                      "instance_selection_suite": 6, "cloudprovider": 8}


def test_port_run_reaches_no_reference_object():
    """Every name a suite takes from the reference package, and every
    value it builds at import, resolves in the port."""
    for suite in SUITES.values():
        assert reference_names(namespace(suite, MAPPING)) == [], suite.__name__
