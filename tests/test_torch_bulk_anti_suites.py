"""The reference's bulk anti-affinity suite, run on the port.

Each case runs twice from tests/test_bulk_anti.py's own source
(tests/torch_suites.py): once as written, on the reference package, and
once with every import of the reference package mapped to the port's
module of the same path, where `TPUSolver(max_nodes)` is
`TorchSolver(max_nodes, device="cpu")`. Both runs must end in the same
outcome; each case holds the device solver to the host solver itself.
The suite solves on the device path in every case, so it has a file of
its own. Its 11 cases all run.
"""
import pytest

# each package's fake provider registers its well-known labels on import
from karpenter_core_tpu.cloudprovider import fake as _ref_fake  # noqa: F401
from karpenter_core_tpu_torch.cloudprovider import fake as _port_fake  # noqa: F401

import tests.test_bulk_anti as bulk_anti
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
    "bulk_anti": bulk_anti,
}
MAPPING = Mapping(cpu_substitutes())
CASES = [c for name, suite in SUITES.items() for c in cases(name, suite)]


@pytest.mark.parametrize("suite,case,params", params_of(CASES))
def test_case_outcome_matches_reference(suite, case, params, tmp_path):
    compare(SUITES[suite], MAPPING, case, params, tmp_path)


def test_cases_cover_the_suites():
    counts = {name: sum(1 for c in CASES if c[0] == name) for name in SUITES}
    assert counts == {"bulk_anti": 11}


def test_port_run_reaches_no_reference_object():
    """Every name a suite takes from the reference package, and every
    value it builds at import, resolves in the port."""
    for suite in SUITES.values():
        assert reference_names(namespace(suite, MAPPING)) == [], suite.__name__
