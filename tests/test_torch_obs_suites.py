"""The reference's metrics exposition, structured log and tracer suites,
run on the port.

Each case runs twice from its suite's own source (tests/torch_suites.py):
once as written, on the reference package, and once with every import of
the reference package mapped to the port's module of the same path. Both
runs must end in the same outcome. Each run reads its own captured output
(`capsys`) and writes under a tmp_path of its own. The tracer suite's
solve records the reference's solver.phase.* spans (pack and bind among
them, and `compile_cache` on the device span) on `TorchSolver(device=
"cpu")`; its service case builds `SolverService(device="cpu")`.

The suites: tests/test_metrics_exposition.py (17), tests/test_obs_log.py
(17) and tests/test_obs_tracer.py (21).

Nothing is left out (LEFT_OUT): tests/test_solver_factory.py, which
builds the mesh solver of `parallel/`, runs on the port's device grid in
tests/test_torch_mesh_suites.py.
"""
import pytest

# each package's fake provider registers its well-known labels on import
from karpenter_core_tpu.cloudprovider import fake as _ref_fake  # noqa: F401
from karpenter_core_tpu_torch.cloudprovider import fake as _port_fake  # noqa: F401

import tests.test_metrics_exposition as metrics_exposition
import tests.test_obs_log as obs_log
import tests.test_obs_tracer as obs_tracer
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
    "metrics_exposition": metrics_exposition,
    "obs_log": obs_log,
    "obs_tracer": obs_tracer,
}
# suite name -> (suite, why its cases do not run here)
LEFT_OUT = {}
MAPPING = Mapping(cpu_substitutes())
CASES = [c for name, suite in SUITES.items() for c in cases(name, suite)]


@pytest.mark.parametrize("suite,case,params", params_of(CASES))
def test_case_outcome_matches_reference(suite, case, params, tmp_path, capsys):
    compare(SUITES[suite], MAPPING, case, params, tmp_path, capsys=capsys)


def test_cases_cover_the_suites():
    counts = {name: sum(1 for c in CASES if c[0] == name) for name in SUITES}
    assert counts == {"metrics_exposition": 17, "obs_log": 17, "obs_tracer": 21}
    left_out = {name: len(cases(name, suite)) for name, (suite, _why) in LEFT_OUT.items()}
    assert left_out == {}


def test_port_run_reaches_no_reference_object():
    """Every name a suite takes from the reference package, and every
    value it builds at import, resolves in the port."""
    for suite in SUITES.values():
        assert reference_names(namespace(suite, MAPPING)) == [], suite.__name__
