"""The reference's static-analysis framework suite, its command-line
cases, run on the port's `python -m karpenter_core_tpu_torch.analysis`.

Each case of tests/test_analysis_framework.py runs twice from its own
source (tests/torch_suites.py): once as written, on the reference's
`karpenter_core_tpu.analysis` and `hack/lint.py`, and once with every
import of the reference package mapped to the port's module of the same
path. On the port the suite's `run_lint` is `python -m
karpenter_core_tpu_torch.analysis` with the same arguments, and its
`import lint` (hack/lint.py, for `sarif_payload`) is the port's
`analysis/__main__`, so the command-line cases run the port's CLI over the
port's tree. Both runs must end in the same outcome.

This file runs the suite's 11 command-line cases (`is_cli_case`: the
cases that start the CLI in a child process, or read its module);
tests/test_torch_analysis_framework_suites.py runs its 11 other cases.
"""
import inspect
import os
import subprocess
import sys

import pytest

import tests.test_analysis_framework as analysis_framework
from tests.torch_suites import (  # noqa: F401  (restore_process_state: autouse)
    PORT,
    Mapping,
    cases,
    compare,
    namespace,
    params_of,
    reference_names,
    restore_process_state,
)

SUITES = {"analysis_framework": analysis_framework}
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# hack/lint.py's counterpart is the port package's own entry point
MAPPING = Mapping(renames={"lint": f"{PORT}.analysis.__main__"})


def run_port_lint(*args, cwd=REPO_ROOT):
    """The suite's `run_lint` on the port: `python -m
    karpenter_core_tpu_torch.analysis` with the same arguments."""
    return subprocess.run([sys.executable, "-m", f"{PORT}.analysis", *args],
                          capture_output=True, text=True, cwd=cwd)


PORT_NAMES = {"run_lint": run_port_lint}


def is_cli_case(case: str) -> bool:
    """A case that runs the lint CLI in a child process (`run_lint`), or
    reads its module (`import lint`)."""
    source = inspect.getsource(getattr(analysis_framework, case))
    return "run_lint(" in source or "import lint" in source


CASES = [c for name, suite in SUITES.items() for c in cases(name, suite, keep=is_cli_case)]


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
