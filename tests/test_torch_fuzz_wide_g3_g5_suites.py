"""The reference's wide differential fuzz on the port, geometries G3
(relaxation), G4 (multi-attribute) and G5 (hostname anti-affinity): the
cases, the seed budget and the mapping are
tests/test_torch_fuzz_wide_suites.py's, which runs G1, G2 and the screen
kernel's fuzz."""
import pytest

from tests.test_torch_fuzz_wide_suites import SEEDS, geometry_cases, run_case

CASES = geometry_cases("g3", "g4", "g5")


@pytest.mark.parametrize("case,params", [c[:2] for c in CASES], ids=[c[2] for c in CASES])
def test_case_passes_on_the_port(case, params):
    run_case(case, params)


def test_cases_take_the_seed_budget():
    assert len(CASES) == SEEDS["g3"] + SEEDS["g4"] + SEEDS["g5"]
