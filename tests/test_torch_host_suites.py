"""The reference's suites of the solver service, the solver host, the
program inventory, fair-share admission and tenant attribution, run on the
port.

Each case runs from its suite's own source, executed under an `__import__`
that maps every import of the reference package to the port's module of
the same path (tests/test_torch_entry_suites.py's method), and must pass.
These suites spawn solver children and gRPC servers, so each case runs on
the port only: the reference's own run is its own file's. A suite's
module-scoped fixtures (its gRPC server, its HostSolver) are made once per
suite here too, and torn down when this file ends.

Where the port's counterpart needs the CPU or has another name:
- `TPUSolver(...)` is `TorchSolver(..., device="cpu")` (as in the entry
  suites), `HostSolver(...)` and `serve(...)` get `device="cpu"`,
  `new_operator` without a solver gets `TorchSolver(device="cpu")`, and
  `SoakDriver` without a solver gets `TorchSolver(max_nodes,
  screen_mode="prescreen", device="cpu")`;
- `karpenter_core_tpu.chaos` is the port's `chaos`: the cases that arm
  faults (the host's crash, the wedge's hang, the gate's overload and
  flood, the RPC's retry budget) arm the port's points.

Left out, by case (LEFT_OUT): the two timing-dependent cases ROADMAP
Queue C names as the reference's own reds.

The harness is tests/torch_suites.py's (`PortSuites`);
tests/test_torch_chaos_suites.py runs the chaos and loadgen suites with
this file's counterparts.
"""
import functools

import pytest

# each package's fake provider registers its well-known labels on import
from karpenter_core_tpu.cloudprovider import fake as _ref_fake  # noqa: F401
from karpenter_core_tpu_torch.cloudprovider import fake as _port_fake  # noqa: F401
from karpenter_core_tpu_torch.solver import host as thost
from karpenter_core_tpu_torch.solver import service as tservice

import tests.test_admission_fairshare as admission_fairshare
import tests.test_proghealth as proghealth_suite
import tests.test_solver_host as solver_host
import tests.test_solver_service as solver_service
import tests.test_tenant_attribution as tenant_attribution
from tests.torch_suites import PORT, Mapping, PortSuites, cases, cpu_substitutes, reference_names

SUITES = {
    "solver_service": solver_service,
    "solver_host": solver_host,
    "proghealth": proghealth_suite,
    "admission_fairshare": admission_fairshare,
    "tenant_attribution": tenant_attribution,
}
LEFT_OUT = {
    "solver_host": {
        "test_warm_respawn_fraction_of_cold_start":
            "timing-dependent: a reference red (ROADMAP Queue C)",
        "test_residency_rebuilt_after_respawn":
            "timing-dependent: a reference red (ROADMAP Queue C)",
    },
}


def _cpu_host_solver(*a, **kw):
    kw.setdefault("device", "cpu")
    return thost.HostSolver(*a, **kw)


def _cpu_soak_driver(config, *a, **kw):
    from karpenter_core_tpu_torch.loadgen.driver import SoakDriver
    from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

    if kw.get("solver") is None:
        kw["solver"] = TorchSolver(max_nodes=kw.get("max_nodes", 256),
                                   screen_mode="prescreen", device="cpu")
    return SoakDriver(config, *a, **kw)


def host_substitutes() -> dict:
    """The CPU counterparts of the suites that spawn solver children,
    servers and soaks (tests/test_torch_chaos_suites.py's too)."""
    return {
        **cpu_substitutes(),
        (f"{PORT}.solver.host", "HostSolver"): _cpu_host_solver,
        (f"{PORT}.solver.service", "serve"): functools.partial(tservice.serve, device="cpu"),
        (f"{PORT}.loadgen", "SoakDriver"): _cpu_soak_driver,
        (f"{PORT}.loadgen.driver", "SoakDriver"): _cpu_soak_driver,
    }


PORT_SUITES = PortSuites(Mapping(host_substitutes()))
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
    counts = {name: sum(1 for c in CASES if c[0] == name) for name in SUITES}
    assert counts == {"solver_service": 10, "solver_host": 17, "proghealth": 23,
                      "admission_fairshare": 16, "tenant_attribution": 10}
    for name, left in LEFT_OUT.items():
        for case in left:
            assert case in vars(SUITES[name]), (name, case)


def test_port_run_reaches_no_reference_object():
    """Every name a suite takes from the reference package resolves in the
    port."""
    for suite in SUITES.values():
        assert reference_names(PORT_SUITES.namespace(suite)) == [], suite.__name__
