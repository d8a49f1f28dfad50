"""The reference's suites of the real-cluster client, the kube protocol, the
wire fixtures, the race watchers and the deflake harness, run on the port.

Each case runs from its suite's own source, executed under an `__import__`
that maps every import of the reference package to the port's module of
the same path (tests/torch_suites.py's `PortSuites`), and must pass on
the port:
- tests/test_apiserver_client.py and tests/test_kube_retry.py: the port's
  kube/apiserver.py against the suites' mocked apiserver; the operator
  case steps `new_operator` over it with `TorchSolver(device="cpu")`;
- tests/test_kube_protocol.py: the in-memory half on the port's
  InMemoryKubeClient, the adapter half through the same client;
- tests/test_wire_fixtures.py: the port's kube/serialization.py, which the
  adapter's encode and decode ride on;
- tests/test_lockwatch.py and tests/test_racewatch.py: the port's
  testing/{lockwatch,racewatch}.py. The three `test_real_*` cases read
  racewatch.GLOBAL, which is the port's here: this file installs the
  port's global watchers around each of them (the reference's conftest
  arms the reference's for the session), so that the port's
  ResilientSolver, Registry and chaos Fault they build are tracked;
- tests/test_deflake.py: the port's Operator.start() with randomized pump
  delays and two churn threads, and the port's CacheSyncingClient.

A port watcher installed over the reference's session watcher must come
off before the next case: after every case of this file, threading.Lock
and threading.RLock are again what they were before it. Nothing is left
out.
"""
import threading

import pytest

from karpenter_core_tpu_torch.testing import lockwatch as tlockwatch
from karpenter_core_tpu_torch.testing import racewatch as tracewatch

import tests.test_apiserver_client as apiserver_client
import tests.test_deflake as deflake
import tests.test_kube_protocol as kube_protocol
import tests.test_kube_retry as kube_retry
import tests.test_lockwatch as lockwatch_suite
import tests.test_racewatch as racewatch_suite
import tests.test_wire_fixtures as wire_fixtures
from tests.torch_suites import (
    Mapping,
    PortSuites,
    cases,
    cpu_substitutes,
    reference_names,
)

SUITES = {
    "apiserver_client": apiserver_client,
    "kube_retry": kube_retry,
    "kube_protocol": kube_protocol,
    "wire_fixtures": wire_fixtures,
    "lockwatch": lockwatch_suite,
    "racewatch": racewatch_suite,
    "deflake": deflake,
}

PORT_SUITES = PortSuites(Mapping(cpu_substitutes()))
CASES = [c for name, suite in SUITES.items() for c in cases(name, suite)]


@pytest.fixture(scope="module", autouse=True)
def _module_fixtures():
    yield
    PORT_SUITES.finish()


@pytest.fixture
def port_watchers():
    """The port's global lockwatch and racewatch installed for one case,
    then uninstalled in reverse order."""
    tlockwatch.GLOBAL.install()
    tracewatch.GLOBAL.install()
    try:
        yield
    finally:
        tracewatch.GLOBAL.uninstall()
        tlockwatch.GLOBAL.uninstall()


@pytest.fixture(autouse=True)
def _factories_restored():
    """Whatever a case installs, the session's lock factories are back
    after it; the port's global watchers end as they began."""
    before = (threading.Lock, threading.RLock)
    lw_installed, rw_installed = tlockwatch.GLOBAL.installed, tracewatch.GLOBAL.installed
    yield
    if tracewatch.GLOBAL.installed and not rw_installed:
        tracewatch.GLOBAL.uninstall()
    if tlockwatch.GLOBAL.installed and not lw_installed:
        tlockwatch.GLOBAL.uninstall()
    assert (threading.Lock, threading.RLock) == before


@pytest.mark.parametrize("suite,case,params", [c[:3] for c in CASES],
                         ids=[f"{c[0]}-{c[3]}" for c in CASES])
def test_case_passes_on_the_port(suite, case, params, tmp_path, request):
    if suite == "racewatch" and case.startswith("test_real_"):
        request.getfixturevalue("port_watchers")
        before = tracewatch.GLOBAL.stats()["tracked_instances"]
        PORT_SUITES.run(SUITES[suite], case, params, tmp_path)
        # the case's objects were the port's, and the port's watcher
        # tracked them
        assert tracewatch.GLOBAL.stats()["tracked_instances"] > before
        return
    PORT_SUITES.run(SUITES[suite], case, params, tmp_path)


def test_cases_cover_the_suites():
    counts = {name: sum(1 for c in CASES if c[0] == name) for name in SUITES}
    assert counts == {"apiserver_client": 19, "kube_retry": 10, "kube_protocol": 14,
                      "wire_fixtures": 7, "lockwatch": 12, "racewatch": 19, "deflake": 9}


def test_port_run_reaches_no_reference_object():
    """Every name a suite takes from the reference package resolves in the
    port."""
    for suite in SUITES.values():
        assert reference_names(PORT_SUITES.namespace(suite)) == [], suite.__name__
