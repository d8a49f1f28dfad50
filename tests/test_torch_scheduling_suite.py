"""The reference's scheduling-suite specs on the port's host solver.

Every spec of tests/test_scheduling_suite.py (50),
tests/test_scheduling_suite_binpack.py (26),
tests/test_scheduling_suite_inflight.py (16) and
tests/test_scheduling_suite_volumes.py (8) runs twice from its own
source: once as written, on the reference's Env() (its host greedy
solver), and once with every name it takes from the reference package
rebound to the port's module or object of the same path and name, on the
port's Env(solver=GreedySolver()); the one spec that builds its Env on the
reference's device solver runs on TorchSolver(device="cpu") there. Pods get pinned names, uids and
creation timestamps on both sides (they break FFD ties), and each Env
launches a solve's machines one at a time in the solve's order (the
in-flight nodes' order breaks ties in the next round). Each spec makes
its own assertions, and the two runs must end in the same outcome: the
nodes launched (by their labels) with the pods bound to each, the pods
left unbound, and the cloud provider's create calls.
"""
import importlib
import types

import pytest

from karpenter_core_tpu.api import settings as jsettings
from karpenter_core_tpu_torch.api import settings as tsettings
from karpenter_core_tpu_torch.solver.torch_solver import GreedySolver, TorchSolver

import tests.test_scheduling_suite as main
import tests.test_scheduling_suite_binpack as binpack
import tests.test_scheduling_suite_inflight as inflight
import tests.test_scheduling_suite_volumes as volumes

SUITES = {"binpack": binpack, "inflight": inflight, "main": main, "volumes": volumes}
REF, PORT = "karpenter_core_tpu", "karpenter_core_tpu_torch"
NODE_LABELS = ("node.kubernetes.io/instance-type", "topology.kubernetes.io/zone",
               "karpenter.sh/capacity-type", "kubernetes.io/arch", "kubernetes.io/os",
               "karpenter.sh/provisioner-name")


@pytest.fixture(autouse=True)
def _reset_settings():
    yield
    jsettings.set_current(jsettings.Settings())
    tsettings.set_current(tsettings.Settings())


def _port_of(value, name):
    """The port's counterpart of a reference module, class or function:
    the same module path under the port's package, the same name."""
    if isinstance(value, types.ModuleType):
        if value.__name__.startswith(REF + "."):
            return importlib.import_module(PORT + value.__name__[len(REF):])
        return value
    module = getattr(value, "__module__", None) or ""
    if module.startswith(REF + ".") and callable(value):
        port = importlib.import_module(PORT + module[len(REF):])
        return getattr(port, getattr(value, "__name__", name))
    return value


def _serial_launches(provisioning) -> None:
    """Launch each solve's machines one at a time, in the solve's order.
    Both packages launch a solve's machines on parallel threads, and the
    fake provider names each machine (fake-machine-N) when its create runs:
    so the order in which the in-flight nodes enter the cluster, which
    breaks ties between equal pods in the next round (the zonal spread
    over in-flight nodes), would follow the threads' timing, and two runs
    of one spec could place the same pods differently."""
    parallel = provisioning._launch_machines_with_errors

    def serial(machines, opts=None):
        names, errors = [], []
        for machine in machines:
            n, e = parallel([machine], opts)
            names += n
            errors += e
        return names, errors

    provisioning._launch_machines_with_errors = serial


class _Run:
    """One package's run of one spec: its globals, the Envs it made."""

    def __init__(self, suite, port: bool):
        self.envs = []
        self.n = 0
        g = dict(vars(suite))
        if port:
            g = {k: _port_of(v, k) for k, v in g.items()}
        env_cls, make_pod = g["Env"], g["make_pod"]

        def env_factory(*a, **kw):
            solver = kw.get("solver")
            if port and solver is None:
                kw["solver"] = GreedySolver()
            elif port and type(solver).__module__.startswith(REF + "."):
                # a spec that imports the reference's device solver in its
                # body runs on the port's device solver
                kw["solver"] = TorchSolver(max_nodes=solver.max_nodes, device="cpu")
            env = env_cls(*a, **kw)
            _serial_launches(env.op.provisioning)
            self.envs.append(env)
            return env

        def pinned_pod(*a, **kw):
            self.n += 1
            kw.setdefault("name", f"pod-{self.n:03d}")
            pod = make_pod(*a, **kw)
            pod.metadata.uid = f"uid-{self.n:05d}"
            pod.metadata.creation_timestamp = 1000.0 + self.n
            return pod

        g["Env"], g["make_pod"] = env_factory, pinned_pod
        # the suite's own helpers read the rebound globals too
        for k, v in list(g.items()):
            if isinstance(v, types.FunctionType) and v.__module__ == suite.__name__:
                g[k] = types.FunctionType(v.__code__, g, v.__name__, v.__defaults__,
                                          v.__closure__)
                g[k].__kwdefaults__ = v.__kwdefaults__
        self.globals = g

    def __call__(self, spec_name):
        fn = self.globals[spec_name]
        if fn.__code__.co_argcount:
            fn(self.globals["Env"]())
        else:
            fn()
        return [_outcome(env) for env in self.envs]


def _outcome(env):
    where = {}
    for p in env.kube.list("Pod"):
        where.setdefault(p.spec.node_name or "", []).append(p.metadata.name)
    nodes = sorted(
        (tuple((k, n.metadata.labels.get(k)) for k in NODE_LABELS),
         tuple(sorted(where.get(n.metadata.name, []))))
        for n in env.kube.list("Node")
    )
    return nodes, sorted(where.get("", [])), len(env.cloud_provider.create_calls)


SPECS = [(suite, name) for suite, mod in SUITES.items() for name in sorted(vars(mod))
         if name.startswith("test_")]


@pytest.mark.parametrize("suite,spec", SPECS, ids=[f"{s}-{n[5:]}" for s, n in SPECS])
def test_spec_outcome_matches_reference(suite, spec):
    want = _Run(SUITES[suite], port=False)(spec)
    got = _Run(SUITES[suite], port=True)(spec)
    assert got == want


def test_specs_cover_the_four_suites():
    counts = {suite: sum(1 for s, _ in SPECS if s == suite) for suite in SUITES}
    assert counts == {"binpack": 26, "inflight": 16, "main": 50, "volumes": 8}


def test_port_run_reaches_no_reference_object():
    """The port's run of a spec builds only port objects: every name the
    suites take from the reference package resolves in the port."""
    for mod in SUITES.values():
        g = _Run(mod, port=True).globals
        for k, v in g.items():
            owner = v.__name__ if isinstance(v, types.ModuleType) else (
                getattr(v, "__module__", None) or "")
            assert not owner.startswith(REF + "."), (mod.__name__, k, owner)
