"""Analysis configuration: the dependency DAG, the wall-clock allowlist,
and the structural knobs every pass reads. `default_config()` describes
THIS package (karpenter_core_tpu_torch); fixture tests build their own
`AnalysisConfig` to lint synthetic trees.

The port compiles nothing with a tracer today: its device work is eager
PyTorch and hand-written CUDA kernels (csrc/, built by ops/cuda_build.py).
So `default_config().trace_wrappers` names torch's tracing entry points
(`torch.compile`, `torch.jit.script`, `torch.jit.trace`), which no body of
the package uses yet; a later change that adds one is held to the
trace-safety rule from its first line. The recompile-guard sinks are the
port's kernel factories: each geometry they are built for is a residency
entry of the solver's 8-entry LRU, so a raw `len()` reaching one mints an
entry per size instead of per bucket.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, FrozenSet

# Subpackage dependency DAG: subpackage -> subpackages it may import at
# MODULE scope. Function-scope imports are exempt (they express a runtime
# collaboration, not a load-order dependency — e.g. solver/encode.py builds
# host Topology inside encode_snapshot). The map is the architecture:
# adding an edge here is a design decision, reviewed like one.
#
# Layers, roughly bottom-up:
#   metrics                                      (leaf)
#   obs, analysis                                (obs -> metrics only)
#   chaos                                        (registry + env arming)
#   utils, kube                                  (kube <-> utils is two
#                                                 module-level acyclic edges:
#                                                 utils/podutils -> kube/objects,
#                                                 kube/apiserver -> utils/backoff)
#   api, events, scheduling                      (domain objects)
#   cloudprovider, state                         (cluster model)
#   ops, native                                  (device kernels; csrc/ holds
#                                                 the CUDA sources and no
#                                                 Python, so it is no layer)
#   solver                                       (MUST NOT see controllers)
#   controllers                                  (may orchestrate solver)
#   operator, webhooks, testing                  (process wiring)
#   loadgen                                      (churn generator: may see
#                                                 everything, seen by nobody)
# The reference's `parallel` layer (the mesh programs) has no counterpart
# yet; it joins this map with the multi-device slice.
DEFAULT_LAYERING: Dict[str, FrozenSet[str]] = {
    "metrics": frozenset(),
    "analysis": frozenset(),
    "obs": frozenset({"metrics"}),
    "chaos": frozenset({"metrics", "obs"}),
    "utils": frozenset({"kube", "metrics", "obs"}),
    "kube": frozenset({"chaos", "metrics", "obs", "utils"}),
    "events": frozenset({"kube", "metrics", "obs", "utils"}),
    "api": frozenset({"kube", "utils"}),
    "scheduling": frozenset({"api", "kube", "utils"}),
    "cloudprovider": frozenset({"api", "kube", "metrics", "obs", "scheduling", "utils"}),
    "state": frozenset({"api", "chaos", "kube", "obs", "scheduling", "utils"}),
    "ops": frozenset({"metrics", "obs", "utils"}),
    "native": frozenset({"metrics", "obs", "utils"}),
    # parallel sits above solver, as the reference's: ShardedSolver is a
    # TorchSolver subclass (parallel/sharded.py), so parallel may see solver
    # and solver reaches parallel only at function scope (factory, service)
    "parallel": frozenset({"chaos", "metrics", "obs", "ops", "solver", "utils"}),
    "solver": frozenset({
        "api", "chaos", "cloudprovider", "events", "kube", "metrics", "native",
        "obs", "ops", "scheduling", "state", "utils",
    }),
    "controllers": frozenset({
        "api", "chaos", "cloudprovider", "events", "kube", "metrics", "native",
        "obs", "ops", "parallel", "scheduling", "solver", "state", "utils",
    }),
    "operator": frozenset({
        "api", "chaos", "cloudprovider", "controllers", "events", "kube",
        "metrics", "obs", "scheduling", "solver", "state", "utils", "webhooks",
    }),
    "webhooks": frozenset({"api", "kube", "obs", "utils"}),
    "testing": frozenset({
        "api", "chaos", "cloudprovider", "controllers", "events", "kube",
        "metrics", "obs", "operator", "scheduling", "solver", "state", "utils",
    }),
    # churn/soak load generation: drives the REAL operator loop (batcher ->
    # provisioner -> solver -> bind), so it sits above everything — and is
    # a leaf the other way: NOTHING may depend on loadgen (no other layer
    # lists it), so load generation can never leak into the control plane
    "loadgen": frozenset({
        "api", "chaos", "cloudprovider", "controllers", "events", "kube",
        "metrics", "obs", "operator", "scheduling", "solver", "state",
        "testing", "utils",
    }),
}

# monotonic-time allowlist: `relpath::function` sites whose time.time() IS
# the point — they produce wall-clock timestamps that are serialized,
# compared against k8s object timestamps, or rendered for humans. Every
# other site measures durations and must use time.monotonic() or
# time.perf_counter().
DEFAULT_WALLCLOCK_ALLOWLIST: FrozenSet[str] = frozenset({
    # structured log records carry an epoch ts field (logfmt/JSON output)
    "karpenter_core_tpu_torch/obs/log.py::_emit",
    # k8s condition lastTransitionTime is wall-clock API surface
    "karpenter_core_tpu_torch/api/machine.py::set_condition",
    # deletionTimestamp mirrors metav1.Time — wall-clock like
    # creation_timestamp (kube/objects.py ObjectMeta default)
    "karpenter_core_tpu_torch/kube/client.py::delete",
    # flight records are stamped with the wall-clock solve time; the dump
    # filename renders it via time.gmtime
    "karpenter_core_tpu_torch/obs/flightrec.py::__init__",
    "karpenter_core_tpu_torch/obs/flightrec.py::dump",
    # consolidation decision records carry the same wall-clock stamp
    "karpenter_core_tpu_torch/obs/flightrec.py::record_consolidation",
    # a heartbeat file is a CROSS-PROCESS liveness signal: the only clock
    # a worker and its supervisor share is the filesystem's wall clock
    # (the file's mtime), so its age is read against it by design
    "karpenter_core_tpu_torch/utils/supervise.py::age",
    # a health verdict's stamp and its TTL, read by other processes
    "karpenter_core_tpu_torch/utils/supervise.py::write_verdict",
    "karpenter_core_tpu_torch/utils/supervise.py::read_verdict",
})

# kernel factories whose arguments shape what they build, and the bucket
# functions that absorb a runtime size (recompile-guard pass)
PORT_RECOMPILE_SINKS: FrozenSet[str] = frozenset({
    "make_device_run",
    "make_prescreen_kernel",
    "make_pack_kernel",
    "make_batched_replan_kernel",
    "make_replan_verdict_kernel",
    "make_segment_partition_kernel",
})
PORT_RECOMPILE_SANITIZERS: FrozenSet[str] = frozenset({
    "ladder_pad",
    "bucket_pow2",
    "replan_k_pad",
    "replan_chunks",
    "segment_lane_pad",
    "segment_item_pad",
    "solve_geometry",
})
# torch's tracing entry points, by terminal name (`torch.compile`,
# `torch.jit.script`, `torch.jit.trace`)
PORT_TRACE_WRAPPERS: FrozenSet[str] = frozenset({"compile", "script", "trace"})


@dataclass
class AnalysisConfig:
    repo_root: str
    package_name: str = "karpenter_core_tpu_torch"
    layering: Dict[str, FrozenSet[str]] = field(
        default_factory=lambda: dict(DEFAULT_LAYERING)
    )
    # subpackages whose absence from `layering` is an error (catches a new
    # top-level subpackage landing without a declared layer)
    layering_strict: bool = True
    wallclock_allowlist: FrozenSet[str] = DEFAULT_WALLCLOCK_ALLOWLIST
    # the single module allowed to touch os.environ
    env_funnel: str = "karpenter_core_tpu_torch/obs/envflags.py"
    # callables that trace the function they wrap (trace-safety pass); the
    # generic vocabulary of fixture trees — default_config() names torch's
    trace_wrappers: FrozenSet[str] = frozenset({"jit", "pjit", "shard_map"})
    # method-name suffix conventionally meaning "caller holds the lock" —
    # writes there are treated as guarded (guarded-by pass)
    locked_suffix: str = "_locked"
    # modules allowed to Popen without an inline start_new_session= (the
    # audited supervisor funnel — it DOES set it today; the funnel list
    # exists so refactors inside it don't fight the lint)
    popen_funnels: FrozenSet[str] = frozenset({
        "karpenter_core_tpu_torch/solver/host.py",
    })
    # `relpath::function` sites where a bare os.kill IS the point (none
    # today: the convention is os.killpg / supervise._kill_group)
    os_kill_allowlist: FrozenSet[str] = frozenset()
    # modules exempt from atomic-write wholesale: supervise IMPLEMENTS the
    # write-temp-fsync-rename idiom (its heartbeat and its tail readers)
    atomic_write_funnels: FrozenSet[str] = frozenset({
        "karpenter_core_tpu_torch/utils/supervise.py",
    })
    # `relpath::function` sites audited for a bare open-for-write: the solver host's
    # child stderr file is a LIVE STREAM handed to Popen — there is no
    # final artifact to rename into place, and its reader (tail_bytes_of
    # in _stderr_tail) tolerates a partial tail by design
    plain_write_allowlist: FrozenSet[str] = frozenset({
        "karpenter_core_tpu_torch/solver/host.py::_spawn_locked",
    })
    # bucketing funnels that absorb a runtime-size taint (recompile-guard
    # pass): a len()-derived value routed through one of these lands on
    # the geometry bucket ladder, so downstream static shapes are bounded
    recompile_sanitizers: FrozenSet[str] = PORT_RECOMPILE_SANITIZERS
    # compile boundaries whose static arguments shape a program
    # (recompile-guard pass): kernel factories, shape-struct constructors,
    # and jit/pjit themselves — a raw runtime size arriving here mints one
    # program per distinct value. These defaults are the rule's generic
    # vocabulary, which fixture trees are written in; default_config()
    # narrows them to the port's own names
    recompile_sinks: FrozenSet[str] = frozenset({
        "jit",
        "pjit",
        "ShapeDtypeStruct",
        "make_device_run",
        "make_prescreen_kernel",
        "make_screen_refresh_kernel",
        "make_batched_replan_kernel",
        "make_replan_verdict_kernel",
        "make_segment_partition_kernel",
        "make_pack_kernel",
        "make_screen_ops",
    })

    def subpackage_of(self, module: str) -> str:
        """`pkg.solver.encode` -> `solver`; root-level modules -> ''."""
        prefix = self.package_name + "."
        if not module.startswith(prefix):
            return ""
        rest = module[len(prefix):]
        return rest.split(".")[0] if "." in rest else (
            rest if self._is_subpackage(rest) else ""
        )

    def _is_subpackage(self, name: str) -> bool:
        return os.path.isdir(
            os.path.join(self.repo_root, self.package_name, name)
        )


def default_config(repo_root: str | None = None) -> AnalysisConfig:
    if repo_root is None:
        # analysis/config.py lives two levels under the repo root
        repo_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
    return AnalysisConfig(
        repo_root=repo_root,
        trace_wrappers=PORT_TRACE_WRAPPERS,
        recompile_sinks=PORT_RECOMPILE_SINKS,
    )
