"""Pluggable AST-based static analysis for karpenter_core_tpu_torch.

The Go reference leans on `go vet` and the race detector in presubmit; this
package is the Python analog, run over the port's own tree. Each pass is a
`Pass` subclass registered in `all_passes()`; `python -m
karpenter_core_tpu_torch.analysis` is the command line (exit 0 clean, 1 on
any violation, 2 on a usage error). Per-line suppression: `# lint: disable=<rule>[,<rule>...]`.

Passes (rule ids in parentheses):
  trace_safety  (trace-safety)    — host-side Python control flow/coercions
                                    inside jit/pjit/shard_map-traced bodies
  layering      (layering,        — subpackage dependency DAG + module-scope
                 import-cycle)      import-cycle detection
  envdiscipline (env-flags)       — all os.environ access funnels through
                                    obs/envflags.py
  montime       (monotonic-time)  — time.time() banned outside the audited
                                    wall-clock allowlist
  concurrency   (bare-except,     — exception/thread/lock discipline with
                 thread-discipline,  guarded-by inference for self._lock;
                 guarded-by,         v2 adds intraprocedural lockset
                 guarded-by-v2)      summaries incl. acquire()/release()
  procdiscipline (proc-group,     — process-group spawn discipline,
                 proc-kill-group,    killpg convention, joined non-daemon
                 thread-join)        child-waiter threads
  atomicwrite   (atomic-write)    — artifact writes must be atomic
                                    (write-temp-fsync-rename) for the
                                    resume/health/replay readers
  noprint       (no-print)        — bare print() in production code
  metriclabels  (metric-label-keys, — instrument label key sets must be
                 metric-tenant-guard) static literals/tracked dicts;
                                    "tenant" values route through the
                                    cardinality guard (obs/reqctx)
  recompileguard (recompile-guard) — runtime collection sizes (len of
                                    pods/nodes/types) must pass through
                                    the bucket ladder before reaching a
                                    jit/pjit boundary or kernel-factory
                                    static argument

The reference's second backend, analysis/irlint (rule ids ir-*), checks
the lowered jaxpr/HLO of its compiled programs. It has no counterpart here:
the port lowers no program to an IR it could read.
"""
from karpenter_core_tpu_torch.analysis.core import (  # noqa: F401
    Pass,
    SourceFile,
    Violation,
    load_baseline,
    load_tree,
    run_passes,
)
from karpenter_core_tpu_torch.analysis.config import AnalysisConfig, default_config  # noqa: F401


def all_passes():
    """Instantiate every registered pass, import-cycle-free at module load."""
    from karpenter_core_tpu_torch.analysis.atomicwrite import AtomicWritePass
    from karpenter_core_tpu_torch.analysis.concurrency import ConcurrencyPass
    from karpenter_core_tpu_torch.analysis.envdiscipline import EnvDisciplinePass
    from karpenter_core_tpu_torch.analysis.layering import LayeringPass
    from karpenter_core_tpu_torch.analysis.metriclabels import MetricLabelsPass
    from karpenter_core_tpu_torch.analysis.montime import MonotonicTimePass
    from karpenter_core_tpu_torch.analysis.noprint import NoPrintPass
    from karpenter_core_tpu_torch.analysis.procdiscipline import ProcessDisciplinePass
    from karpenter_core_tpu_torch.analysis.recompileguard import RecompileGuardPass
    from karpenter_core_tpu_torch.analysis.trace_safety import TraceSafetyPass

    return [
        TraceSafetyPass(),
        LayeringPass(),
        EnvDisciplinePass(),
        MonotonicTimePass(),
        ConcurrencyPass(),
        ProcessDisciplinePass(),
        AtomicWritePass(),
        NoPrintPass(),
        MetricLabelsPass(),
        RecompileGuardPass(),
    ]
