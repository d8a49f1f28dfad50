"""Monotonic-time pass (rule `monotonic-time`): time.time() is banned from
the package except at audited wall-clock sites.

Wall clocks jump: NTP slews, manual resets, leap smearing. Any duration,
deadline, or backoff computed from time.time() deltas can go negative or
explode — the reference's clock discipline (monotonic for durations, wall
for object timestamps) is enforced here. The allowlist in
AnalysisConfig.wallclock_allowlist names `relpath::function` sites whose
job IS producing a wall-clock timestamp (log record ts, k8s condition
lastTransitionTime, deletionTimestamp, flight-record stamps); everything
else must use time.monotonic() / time.perf_counter().

Instance-clock references (`clock=time.time` defaults on METHODS, stored on
the instance at construction) are not calls and are not flagged — those
clocks are compared against object wall-clock timestamps by design. But the
same spelling on a MODULE-LEVEL FUNCTION is flagged (rule
`monotonic-time-default`): a function default evaluates ONCE at import, so
the bound clock is a hidden global — a fake clock installed later (tests
monkeypatching time.time, a steppable clock threaded most of the way down)
silently never reaches the call site. Spell it `clock=None` and resolve at
call time instead (deprovisioning/core.lifetime_remaining is the audited
pattern; tests/analysis_fixtures/montime_default_{good,bad}.py pin it).
"""
from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Set

from karpenter_core_tpu_torch.analysis.core import Pass, SourceFile, Violation


class MonotonicTimePass(Pass):
    name = "montime"
    rules = ("monotonic-time", "monotonic-time-default")

    def run(self, files: Sequence[SourceFile], config) -> List[Violation]:
        out: List[Violation] = []
        for f in files:
            if f.tree is None:
                continue
            time_aliases: Set[str] = set()
            bare_time: Set[str] = set()  # names bound to the time.time function
            for node in ast.walk(f.tree):
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        if alias.name == "time":
                            time_aliases.add(alias.asname or "time")
                elif isinstance(node, ast.ImportFrom):
                    if node.module == "time" and not node.level:
                        for alias in node.names:
                            if alias.name == "time":
                                bare_time.add(alias.asname or "time")
            if not time_aliases and not bare_time:
                continue

            def is_time_ref(expr) -> bool:
                return (
                    isinstance(expr, ast.Attribute)
                    and expr.attr == "time"
                    and isinstance(expr.value, ast.Name)
                    and expr.value.id in time_aliases
                ) or (isinstance(expr, ast.Name) and expr.id in bare_time)

            # module-level function defaults: `def f(..., clock=time.time)`
            # at module scope binds the clock AT IMPORT — flag it. Methods
            # (functions inside a ClassDef) are exempt: they stash the
            # injectable clock on the instance at construction, the
            # audited convention.
            for node in f.tree.body:
                if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                defaults = list(node.args.defaults) + [
                    d for d in node.args.kw_defaults if d is not None
                ]
                for default in defaults:
                    if is_time_ref(default):
                        out.append(Violation(
                            relpath=f.relpath,
                            line=default.lineno,
                            rule="monotonic-time-default",
                            message=(
                                "time.time bound as a module-level function "
                                "parameter default — evaluated once at "
                                "import, so later-installed clocks (fakes, "
                                "monkeypatches) never reach the call; use "
                                "`clock=None` and resolve at call time"
                            ),
                        ))
            # map each call to its enclosing function for allowlist checks
            parents = _FuncIndex(f.tree)
            for node in ast.walk(f.tree):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                is_time_call = (
                    isinstance(func, ast.Attribute)
                    and func.attr == "time"
                    and isinstance(func.value, ast.Name)
                    and func.value.id in time_aliases
                ) or (isinstance(func, ast.Name) and func.id in bare_time)
                if not is_time_call:
                    continue
                site = f"{f.relpath}::{parents.enclosing(node.lineno) or '<module>'}"
                if site in config.wallclock_allowlist:
                    continue
                out.append(Violation(
                    relpath=f.relpath,
                    line=node.lineno,
                    rule="monotonic-time",
                    message=(
                        "time.time() outside the wall-clock allowlist — use "
                        "time.monotonic()/perf_counter() for durations and "
                        "deadlines, or add the audited site to "
                        "AnalysisConfig.wallclock_allowlist"
                    ),
                ))
        return out


class _FuncIndex:
    """Line -> innermost enclosing function name."""

    def __init__(self, tree: ast.AST) -> None:
        self.spans: List[tuple] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                end = getattr(node, "end_lineno", node.lineno)
                self.spans.append((node.lineno, end, node.name))
        # innermost = narrowest span containing the line
        self.spans.sort(key=lambda s: (s[1] - s[0]))

    def enclosing(self, line: int) -> Optional[str]:
        for lo, hi, name in self.spans:
            if lo <= line <= hi:
                return name
        return None
