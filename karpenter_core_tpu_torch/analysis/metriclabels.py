"""Metric-labels pass (rules `metric-label-keys`, `metric-tenant-guard`):
label discipline for the attribution plane.

Prometheus label KEYS define a family's schema and label VALUES define its
cardinality. Both invariants are load-bearing here: the merge plane
(ProcessSeriesMerger) and the SLO engine pattern-match on static key sets,
and tenant values are request-derived strings — unbounded unless every one
routes through the cardinality guard (obs/reqctx.TenantGuard, which caps
the slot count and folds overflow into "other").

So, for every call on an instrument constant (UPPER_CASE receiver —
`SOLVER_SHED_TOTAL.inc`, `reqctx-style module.CACHE_HITS.inc`, including
the `(A if hit else B).inc` conditional form) the labels argument must be
one of:

  * absent / None,
  * a dict literal with constant-string keys and no `**` unpacking,
  * a call to the guard helpers `tenant_labels(...)` (static kwargs only)
    or `TENANTS.admit(...)` — the only functions allowed to mint label
    dicts from request state,
  * a local name whose every assignment in the enclosing scope is one of
    the above (the tracer's build-then-observe idiom: `labels = {...};
    labels["tenant"] = TENANTS.admit(t)`).

and any "tenant" KEY — in a literal or a tracked local — must carry a
guard-call VALUE (`TENANTS.admit(...)`), never a raw request string.
Everything else (bare names from parameters, comprehensions, `dict(...)`
with dynamic keys) is a violation: either the schema is no longer static
(`metric-label-keys`) or a request string reached a label unguarded
(`metric-tenant-guard`).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_core_tpu_torch.analysis.core import Pass, SourceFile, Violation

# instrument methods whose signature carries a labels dict, and the
# positional index the labels argument occupies
_METHODS = {
    "inc": 0,        # Counter.inc(labels)
    "observe": 1,    # Histogram.observe(value, labels, exemplar)
    "set": 1,        # Gauge.set(value, labels)
    "delete": 0,     # Gauge.delete(labels)
}

# the cardinality-guard helpers: the only calls allowed to mint label
# dicts (tenant_labels) or tenant label values (TENANTS.admit) from
# request-derived state
_GUARD_FUNCS = ("tenant_labels",)
_GUARD_METHOD = "admit"
_GUARD_RECEIVER = "TENANTS"


def _is_upper(name: str) -> bool:
    return name.isupper() and any(c.isalpha() for c in name)


def _is_instrument(node: ast.expr) -> bool:
    """Receiver looks like a module-level instrument constant."""
    if isinstance(node, ast.Name):
        return _is_upper(node.id)
    if isinstance(node, ast.Attribute):
        return _is_upper(node.attr)
    if isinstance(node, ast.IfExp):  # (CACHE_HITS if hit else CACHE_MISSES)
        return _is_instrument(node.body) and _is_instrument(node.orelse)
    return False


def _terminal_name(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _is_guard_call(node: ast.expr) -> bool:
    """tenant_labels(...) / reqctx.tenant_labels(...) /
    TENANTS.admit(...) / reqctx.TENANTS.admit(...)."""
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    name = _terminal_name(func)
    if name in _GUARD_FUNCS:
        # static kwargs only: tenant_labels(**dynamic) would smuggle keys
        return all(kw.arg is not None for kw in node.keywords)
    if name == _GUARD_METHOD and isinstance(func, ast.Attribute):
        recv = func.value
        recv_name = _terminal_name(recv) if isinstance(
            recv, (ast.Name, ast.Attribute)
        ) else None
        return recv_name == _GUARD_RECEIVER
    return False


def _dict_literal_problems(node: ast.Dict) -> List[str]:
    problems: List[str] = []
    for key, value in zip(node.keys, node.values):
        if key is None:
            problems.append("label dict uses `**` unpacking — keys are not static")
            continue
        if not (isinstance(key, ast.Constant) and isinstance(key.value, str)):
            problems.append("label key is not a constant string")
            continue
        if key.value == "tenant" and not _is_guard_call(value):
            problems.append(
                'label "tenant" value must come from the cardinality guard '
                "(TENANTS.admit(...)/tenant_labels(...)), not a raw request string"
            )
    return problems


class _ScopeFacts:
    """Per-scope dataflow for the build-then-observe idiom: which local
    names hold label dicts assembled ONLY from compliant pieces."""

    def __init__(self) -> None:
        # name -> list of problems accumulated across all assignments;
        # None entry means the name was assigned something untrackable
        self.names: Dict[str, Optional[List[str]]] = {}

    def assign(self, name: str, value: ast.expr) -> None:
        if isinstance(value, ast.Dict):
            probs = _dict_literal_problems(value)
        elif _is_guard_call(value) or (
            isinstance(value, ast.Constant) and value.value is None
        ):
            probs = []
        else:
            self.names[name] = None
            return
        if name not in self.names:
            self.names[name] = probs
        elif self.names[name] is not None:
            self.names[name] = self.names[name] + probs  # type: ignore[operator]

    def subscript_assign(self, name: str, key: ast.expr, value: ast.expr) -> None:
        prior = self.names.get(name)
        if name not in self.names or prior is None:
            return  # base dict untracked: already a violation at use sites
        if not (isinstance(key, ast.Constant) and isinstance(key.value, str)):
            prior.append("label key is not a constant string")
        elif key.value == "tenant" and not _is_guard_call(value):
            prior.append(
                'label "tenant" value must come from the cardinality guard '
                "(TENANTS.admit(...)/tenant_labels(...)), not a raw request string"
            )

    def problems_for(self, name: str) -> Optional[List[str]]:
        """None = untracked (violation); [] = clean; else the problems."""
        return self.names.get(name)


def _collect_scope_facts(scope_body: Sequence[ast.stmt]) -> _ScopeFacts:
    facts = _ScopeFacts()

    def scan(stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested scopes track their own facts
            if isinstance(stmt, ast.Assign):
                for target in stmt.targets:
                    if isinstance(target, ast.Name):
                        facts.assign(target.id, stmt.value)
                    elif (isinstance(target, ast.Subscript)
                          and isinstance(target.value, ast.Name)):
                        facts.subscript_assign(
                            target.value.id, target.slice, stmt.value
                        )
            elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                target = stmt.target
                if isinstance(target, ast.Name):
                    if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                        facts.assign(target.id, stmt.value)
                    elif isinstance(stmt, ast.AugAssign):
                        facts.names[target.id] = None
            # recurse into compound statement bodies (if/for/while/with/try)
            for field in ("body", "orelse", "finalbody"):
                inner = getattr(stmt, field, None)
                if inner:
                    scan(inner)
            for handler in getattr(stmt, "handlers", []) or []:
                scan(handler.body)

    scan(scope_body)
    return facts


def _labels_arg(call: ast.Call, method: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == "labels":
            return kw.value
    idx = _METHODS[method]
    if len(call.args) > idx:
        return call.args[idx]
    return None


class MetricLabelsPass(Pass):
    name = "metriclabels"
    rules = ("metric-label-keys", "metric-tenant-guard")

    def run(self, files: Sequence[SourceFile], config) -> List[Violation]:
        out: List[Violation] = self.syntax_violations(files, "metric-label-keys")
        for f in files:
            if f.tree is None:
                continue
            for scope_node, scope_body in _scopes(f.tree):
                facts = _collect_scope_facts(scope_body)
                for call in _metric_calls(scope_body):
                    method = call.func.attr  # type: ignore[union-attr]
                    labels = _labels_arg(call, method)
                    out.extend(
                        _check_labels(f, call, labels, facts)
                    )
        return out


def _scopes(tree: ast.AST) -> List[Tuple[ast.AST, Sequence[ast.stmt]]]:
    """(scope node, body) for the module and every function."""
    scopes: List[Tuple[ast.AST, Sequence[ast.stmt]]] = [
        (tree, getattr(tree, "body", []))
    ]
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scopes.append((node, node.body))
    return scopes


def _metric_calls(scope_body: Sequence[ast.stmt]) -> List[ast.Call]:
    """Instrument calls whose receiver is in THIS scope (nested function
    bodies are their own scope and are skipped here)."""
    calls: List[ast.Call] = []

    def scan(nodes) -> None:
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _METHODS
                    and _is_instrument(node.func.value)):
                calls.append(node)
            scan(ast.iter_child_nodes(node))

    scan(scope_body)
    return calls


def _check_labels(
    f: SourceFile, call: ast.Call, labels: Optional[ast.expr], facts: _ScopeFacts
) -> List[Violation]:
    def v(rule: str, message: str) -> Violation:
        return Violation(
            relpath=f.relpath, line=call.lineno, rule=rule, message=message
        )

    if labels is None or (
        isinstance(labels, ast.Constant) and labels.value is None
    ):
        return []
    if isinstance(labels, ast.Dict):
        return [
            v(
                "metric-tenant-guard" if "tenant" in p else "metric-label-keys",
                p,
            )
            for p in _dict_literal_problems(labels)
        ]
    if _is_guard_call(labels):
        return []
    if isinstance(labels, ast.Name):
        problems = facts.problems_for(labels.id)
        if problems is None:
            return [v(
                "metric-label-keys",
                f"labels `{labels.id}` is not a tracked static dict — build it "
                "as a dict literal (or tenant_labels(...)) in this scope",
            )]
        return [
            v(
                "metric-tenant-guard" if "tenant" in p else "metric-label-keys",
                p,
            )
            for p in problems
        ]
    return [v(
        "metric-label-keys",
        "labels argument must be a dict literal with constant keys, "
        "tenant_labels(...), or a tracked local dict",
    )]
