"""Recompile-guard pass (rule `recompile-guard`): raw runtime sizes at
compile boundaries.

Every static shape a compiled program is traced with must come off the
geometry bucket ladder (solver/encode.py `ladder_pad` / `bucket_pow2` and
friends): a value derived from a live collection size (`len(pods)`,
`len(state_nodes)`, ...) that reaches a jit/pjit boundary or a kernel
factory's static argument mints one program per distinct size — unbounded
compile churn that the runtime counter `karpenter_bucket_overflow_total`
only notices after the fact. This pass is that counter's static twin: it
catches the unbucketed route at review time.

Mechanics: per-function taint tracking in statement order. `len(...)` is
the taint source; assignments propagate taint through arithmetic and
ordinary calls; calls to the configured sanitizers
(`config.recompile_sanitizers` — the bucketing funnels) clean it. A
tainted expression arriving as an argument to a configured sink
(`config.recompile_sinks` — the kernel factories and shape-struct
constructors, plus jit/pjit boundaries and immediate `jit(f)(...)`
dispatches) is a violation. Flow analysis is intraprocedural and
name-based — a taint laundered through an attribute or a container is out
of reach (same known-limits posture as trace-safety).
"""
from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Set

from karpenter_core_tpu_torch.analysis.core import Pass, SourceFile, Violation

_JIT_NAMES = frozenset({"jit", "pjit"})


def _call_name(node: ast.Call) -> Optional[str]:
    """The terminal name a call dispatches through: `jax.jit(...)` ->
    'jit', `ladder_pad(...)` -> 'ladder_pad'."""
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


class _FunctionTaint(ast.NodeVisitor):
    """Statement-order taint walk over ONE function body (nested defs get
    their own walker: their bodies run later, with their own locals)."""

    def __init__(self, pass_, relpath: str, config) -> None:
        self.pass_ = pass_
        self.relpath = relpath
        self.config = config
        self.sanitizers: Set[str] = set(config.recompile_sanitizers)
        self.sinks: Set[str] = set(config.recompile_sinks)
        self.tainted: Set[str] = set()
        self.out: List[Violation] = []

    # -- expression taint --------------------------------------------------

    def is_tainted(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Call):
            name = _call_name(node)
            if name == "len":
                return True
            if name in self.sanitizers:
                return False  # bucketed: the funnel absorbs the taint
            return any(self.is_tainted(a) for a in node.args) or any(
                self.is_tainted(k.value) for k in node.keywords
            )
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.BinOp):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand)
        if isinstance(node, ast.IfExp):
            return self.is_tainted(node.body) or self.is_tainted(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_tainted(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.is_tainted(node.value)
        return False

    # -- statements --------------------------------------------------------

    def _bind(self, target: ast.expr, tainted: bool) -> None:
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            # tuple unpack: conservative — every bound name inherits the
            # RHS verdict (a mixed tuple is rare at the sizes this tracks)
            for elt in target.elts:
                self._bind(elt, tainted)

    def visit_Assign(self, node: ast.Assign) -> None:
        self._check_expr(node.value)
        tainted = self.is_tainted(node.value)
        for target in node.targets:
            self._bind(target, tainted)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._check_expr(node.value)
            self._bind(node.target, self.is_tainted(node.value))

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_expr(node.value)
        if isinstance(node.target, ast.Name):
            if self.is_tainted(node.value):
                self.tainted.add(node.target.id)

    def visit_For(self, node: ast.For) -> None:
        self._check_expr(node.iter)
        self._bind(node.target, self.is_tainted(node.iter))
        for stmt in node.body:
            self.visit(stmt)
        for stmt in node.orelse:
            self.visit(stmt)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.pass_.check_function(node, self.relpath, self.out, self.config)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def generic_visit(self, node: ast.AST) -> None:
        # sink checks on every expression statement / call we walk past
        if isinstance(node, ast.expr):
            self._check_expr(node)
            return  # _check_expr recurses into calls itself
        super().generic_visit(node)

    # -- sinks -------------------------------------------------------------

    def _check_expr(self, node: ast.expr) -> None:
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            name = _call_name(call)
            if name in self.sinks:
                self._check_sink(call, name)
            elif (
                isinstance(call.func, ast.Call)
                and _call_name(call.func) in _JIT_NAMES
            ):
                # immediate dispatch of a fresh jit: jit(f)(args...) — the
                # arguments ARE the traced shapes
                self._check_sink(call, "jit(...)")

    def _check_sink(self, call: ast.Call, name: str) -> None:
        exprs = list(call.args) + [k.value for k in call.keywords]
        if name in _JIT_NAMES:
            # jax.jit(fn, donate_argnums=..., static_argnums=...): the
            # keywords are argument POSITIONS (commonly counted off a
            # fixed-size donation tuple), not shapes — only positional
            # values trace
            exprs = list(call.args)
        for arg in exprs:
            if self.is_tainted(arg):
                self.out.append(Violation(
                    relpath=self.relpath,
                    line=arg.lineno,
                    rule="recompile-guard",
                    message=(
                        f"runtime collection size reaches {name} without "
                        "bucketing — pad through ladder_pad/bucket_pow2 "
                        "(solver/encode.py) or one program per distinct "
                        "size gets minted"
                    ),
                ))


class RecompileGuardPass(Pass):
    name = "recompileguard"
    rules = ("recompile-guard",)

    def run(self, files: Sequence[SourceFile], config) -> List[Violation]:
        out: List[Violation] = self.syntax_violations(
            files, "recompile-guard"
        )
        for f in files:
            if f.tree is None:
                continue
            for node in ast.iter_child_nodes(f.tree):
                self._walk_defs(node, f.relpath, out, config)
        return out

    def _walk_defs(self, node: ast.AST, relpath: str, out, config) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.check_function(node, relpath, out, config)
        else:
            for child in ast.iter_child_nodes(node):
                self._walk_defs(child, relpath, out, config)

    def check_function(self, node, relpath: str, out, config) -> None:
        walker = _FunctionTaint(self, relpath, config)
        for stmt in node.body:
            walker.visit(stmt)
        out.extend(walker.out)
