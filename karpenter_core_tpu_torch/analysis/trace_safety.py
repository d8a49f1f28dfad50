"""Trace-safety pass (rule `trace-safety`): host-side Python on traced
values inside jit/pjit/shard_map-wrapped functions.

Inside a traced body, a Python `if`/`while` on a traced array raises a
ConcretizationTypeError at best; at worst the branch silently becomes a
compile-time constant keyed into the trace, and every new value RECOMPILES
the program — which blows the <1s p99 Solve() target the whole solver is
built around. `.item()` / `bool()` / `float()` / `int()` coercions and host
`np.` calls on traced arguments force a device sync or bake a constant the
same way.

Detection is name-taint based and deliberately conservative:

  1. Find traced functions: `@jax.jit`-style decorators, and functions whose
     NAME is passed to jit/pjit/shard_map/vmap in the same module (assignment
     chains like `sharded = shard_map(body, ...); jax.jit(sharded)` are
     followed one level). NamedSharding-jit mesh-program bodies (
     `jax.jit(body, in_shardings=..., donate_argnums=...)` and bodies that
     apply with_sharding_constraint via a SpecLayout) are the same `jit`
     spelling, so they are covered by the same name-based detection.
  2. Taint the function's parameters, then propagate through simple
     assignments whose RHS mentions a tainted name.
  3. Flag `if`/`while` tests, coercion calls, `np.*` calls, and explicit
     host transfers (`jax.device_get` / `device_get`) that touch a
     tainted name — inside a mesh program a host transfer is a
     cross-device sync of EVERY shard, not just one chip's stall.
     (`device_put` inside a jitted body is deliberately NOT flagged: it
     is on-device placement, not a host round-trip — see the jaxpr
     tripwire in tests/test_sharded.py.)

Functions produced by factories (`jax.jit(make_device_run(...))`) are out of
static reach — the kernels those factories close over are covered by their
own fixture-style unit tests and by the runtime differential suites.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set

from karpenter_core_tpu_torch.analysis.core import Pass, SourceFile, Violation

COERCIONS = {"bool", "float", "int"}
NUMPY_ALIASES = {"np", "numpy"}
# explicit host-transfer calls: flagged on tainted values inside any traced
# body — jit, shard_map, or a NamedSharding-jit mesh-program body, where
# the sync stalls every device on the mesh. device_put is NOT here: inside
# a jitted body it lowers to on-device placement, not a host round-trip.
HOST_TRANSFERS = {"device_get"}


def _called_name(func: ast.expr) -> Optional[str]:
    """`jax.jit` -> 'jit', `pjit` -> 'pjit', `jax.experimental.shard_map.shard_map`
    -> 'shard_map'."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


class _NameCollector(ast.NodeVisitor):
    def __init__(self) -> None:
        self.names: Set[str] = set()

    def visit_Name(self, node: ast.Name) -> None:
        self.names.add(node.id)


def _names_in(node: ast.AST) -> Set[str]:
    c = _NameCollector()
    c.visit(node)
    return c.names


class TraceSafetyPass(Pass):
    name = "trace_safety"
    rules = ("trace-safety",)

    def run(self, files: Sequence[SourceFile], config) -> List[Violation]:
        out: List[Violation] = []
        wrappers = set(config.trace_wrappers)
        for f in files:
            if f.tree is None:
                continue
            out.extend(self._check_module(f, wrappers))
        return out

    def _check_module(self, f: SourceFile, wrappers: Set[str]) -> List[Violation]:
        # index every function definition in the module by name (innermost
        # definition wins — good enough for the closure-factory idiom)
        defs: Dict[str, ast.FunctionDef] = {}
        # name -> name it aliases via `x = wrapper(y, ...)`
        aliases: Dict[str, str] = {}
        for node in ast.walk(f.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs[node.name] = node
            elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                callee = _called_name(node.value.func)
                if callee in wrappers or callee == "vmap":
                    arg0 = node.value.args[0] if node.value.args else None
                    if isinstance(arg0, ast.Name) and len(node.targets) == 1:
                        target = node.targets[0]
                        if isinstance(target, ast.Name):
                            aliases[target.id] = arg0.id

        traced: Set[str] = set()
        for node in ast.walk(f.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    dec_name = _called_name(
                        dec.func if isinstance(dec, ast.Call) else dec
                    )
                    if dec_name in wrappers:
                        traced.add(node.name)
                    elif dec_name == "partial" and isinstance(dec, ast.Call):
                        if dec.args and _called_name(dec.args[0]) in wrappers:
                            traced.add(node.name)
            elif isinstance(node, ast.Call):
                callee = _called_name(node.func)
                if callee in wrappers:
                    for arg in node.args[:1]:
                        if isinstance(arg, ast.Name):
                            name = arg.id
                            # follow one alias hop: jit(sharded) where
                            # sharded = shard_map(body, ...)
                            name = aliases.get(name, name)
                            traced.add(name)

        out: List[Violation] = []
        for name in sorted(traced):
            fn = defs.get(name)
            if fn is not None:
                out.extend(self._check_function(f, fn))
        return out

    def _check_function(self, f: SourceFile, fn: ast.FunctionDef) -> List[Violation]:
        tainted: Set[str] = set()
        a = fn.args
        for arg in (
            list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
            + ([a.vararg] if a.vararg else [])
            + ([a.kwarg] if a.kwarg else [])
        ):
            tainted.add(arg.arg)

        # forward taint propagation through simple assignments; iterate to a
        # fixpoint so `a = x; b = a` taints b regardless of nesting order
        assigns: List[ast.Assign] = [
            n for n in ast.walk(fn) if isinstance(n, (ast.Assign, ast.AugAssign))
        ]
        changed = True
        while changed:
            changed = False
            for node in assigns:
                value = node.value
                if not (_names_in(value) & tainted):
                    continue
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for target in targets:
                    for t in ast.walk(target):
                        if isinstance(t, ast.Name) and t.id not in tainted:
                            tainted.add(t.id)
                            changed = True

        out: List[Violation] = []

        def flag(node: ast.AST, message: str) -> None:
            out.append(Violation(
                relpath=f.relpath, line=node.lineno, rule="trace-safety",
                message=f"in traced function '{fn.name}': {message}",
            ))

        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While)):
                hit = _names_in(node.test) & tainted
                if hit:
                    kind = "if" if isinstance(node, ast.If) else "while"
                    flag(node, (
                        f"Python `{kind}` on traced value(s) "
                        f"{', '.join(sorted(hit))} — use jnp.where/lax.cond, "
                        "or hoist the branch out of the traced body"
                    ))
            elif isinstance(node, ast.Call):
                callee = node.func
                transfer = None
                if isinstance(callee, ast.Name) and callee.id in HOST_TRANSFERS:
                    transfer = callee.id
                elif (
                    isinstance(callee, ast.Attribute)
                    and callee.attr in HOST_TRANSFERS
                ):
                    transfer = callee.attr
                if transfer is not None:
                    hit = set()
                    for arg in list(node.args) + [kw.value for kw in node.keywords]:
                        hit |= _names_in(arg) & tainted
                    if hit:
                        flag(node, (
                            f"`{transfer}` host transfer on traced value(s) "
                            f"{', '.join(sorted(hit))} — inside a mesh "
                            "program this syncs every device; fetch after "
                            "the program returns"
                        ))
                    continue
                if isinstance(callee, ast.Name) and callee.id in COERCIONS:
                    hit = set()
                    for arg in node.args:
                        hit |= _names_in(arg) & tainted
                    if hit:
                        flag(node, (
                            f"`{callee.id}()` coerces traced value(s) "
                            f"{', '.join(sorted(hit))} to a host scalar "
                            "(forces a device sync / constant-folds the trace)"
                        ))
                elif isinstance(callee, ast.Attribute):
                    if callee.attr == "item":
                        base = callee.value
                        hit = _names_in(base) & tainted
                        if hit:
                            flag(node, (
                                f"`.item()` on traced value(s) "
                                f"{', '.join(sorted(hit))} — host sync inside "
                                "the traced body"
                            ))
                    elif (
                        isinstance(callee.value, ast.Name)
                        and callee.value.id in NUMPY_ALIASES
                    ):
                        hit = set()
                        for arg in list(node.args) + [kw.value for kw in node.keywords]:
                            hit |= _names_in(arg) & tainted
                        if hit:
                            flag(node, (
                                f"host-side `{callee.value.id}.{callee.attr}` on "
                                f"traced value(s) {', '.join(sorted(hit))} — "
                                "use jax.numpy inside the traced body"
                            ))
        return out
