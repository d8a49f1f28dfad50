"""Atomic-write pass.

The resume/health machinery reads other processes' files while they are
being written: bench `--resume` re-reads stage artifacts, the health
daemon's verdict file is polled by every consumer, replay reads flight-
recorder dumps. A bare ``open(path, "w")`` on any of those paths is a
torn-read hazard — a reader can observe a truncated file between the
truncate and the final flush. The repo idiom is write-temp-fsync-rename
(`utils/supervise.atomic_write_json`): `os.replace` is atomic on POSIX,
so a reader sees the old version or the new one, never a prefix.

Rule `atomic-write`: every ``open(..., "w"/"wb"/"x"...)`` call in the
package must either

  * live in a supervisor funnel module (config.atomic_write_funnels —
    the module that IMPLEMENTS the idiom, plus stream files whose
    readers tolerate partial tails by design), or
  * sit in a function that also calls ``os.replace``/``os.rename`` (the
    inline idiom: the open targets a temp path renamed into place), or
  * carry an audited `relpath::function` entry in
    config.plain_write_allowlist (each with its reason beside it in
    config.py).

Append mode is exempt: appends don't truncate (heartbeat touches, log
tails), so a torn read shows a short tail, not a half-written artifact.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Sequence, Tuple

from karpenter_core_tpu_torch.analysis.core import Pass, SourceFile, Violation

WRITE_MODES = {"w", "wb", "wt", "x", "xb", "xt", "w+", "wb+", "w+b"}


def _open_mode(node: ast.Call) -> Optional[str]:
    """The literal mode string of an open() call: '' when absent (read),
    None when non-literal (out of static reach, skipped)."""
    if len(node.args) >= 2:
        mode = node.args[1]
    else:
        mode = next(
            (kw.value for kw in node.keywords if kw.arg == "mode"), None
        )
    if mode is None:
        return ""
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value
    return None


def _scope_nodes(scope: ast.AST) -> Iterator[ast.AST]:
    """Every node lexically in `scope`, NOT descending into nested
    function definitions (each def is judged as its own scope)."""
    stack = list(getattr(scope, "body", []))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue  # nested scope: judged on its own
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _scopes(tree: ast.AST) -> List[Tuple[str, ast.AST]]:
    """(function name, scope node) for every def plus ('', module)."""
    out: List[Tuple[str, ast.AST]] = [("", tree)]
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append((node.name, node))
    return out


class AtomicWritePass(Pass):
    name = "atomicwrite"
    rules = ("atomic-write",)

    def run(self, files: Sequence[SourceFile], config) -> List[Violation]:
        out: List[Violation] = []
        funnels = getattr(config, "atomic_write_funnels", frozenset())
        allowlist = getattr(config, "plain_write_allowlist", frozenset())
        for f in files:
            if f.tree is None or f.relpath in funnels:
                continue
            for scope_name, scope in _scopes(f.tree):
                nodes = list(_scope_nodes(scope))
                has_rename = any(
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr in ("replace", "rename")
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id == "os"
                    for n in nodes
                )
                if has_rename:
                    continue  # inline write-temp + atomic-rename idiom
                if f"{f.relpath}::{scope_name}" in allowlist:
                    continue
                for n in nodes:
                    if not (
                        isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Name)
                        and n.func.id == "open"
                    ):
                        continue
                    mode = _open_mode(n)
                    if mode is None or mode not in WRITE_MODES:
                        continue
                    out.append(Violation(
                        relpath=f.relpath, line=n.lineno,
                        rule="atomic-write",
                        message=(
                            f"bare open(..., {mode!r}) — a concurrent "
                            "reader (resume/health/replay) can see a "
                            "truncated file; use supervise."
                            "atomic_write_json / ArtifactStore or the "
                            "write-temp-fsync-os.replace idiom, or add "
                            "an audited plain_write_allowlist entry"
                        ),
                    ))
        return out
