"""Process-discipline pass.

The repo's supervision story (utils/supervise, solver/host) is built on
one invariant: every child process lives in its OWN process group, so a
wedge kill (`os.killpg` SIGKILL) takes the grandchildren with it. Three
rules keep that invariant from eroding as new spawn sites appear:

Rule `proc-group`: every `subprocess.Popen(...)` must pass an explicit
``start_new_session=`` — or live in one of the audited supervisor funnels
(config.popen_funnels). A Popen that shares the parent's process group
cannot be group-killed without killing the parent, and its own children
survive a plain kill(): the zombie class a supervisor must never leave.

Rule `proc-kill-group`: `os.kill(...)` on a child pid where `os.killpg`
is the repo convention. A lone os.kill reaps the child but leaks any
grandchild holding a pipe — the supervisor's `_kill_group` exists so
nothing outlives the kill. Audited exceptions (e.g. a signal-0 liveness
probe) go in config.os_kill_allowlist as `relpath::function`.

Rule `thread-join`: a `threading.Thread(...)` constructed with
``daemon=False`` (a child-waiter the process will wait on at exit) must
have a reachable ``.join(`` somewhere in the same file, or be flagged:
an unjoined non-daemon thread wedges interpreter shutdown — the exact
hang class the operator's watch pumps are daemonized to avoid. (The
`thread-discipline` rule already forces the daemon= decision to be
explicit; this rule polices the False branch.)
"""
from __future__ import annotations

import ast
from typing import List, Sequence

from karpenter_core_tpu_torch.analysis.core import Pass, SourceFile, Violation


def _call_name(func: ast.expr) -> str:
    """Dotted tail of a call target: `subprocess.Popen` -> 'subprocess.Popen',
    `Popen` -> 'Popen'."""
    parts: List[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


class ProcessDisciplinePass(Pass):
    name = "procdiscipline"
    rules = ("proc-group", "proc-kill-group", "thread-join")

    def run(self, files: Sequence[SourceFile], config) -> List[Violation]:
        out: List[Violation] = []
        funnels = getattr(config, "popen_funnels", frozenset())
        kill_allowlist = getattr(config, "os_kill_allowlist", frozenset())
        for f in files:
            if f.tree is None:
                continue
            popen_names = self._popen_aliases(f.tree)
            thread_names = self._thread_aliases(f.tree)
            join_targets = self._joined_names(f.tree)
            for node in ast.walk(f.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = _call_name(node.func)
                if name in popen_names and f.relpath not in funnels:
                    kwargs = {kw.arg for kw in node.keywords if kw.arg}
                    if "start_new_session" not in kwargs:
                        out.append(Violation(
                            relpath=f.relpath, line=node.lineno,
                            rule="proc-group",
                            message=(
                                "subprocess.Popen without explicit "
                                "start_new_session= — a child sharing the "
                                "parent's process group cannot be wedge-"
                                "killed (os.killpg) without killing the "
                                "parent; set start_new_session= or spawn "
                                "through utils/supervise or solver/host"
                            ),
                        ))
                elif name == "os.kill":
                    func_name = self._enclosing_function(f.tree, node)
                    if f"{f.relpath}::{func_name}" not in kill_allowlist:
                        out.append(Violation(
                            relpath=f.relpath, line=node.lineno,
                            rule="proc-kill-group",
                            message=(
                                "os.kill on a child pid — the repo "
                                "convention is os.killpg (grandchildren "
                                "holding pipes survive a lone kill); use "
                                "supervise._kill_group / killpg, or add "
                                "an audited os_kill_allowlist entry"
                            ),
                        ))
                elif name in thread_names or (
                    name == "threading.Thread"
                ):
                    for kw in node.keywords:
                        if (
                            kw.arg == "daemon"
                            and isinstance(kw.value, ast.Constant)
                            and kw.value.value is False
                        ):
                            target = self._assigned_name(f.tree, node)
                            if target is None or target not in join_targets:
                                out.append(Violation(
                                    relpath=f.relpath, line=node.lineno,
                                    rule="thread-join",
                                    message=(
                                        "non-daemon Thread with no "
                                        "reachable .join() in this file — "
                                        "an unjoined child-waiter thread "
                                        "wedges interpreter shutdown; join "
                                        "it (with a timeout) or daemonize "
                                        "and supervise it"
                                    ),
                                ))
        return out

    @staticmethod
    def _popen_aliases(tree: ast.AST) -> set:
        """Spellings Popen is reachable under in this module."""
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "subprocess":
                        names.add(f"{alias.asname or 'subprocess'}.Popen")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "subprocess" and not node.level:
                    for alias in node.names:
                        if alias.name == "Popen":
                            names.add(alias.asname or "Popen")
        return names

    @staticmethod
    def _thread_aliases(tree: ast.AST) -> set:
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "threading":
                        names.add(f"{alias.asname or 'threading'}.Thread")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "threading" and not node.level:
                    for alias in node.names:
                        if alias.name == "Thread":
                            names.add(alias.asname or "Thread")
        return names

    @staticmethod
    def _joined_names(tree: ast.AST) -> set:
        """Names (and self-attrs) that have a .join(...) call in the file."""
        joined = set()
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"
            ):
                base = node.func.value
                if isinstance(base, ast.Name):
                    joined.add(base.id)
                elif isinstance(base, ast.Attribute):
                    joined.add(base.attr)
        return joined

    @staticmethod
    def _assigned_name(tree: ast.AST, call: ast.Call):
        """The simple name or self-attr the Thread(...) result is bound to
        (None when constructed anonymously)."""
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and node.value is call:
                target = node.targets[0]
                if isinstance(target, ast.Name):
                    return target.id
                if isinstance(target, ast.Attribute):
                    return target.attr
        return None

    @staticmethod
    def _enclosing_function(tree: ast.AST, target: ast.AST) -> str:
        """Name of the innermost def containing `target` ('' at module
        scope) — matches the `relpath::function` allowlist convention."""
        best = ""
        best_span = None
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                end = getattr(node, "end_lineno", None)
                if (
                    end is not None
                    and node.lineno <= target.lineno <= end
                ):
                    span = end - node.lineno
                    if best_span is None or span < best_span:
                        best, best_span = node.name, span
        return best
