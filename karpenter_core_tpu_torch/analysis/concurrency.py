"""Concurrency-discipline pass.

Rule `bare-except`: `except:` swallows KeyboardInterrupt/SystemExit and
masks the cancellation paths the operator's shutdown depends on — name the
exception (`except Exception:` at minimum).

Rule `thread-discipline`: every threading.Thread must be constructed with
an explicit `daemon=` AND `name=`. A non-daemon background thread wedges
process exit (the operator's watch pumps and probe threads must never
outlive main), and an unnamed one is invisible in stack dumps — py-spy on a
wedged operator showing eight `Thread-5`s is how concurrency bugs stay
unfixed.

Rule `guarded-by`: within a class that owns a threading lock, an attribute
written both inside `with self.<lock>:` blocks and outside them (in any
non-init method) has an inconsistent locking story — either the lock is
unnecessary or the unguarded write is a race. Inference is syntactic:
  - lock attributes: `self.X = threading.Lock()/RLock()` anywhere in the class
  - guarded write: an Assign/AugAssign to `self.attr` lexically inside a
    `with self.<lock>` block in the same method
  - `__init__`/`__post_init__`/`__new__` writes are construction, exempt
  - methods named `*_locked` (config.locked_suffix) are callee-guarded by
    convention: the caller holds the lock, so their writes count as guarded

Rule `guarded-by-v2`: the lockset upgrade of `guarded-by`.
Where v1 reduces "guarded" to a boolean (inside ANY `with self.<lock>:`),
v2 computes an intraprocedural lockset summary per method — which lock
attributes are held at each write, flowing through `with` nesting AND the
`self.X.acquire()` / `self.X.release()` statement pattern v1 cannot see.
Per attribute, the candidate lockset is the intersection of every
non-exempt write's held set (Eraser's discipline, statically): if some
write is guarded but the intersection is EMPTY, the writes missing the
protecting lock are flagged — catching an attribute written under
`self._lock_a` in one method and `self._lock_b` (or no lock) in another,
even when the second method never mentions the first lock. Findings v1
already reports (same line, same attribute) are not re-reported.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set, Tuple

from karpenter_core_tpu_torch.analysis.core import Pass, SourceFile, Violation

INIT_METHODS = {"__init__", "__post_init__", "__new__", "__init_subclass__"}
LOCK_FACTORIES = {"Lock", "RLock"}


def _self_attr(node: ast.expr) -> str:
    """'attr' when node is `self.attr`, else ''."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return ""


def _is_lock_ctor(value: ast.expr) -> bool:
    if not isinstance(value, ast.Call):
        return False
    func = value.func
    name = func.attr if isinstance(func, ast.Attribute) else (
        func.id if isinstance(func, ast.Name) else ""
    )
    return name in LOCK_FACTORIES


@dataclass
class _Write:
    attr: str
    line: int
    method: str
    guarded: bool


@dataclass
class _LocksetWrite:
    attr: str
    line: int
    method: str
    lockset: frozenset


class ConcurrencyPass(Pass):
    name = "concurrency"
    rules = ("bare-except", "thread-discipline", "guarded-by", "guarded-by-v2")

    def run(self, files: Sequence[SourceFile], config) -> List[Violation]:
        out: List[Violation] = []
        for f in files:
            if f.tree is None:
                continue
            # names the threading module is bound to (`import threading as t`)
            # and names Thread itself is bound to (`from threading import Thread`)
            mod_aliases: set = set()
            thread_names: set = set()
            for node in ast.walk(f.tree):
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        if alias.name == "threading":
                            mod_aliases.add(alias.asname or "threading")
                elif isinstance(node, ast.ImportFrom):
                    if node.module == "threading" and not node.level:
                        for alias in node.names:
                            if alias.name == "Thread":
                                thread_names.add(alias.asname or "Thread")
            for node in ast.walk(f.tree):
                if isinstance(node, ast.ExceptHandler) and node.type is None:
                    out.append(Violation(
                        relpath=f.relpath, line=node.lineno, rule="bare-except",
                        message=(
                            "bare `except:` catches KeyboardInterrupt/SystemExit"
                            " — catch Exception (or narrower) instead"
                        ),
                    ))
                elif isinstance(node, ast.Call) and self._is_thread_ctor(
                    node, mod_aliases, thread_names
                ):
                    kwargs = {kw.arg for kw in node.keywords if kw.arg}
                    missing = [k for k in ("daemon", "name") if k not in kwargs]
                    if missing:
                        out.append(Violation(
                            relpath=f.relpath, line=node.lineno,
                            rule="thread-discipline",
                            message=(
                                "threading.Thread without explicit "
                                + " and ".join(f"{k}=" for k in missing)
                                + " — background threads must be daemonized "
                                "and named for stack-dump triage"
                            ),
                        ))
                elif isinstance(node, ast.ClassDef):
                    out.extend(self._check_guarded_by(f, node, config))
        return out

    @staticmethod
    def _is_thread_ctor(node: ast.Call, mod_aliases: set, thread_names: set) -> bool:
        func = node.func
        if isinstance(func, ast.Attribute):
            return (
                func.attr == "Thread"
                and isinstance(func.value, ast.Name)
                and func.value.id in mod_aliases
            )
        return isinstance(func, ast.Name) and func.id in thread_names

    def _check_guarded_by(
        self, f: SourceFile, cls: ast.ClassDef, config
    ) -> List[Violation]:
        lock_attrs: Set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                for target in node.targets:
                    attr = _self_attr(target)
                    if attr:
                        lock_attrs.add(attr)
        if not lock_attrs:
            return []

        writes: List[_Write] = []
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            callee_guarded = method.name in INIT_METHODS or method.name.endswith(
                config.locked_suffix
            )
            self._collect_writes(
                method, method.name, lock_attrs, in_lock=callee_guarded,
                init=method.name in INIT_METHODS, writes=writes,
            )

        by_attr: Dict[str, List[_Write]] = {}
        for w in writes:
            by_attr.setdefault(w.attr, []).append(w)

        out: List[Violation] = []
        v1_flagged: Set[Tuple[int, str]] = set()
        for attr, ws in sorted(by_attr.items()):
            if attr in lock_attrs:
                continue
            guarded = [w for w in ws if w.guarded]
            unguarded = [w for w in ws if not w.guarded]
            if guarded and unguarded:
                guard_lines = ", ".join(
                    f"{w.method}:{w.line}" for w in guarded[:3]
                )
                for w in unguarded:
                    v1_flagged.add((w.line, attr))
                    out.append(Violation(
                        relpath=f.relpath, line=w.line, rule="guarded-by",
                        message=(
                            f"{cls.name}.{attr} written without the lock in "
                            f"{w.method}() but under it at {guard_lines} — "
                            "hold the lock at every write or rename the "
                            f"method with the '{config.locked_suffix}' suffix "
                            "if the caller holds it"
                        ),
                    ))
        out.extend(
            self._check_guarded_by_v2(f, cls, config, lock_attrs, v1_flagged)
        )
        return out

    # -- guarded-by-v2: intraprocedural lockset summaries --------------------

    def _check_guarded_by_v2(
        self, f: SourceFile, cls: ast.ClassDef, config,
        lock_attrs: Set[str], v1_flagged: Set[Tuple[int, str]],
    ) -> List[Violation]:
        writes: List[_LocksetWrite] = []
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if method.name in INIT_METHODS or method.name.endswith(
                config.locked_suffix
            ):
                continue  # construction / callee-guarded: exempt, and they
                # must not poison the intersection either
            self._lockset_flow(
                method.body, frozenset(), method.name, lock_attrs, writes
            )

        by_attr: Dict[str, List[_LocksetWrite]] = {}
        for w in writes:
            by_attr.setdefault(w.attr, []).append(w)

        out: List[Violation] = []
        for attr, ws in sorted(by_attr.items()):
            if attr in lock_attrs:
                continue
            if not any(w.lockset for w in ws):
                continue  # never written under a lock: v2 has no evidence
            common = frozenset.intersection(*[w.lockset for w in ws])
            if common:
                continue  # a consistent protecting lock exists
            # the protecting candidate: the lock most writes hold
            counts: Dict[str, int] = {}
            for w in ws:
                for lock in w.lockset:
                    counts[lock] = counts.get(lock, 0) + 1
            protect = max(sorted(counts), key=lambda k: counts[k])
            held_lines = ", ".join(
                f"{w.method}:{w.line}" for w in ws if protect in w.lockset
            )
            for w in ws:
                if protect in w.lockset:
                    continue
                if (w.line, attr) in v1_flagged:
                    continue  # v1 already reports this exact write
                under = ", ".join(sorted(w.lockset)) or "no lock"
                out.append(Violation(
                    relpath=f.relpath, line=w.line, rule="guarded-by-v2",
                    message=(
                        f"{cls.name}.{attr} written under [{under}] in "
                        f"{w.method}() but under {protect} at {held_lines} "
                        "— the write locksets share no common lock; hold "
                        f"{protect} at every write (or rename the method "
                        f"with the '{config.locked_suffix}' suffix if the "
                        "caller holds it)"
                    ),
                ))
        return out

    def _lockset_flow(
        self,
        body: List[ast.stmt],
        held: frozenset,
        method: str,
        lock_attrs: Set[str],
        writes: List[_LocksetWrite],
    ) -> frozenset:
        """Statement-ordered lockset flow through one body: `with self.X:`
        scopes X over its block; `self.X.acquire(...)` holds X from that
        statement on (conditional acquires count — the common pattern is
        `if not self.X.acquire(False): return`); `self.X.release()` drops
        it. Compound statements recurse per sub-body, so a `with` nested
        in an `if`/`try` still scopes correctly; acquires/releases found
        anywhere in a compound statement propagate to its siblings."""
        current = held
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested defs are their own analysis context
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                block = set(current)
                for item in stmt.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call):
                        expr = expr.func
                    attr = _self_attr(expr)
                    if not attr and isinstance(expr, ast.Attribute):
                        attr = _self_attr(expr.value)
                    if attr in lock_attrs:
                        block.add(attr)
                self._lockset_flow(
                    stmt.body, frozenset(block), method, lock_attrs, writes
                )
                # acquire()/release() inside the block outlive it
                current = self._apply_lock_calls(stmt, current, lock_attrs)
                continue
            sub_bodies = self._sub_bodies(stmt)
            if sub_bodies:
                # header acquires (`if not self.X.acquire(): return`) are
                # held inside the bodies; each body starts from there
                entry = self._apply_lock_calls(
                    stmt, current, lock_attrs, headers_only=True
                )
                for sub in sub_bodies:
                    self._lockset_flow(sub, entry, method, lock_attrs, writes)
                current = self._apply_lock_calls(stmt, current, lock_attrs)
                continue
            # simple statement: record writes at the CURRENT lockset
            for node in ast.walk(stmt):
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (
                        node.targets if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    for target in targets:
                        attr = _self_attr(target)
                        if attr:
                            writes.append(_LocksetWrite(
                                attr=attr, line=node.lineno, method=method,
                                lockset=current,
                            ))
            current = self._apply_lock_calls(stmt, current, lock_attrs)
        return current

    @staticmethod
    def _sub_bodies(stmt: ast.stmt) -> List[List[ast.stmt]]:
        if isinstance(stmt, ast.If):
            return [stmt.body, stmt.orelse]
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            return [stmt.body, stmt.orelse]
        if isinstance(stmt, ast.Try):
            return (
                [stmt.body]
                + [h.body for h in stmt.handlers]
                + [stmt.orelse, stmt.finalbody]
            )
        return []

    @staticmethod
    def _apply_lock_calls(
        stmt: ast.stmt, current: frozenset, lock_attrs: Set[str],
        headers_only: bool = False,
    ) -> frozenset:
        """`current` after the acquire()/release() calls in `stmt` (or in
        its header expressions only: the If test / For iter / While test),
        nested defs excluded."""
        roots: List[ast.AST]
        if headers_only:
            roots = [
                n for n in (
                    getattr(stmt, "test", None), getattr(stmt, "iter", None)
                ) if n is not None
            ]
        else:
            roots = [stmt]
        acquired, released = set(), set()
        stack: List[ast.AST] = list(roots)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("acquire", "release")
            ):
                attr = _self_attr(node.func.value)
                if attr in lock_attrs:
                    (acquired if node.func.attr == "acquire"
                     else released).add(attr)
            stack.extend(ast.iter_child_nodes(node))
        if not (acquired or released):
            return current
        return frozenset((set(current) | acquired) - released)

    def _collect_writes(
        self,
        node: ast.AST,
        method: str,
        lock_attrs: Set[str],
        in_lock: bool,
        init: bool,
        writes: List[_Write],
    ) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue  # nested defs get their own analysis context: skip
            child_in_lock = in_lock
            if isinstance(child, ast.With):
                for item in child.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call):
                        expr = expr.func
                    attr = _self_attr(expr)
                    if not attr and isinstance(expr, ast.Attribute):
                        # with self._lock.acquire_timeout(...): the lock is
                        # the attribute's VALUE, one level down
                        attr = _self_attr(expr.value)
                    if attr in lock_attrs:
                        child_in_lock = True
            if isinstance(child, (ast.Assign, ast.AugAssign)):
                targets = (
                    child.targets if isinstance(child, ast.Assign) else [child.target]
                )
                for target in targets:
                    attr = _self_attr(target)
                    if attr and not init:
                        writes.append(_Write(
                            attr=attr, line=child.lineno, method=method,
                            guarded=in_lock,
                        ))
            self._collect_writes(
                child, method, lock_attrs, child_in_lock, init, writes
            )
        return None
