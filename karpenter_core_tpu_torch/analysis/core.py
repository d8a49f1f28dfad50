"""Framework core: source loading, suppression parsing, pass protocol,
baseline handling, and the runner.

A pass sees the WHOLE file set at once (layering needs the global import
graph); single-file passes just loop. Violations carry (relpath, line,
rule, message); suppressions and the baseline subtract by key. Everything
here is stdlib-only so the analyzer can run in a bare interpreter and never
participates in the package's own layering constraints.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable=([A-Za-z0-9_,\- ]+)")


@dataclass(frozen=True)
class Violation:
    relpath: str  # repo-relative, '/'-separated
    line: int
    rule: str
    message: str

    def key(self) -> str:
        return f"{self.relpath}:{self.line}:{self.rule}"

    def render(self) -> str:
        return f"{self.relpath}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class SourceFile:
    """One parsed module plus its per-line suppressions."""

    path: str  # absolute
    relpath: str  # relative to the scan root, '/'-separated
    module: Optional[str]  # dotted module name when under the package root
    text: str = ""
    tree: Optional[ast.AST] = None
    parse_error: Optional[SyntaxError] = None
    # line -> set of suppressed rule names for that line
    suppressions: Dict[int, Set[str]] = field(default_factory=dict)

    def suppressed(self, line: int, rule: str) -> bool:
        rules = self.suppressions.get(line)
        return rules is not None and (rule in rules or "*" in rules)


def parse_suppressions(text: str) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        if "lint:" not in line:
            continue
        m = SUPPRESS_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def load_tree(path: str, relpath: str, module: Optional[str] = None) -> SourceFile:
    with open(path, encoding="utf-8") as f:
        text = f.read()
    sf = SourceFile(path=path, relpath=relpath, module=module, text=text)
    sf.suppressions = parse_suppressions(text)
    try:
        sf.tree = ast.parse(text, filename=path)
    except SyntaxError as exc:
        sf.parse_error = exc
    return sf


def collect_sources(
    root: str, package_name: str, subdir: Optional[str] = None
) -> List[SourceFile]:
    """Walk `<root>/<package_name>` (or a subdir of it) into SourceFiles.

    `relpath` is relative to `root`; `module` is the dotted import name, so
    `<root>/<pkg>/solver/encode.py` -> `<pkg>.solver.encode`.
    """
    base = os.path.join(root, package_name)
    scan = os.path.join(base, subdir) if subdir else base
    files: List[SourceFile] = []
    for dirpath, dirnames, filenames in os.walk(scan):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for filename in sorted(filenames):
            if not filename.endswith(".py"):
                continue
            path = os.path.join(dirpath, filename)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            module = rel[: -len(".py")].replace("/", ".")
            if module.endswith(".__init__"):
                module = module[: -len(".__init__")]
            files.append(load_tree(path, rel, module))
    return files


class Pass:
    """One analysis pass. Subclasses set `name` (the pass id) and `rules`
    (every rule id the pass can emit — used by --rule filtering and the
    docs catalog) and implement run().

    `scope` declares what run() needs to see: "file" (the default) means
    findings for a file depend only on that file, so the runner may invoke
    run() once per file — in parallel; "fileset" (layering: the global
    import graph) always gets the whole set in one call."""

    name: str = ""
    rules: Tuple[str, ...] = ()
    scope: str = "file"

    def run(self, files: Sequence[SourceFile], config) -> List[Violation]:
        raise NotImplementedError

    # -- helpers shared by AST passes -------------------------------------

    @staticmethod
    def syntax_violations(files: Sequence[SourceFile], rule: str) -> List[Violation]:
        return [
            Violation(
                relpath=f.relpath,
                line=f.parse_error.lineno or 0,
                rule=rule,
                message=f"file does not parse: {f.parse_error.msg}",
            )
            for f in files
            if f.parse_error is not None
        ]


def module_scope_imports(tree: ast.AST) -> List[ast.stmt]:
    """Import statements executed at module import time: top level, plus
    inside top-level if/try bodies (version shims) — but NOT inside
    `if TYPE_CHECKING:` blocks, which never run."""
    out: List[ast.stmt] = []

    def is_type_checking(test: ast.expr) -> bool:
        return (isinstance(test, ast.Name) and test.id == "TYPE_CHECKING") or (
            isinstance(test, ast.Attribute) and test.attr == "TYPE_CHECKING"
        )

    def scan(body: Iterable[ast.stmt]) -> None:
        for node in body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                out.append(node)
            elif isinstance(node, ast.If):
                if not is_type_checking(node.test):
                    scan(node.body)
                scan(node.orelse)
            elif isinstance(node, ast.Try):
                scan(node.body)
                for handler in node.handlers:
                    scan(handler.body)
                scan(node.orelse)
                scan(node.finalbody)
            elif isinstance(node, ast.With):
                scan(node.body)

    scan(getattr(tree, "body", []))
    return out


def resolve_import_targets(
    node: ast.stmt,
    current_module: str,
    known_modules: Set[str],
    package_name: str,
    is_package: bool = False,
) -> List[str]:
    """Dotted module names a single import statement binds, restricted to
    modules inside the package (`known_modules`). Handles absolute imports,
    `from pkg import submodule`, and explicit relative imports
    (`is_package`: current_module is an __init__, so `from .` is the module
    itself, not its parent)."""
    targets: List[str] = []
    if isinstance(node, ast.Import):
        for alias in node.names:
            name = alias.name
            if name == package_name or name.startswith(package_name + "."):
                targets.append(name)
    elif isinstance(node, ast.ImportFrom):
        if node.level:
            parts = current_module.split(".")
            # `from . import x` inside pkg/a/b.py: level 1 strips b; inside
            # pkg/a/__init__.py (module 'pkg.a') level 1 is pkg.a itself
            strip = node.level - 1 if is_package else node.level
            base_parts = parts[: len(parts) - strip] if strip else parts
            base = ".".join(base_parts)
            if node.module:
                base = f"{base}.{node.module}" if base else node.module
        else:
            base = node.module or ""
        if base == package_name or base.startswith(package_name + "."):
            for alias in node.names:
                candidate = f"{base}.{alias.name}"
                # `from pkg.x import y`: y may be a module or an object
                targets.append(candidate if candidate in known_modules else base)
    # de-dup while keeping order, and resolve to known modules only
    seen: Set[str] = set()
    resolved: List[str] = []
    for t in targets:
        mod = t if t in known_modules else _longest_known_prefix(t, known_modules)
        if mod and mod not in seen:
            seen.add(mod)
            resolved.append(mod)
    return resolved


def _longest_known_prefix(dotted: str, known: Set[str]) -> Optional[str]:
    parts = dotted.split(".")
    for end in range(len(parts), 0, -1):
        prefix = ".".join(parts[:end])
        if prefix in known:
            return prefix
    return None


def load_baseline(path: str) -> Set[str]:
    """Baseline entries: `relpath:line:rule` lines; '#' comments and blanks
    ignored. The checked-in baseline ships empty — this exists so a future
    emergency can land with a debt marker instead of a suppression spray."""
    if not os.path.exists(path):
        return set()
    entries: Set[str] = set()
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                entries.add(line)
    return entries


@dataclass
class RunResult:
    violations: List[Violation]
    suppressed: List[Violation]
    baselined: List[Violation]
    # warn-only: `# lint: disable=<rule>` comments whose line no longer
    # triggers the named rule — dead suppressions accumulate as silent
    # blind spots, so the runner reports them (they never affect the
    # exit code; deleting the comment clears the warning)
    unused_suppressions: List[Violation] = field(default_factory=list)


def run_passes(
    files: Sequence[SourceFile],
    config,
    passes: Optional[Sequence[Pass]] = None,
    rules: Optional[Set[str]] = None,
    baseline: Optional[Set[str]] = None,
    workers: int = 1,
) -> RunResult:
    """Run the passes; `workers` > 1 fans file-scope passes out over a
    thread pool, one (pass, file) task each — findings are identical to
    the sequential run because the result is canonically sorted below
    (tests/test_analysis_framework.py asserts the equality)."""
    if passes is None:
        from karpenter_core_tpu_torch.analysis import all_passes

        passes = all_passes()
    baseline = baseline or set()
    selected = [
        p for p in passes if not rules or (rules & set(p.rules))
    ]
    raw: List[Violation] = []
    if workers > 1 and len(files) > 1:
        from concurrent.futures import ThreadPoolExecutor

        per_file = [p for p in selected if p.scope == "file"]
        whole_set = [p for p in selected if p.scope != "file"]
        with ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="lint"
        ) as pool:
            futures = [
                pool.submit(p.run, [f], config)
                for p in per_file for f in files
            ]
            for p in whole_set:
                raw.extend(p.run(files, config))
            for fut in futures:
                raw.extend(fut.result())
    else:
        for p in selected:
            raw.extend(p.run(files, config))
    return filter_findings(raw, files, rules=rules, baseline=baseline)


def _mp_run_file(payload):
    """Process-pool worker: re-load ONE source file in the child and run
    every registry file-scope pass over it. Module-level (picklable);
    takes/returns plain tuples so the only things crossing the pipe are
    primitives and the (dataclass, frozenset-valued) AnalysisConfig.
    Re-loading from disk in the child costs one read+parse but keeps
    SourceFile/ast trees out of pickle entirely."""
    path, relpath, module, config, rules = payload
    from karpenter_core_tpu_torch.analysis import all_passes

    sf = load_tree(path, relpath, module)
    out = []
    for p in all_passes():
        if p.scope != "file":
            continue
        if rules is not None and not (set(p.rules) & rules):
            continue
        for v in p.run([sf], config):
            out.append((v.relpath, v.line, v.rule, v.message))
    return out


def run_passes_multiprocessing(
    files: Sequence[SourceFile],
    config,
    rules: Optional[Set[str]] = None,
    baseline: Optional[Set[str]] = None,
    jobs: int = 2,
) -> RunResult:
    """run_passes with the file-scope passes fanned out over a PROCESS
    pool (the command line's `--jobs`): one (file) task per child call, registry
    passes only (children re-instantiate all_passes() — a custom `passes`
    list can't ship by reference, use run_passes for those). Fileset
    passes run in the parent. Findings are byte-identical to the
    sequential run: the shared filter_findings tail canonically sorts and
    splits (tests/test_analysis_framework.py asserts the equality).
    Workers spawn (not fork): the parent may have jax's thread pools live
    (pytest, --ir in the same process), and forking a multithreaded
    process can deadlock; the worker import surface is stdlib-only so a
    fresh interpreter costs ~30ms."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from karpenter_core_tpu_torch.analysis import all_passes

    raw: List[Violation] = []
    payloads = [
        (f.path, f.relpath, f.module, config, rules) for f in files
    ]
    with ProcessPoolExecutor(
        max_workers=max(1, jobs),
        mp_context=multiprocessing.get_context("spawn"),
    ) as pool:
        for chunk in pool.map(_mp_run_file, payloads, chunksize=8):
            raw.extend(Violation(*t) for t in chunk)
    for p in all_passes():
        if p.scope == "file":
            continue
        if rules is not None and not (set(p.rules) & rules):
            continue
        raw.extend(p.run(files, config))
    return filter_findings(raw, files, rules=rules, baseline=baseline)


def filter_findings(
    raw: Sequence[Violation],
    files: Sequence[SourceFile],
    rules: Optional[Set[str]] = None,
    baseline: Optional[Set[str]] = None,
) -> RunResult:
    """Canonical-sort raw findings and subtract suppressions and the
    baseline — the one spelling of the kept/suppressed/baselined split,
    shared by the sequential, thread-pool, and multiprocessing runners
    (identical findings across all three is what the parallel tests
    assert). Also flags *unused* suppressions: a `# lint: disable=<rule>`
    whose line produced no finding for that rule. Skipped under a --rule
    filter (only some passes ran, so absence proves nothing) — same
    reason a partial run must not --update-baseline."""
    baseline = baseline or set()
    if rules:
        raw = [v for v in raw if v.rule in rules]
    by_rel: Dict[str, SourceFile] = {f.relpath: f for f in files}
    kept: List[Violation] = []
    suppressed: List[Violation] = []
    baselined: List[Violation] = []
    hit: Set[Tuple[str, int, str]] = set()
    for v in sorted(raw, key=lambda v: (v.relpath, v.line, v.rule, v.message)):
        sf = by_rel.get(v.relpath)
        if sf is not None and sf.suppressed(v.line, v.rule):
            suppressed.append(v)
            hit.add((v.relpath, v.line, v.rule))
            hit.add((v.relpath, v.line, "*"))
        elif v.key() in baseline:
            baselined.append(v)
        else:
            kept.append(v)
    unused: List[Violation] = []
    if not rules:
        for f in files:
            for line, names in sorted(f.suppressions.items()):
                for rule in sorted(names):
                    if (f.relpath, line, rule) not in hit:
                        unused.append(Violation(
                            relpath=f.relpath, line=line,
                            rule="unused-suppression",
                            message=(
                                f"suppression 'lint: disable={rule}' no "
                                "longer matches a finding on this line — "
                                "delete the comment"
                            ),
                        ))
    return RunResult(
        violations=kept, suppressed=suppressed, baselined=baselined,
        unused_suppressions=unused,
    )
