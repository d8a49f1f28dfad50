"""Layering pass: subpackage dependency DAG + module-scope import cycles.

Rule `layering`: a module in subpackage A importing subpackage B at module
scope when B is not in A's allowed set (config.DEFAULT_LAYERING). The
canonical violation this exists to prevent: solver/ importing controllers/
— the solver is a backend the controllers call, never the reverse.

Rule `import-cycle`: strongly-connected components (size > 1) in the
module-scope import graph. Python tolerates some cycles depending on import
order; none of them are intentional here, and the ones that "work" break
the moment an entrypoint imports the other module first.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Sequence, Set, Tuple

from karpenter_core_tpu_torch.analysis.core import (
    Pass,
    SourceFile,
    Violation,
    module_scope_imports,
    resolve_import_targets,
)


class LayeringPass(Pass):
    name = "layering"
    rules = ("layering", "import-cycle")
    scope = "fileset"  # needs the global import graph: never per-file

    def run(self, files: Sequence[SourceFile], config) -> List[Violation]:
        out: List[Violation] = []
        known = {f.module for f in files if f.module}
        by_module = {f.module: f for f in files if f.module}
        # module -> [(target_module, line)]
        graph: Dict[str, List[Tuple[str, int]]] = {}
        for f in files:
            if f.tree is None or f.module is None:
                continue
            edges: List[Tuple[str, int]] = []
            for node in module_scope_imports(f.tree):
                for target in resolve_import_targets(
                    node, f.module, known, config.package_name,
                    is_package=f.relpath.endswith("__init__.py"),
                ):
                    if target != f.module:
                        edges.append((target, node.lineno))
            graph[f.module] = edges

        # -- DAG check ----------------------------------------------------
        for module, edges in sorted(graph.items()):
            src_sub = config.subpackage_of(module)
            allowed = config.layering.get(src_sub)
            for target, line in edges:
                dst_sub = config.subpackage_of(target)
                if not dst_sub or dst_sub == src_sub:
                    continue
                if not src_sub:
                    continue  # root-level modules are unconstrained
                if allowed is None:
                    if config.layering_strict:
                        out.append(Violation(
                            relpath=by_module[module].relpath,
                            line=line,
                            rule="layering",
                            message=(
                                f"subpackage '{src_sub}' has no declared layer"
                                " — add it to the dependency DAG"
                                " (analysis/config.py DEFAULT_LAYERING)"
                            ),
                        ))
                    continue
                if dst_sub not in allowed:
                    out.append(Violation(
                        relpath=by_module[module].relpath,
                        line=line,
                        rule="layering",
                        message=(
                            f"module-scope import of '{target}':"
                            f" '{src_sub}' may not depend on '{dst_sub}'"
                            f" (allowed: {', '.join(sorted(allowed)) or 'none'})"
                        ),
                    ))

        # -- cycle check --------------------------------------------------
        for scc in _tarjan({m: [t for t, _ in e] for m, e in graph.items()}):
            if len(scc) < 2:
                continue
            cycle = sorted(scc)
            for module in cycle:
                line = next(
                    (ln for t, ln in graph[module] if t in scc), 1
                )
                out.append(Violation(
                    relpath=by_module[module].relpath,
                    line=line,
                    rule="import-cycle",
                    message=(
                        "module-scope import cycle: "
                        + " <-> ".join(cycle)
                    ),
                ))
        return out


def _tarjan(graph: Dict[str, List[str]]) -> List[Set[str]]:
    """Iterative Tarjan SCC (the module graph is deep enough that the
    recursive form can hit the default recursion limit)."""
    index: Dict[str, int] = {}
    lowlink: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[Set[str]] = []
    counter = [0]

    for root in graph:
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            node, ei = work[-1]
            if ei == 0:
                index[node] = lowlink[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            advanced = False
            targets = [t for t in graph.get(node, []) if t in graph]
            while ei < len(targets):
                target = targets[ei]
                ei += 1
                if target not in index:
                    work[-1] = (node, ei)
                    work.append((target, 0))
                    advanced = True
                    break
                if target in on_stack:
                    lowlink[node] = min(lowlink[node], index[target])
            if advanced:
                continue
            work.pop()
            if lowlink[node] == index[node]:
                scc: Set[str] = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.add(w)
                    if w == node:
                        break
                sccs.append(scc)
            if work:
                parent, _ = work[-1]
                lowlink[parent] = min(lowlink[parent], lowlink[node])
    return sccs
