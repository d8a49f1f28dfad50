"""Env-flag discipline pass (rule `env-flags`): every environment read in
the package funnels through obs/envflags.py.

The operator, solver service, chaos registry, compile cache, and the three
obs subsystems are all env-configured; when each module calls os.environ
directly the spellings drift (\"1\" vs \"true\" vs \"on\"), defaults fork, and
there is no single place to enumerate the knobs. obs/envflags.py owns the
truthy/falsy grammar and the accessors; everything else imports it.

Flags any use of `os.environ` / `os.getenv` (including aliased module
imports and `from os import environ`) outside the funnel module.
"""
from __future__ import annotations

import ast
from typing import List, Sequence, Set

from karpenter_core_tpu_torch.analysis.core import Pass, SourceFile, Violation


class EnvDisciplinePass(Pass):
    name = "envdiscipline"
    rules = ("env-flags",)

    def run(self, files: Sequence[SourceFile], config) -> List[Violation]:
        out: List[Violation] = []
        for f in files:
            if f.tree is None or f.relpath == config.env_funnel:
                continue
            os_aliases: Set[str] = set()
            direct: Set[str] = set()  # names bound to os.environ / os.getenv
            for node in ast.walk(f.tree):
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        if alias.name == "os":
                            os_aliases.add(alias.asname or "os")
                elif isinstance(node, ast.ImportFrom):
                    if node.module == "os" and not node.level:
                        for alias in node.names:
                            if alias.name in ("environ", "getenv", "putenv"):
                                direct.add(alias.asname or alias.name)
            if not os_aliases and not direct:
                continue
            for node in ast.walk(f.tree):
                if isinstance(node, ast.Attribute):
                    if (
                        isinstance(node.value, ast.Name)
                        and node.value.id in os_aliases
                        and node.attr in ("environ", "getenv", "putenv")
                    ):
                        out.append(self._violation(f, node))
                elif isinstance(node, ast.Name) and node.id in direct:
                    if isinstance(node.ctx, ast.Load):
                        out.append(self._violation(f, node))
        return out

    @staticmethod
    def _violation(f: SourceFile, node: ast.AST) -> Violation:
        return Violation(
            relpath=f.relpath,
            line=node.lineno,
            rule="env-flags",
            message=(
                "direct os.environ access — route through "
                "karpenter_core_tpu_torch.obs.envflags (raw/require/get_bool/environ)"
            ),
        )
