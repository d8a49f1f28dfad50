"""No-print pass (rule `no-print`): bare print() in production code.

The package logs through the structured logger (obs/log) — prints bypass
the level gate, the /debug/logs ring, and trace-id correlation. AST-based,
not grep: a `print(` inside a string literal (the subprocess probe source
in solver/fallback.py) is not a violation, and a real call can't hide
behind formatting. Unparseable files are flagged too so a syntax error
can't smuggle one through.
"""
from __future__ import annotations

import ast
from typing import List, Sequence

from karpenter_core_tpu_torch.analysis.core import Pass, SourceFile, Violation


class NoPrintPass(Pass):
    name = "noprint"
    rules = ("no-print",)

    def run(self, files: Sequence[SourceFile], config) -> List[Violation]:
        out: List[Violation] = self.syntax_violations(files, "no-print")
        for f in files:
            if f.tree is None:
                continue
            for node in ast.walk(f.tree):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"
                ):
                    out.append(Violation(
                        relpath=f.relpath,
                        line=node.lineno,
                        rule="no-print",
                        message=(
                            "bare print() — log through "
                            "karpenter_core_tpu_torch.obs.log instead"
                        ),
                    ))
        return out
