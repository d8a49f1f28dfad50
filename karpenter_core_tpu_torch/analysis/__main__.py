"""Static analysis of karpenter_core_tpu_torch/ from the command line: every pass.

Usage:
  python -m karpenter_core_tpu_torch.analysis                 # all passes, fatal on any violation
  python -m karpenter_core_tpu_torch.analysis --list-rules    # rule catalog
  python -m karpenter_core_tpu_torch.analysis --rule no-print --rule layering
  python -m karpenter_core_tpu_torch.analysis --jobs 4        # file-scope passes on a process pool
  python -m karpenter_core_tpu_torch.analysis --changed       # report only files differing from main
  python -m karpenter_core_tpu_torch.analysis --format sarif  # SARIF 2.1.0 for CI annotation
  python -m karpenter_core_tpu_torch.analysis --update-baseline PATH
                                     # write the current violations to PATH as
                                     # `relpath:line:rule` debt markers

The package ships no baseline: zero violations is the bar, and `--baseline
PATH` reads one only where it is named. Per-line suppression in source:
`# lint: disable=<rule>[,<rule>...]` (the package itself carries none).
Unused suppressions print as warnings (never fatal). Exit codes: 0 clean,
1 violations, 2 usage error.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from karpenter_core_tpu_torch.analysis import (
    all_passes,
    default_config,
    load_baseline,
    run_passes,
)
from karpenter_core_tpu_torch.analysis.core import (
    collect_sources,
    run_passes_multiprocessing,
)

REPO_ROOT = default_config().repo_root


def changed_relpaths(base: str = "main") -> set:
    """Repo-relative paths of files differing from `base` (committed,
    staged, or unstaged) plus untracked files — what a change's reviewable
    surface is. Raises RuntimeError outside a git checkout."""
    out = set()
    for args in (
        ["git", "diff", "--name-only", base, "--"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        proc = subprocess.run(
            args, cwd=REPO_ROOT, capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(args)} failed: {proc.stderr.strip()}"
            )
        out.update(line.strip() for line in proc.stdout.splitlines() if line.strip())
    return out


def sarif_payload(passes, result) -> dict:
    """SARIF 2.1.0 over the kept violations: one rule entry per rule id,
    one result per violation (region startLine), so CI can annotate."""
    rule_ids = sorted({r for p in passes for r in p.rules})
    doc = "karpenter_core_tpu_torch/analysis/__init__.py"
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "karpenter-lint",
                        "informationUri": doc,
                        "rules": [
                            {
                                "id": rule,
                                "shortDescription": {"text": rule},
                                "helpUri": doc,
                            }
                            for rule in rule_ids
                        ],
                    }
                },
                "results": [
                    {
                        "ruleId": v.rule,
                        "level": "error",
                        "message": {"text": v.message},
                        "locations": [
                            {
                                "physicalLocation": {
                                    "artifactLocation": {"uri": v.relpath},
                                    "region": {"startLine": max(v.line, 1)},
                                }
                            }
                        ],
                    }
                    for v in result.violations
                ],
            }
        ],
    }


def _filter_changed(result, changed: set) -> None:
    for attr in ("violations", "suppressed", "baselined", "unused_suppressions"):
        setattr(result, attr, [v for v in getattr(result, attr) if v.relpath in changed])


def _write_baseline(path: str, violations) -> None:
    """The debt markers, written whole to a temporary file and renamed
    into place."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write("# Static-analysis baseline (python -m karpenter_core_tpu_torch.analysis\n")
        f.write("# --update-baseline). Entries are `relpath:line:rule` debt markers.\n")
        for v in violations:
            f.write(v.key() + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _report(out, passes, rules, result, changed, base) -> None:
    for v in result.violations:
        out.write(v.render() + "\n")
    for v in result.unused_suppressions:
        # warn-only: dead `# lint: disable=` comments are blind spots but
        # never fail the run — deleting the comment clears the warning
        out.write(f"warning: {v.render()}\n")
    parts = [f"{len(result.violations)} violation(s)"]
    if result.suppressed:
        parts.append(f"{len(result.suppressed)} suppressed")
    if result.baselined:
        parts.append(f"{len(result.baselined)} baselined")
    if result.unused_suppressions:
        parts.append(f"{len(result.unused_suppressions)} unused suppression(s)")
    if changed is not None:
        parts.append(f"changed-only: {len(changed)} file(s) vs {base}")
    ran = sorted(rules) if rules else sorted(r for p in passes for r in p.rules)
    out.write(f"lint: {', '.join(parts)} — rules: {', '.join(ran)}\n")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m karpenter_core_tpu_torch.analysis",
        description=__doc__.splitlines()[0],
    )
    parser.add_argument(
        "--rule", action="append", default=None,
        help="run only the named rule(s); repeatable",
    )
    parser.add_argument(
        "--baseline", default=None, metavar="PATH",
        help="subtract the `relpath:line:rule` entries of PATH (none by default)",
    )
    parser.add_argument(
        "--update-baseline", nargs="?", const=True, default=None, metavar="PATH",
        help="write the current violation set to PATH (or to --baseline's)",
    )
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument(
        "--format", choices=("text", "sarif"), default="text",
        help="violation output format (sarif: SARIF 2.1.0 on stdout)",
    )
    parser.add_argument(
        "--changed", nargs="?", const="main", default=None, metavar="BASE",
        help="report only files differing from BASE (default: main). The "
        "passes still see the whole package (layering needs the global "
        "import graph); only the REPORT is filtered",
    )
    parser.add_argument(
        "--workers", type=int, default=min(8, os.cpu_count() or 1),
        help="thread-pool width for file-scope passes (1 = sequential; "
        "findings are identical either way)",
    )
    parser.add_argument(
        "--jobs", type=int, default=min(4, os.cpu_count() or 1), metavar="N",
        help="process-pool width for file-scope passes (takes precedence "
        "over --workers when > 1; findings are byte-identical to the "
        "sequential run)",
    )
    parser.add_argument(
        "-q", "--quiet", action="store_true", help="violations only, no summary"
    )
    args = parser.parse_args(argv)

    passes = all_passes()
    if args.list_rules:
        for p in passes:
            for rule in p.rules:
                sys.stdout.write(f"{rule}  (pass: {p.name})\n")
        return 0

    rules = set(args.rule) if args.rule else None
    updating = args.update_baseline is not None
    if updating and (rules or args.changed):
        # a filtered update would silently drop every other entry
        sys.stderr.write("lint: --update-baseline requires a full run "
                         "(drop --rule/--changed)\n")
        return 2
    baseline_path = (args.update_baseline if isinstance(args.update_baseline, str)
                     else args.baseline)
    if updating and baseline_path is None:
        sys.stderr.write("lint: --update-baseline needs a PATH\n")
        return 2
    if rules:
        unknown = rules - {r for p in passes for r in p.rules}
        if unknown:
            sys.stderr.write(f"lint: unknown rule(s): {', '.join(sorted(unknown))}\n")
            return 2

    changed = None
    if args.changed is not None:
        try:
            changed = changed_relpaths(args.changed)
        except (RuntimeError, OSError) as e:
            sys.stderr.write(f"lint: --changed unavailable: {e}\n")
            return 2

    config = default_config(REPO_ROOT)
    files = collect_sources(REPO_ROOT, config.package_name)
    baseline = load_baseline(args.baseline) if args.baseline and not updating else set()
    if args.jobs > 1:
        result = run_passes_multiprocessing(
            files, config, rules=rules, baseline=baseline, jobs=args.jobs
        )
    else:
        result = run_passes(files, config, passes=passes, rules=rules,
                            baseline=baseline, workers=max(1, args.workers))
    if changed is not None:
        _filter_changed(result, changed)

    if updating:
        _write_baseline(baseline_path, result.violations)
        n = len(result.violations)
        sys.stdout.write(f"lint: baseline updated with {n} entr{'y' if n == 1 else 'ies'}\n")
        return 0

    if args.format == "sarif":
        json.dump(sarif_payload(passes, result), sys.stdout, indent=2)
        sys.stdout.write("\n")
    elif args.quiet:
        for v in result.violations:
            sys.stdout.write(v.render() + "\n")
    else:
        _report(sys.stdout, passes, rules, result, changed, args.changed)
    return 1 if result.violations else 0


if __name__ == "__main__":
    sys.exit(main())
