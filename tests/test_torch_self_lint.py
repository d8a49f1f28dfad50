"""Self-lint of the port: karpenter_core_tpu_torch/ is violation-free under
every pass of its own static analysis (karpenter_core_tpu_torch/analysis,
`python -m karpenter_core_tpu_torch.analysis`), with no suppression
comment in the package and no baseline. The wall-clock, plain-write and
os.kill exemptions are the config's allowlists, each naming a live site;
the popen and atomic-write funnels name live modules; the recompile-guard
sinks and sanitizers name functions the port defines. The counterpart of
tests/test_self_lint.py, on the port's tree.
"""
import ast
import os
import subprocess
import sys

import pytest

from karpenter_core_tpu_torch.analysis import all_passes, default_config, run_passes
from karpenter_core_tpu_torch.analysis.core import collect_sources

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "karpenter_core_tpu_torch"


@pytest.fixture(scope="module")
def full_run():
    config = default_config(REPO_ROOT)
    files = collect_sources(REPO_ROOT, config.package_name)
    return config, files, run_passes(files, config)


def test_config_describes_the_port(full_run):
    config, files, _ = full_run
    assert config.package_name == PACKAGE
    assert config.env_funnel == f"{PACKAGE}/obs/envflags.py"
    assert config.env_funnel in {f.relpath for f in files}
    # the device grid (parallel/) sits above solver, as the reference's
    assert "solver" in config.layering["parallel"]
    assert "parallel" not in config.layering["solver"]
    assert all(PACKAGE + "/" in entry for entry in
               config.wallclock_allowlist | config.plain_write_allowlist
               | config.popen_funnels | config.atomic_write_funnels)


def test_package_is_violation_free(full_run):
    _, _, result = full_run
    assert result.violations == [], "\n".join(v.render() for v in result.violations)


def test_no_suppression_comments_in_package(full_run):
    _, files, result = full_run
    with_suppressions = {f.relpath: sorted(f.suppressions) for f in files if f.suppressions}
    assert with_suppressions == {}, (
        "in-package `# lint: disable` found; the only exemptions are the "
        f"config's allowlists: {with_suppressions}")
    assert result.suppressed == [] and result.baselined == []


def test_every_source_file_parses(full_run):
    _, files, _ = full_run
    assert [f.relpath for f in files if f.parse_error is not None] == []


def test_every_subpackage_has_a_layer(full_run):
    """The layering pass is strict: a new subpackage lands with its layer."""
    config, files, _ = full_run
    subpackages = {config.subpackage_of(f.module) for f in files if f.module} - {""}
    assert subpackages <= set(config.layering), subpackages - set(config.layering)


def _defs(files, relpath=None):
    return {n.name for f in files if relpath is None or f.relpath == relpath
            for n in ast.walk(f.tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


@pytest.mark.parametrize("allowlist", ["wallclock_allowlist", "plain_write_allowlist",
                                       "os_kill_allowlist"])
def test_allowlist_sites_still_exist(full_run, allowlist):
    """Each entry names a live `relpath::function` site; a stale entry
    would silently widen the exemption."""
    config, files, _ = full_run
    relpaths = {f.relpath for f in files}
    for entry in sorted(getattr(config, allowlist)):
        relpath, func = entry.split("::")
        assert relpath in relpaths, f"allowlisted file gone: {entry}"
        assert func in _defs(files, relpath), f"allowlisted function gone: {entry}"


def test_funnel_modules_still_exist(full_run):
    config, files, _ = full_run
    relpaths = {f.relpath for f in files}
    for entry in sorted(config.popen_funnels | config.atomic_write_funnels):
        assert entry in relpaths, f"funnel module gone: {entry}"


def test_recompile_guard_names_are_the_ports(full_run):
    """The sinks are the port's kernel factories and the sanitizers its
    bucket functions: each is defined in the package."""
    config, files, _ = full_run
    missing = sorted((config.recompile_sinks | config.recompile_sanitizers) - _defs(files))
    assert missing == []


def test_every_pass_runs_on_the_port(full_run):
    """The rule catalog is the reference's, whole."""
    rules = {r for p in all_passes() for r in p.rules}
    assert len(rules) == 18 and "recompile-guard" in rules and "guarded-by-v2" in rules


def test_analysis_imports_no_jax_and_no_reference(full_run):
    """Neither a module of analysis/ nor its CLI imports jax or the
    reference package, at any scope; and a fresh interpreter that runs the
    CLI's listing loads neither."""
    _, files, _ = full_run
    for f in files:
        if not f.relpath.startswith(f"{PACKAGE}/analysis/"):
            continue
        for node in ast.walk(f.tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "karpenter_core_tpu"), (f.relpath, name)
    code = ("import runpy, sys\n"
            "sys.argv = ['lint', '--list-rules']\n"
            "try:\n"
            f"    runpy.run_module('{PACKAGE}.analysis', run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'karpenter_core_tpu'))\n"
            "sys.stderr.write(repr(bad))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stderr.strip() == "[]"
    assert "recompile-guard" in proc.stdout


def test_cli_exits_zero_on_the_repo():
    proc = subprocess.run([sys.executable, "-m", f"{PACKAGE}.analysis", "--jobs", "1"],
                          capture_output=True, text=True, cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lint: 0 violation(s)" in proc.stdout
