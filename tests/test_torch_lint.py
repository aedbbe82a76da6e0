"""The port's jengalint (``repro_torch.analysis.jengalint``) against the
reference's on the reference's fixtures for the rules it copies (nondet,
alloc-direct, the waiver grammar), its torch rules (host-sync,
jit-hygiene) on the fixtures under ``tests/lint_fixtures_torch``, and the
port's own tree, which lints clean with a reason on every waiver."""
import pathlib
import subprocess
import sys

import pytest

from repro.analysis import jengalint as ref_lint
from repro_torch.analysis import jengalint

REPO = pathlib.Path(__file__).resolve().parent.parent
REF_FIXTURES = REPO / "tests" / "lint_fixtures"
FIXTURES = REPO / "tests" / "lint_fixtures_torch"


def rules_and_lines(violations):
    return [(v.rule, v.line, v.col) for v in violations]


def run_fixture(name, relpath):
    """Lint a fixture under a virtual in-package path (rule scoping keys
    on the relpath, not on where the fixture file lives)."""
    return jengalint.lint_source((FIXTURES / name).read_text(), relpath)


# ------------------------------------------- the rules copied unchanged
@pytest.mark.parametrize("name,relpath", [
    ("nondet_bad.py", "serving/scheduler.py"),
    ("nondet_good.py", "serving/scheduler.py"),
    ("nondet_bad.py", "serving/engine.py"),
    ("alloc_bad.py", "serving/engine.py"),
    ("alloc_good.py", "serving/engine.py"),
    ("alloc_bad.py", "core/manager.py"),
    ("waiver_noreason.py", "serving/sampler.py"),
    ("waiver_stale.py", "serving/sampler.py"),
])
def test_copied_rules_match_the_reference(name, relpath):
    src = (REF_FIXTURES / name).read_text()
    ours = jengalint.lint_source(src, relpath)
    ref = ref_lint.lint_source(src, relpath)
    assert rules_and_lines(ours) == rules_and_lines(ref), (ours, ref)


def test_waiver_suppresses_only_named_rule():
    src = ("import numpy as np\n"
           "# jengalint: allow[nondet] wrong rule name for this line\n"
           "x = np.asarray(1)\n")
    vs = jengalint.lint_source(src, "serving/sampler.py")
    assert sorted(v.rule for v in vs) == ["host-sync", "stale-waiver"], vs


# ------------------------------------------------------------ host-sync
def test_host_sync_bad_fixture_flags_every_sync():
    vs = run_fixture("host_sync_bad.py", "serving/sampler.py")
    assert [v.rule for v in vs] == ["host-sync"] * 14, vs
    assert [v.line for v in vs] == list(range(7, 21)), vs
    text = " ".join(v.message for v in vs)
    for what in (".cpu()", ".tolist()", ".item()", ".synchronize()",
                 "nonzero()", ".numpy()", '.to("cpu")', "np.asarray()",
                 "unique()", "masked_select()", "boolean mask",
                 "one-argument torch.where()", "repeat_interleave()"):
        assert what in text, what


def test_host_sync_good_fixture_is_clean():
    assert run_fixture("host_sync_good.py", "serving/sampler.py") == []


@pytest.mark.parametrize("relpath,flagged", [
    ("serving/engine.py", False), ("serving/scheduler.py", False),
    ("serving/runner.py", True), ("serving/spec_decode.py", True),
    ("kernels/foo.py", True)])
def test_host_sync_scoping(relpath, flagged):
    vs = run_fixture("host_sync_bad.py", relpath)
    assert ("host-sync" in [v.rule for v in vs]) == flagged, vs


# ---------------------------------------------------------- jit-hygiene
def test_jit_bad_fixture():
    vs = run_fixture("jit_bad.py", "kernels/step.py")
    jit = [(v.line, v.message.split(" inside")[0]) for v in vs
           if v.rule == "jit-hygiene"]
    assert jit == [(6, "print()"), (7, "Python branching on tensor 'x'"),
                   (9, "host sync .item()"), (16, "host sync .cpu()")], vs
    assert [v.line for v in vs if v.rule == "host-sync"] == [9, 16], vs


def test_jit_good_fixture_is_clean():
    assert run_fixture("jit_good.py", "kernels/step.py") == []


# ----------------------------------------------------------- self-check
def test_tree_is_clean():
    root = jengalint.find_package_root()
    assert root.name == "repro_torch"
    assert jengalint.lint_tree() == []


def test_every_waiver_in_tree_has_reason():
    root = jengalint.find_package_root()
    waivers = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        for w in jengalint.list_waivers(path.read_text(), rel):
            assert w.reason, f"{rel}:{w.line} waiver without reason"
            waivers.append((rel, w.rules))
    # the fetch phase: runner.fetch / fetch_tokens, SpecDecodeEngine's
    # round, and the host sampler's already-fetched rows
    assert sorted(waivers) == [
        ("serving/runner.py", ("host-sync",))] * 2 + [
        ("serving/sampler.py", ("host-sync",))] * 2 + [
        ("serving/spec_decode.py", ("host-sync",))], waivers


def test_run_lint_torch_script_exits_zero():
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "run_lint_torch.py")],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout
