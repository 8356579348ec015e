"""The port's linter (ceph_tpu_torch/tools/radoslint, tools/lint_tool.py)
against the JAX package's, on the CPU.

The reference's cases run on the port: tests/test_radoslint.py is exec'd
with its imports renamed to the port (`load_reference_tests`), its
fixtures read from tests/radoslint_fixtures/, and its tier-1 gate
pointed at ceph_tpu_torch/ and the port's own baseline
(ceph_tpu_torch/.radoslint-baseline.json). Left out, with the reason:
its two trend-guard cases read the repository root's TPU BENCH_r*.json
records; the port's trend guard comes with its first benchmark, on its
own card records.

Then the port's linter against the reference's: equal findings (rule,
path, line, message) on every fixture, over ceph_tpu_torch/ and over
ceph_tpu/, equal `rules` and `explain` output; a copy of the port's
tree with one seeded violation fails the gate; and the gate's command
with no arguments lints ceph_tpu_torch/, never ceph_tpu/.
"""
from __future__ import annotations

import inspect
import json
import os
import shutil
import subprocess
import sys

import pytest

from ceph_tpu.tools import lint_tool as ref_lint_tool
from ceph_tpu.tools.radoslint import core as ref_core
from ceph_tpu_torch.tools import lint_tool
from ceph_tpu_torch.tools.radoslint import cli, core

from tests.test_torch_kv_objectstore import load_reference_tests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "radoslint_fixtures")
PORT_BASELINE = os.path.join(REPO, "ceph_tpu_torch", core.BASELINE_NAME)

#: the reference's cases left out, with the reason
SKIPPED = {
    "test_bench_trend_guard": "the trend guard: reads TPU BENCH_r*.json "
                              "records; it comes with the port's first "
                              "benchmark",
    "test_bench_trend_guard_prefers_newest_round": "the same trend guard",
}

#: the gate on the port's tree and the port's own baseline
EDITS = (
    ('findings = core.run_lint([os.path.join(REPO, "ceph_tpu")], '
     'root=REPO)',
     'findings = core.run_lint([os.path.join(REPO, "ceph_tpu_torch")], '
     'root=REPO)'),
    ("baseline_path = os.path.join(REPO, core.BASELINE_NAME)",
     'baseline_path = os.path.join(REPO, "ceph_tpu_torch", '
     'core.BASELINE_NAME)'),
)


@pytest.fixture(autouse=True)
def _port_gates():
    """The port's own leak gates (tests/conftest.py gates the
    reference's modules): the exec'd sanitizer cases arm the port's."""
    yield
    from ceph_tpu_torch.utils import loopprof, sanitizer
    assert not loopprof.installed_loops(), "port loopprof left armed"
    strays = sanitizer.take_foreign_call_soon()
    assert not strays, f"port sanitizer saw foreign call_soon: {strays}"


def _reference_module():
    return load_reference_tests("test_radoslint", True, [], {}, edits=EDITS)


def _cases() -> list[tuple]:
    """(case, parameters) for every case of tests/test_radoslint.py as
    pytest collects it, less those left out."""
    mod = load_reference_tests("test_radoslint", False, [], {})
    out = []
    for name, fn in vars(mod).items():
        if not name.startswith("test_") or not callable(fn) \
                or name in SKIPPED:
            continue
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if marks:
            out += [(name, tuple(p)) for p in marks[0].args[1]]
        else:
            out.append((name, None))
    return out


#: the gate first: the reference's entry-point case lints a fixture at the
#: repository root, which replaces the project rules' part of the port's
#: cache there, and the gate would then run them afresh
CASES = sorted(_cases(), key=lambda c: c[0] != "test_tier1_gate_zero_findings")
#: the fixtures, less the linters' caches their own runs leave there
FIXTURE_NAMES = sorted(n for n in os.listdir(FIXTURES)
                       if not n.startswith("."))


def _ids(case):
    name, params = case
    return name + (f"[{'-'.join(map(str, params))}]" if params else "")


def test_every_reference_case_is_mirrored():
    """40 cases in tests/test_radoslint.py: 21 rule fixtures and 19
    others, of which the two trend-guard cases are left out."""
    names = [name for name, _ in CASES]
    assert len(CASES) + len(SKIPPED) == 40
    assert names.count("test_rule_fixtures") == 21
    assert "test_tier1_gate_zero_findings" in names


def _lint_tree(package: str, tree: str) -> subprocess.Popen:
    """A child process that prints the findings of `package`'s linter
    over `tree` as (rule, path, line, message). Only the port's linter
    over the port's tree keeps its cache (at the repository root, where
    the gate below finds it warm); the other runs keep none, as a
    reference run there would write the reference's cache."""
    cache = package == tree == "ceph_tpu_torch"
    script = (
        "import json, sys\n"
        f"from {package}.tools.radoslint import core\n"
        f"fs = core.run_lint([{tree!r}], root={REPO!r}, "
        f"use_cache={cache})\n"
        "print(json.dumps([[f.rule, f.path, f.line, f.message] "
        "for f in fs]))\n")
    return subprocess.Popen([sys.executable, "-c", script], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_parity_over_both_trees():
    """Both linters, all 14 rules, over ceph_tpu_torch/ and over
    ceph_tpu/: equal findings. The four runs go at once, each in a
    process of its own."""
    procs = {(pkg, tree): _lint_tree(pkg, tree)
             for pkg in ("ceph_tpu", "ceph_tpu_torch")
             for tree in ("ceph_tpu", "ceph_tpu_torch")}
    found = {}
    for key, proc in procs.items():
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err[-2000:]
        found[key] = json.loads(out)
    for tree in ("ceph_tpu", "ceph_tpu_torch"):
        assert found[("ceph_tpu_torch", tree)] == found[("ceph_tpu", tree)]


def test_seeded_violation_fails_the_gate(tmp_path, capsys):
    """A copy of the port's tree, with its baseline and one module that
    drops the task asyncio.create_task returns: the gate exits 1 and
    names the seeded line. The copy starts from the port's cache, so
    only the seeded module and the project rules are linted afresh."""
    copy = tmp_path / "ceph_tpu_torch"
    shutil.copytree(os.path.join(REPO, "ceph_tpu_torch"), copy,
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    cache = os.path.join(REPO, core.CACHE_NAME)
    if os.path.exists(cache):
        shutil.copy(cache, tmp_path / core.CACHE_NAME)
    argv = [str(copy), "--root", str(tmp_path)]
    assert cli.main(argv) == 0
    (copy / "utils" / "seeded.py").write_text(
        "import asyncio\n\n\n"
        "async def spawn(coro):\n"
        "    asyncio.create_task(coro)\n")
    capsys.readouterr()
    assert cli.main(argv) == 1
    out = capsys.readouterr().out
    assert "ceph_tpu_torch/utils/seeded.py:5: [detached-task]" in out


@pytest.mark.parametrize("fixture", FIXTURE_NAMES)
def test_parity_on_fixture(fixture):
    """Both linters, all 14 rules, on each fixture: equal findings."""
    path = os.path.join(FIXTURES, fixture)
    ours = core.run_lint([path], root=FIXTURES, use_cache=False)
    ref = ref_core.run_lint([path], root=FIXTURES, use_cache=False)
    assert [(f.rule, f.path, f.line, f.message) for f in ours] \
        == [(f.rule, f.path, f.line, f.message) for f in ref]


def test_rules_and_explain_match(capsys):
    """`lint_tool rules` and `explain` of every rule print the
    reference's text."""
    assert lint_tool.main(["rules"]) == 0
    ours = capsys.readouterr().out
    assert ref_lint_tool.main(["rules"]) == 0
    assert ours == capsys.readouterr().out
    assert sorted(core.RULES) == sorted(ref_core.RULES)
    for rid in sorted(core.RULES):
        assert lint_tool.main(["explain", rid]) == 0
        ours = capsys.readouterr().out
        assert ref_lint_tool.main(["explain", rid]) == 0
        assert ours == capsys.readouterr().out, rid


@pytest.mark.parametrize("case,params", CASES, ids=[_ids(c) for c in CASES])
def test_reference_lint_case_on_the_port(case, params, tmp_path,
                                         monkeypatch, capsys):
    fn = getattr(_reference_module(), case)
    args = {"tmp_path": tmp_path, "monkeypatch": monkeypatch,
            "capsys": capsys}
    names = list(inspect.signature(fn).parameters)
    if params is not None:
        fn(*params)
    else:
        fn(*[args[p] for p in names])


def test_gate_without_arguments_lints_the_port(tmp_path):
    """`python -m ceph_tpu_torch.tools.radoslint` with no arguments, from
    a directory that holds a ceph_tpu_torch/ and a ceph_tpu/ with one
    violation each: it reports the first and not the second."""
    bad = ("import asyncio\n\n\n"
           "async def spawn(coro):\n"
           "    asyncio.create_task(coro)\n")
    for tree in ("ceph_tpu_torch", "ceph_tpu"):
        (tmp_path / tree).mkdir()
        (tmp_path / tree / "mod.py").write_text(bad)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.radoslint", "--json"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    paths = {f["path"] for f in json.loads(proc.stdout)["findings"]}
    assert paths == {"ceph_tpu_torch/mod.py"}


def test_the_port_keeps_its_own_baseline_and_cache():
    """The port's baseline is found first from its tree, holds no
    finding, and its cache has a name of its own at the lint root."""
    assert core.find_baseline(os.path.join(REPO, "ceph_tpu_torch")) \
        == PORT_BASELINE
    assert core.load_baseline(PORT_BASELINE) == set()
    assert core.CACHE_NAME != ref_core.CACHE_NAME
