"""Pytest-marker audit: the test tiers stay honest statically (the port's
copy of the reference's ``repro.analysis.markers``; the same checks over
the same ``tests/`` and ``pytest.ini``).

The suite is tiered by markers registered in ``pytest.ini`` — ``tier1``
(the default gate, auto-applied by ``tests/conftest.py`` to everything not
``slow``), ``slow`` (excluded from ``scripts/check.sh``'s tier-1 run), and
``subprocess`` (worker-spawning tests, a subset of ``slow``).  Tiering by
convention rots silently: an unregistered mark is a typo pytest happily
ignores, a subprocess test someone forgets to mark drags the tier-1 gate,
and a hand-applied ``tier1`` shadows the auto-marker.  This pass parses
``tests/*.py`` (AST, no collection — it must not import test modules) and
``pytest.ini`` and reports:

* ``unregistered-marker`` — a ``pytest.mark.<name>`` used in tests but
  registered neither in ``pytest.ini`` nor built into pytest;
* ``unmarked-subprocess`` — a test module that calls ``subprocess.run`` /
  ``Popen`` without any ``pytest.mark.subprocess`` in it;
* ``subprocess-not-slow`` — a ``subprocess``-marked test function missing
  the ``slow`` marker (the subprocess tier is a subset of the slow tier);
* ``explicit-tier1`` — a hand-applied ``tier1`` mark (conftest owns it);
* ``missing-config`` — ``pytest.ini`` absent or missing a tier marker.

``python -m repro_torch.analysis --strict`` fails on any of these
unsuppressed.
"""
from __future__ import annotations

import ast
import configparser
import pathlib

from repro_torch.analysis.findings import Finding

# marks pytest ships with — using them needs no registration
_BUILTIN_MARKS = {
    "parametrize", "skip", "skipif", "xfail", "usefixtures",
    "filterwarnings", "timeout",
}
_TIER_MARKS = ("tier1", "slow", "subprocess")


def _repo_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[3]


def registered_markers(root: pathlib.Path | None = None) -> set[str]:
    """Marker names registered in ``pytest.ini`` (empty set if absent)."""
    root = root or _repo_root()
    ini = root / "pytest.ini"
    if not ini.is_file():
        return set()
    cp = configparser.ConfigParser()
    cp.read(ini)
    raw = cp.get("pytest", "markers", fallback="")
    return {line.split(":", 1)[0].strip()
            for line in raw.splitlines() if line.strip()}


def _mark_name(dec: ast.expr) -> str | None:
    """``pytest.mark.<name>`` / ``pytest.mark.<name>(...)`` -> name."""
    if isinstance(dec, ast.Call):
        dec = dec.func
    if (isinstance(dec, ast.Attribute)
            and isinstance(dec.value, ast.Attribute)
            and dec.value.attr == "mark"
            and isinstance(dec.value.value, ast.Name)
            and dec.value.value.id == "pytest"):
        return dec.attr
    return None


def _module_marks(tree: ast.Module) -> tuple[set[str], dict[str, set[str]]]:
    """(module-level ``pytestmark`` marks, {test function: its marks})."""
    module_marks: set[str] = set()
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "pytestmark"
                        for t in node.targets)):
            vals = (node.value.elts
                    if isinstance(node.value, (ast.List, ast.Tuple))
                    else [node.value])
            module_marks |= {m for m in map(_mark_name, vals) if m}
    per_test: dict[str, tuple[set[str], ast.AST]] = {}
    for node in ast.walk(tree):
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name.startswith("test")):
            per_test[node.name] = (
                {m for m in map(_mark_name, node.decorator_list) if m}, node)
    return module_marks, per_test


def _calls_subprocess(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f = sub.func
            if (isinstance(f, ast.Attribute)
                    and ((isinstance(f.value, ast.Name)
                          and f.value.id == "subprocess")
                         or f.attr == "Popen")):
                return True
    return False


def marker_findings(root: pathlib.Path | None = None) -> list[Finding]:
    root = root or _repo_root()
    out: list[Finding] = []
    registered = registered_markers(root)
    for mark in _TIER_MARKS:
        if mark not in registered:
            out.append(Finding(
                "markers", "pytest.ini", "missing-config",
                f"tier marker {mark!r} not registered in pytest.ini"))
    known = registered | _BUILTIN_MARKS
    tests = root / "tests"
    for path in sorted(tests.glob("*.py")) if tests.is_dir() else []:
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
        module_marks, per_test = _module_marks(tree)
        all_marks = set(module_marks)
        for marks, _ in per_test.values():
            all_marks |= marks
        for m in sorted(all_marks - known):
            out.append(Finding(
                "markers", path.name, "unregistered-marker",
                f"pytest.mark.{m} is registered neither in pytest.ini nor "
                f"built into pytest — a typo'd tier silently selects nothing"))
        if "tier1" in all_marks:
            out.append(Finding(
                "markers", path.name, "explicit-tier1",
                "tier1 is auto-applied by tests/conftest.py to every test "
                "not marked slow; hand-applying it desynchronizes the tiers"))
        any_spawn = "subprocess" in source and _calls_subprocess(tree)
        if (any_spawn and "subprocess" not in all_marks):
            out.append(Finding(
                "markers", path.name, "unmarked-subprocess",
                "module spawns worker subprocesses but no test carries "
                "pytest.mark.subprocess — it would ride the tier-1 gate"))
        for test, (marks, node) in sorted(per_test.items()):
            eff = marks | module_marks
            if "subprocess" not in eff and _calls_subprocess(node):
                out.append(Finding(
                    "markers", f"{path.name}::{test}", "unmarked-subprocess",
                    "test spawns a worker subprocess without "
                    "pytest.mark.subprocess — it would ride the tier-1 gate"))
            if "subprocess" in eff and "slow" not in eff:
                out.append(Finding(
                    "markers", f"{path.name}::{test}", "subprocess-not-slow",
                    "subprocess-marked tests are a subset of the slow tier; "
                    "add pytest.mark.slow"))
    return out
