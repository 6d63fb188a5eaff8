"""Nothing under bench/ imports JAX, the JAX package ``repro`` or the old
``benchmarks`` folder, and the yardstick's own modules (the reference, the
generators, the byte formulas) import nothing of the program.  Names are
compared by their whole top-level part: ``repro_torch`` is not ``repro``."""
import ast
import sys

import pytest

from bench import harness

from conftest import ROOT

FILES = sorted((ROOT / "bench").rglob("*.py"))
YARDSTICK = ("reference.py", "graphgen.py", "yardstick.py")


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_files_found():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not imported(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    assert imported(ROOT / "bench" / name) <= {"__future__", "math", "typing", "warnings",
                                                "numpy", "torch"}


def test_run_guard(monkeypatch):
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert harness.forbidden_loaded() == ["jaxlib.xla"]
