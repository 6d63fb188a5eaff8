"""Static import audit: the port, chip_smoke.py and the port's card
scripts import neither JAX nor anything of the reference package ``repro``
(``repro_torch`` is the port).

Every ``.py`` under ``src/repro_torch/``, ``chip_smoke.py`` and the
card scripts (``scripts/build_rss.py``, ``scripts/first_solve.py``,
``scripts/flash_ablation.py``,
``scripts/ppr_sum_accuracy.py``, ``scripts/spmv_ablation.py``,
``scripts/spmv_times.py``) is parsed with ``ast`` — nothing is imported
or run.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + [
    ROOT / "scripts" / name
    for name in ("build_rss.py", "first_solve.py", "flash_ablation.py",
                 "ppr_sum_accuracy.py", "spmv_ablation.py", "spmv_times.py")]


def forbidden_imports(tree: ast.AST) -> list[str]:
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                found.append(f"line {node.lineno}: {name}")
    return found


def test_the_port_has_files_to_audit():
    assert len(FILES) > 10 and all(p.is_file() for p in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    assert forbidden_imports(tree) == []


@pytest.mark.parametrize("src,bad", [
    ("import jax", True),
    ("import jax.numpy as jnp", True),
    ("from jax import lax", True),
    ("import repro", True),
    ("from repro.graphs import Graph", True),
    ("import repro.core.solver", True),
    ("from repro_torch.graphs import Graph", False),
    ("import repro_torch", False),
    ("from . import build", False),
    ("import numpy, torch", False),
    ("def f():\n    import jax\n", True),
])
def test_audit_catches_forbidden_forms(src, bad):
    assert bool(forbidden_imports(ast.parse(src))) is bad


@pytest.mark.parametrize("module", [
    "core/dynamic.py", "serving/runtime.py", "serving/loadgen.py",
    "serving/metrics.py", "launch/pagerank_run.py"])
def test_the_audit_covers_the_dynamic_and_serving_modules(module):
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("module", [
    "core/distributed.py", "launch/mesh.py", "serving/ppr_engine.py"])
def test_the_audit_covers_the_distributed_modules(module):
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("module", [
    "graphs/store.py", "graphs/datasets.py", "core/runtime.py", "device.py"])
def test_the_audit_covers_the_store_and_runtime_modules(module):
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("module", ["graphs/pipeline.py", "graphs/rmat.py"])
def test_the_audit_covers_the_build_pipeline_modules(module):
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("module", [
    "analysis/__init__.py", "analysis/__main__.py", "analysis/findings.py",
    "analysis/markers.py", "analysis/contracts.py", "analysis/trace_lint.py",
    "analysis/kernels.py"])
def test_the_audit_covers_the_analysis_modules(module):
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("module", [
    "training/__init__.py", "training/optimizer.py", "training/train_step.py",
    "training/local_sgd.py", "data/__init__.py", "data/tokens.py",
    "checkpoint/__init__.py", "checkpoint/ckpt.py", "launch/train.py",
    "configs/whisper_medium.py", "models/remat.py"])
def test_the_audit_covers_the_training_and_whisper_modules(module):
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("module", [
    "utils/__init__.py", "utils/roofline.py", "utils/flops.py", "utils/cost.py",
    "sharding/__init__.py", "sharding/rules.py", "launch/mesh.py", "launch/specs.py",
    "launch/dryrun.py", "configs/__init__.py"])
def test_the_audit_covers_the_dryrun_modules(module):
    assert ROOT / "src" / "repro_torch" / module in FILES
