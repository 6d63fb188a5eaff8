"""The command refuses to run without the card the cell asks for: it
exits non-zero and prints no result line."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT


def command(cwd, *args):
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def no_json(stdout):
    for line in stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        return False
    return True


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = command(ROOT, "--workload", "lj-nosync", "--seed", "1", "--seconds", "1",
                "--trace", "0")
    assert p.returncode != 0 and no_json(p.stdout)
    assert "needs 1 CUDA card" in p.stderr


def test_bare_directory_no_result(tmp_path):
    """Only BENCHMARK.json and bench/: no program to run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = command(tmp_path, "--workload", "lj-barrier", "--seed", "1", "--seconds", "1",
                "--trace", "1")
    assert p.returncode != 0 and no_json(p.stdout)


def test_unknown_workload():
    p = command(ROOT, "--workload", "no-such-cell", "--seed", "1", "--seconds", "1")
    assert p.returncode != 0 and no_json(p.stdout)
