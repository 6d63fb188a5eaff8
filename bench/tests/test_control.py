"""The control (the reference at bfloat16 in the program's place) fails
each cell's comparison: here on the CPU at a small size, and, marked
``cuda``, on the card at the cells' own sizes on three seeds."""
import time

import pytest
import torch

from bench import harness

from conftest import ROOT, small_run

CONTROL = harness.load_module(ROOT / "bench" / "tools" / "control.py")
CELLS = ["lj-nosync", "lj-barrier"]


def fails(readings, limits):
    return any(not readings[k] <= limits[k] for k in limits)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 2**32 + 1])
def test_control_fails_small(spec, cell, seed):
    run, _ = small_run(spec, cell, seed=seed)
    assert fails(CONTROL.control_readings(run), run.limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_size(spec, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    for seed in (21, 22, 2**33 + 23):
        run, _ = harness.make_run(spec, cell, seed=seed, seconds=1.0, trace=False,
                                  device="cuda", t0=time.perf_counter())
        assert fails(CONTROL.control_readings(run), run.limits)
