"""The rest of a run, on the CPU at a small size, with the timed path
broken underneath: ``correct`` has to come out false.  The sound run of
each cell comes out true.  The faults are those each cell can have: a step
that returns its state unchanged, an answer altered where it is produced.
A solve has a batch of one rank vector, so no half of it can be left out;
one card runs each cell, so no exchange between cards can be left out."""
import math

import pytest
import torch

from bench import harness

from conftest import small_run

CELLS = ["lj-nosync", "lj-barrier"]


def outcome(spec, cell, **kw):
    run, driver = small_run(spec, cell, **kw)
    return driver.run(run)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(spec, cell):
    out = outcome(spec, cell)
    assert out.correct and out.attempted > 0 and out.failed == 0, (out.checks, out.failed)
    assert out.e2e["setup_s"] > 0


def test_nothing_compared_is_not_correct():
    assert math.isnan(harness.worst([]))
    assert math.isnan(harness.worst([1.0, float("nan")]))
    out = harness.Outcome(e2e={}, checks={"l1": (harness.worst([]), 1.0)}, attempted=0,
                          failed=0, memory_peak_bytes=0, context={})
    assert not out.correct


def unchanged_solve(monkeypatch):
    import repro_torch.kernels.spmv.ops as ops

    real = ops.solve

    def solve(step, pr0, **kw):
        def still(state):
            return state._replace(perr=torch.zeros_like(state.perr), it=state.it + 1,
                                  sweeps=state.sweeps + 1)
        return real(still, pr0, **kw)

    monkeypatch.setattr(ops, "solve", solve)


def altered_solve(monkeypatch):
    import repro_torch.kernels.spmv.ops as ops

    real = ops.solve

    def solve(step, pr0, **kw):
        r = real(step, pr0, **kw)
        pr = r.pr.clone()
        pr.view(-1)[7] *= 1.01  # one vertex's rank, 1 % off
        return r._replace(pr=pr)

    monkeypatch.setattr(ops, "solve", solve)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged_solve, altered_solve])
def test_solve_faults_fail(spec, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = outcome(spec, cell)
    assert not out.correct and out.failed > 0
