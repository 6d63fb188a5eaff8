"""Shared helpers of the benchmark's CPU tests: the cells run on the CPU
at a small size, through the program's CPU path (its kernels' plain
versions).  Run from the repository's root: ``python -m pytest bench/tests``."""
import pathlib
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402

SMALL = {"n": 3000, "m": 24000}


@pytest.fixture
def spec():
    return harness.load_json(ROOT / "BENCHMARK.json")


def small_run(spec, cell, *, seed=2**31 + 11, seconds=2.0, trace=False, size=SMALL):
    """The cell's run on the CPU, its configuration cut to ``size``."""
    config = dict(harness.load_json(
        ROOT / "bench" / "configs" / f"{harness.cell_of(spec, cell)['config']}.json"), **size)
    run, driver = harness.make_run(spec, cell, seed=seed, seconds=seconds, trace=trace,
                                   device="cpu", t0=time.perf_counter(), config=config)
    run.trace_s = seconds / 2
    return run, driver
