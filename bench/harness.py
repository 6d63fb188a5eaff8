"""Runs one cell of ``BENCHMARK.json`` and builds its result line.

The cell names a configuration and a traffic mix; the mix names the
driver (``kinds/<kind>.py``) that sets the system up, drives its measured
window and judges what the window produced against the plain reference.
The harness keeps the rest: the card check, the result's shape, the
per-layer readers of the cell (``metrics/<name>.py``) and the check that
no JAX module was loaded.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time

import torch

from bench import devtrace

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
# top-level modules that no run may hold once its window has closed: JAX,
# and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
TRACE_SECONDS = 5.0  # the traced slice at the head of a --trace 1 window


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """The Python file ``path`` as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Run:
    """What a driver is given: the cell's files, the run's arguments."""

    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    trace_s: float = TRACE_SECONDS

    def since_start(self) -> float:
        return time.perf_counter() - self.t0


@dataclasses.dataclass
class Outcome:
    """What a driver hands back.  ``checks`` maps each compared number to
    ``(value, limit)``; ``context`` is what the per-layer readers read."""

    e2e: dict
    checks: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    context: dict
    reading: devtrace.Reading | None = None

    @property
    def correct(self) -> bool:
        # a NaN reading fails: it is not at or below its limit
        return self.failed == 0 and all(v <= lim for v, lim in self.checks.values())


def worst(values) -> float:
    """The largest of ``values``; NaN where any is NaN, or where there are
    none: a run that compared nothing is not correct."""
    values = list(values)
    return math.nan if not values or any(v != v for v in values) else max(values)


def cell_of(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                     f"{[c['name'] for c in spec['workloads']]}")


def metrics_for(spec: dict, section: str, cell: str) -> list[dict]:
    """The metrics of ``section`` that the cell reports."""
    return [m for m in spec[section] if cell in m.get("workloads", [cell])]


def power_limit_w() -> float | None:
    """The card's power limit as ``nvidia-smi`` reads it (None without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def make_run(spec: dict, name: str, *, seed: int, seconds: float, trace: bool,
             device, t0: float, config: dict | None = None) -> tuple[Run, object]:
    """The cell's :class:`Run` and its driver module; ``config`` stands in
    for the cell's configuration file (the CPU tests run small graphs)."""
    cell = cell_of(spec, name)
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    run = Run(cell=cell,
              config=config or load_json(BENCH / "configs" / f"{cell['config']}.json"),
              traffic=traffic,
              limits=load_json(BENCH / "workloads" / f"{name}.json")["limits"],
              seed=seed, seconds=seconds, trace=trace,
              device=torch.device(device), t0=t0)
    return run, load_module(BENCH / "kinds" / f"{traffic['kind']}.py")


def result_line(spec: dict, run: Run, out: Outcome, *, kind: str, count: int) -> dict:
    """The JSON object the run prints last; the checks are also printed on
    standard error, as the run's last lines."""
    name = run.cell["name"]
    metrics = {}
    watts = power_limit_w() if run.device.type == "cuda" else None
    if run.trace:
        ctx = dict(out.context, reading=out.reading)
        for m in metrics_for(spec, "per_layer", name):
            value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(ctx)
            if value is None:
                log(f"metric {m['name']}: nothing to read in this run")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            if "roofline" in m["name"] or "mfu" in m["name"]:
                log(f"metric {m['name']} = {value} % of 3.35 TB/s (card power "
                    f"limit {watts} W)")
    else:
        for m in metrics_for(spec, "end_to_end", name):
            metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": kind, "count": count,
              "memory_peak_bytes": out.memory_peak_bytes, "power_limit_w": watts}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if run.trace and out.reading is not None:
        device["busy_s"] = out.reading.busy_s
        device["window_s"] = out.reading.window_s
        line["breakdown"] = {"device_ops": out.reading.device_ops(),
                             "idle_gaps": out.reading.idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    log(f"failed {out.failed} of {out.attempted} attempted")
    for k, (v, lim) in out.checks.items():
        log(f"check {k} {v!r} limit {lim!r}" + ("" if v <= lim else "  FAILED"))
    return line


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv: list[str], t0: float) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0 or not math.isfinite(args.seconds) or args.seconds <= 0:
        ap.error("--seed must be >= 0 and --seconds > 0")
    spec = load_json(ROOT / "BENCHMARK.json")
    chips = cell_of(spec, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}")
        return 2
    torch.set_num_threads(1)  # load from one process with few threads
    run, driver = make_run(spec, args.workload, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), device="cuda", t0=t0)
    out = driver.run(run)
    found = forbidden_loaded()
    if found:
        log(f"modules of JAX or of the JAX package are loaded: {found}")
        return 3
    line = result_line(spec, run, out, kind=torch.cuda.get_device_name(0), count=chips)
    print(json.dumps(line), flush=True)
    return 0
