#!/usr/bin/env python
"""Where the first solve of a process spends its time on a GPU.

    python scripts/first_solve.py

A process that runs ``repro_torch.launch.pagerank_run`` solves once, so
what the first solve pays once is part of its wall.  Each case runs in a
fresh process (``--case NAME``) on the full webStanford surrogate, with
threshold 1e-8 and dangling redistribution, timed as the launcher times a
solve (from a synchronized start to the ranks on the host):

* ``blocked_adaptive``: three solves in turn;
* ``blocked_adaptive, mv first``: one dense ``torch.mv`` of the block
  gain's shape (the schedule's certificate product) timed first, then
  three solves;
* ``blocked_nosync``: three solves (the same kernel, no gain product);
* ``blocked_adaptive, traced``: the first solve under ``torch.profiler``,
  its host ops by self CPU time.

The kernel library is built before the cases start (not timed).  Prints
the card's nvidia-smi line and one JSON object; exits 1 without a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
CASES = ("blocked_adaptive", "blocked_adaptive, mv first", "blocked_nosync",
         "blocked_adaptive, traced")
SOLVES = 3


def solve_s(v, bundle) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = v.run(bundle, threshold=1e-8, handle_dangling=True)
    r.pr.cpu()
    return time.perf_counter() - t0


def run_case(case: str) -> dict:
    from repro_torch.core.solver import build_variant
    from repro_torch.graphs import make_dataset

    variant = case.split(",")[0]
    g = make_dataset("webStanford", scale_down=1)
    v, bundle = build_variant(variant, g, device="cuda")
    torch.cuda.synchronize()
    out = {"case": case}
    if case.endswith("mv first"):
        nb = bundle.n_blocks
        gain, x = torch.ones(nb, nb, device="cuda"), torch.ones(nb, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.mv(gain, x)
        torch.cuda.synchronize()
        out["first_mv_s"] = time.perf_counter() - t0
    if case.endswith("traced"):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out["solve_s"] = [solve_s(v, bundle)]
        rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:6]
        out["top_host_ops_ms"] = {e.key: e.self_cpu_time_total / 1e3 for e in rows}
        return out
    out["solve_s"] = [solve_s(v, bundle) for _ in range(SOLVES)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=CASES)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("first_solve: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    if args.case:
        print(json.dumps(run_case(args.case)))
        return 0
    from repro_torch.kernels.spmv import build

    build.build()
    results = []
    for case in CASES:
        proc = subprocess.run([sys.executable, __file__, "--case", case],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        results.append(json.loads(proc.stdout.splitlines()[-1]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(smi)
    print(json.dumps({"first_solve": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
