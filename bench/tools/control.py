"""The control of a cell's comparison: the plain reference put in the
program's place at the next precision below the configuration's float32
(bfloat16 vectors between steps, the matrix and sums in float32), at the
cell's own size, judged by the cell's own comparison.  It has to come out
not correct.  The benchmark's runs never run it.

    python3 bench/tools/control.py --workload <cell> --seeds 11,12,13 [--device cuda]

Prints one JSON line a seed: the control's readings beside the cell's
limits, for the control's rank vector iterated to the traffic's stop rule
(or ``MAX_ITER`` steps where bfloat16 never meets it).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from bench import graphgen, harness, reference  # noqa: E402

MAX_ITER = 500


def control_readings(run: harness.Run) -> dict:
    """The cell's compared numbers for the control on ``run``'s seed."""
    cfg, tr, dev = run.config, run.traffic, run.device
    n, d = int(cfg["n"]), float(cfg["d"])
    thr, dangling = float(tr["threshold"]), bool(tr["handle_dangling"])
    src, dst, _ = graphgen.surrogate_edges(cfg, run.seed, dev)
    exact = reference.Operator(n, src, dst)
    low = reference.Operator(n, src, dst, dtype=torch.float32)
    del src, dst
    tele = torch.full((n, 1), 1.0 / n, dtype=torch.float64, device=dev)
    xstar, _ = reference.iterate(exact, tele, d=d, dangling=dangling, stop=thr)
    x, first = reference.iterate(low, tele, d=d, dangling=dangling, stop=thr,
                                 tight=False, store=torch.bfloat16, max_iter=MAX_ITER)
    out = reference.judge_ranks(x[:, 0], xstar[:, 0])
    out["steps"] = first[0]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(prog="bench/tools/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        run, _ = harness.make_run(spec, args.workload, seed=seed, seconds=1.0,
                                  trace=False, device=args.device, t0=time.perf_counter())
        t = time.perf_counter()
        readings = control_readings(run)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": readings,
                          "limits": run.limits,
                          "seconds": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
