"""PageRank driver of the port: run a registered variant on a Table-1
dataset surrogate, on the GPU by default.

    PYTHONPATH=src python -m repro_torch.launch.pagerank_run \
        --dataset webStanford --variant blocked_nosync --scale-down 1

It builds the surrogate, builds the variant's device bundle, solves, and
prints the iterations, the error, the wall time, the L1 distance to the
float64 oracle, the top-5 vertices, the device and the CUDA kernel launches
of the solve.  ``--device cpu`` runs the same path on the CPU (the kernels'
plain versions).  ``--list`` prints the registry.

The reference launcher's ``--store``, ``--ckpt`` and its ``query``,
``serve`` and ``build`` subcommands come with later slices of the port;
asking for them raises.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core.pagerank import l1_norm, pagerank_numpy
from repro_torch.core.solver import build_variant, get_variant, list_variants
from repro_torch.graphs import DATASETS, make_dataset
from repro_torch.kernels.spmv import launch_counts

_LATER = ("query", "serve", "build", "--store", "--ckpt")


def run(argv=None) -> dict:
    """Parse ``argv``, solve, print the report, and return it as a dict
    (``variant``, ``n``, ``m``, ``device``, ``iterations``, ``sweeps``,
    ``err``, ``wall_s``, ``l1``, ``oracle_iterations``, ``top5``,
    ``launches``); ``--list`` prints the registry and returns ``{}``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    later = [a for a in argv if a.split("=")[0] in _LATER]
    if later:
        raise NotImplementedError(
            f"{later[0]} is not ported yet: the port's launcher runs the "
            f"global solve only")
    ap = argparse.ArgumentParser(prog="repro_torch.launch.pagerank_run")
    ap.add_argument("--dataset", choices=tuple(DATASETS), default="webStanford")
    ap.add_argument("--scale-down", type=float, default=256.0)
    ap.add_argument("--variant", choices=list_variants(), default="nosync")
    ap.add_argument("--threads", type=int, default=56)
    ap.add_argument("--threshold", type=float, default=1e-8)
    ap.add_argument("--block", type=int, default=256,
                    help="blocked: dst-block size (the Gauss–Seidel unit)")
    ap.add_argument("--tile-cap", type=int, default=1024,
                    help="accepted for parity with the reference; the port's "
                         "CSR layout has no tiles")
    ap.add_argument("--handle-dangling", action="store_true",
                    help="redistribute dangling mass uniformly (all variants)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--list", action="store_true",
                    help="list every registered variant and exit; columns are "
                         "layout (bundle-sharing key), backend (numpy | torch "
                         "| cuda) and schedule (barrier | nosync | sequential)")
    args = ap.parse_args(argv)

    if args.list:
        header = (f"{'variant':20s} {'layout':12s} {'backend':8s} "
                  f"{'schedule':10s} description")
        print(header)
        print("-" * len(header))
        for name in list_variants():
            v = get_variant(name)
            print(f"{name:20s} {v.layout:12s} {v.backend:8s} {v.schedule:10s} "
                  f"{v.description}")
        return {}

    g = make_dataset(args.dataset, scale_down=args.scale_down)
    print(f"{args.dataset}: n={g.n} m={g.m} (scale_down={args.scale_down:g})")
    opts = dict(threads=args.threads, block=args.block, tile_cap=args.tile_cap,
                device=args.device)
    v, bundle = build_variant(args.variant, g, **opts)
    name = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "cpu")
    print(f"device: {args.device} ({name})")
    ref, it_seq = pagerank_numpy(g, threshold=1e-12,
                                 handle_dangling=args.handle_dangling)

    before = launch_counts()
    if args.device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = v.run(bundle, threshold=args.threshold,
              handle_dangling=args.handle_dangling, **opts)
    pr = (r.pr.detach().cpu().numpy() if isinstance(r.pr, torch.Tensor)
          else np.asarray(r.pr))
    wall = time.perf_counter() - t0
    launches = {k: n - before[k] for k, n in launch_counts().items()}

    report = dict(
        variant=args.variant, n=g.n, m=g.m, device=name,
        iterations=int(r.iterations), sweeps=r.sweeps, err=float(r.err),
        wall_s=wall, l1=l1_norm(pr, ref), oracle_iterations=it_seq,
        top5=np.argsort(pr)[::-1][:5].tolist(), launches=launches,
    )
    print(f"variant={args.variant}: iterations={report['iterations']} "
          f"err={report['err']:.2e} wall={wall:.3f}s")
    print(f"L1 vs sequential(1e-12, {it_seq} iters): {report['l1']:.3e}")
    print(f"top-5 ranks: {report['top5']}")
    print("kernel launches: " + " ".join(f"{k}={n}" for k, n in launches.items()))
    return report


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
