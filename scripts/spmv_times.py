#!/usr/bin/env python
"""Times and output hashes of the spmv kernels of one checkout's port on a
GPU, taken the way ``chip_smoke.py`` takes them, so that two checkouts can
be compared.

    python scripts/spmv_times.py [--src DIR] [--dataset NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
whose ``build.load`` builds its own ``spmv.cu``, and times its public
wrappers on a full-size surrogate (default webStanford) at block 256: ``spmv_csr_acc``
on a random ``contrib``, ``gs_pass`` unweighted and weighted+biased on
``chip_smoke.py``'s kernel-phase operands (``gs_inputs``: some lanes
frozen, the state's dangling mass), and ``gs_pass_multi`` at b = 8 and
b = 64 on ``chip_smoke.py``'s ``multi_inputs``.  Each is timed by device
time in a profiler trace (``chip_smoke.device_ms``, which says when a
trace held no device events and CUDA events were used instead) and by
CUDA events around a call (``chip_smoke.time_ms``) and around calls made
back to back (``chip_smoke.batch_ms``), and the first call's
output is hashed (SHA-256 of its bytes): equal hashes from two checkouts
mean outputs equal bit for bit.  The inputs come from this checkout's
``chip_smoke.py`` and seeded generators, so they are the same whichever
``DIR`` is timed.  The wrappers take the same arguments in every slice of
the port, so an earlier commit is timed by pointing ``--src`` at an
unpacked copy of it (``git archive``); run the two in turn in one call on
the card (parent, change, change, parent) to compare them.  Prints the
card's nvidia-smi line and one JSON object; exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=pathlib.Path, default=ROOT / "src",
                    help="directory that holds the repro_torch to time")
    ap.add_argument("--dataset", default="webStanford",
                    help="the Table-1 surrogate, at full size, to time on")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spmv_times: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    src = args.src.resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import chip_smoke as smoke
    from repro_torch.graphs import make_dataset
    from repro_torch.kernels.spmv import BlockedGraph, gs_pass, gs_pass_multi, spmv_csr_acc

    dev = torch.device("cuda")
    g = make_dataset(args.dataset, scale_down=1)
    bg = BlockedGraph.build(g, block=256, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    contrib = torch.rand(bg.vmask.shape, generator=gen, device=dev) * bg.vmask / g.n
    cases = {"spmv_csr_acc": (lambda: spmv_csr_acc(contrib, bg.in_ptr, bg.src), 50)}
    rng = np.random.default_rng(0)
    for tag, graph in (("unweighted", g), ("weighted", smoke.weighted_graph(g))):
        bgt = BlockedGraph.build(graph, block=256, device=dev)
        pr, frozen, params = smoke.gs_inputs(graph, bgt, rng)
        cases[f"gs_pass {tag}"] = (
            lambda pr=pr, frozen=frozen, params=params, bgt=bgt: gs_pass(
                pr, bgt.inv_out, bgt.vmask, params, bgt.in_ptr, bgt.src, bgt.weights,
                bgt.bias, frozen), 20)
    for b in (8, 64):
        pr, rest = smoke.multi_inputs(g, bg, b)
        cases[f"gs_pass_multi b={b}"] = (
            lambda pr=pr, rest=rest: gs_pass_multi(pr, *rest), 10)
    report = {}
    for name, (fn, reps) in cases.items():
        digest = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:16]
        ms, by = smoke.device_ms(fn, reps)
        report[name] = {"device_ms": ms, "timed_by": by,
                        "call_ms": smoke.time_ms(fn, reps),
                        "batch_ms": smoke.batch_ms(fn, reps), "sha256": digest}
        print(f"{name}: {ms:.4f} ms device (by {by}); "
              f"{report[name]['call_ms']:.4f} ms a call, "
              f"{report[name]['batch_ms']:.4f} ms a call back to back; "
              f"output sha256 {digest}", flush=True)
    print(smoke.nvidia_smi_line())
    print(json.dumps({"src": str(src), "dataset": args.dataset, "n": g.n, "m": g.m,
                      "times": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
