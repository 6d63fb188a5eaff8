#!/usr/bin/env python
"""How far the PPR engine's first passes are from float64, on a GPU: the
kernel ``gs_pass_multi``, its plain version ``gs_pass_multi_ref``, and
the plain version's sums taken by ``torch.segment_reduce`` on 2-D data.

    python scripts/ppr_sum_accuracy.py

Builds ``src/repro_torch/kernels/spmv/csrc/spmv.cu``, then runs the PPR
engine (``cuda`` backend, 8 slots, dangling redistribution, threshold
1e-6) on the first 8 queries of ``make_query_stream(n, 32, seed=0)`` over
the full webStanford surrogate, twice: with the slots split over
``ShardMesh((cuda,) * 4)`` (2 rows a launch) and unsharded (8 rows).  The
operands of the first ``CALLS`` passes each run makes are kept and each
pass is computed four ways: the kernel, the plain version, the plain
version with each block's sums taken by one ``segment_reduce`` over the
2-D ``(edges, b)`` products (``plain_2d``: the form the plain version
had before it summed each row's segments as 1-D data), and the plain
version on the same operands in float64 (``exact``).  For each way it
prints the largest entry-wise error to ``exact``, over |exact| plus the
mean |exact| of the entry's row (``chip_smoke.py``'s entry bound is 1e-5
of that), and the vertex where it falls with its in-degree.

Prints the card's nvidia-smi line and one JSON object; exits 1 if the
kernel or the plain version is more than 1e-5 from ``exact``, and
without a CUDA device.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

CALLS = 4  # passes kept a run: at 4 shards, every shard's first pass
BOUND = 1e-5


def plain_2d(pr, inv_out, vmask, tele, coef, d, in_ptr, src, weights=None,
             frozen_rows=None):
    """``gs_pass_multi_ref`` with each block's sums as one 2-D
    ``segment_reduce`` over the ``(edges, b)`` products."""
    n_blocks, block, b = pr.shape
    out = pr.clone().reshape(-1, b)
    inv = inv_out.reshape(-1)
    vm = vmask.reshape(-1, 1)
    tl = tele.reshape(-1, b)
    ptr = in_ptr.tolist()
    for db in range(n_blocks):
        v0, v1 = db * block, (db + 1) * block
        e0, e1 = ptr[v0], ptr[v1]
        s = src[e0:e1].long()
        vals = out[s] * inv[s].unsqueeze(1)
        if weights is not None:
            vals = vals * weights[e0:e1].unsqueeze(1)
        acc = torch.segment_reduce(vals, "sum", offsets=in_ptr[v0:v1 + 1] - e0)
        new = (tl[v0:v1] * coef + d * acc) * vm[v0:v1]
        if frozen_rows is not None:
            new = torch.where(frozen_rows, out[v0:v1], new)
        out[v0:v1] = new
    return out.reshape(n_blocks, block, b)


def entry_error(x, exact):
    """Per entry: |x − exact| over |exact| plus the mean |exact| of the
    entry's row (the last axis)."""
    mag = exact.abs()
    return (x.double() - exact).abs() / (mag + mag.mean(dim=(0, 1), keepdim=True))


def main() -> int:
    if not torch.cuda.is_available():
        print("ppr_sum_accuracy: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import ShardMesh
    from repro_torch.graphs import make_dataset
    from repro_torch.kernels.spmv import build, gs_pass_multi, gs_pass_multi_ref
    from repro_torch.ppr import batched
    from repro_torch.serving import PPREngine, make_query_stream

    build.build()
    build.load()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda")
    g = make_dataset("webStanford", scale_down=1)
    queries = make_query_stream(g.n, 32, seed=0)[:8]
    ways = {"kernel": gs_pass_multi, "plain": gs_pass_multi_ref, "plain_2d": plain_2d}
    rows, ok = [], True
    for label, kw in (("4 shards", dict(mesh=ShardMesh((dev,) * 4))),
                      ("unsharded", dict(device=dev))):
        kept = []
        real = batched.gs_pass_multi

        def keep(pr, *args):
            if len(kept) < CALLS:
                kept.append((pr.clone(), tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args)))
            return real(pr, *args)

        batched.gs_pass_multi = keep
        try:
            PPREngine(g, slots=8, threshold=1e-6, handle_dangling=True,
                      backend="cuda", **kw).drain(queries)
        finally:
            batched.gs_pass_multi = real
        for i, (pr, args) in enumerate(kept):
            b = pr.shape[-1]
            exact = gs_pass_multi_ref(pr.double(), *(
                a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                for a in args))
            in_ptr = args[5]
            row = {"run": label, "call": i, "b": b}
            for name, fn in ways.items():
                err = entry_error(fn(pr, *args), exact).reshape(-1, b)
                at = int(torch.argmax(err))
                v = at // b
                row[name] = {"max_entry_err": float(err.max()),
                             "entries_over_bound": int((err > BOUND).sum()),
                             "vertex": v,
                             "in_degree": int(in_ptr[v + 1] - in_ptr[v])}
            ok &= row["kernel"]["max_entry_err"] <= BOUND
            ok &= row["plain"]["max_entry_err"] <= BOUND
            rows.append(row)
            print(f"{label} pass {i} b={b}: " + "; ".join(
                f"{name} {row[name]['max_entry_err']:.3e} at vertex "
                f"{row[name]['vertex']} (in-degree {row[name]['in_degree']}), "
                f"{row[name]['entries_over_bound']} entries over {BOUND:g}"
                for name in ways), flush=True)
    print(json.dumps({"device": smi, "bound": BOUND, "passes": rows}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
