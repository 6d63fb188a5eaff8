#!/usr/bin/env python
"""One-line variants of the spmv kernels on a GPU: what a line costs, and
that the checks catch a broken kernel.

    python scripts/spmv_ablation.py

Builds ``src/repro_torch/kernels/spmv/csrc/spmv.cu`` and copies of it that
each change one line (written to the git-ignored ``build/ablation/``), one
``nvcc`` each, started together, and loads each through ``build.load``.
Every variant is launched by ``kernel.launch_spmv_csr_acc``,
``kernel.launch_gs_pass`` or ``kernel.launch_gs_pass_multi`` (the port's
own C calls, uncounted) on the full webStanford surrogate at block 256,
unweighted, with ``chip_smoke.py``'s inputs (``gs_pass``: its kernel
phase's, ``gs_inputs``), and held against the plain version by
``chip_smoke.py``'s entry-wise bound (1e-5 of |plain| + the row's mean
|plain|); ``gs_pass`` also on a chain of 12 blocks of 256 whose every
edge comes from the block just below:

- mutants, which must break the bound: ``carry_dropped`` (the carries of a
  row cut between CTAs are not added) in ``spmv_csr_acc``,
  ``stale_prefetch`` (the first round of a block is summed from copies
  taken before the block above it committed) in ``gs_pass_multi``, and
  ``gs_stale_window`` (no window fix-up: every source is read from the
  helpers' gather, taken k blocks ahead) in ``gs_pass``, on webStanford and
  on the chain;
- timings, which keep the bound: ``gs_pass_multi`` with one CTA a row
  instead of a cluster (``cluster_1``), with clusters of at most 2 CTAs
  (``cluster_2``, what b = 64 launches with on 132 SMs), and with the
  copies waited for as soon as they are issued (``no_prefetch``), at
  b = 8 and b = 64; ``gs_lookahead_2``, ``gs_pass`` with its helpers
  gathering a block only two blocks ahead (k = 2, the least its schedule
  allows: the walk waits for a block's values two items ahead);
- ``walk_floor``, ``gs_pass_multi`` with no edge added: each block step
  is only its copies, its barriers and its commit, the floor of the
  dependent walk that the byte bound cannot show; ``gs_walk_floor``, the
  same for ``gs_pass`` (every item empty: records copied, no edge copied,
  gathered or summed); and copies, timed only, that find where the rest
  goes: ``short_rows`` (each lane adds at most 8 edges of a row's slice,
  so no long serial chain) and ``no_gathers`` (no copies of the sources'
  values) in ``gs_pass_multi``; ``gs_no_gathers`` (the helpers gather
  nothing: the walk, its copies and its sums alone) and ``gs_no_sums`` (no
  edge added) in ``gs_pass``.

Times are medians of CUDA-event-timed launches, in two rounds of opposite
order.  Prints the card's nvidia-smi line and one JSON object; exits 1 if
a mutant keeps the bound or the kernel misses it, and without a CUDA
device.
"""
from __future__ import annotations

import json
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import nvcc  # noqa: E402
from repro_torch.kernels.spmv import build, kernel  # noqa: E402

RUN = "          const int n = e < s1 ? (s1 - e + G - 1) / G : 0;"
GATHER = "        cp_async_cg16(qd + k * 4, from + (at & ~static_cast<size_t>(3)));"
CLUSTER = "constexpr int kMaxCluster = 8;     // the portable cluster size"
# name: (kernel, role, line of the source, its replacement); roles: "kernel"
# keeps every check, "timing" keeps the bound and is timed, "floor" is only
# timed, "mutant" must break the bound
VARIANTS = {
    "kernel": ("both", "kernel", None, None),
    "no_prefetch": ("gs_pass_multi", "timing",
                    "      cp_async_commit();  // round k + 1 in flight while round k is summed",
                    "      cp_async_commit(); cp_async_wait_all();"),
    "walk_floor": ("gs_pass_multi", "floor", RUN, "          const int n = 0;"),
    "gs_walk_floor": ("gs_pass", "floor", "  return min(a0 + kChunk, e1);", "  return a0;"),
    "gs_no_gathers": ("gs_pass", "floor",
                      "    for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) "
                      "vals[e] = __ldcg(q + __ldg(src + e));", ""),
    "gs_no_sums": ("gs_pass", "floor", "      const int n = max(hi - lo, 0);",
                   "      const int n = 0;"),
    "gs_lookahead_2": ("gs_pass", "timing",
                       "constexpr int kMaxWindow = 8;     // k: blocks between a helper's gather "
                       "and its block's sum", "constexpr int kMaxWindow = 2;"),
    "short_rows": ("gs_pass_multi", "floor", RUN,
                   RUN.replace("(s1 - e + G - 1) / G", "min((s1 - e + G - 1) / G, 8)")),
    "no_gathers": ("gs_pass_multi", "floor", GATHER, ""),
    "cluster_1": ("gs_pass_multi", "timing", CLUSTER, CLUSTER.replace("= 8;", "= 1;")),
    "cluster_2": ("gs_pass_multi", "timing", CLUSTER, CLUSTER.replace("= 8;", "= 2;")),
    "carry_dropped": ("spmv_csr_acc", "mutant", "  acc[row] = s + acc[row];",
                      "  acc[row] = acc[row];"),
    "stale_prefetch": ("gs_pass_multi", "mutant",
                       "      const bool patch = cur.first() && cur.db > 0;  // sources in block "
                       "db - 1 were copied before it committed",
                       "      const bool patch = false;"),
    "gs_stale_window": ("gs_pass", "mutant",
                        "      if (o < w_span) {  // committed after its gather: the window's value",
                        "            if (false) {"),
}
WIDTHS = (8, 64)


def chain_graph(block: int, n_blocks: int = 12):
    """Each row of block k + 1 takes its two in-edges from rows of block k,
    so a Gauss-Seidel pass carries every value one block a step: every
    edge's source is committed just before its block is summed."""
    from repro_torch.graphs import Graph

    n = block * n_blocks
    v = np.arange(block, n)
    src = np.r_[v - block, (v - block + 1) % block + (v // block - 1) * block]
    return Graph.from_edges(n, src, np.r_[v, v])


def sources() -> dict[str, pathlib.Path]:
    text = build.SOURCE.read_text()
    out_dir = ROOT / "build" / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (_, _, old, new) in VARIANTS.items():
        if old is None:
            paths[name] = build.SOURCE
            continue
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not one line of the source")
        path = out_dir / f"spmv_{name}.cu"
        path.write_text(text.replace(old, new))
        paths[name] = path
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("spmv_ablation: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from repro_torch.graphs import make_dataset
    from repro_torch.kernels.spmv import (
        BlockedGraph, gs_pass_multi_ref, gs_pass_ref, spmv_csr_acc_ref,
    )

    paths = sources()
    with ThreadPoolExecutor(len(paths)) as pool:
        built = dict(zip(paths, pool.map(nvcc.build, paths.values())))
    libs = {name: build.load(path) for name, (path, _) in built.items()}
    dev = torch.device("cuda")
    g = make_dataset("webStanford", scale_down=1)
    bg = BlockedGraph.build(g, block=256, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    contrib = torch.rand(bg.vmask.shape, generator=gen, device=dev) * bg.vmask / g.n
    csr = (contrib, bg.in_ptr, bg.src, bg.weights)
    csr_ref = spmv_csr_acc_ref(*csr)
    multi = {b: smoke.multi_inputs(g, bg, b) for b in WIDTHS}
    multi_ref = {b: gs_pass_multi_ref(pr, *args) for b, (pr, args) in multi.items()}
    pr1, frozen1, params1 = smoke.gs_inputs(g, bg, np.random.default_rng(0))
    ch = BlockedGraph.build(chain_graph(256), block=256, device=dev)
    singles = {  # gs_pass's operands: webStanford as chip_smoke.py's kernel phase, the chain
        "webStanford": (pr1, bg.inv_out, bg.vmask, params1, bg.in_ptr, bg.src, bg.weights,
                        bg.bias, frozen1),
        "chain": (torch.zeros_like(ch.vmask), ch.inv_out, ch.vmask,
                  torch.tensor([1.0, 0.85, 0.0], device=dev), ch.in_ptr, ch.src, ch.weights,
                  None, None)}
    singles_ref = {tag: gs_pass_ref(*args) for tag, args in singles.items()}

    def run(name, lib, which, b=None):
        if which == "spmv_csr_acc":
            return kernel.launch_spmv_csr_acc(lib, *csr)
        if which == "gs_pass":
            return kernel.launch_gs_pass(lib, *singles["webStanford" if b is None else b])
        pr, args = multi[b]
        return kernel.launch_gs_pass_multi(lib, pr, *args)

    report, failures = {}, []
    for name, lib in libs.items():
        which, role, _, _ = VARIANTS[name]
        rep = {"kernel": which, "role": role, "entry_over_bound": {}}
        for w in ("spmv_csr_acc", "gs_pass", "gs_pass_multi") if role != "floor" else ():
            if which not in (w, "both"):
                continue
            cases = {"spmv_csr_acc": [(None, csr_ref)], "gs_pass": list(singles_ref.items()),
                     "gs_pass_multi": list(multi_ref.items())}[w]
            for b, ref in cases:
                out = run(name, lib, w, b)
                torch.cuda.synchronize()
                ratio = smoke.agreement(out, ref)[2] / smoke.KERNEL_RTOL
                tag = w if b is None else f"{w} {b}" if w == "gs_pass" else f"{w} b={b}"
                rep["entry_over_bound"][tag] = ratio
                if role in ("kernel", "timing") and ratio > 1.0:
                    failures.append(f"{name} misses the bound on {tag}: {ratio:.3f}x")
                if role == "mutant" and ratio <= 1.0:
                    failures.append(f"mutant {name} keeps the bound on {tag}: {ratio:.3f}x")
        rep["ms"] = {}
        report[name] = rep
        print(f"{name} ({role}): {rep}", flush=True)

    timed = [n for n in libs if VARIANTS[n][1] != "mutant"]
    for order in (timed, timed[::-1]):
        for name in order:
            which = VARIANTS[name][0]
            if which in ("spmv_csr_acc", "both"):
                report[name]["ms"].setdefault("spmv_csr_acc", []).append(smoke.time_ms(
                    lambda lib=libs[name]: run(name, lib, "spmv_csr_acc"), 50))
            if which in ("gs_pass", "both"):
                report[name]["ms"].setdefault("gs_pass", []).append(smoke.time_ms(
                    lambda lib=libs[name]: run(name, lib, "gs_pass"), 10))
            if which in ("gs_pass_multi", "both"):
                for b in WIDTHS:
                    report[name]["ms"].setdefault(f"gs_pass_multi b={b}", []).append(
                        smoke.time_ms(lambda lib=libs[name], b=b: run(name, lib, "gs_pass_multi", b), 10))
    for name in timed:
        ms = report[name]["ms"]
        print(f"{name}: " + "; ".join(f"{k} {' '.join(f'{t:.4f}' for t in v)} ms"
                                      for k, v in ms.items()), flush=True)
    gs_floor = min(report["gs_walk_floor"]["ms"]["gs_pass"])
    k, stages = kernel.gs_pass_plan(bg.block, False, dev, libs["kernel"])
    print(f"walk floor gs_pass: {gs_floor:.4f} ms a pass, {gs_floor / bg.n_blocks * 1e3:.3f} "
          f"us a block step over {bg.n_blocks} steps; the kernel's k={k} D={stages}")
    floor = report["walk_floor"]["ms"]
    for b in WIDTHS:
        step_us = min(floor[f"gs_pass_multi b={b}"]) / bg.n_blocks * 1e3
        print(f"walk floor b={b}: {min(floor[f'gs_pass_multi b={b}']):.4f} ms a pass, "
              f"{step_us:.3f} us a block step over {bg.n_blocks} steps")
    print(smoke.nvidia_smi_line())
    print(json.dumps({"n_blocks": bg.n_blocks, "bound": smoke.KERNEL_RTOL,
                      "variants": report}))
    for msg in failures:
        print(f"spmv_ablation: FAIL: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
