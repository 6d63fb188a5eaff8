"""Back-to-back global PageRank solves of one variant on one bundle.

Set-up makes the configuration's graph from the seed, ingests it through
the program (``Graph.from_edges`` and ``build_variant``, timed as
``ingest_s``) and warms up with one whole solve.  The window runs
``get_variant(v).run(bundle, ...)`` back to back until ``--seconds`` have
passed, ending with the solve that crosses it: the window's wall over the
solves in it is the solve time, reported under the mix's ``metric`` name.
A sample of the solves' rank vectors, drawn from the seed (the first one
always), is held against the float64 reference's fixed point once the
window has closed.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench import devtrace, graphgen, reference, yardstick
from bench.harness import Outcome, Run, log, worst

SAMPLE = 4  # rank vectors compared, the first solve's among them
SEGMENT = 5.0  # seconds of the window a logged count covers


def run(h: Run) -> Outcome:
    from repro_torch.core.solver import build_variant
    from repro_torch.graphs.csr import Graph
    from repro_torch.kernels.spmv.kernel import launch_counts

    cfg, tr, dev = h.config, h.traffic, h.device
    cuda = dev.type == "cuda"
    n, block, d = int(cfg["n"]), int(cfg["block"]), float(cfg["d"])
    src_d, dst_d, _ = graphgen.surrogate_edges(cfg, h.seed, dev)
    src, dst = src_d.cpu().numpy(), dst_d.cpu().numpy()
    del src_d, dst_d
    if cuda:  # the peak is the system's: the generator's buffers go first
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    g = Graph.from_edges(n, src, dst)
    variant, bundle = build_variant(tr["variant"], g, d=d, block=block, device=dev)
    ingest_s = time.perf_counter() - t
    kw = dict(d=d, threshold=float(tr["threshold"]),
              handle_dangling=bool(tr["handle_dangling"]))
    variant.run(bundle, **kw)  # warm-up: the kernels load, the shapes allocate
    if cuda:
        torch.cuda.synchronize()
    setup_s = h.since_start()
    log(f"set-up {setup_s:.3f} s (ingest {ingest_s:.3f} s): n={n} m={g.m}")

    rng = np.random.default_rng(h.seed)
    iterations: list[int] = []
    kept: dict[int, torch.Tensor] = {}
    reservoir: list[int] = []
    ends: list[float] = []  # each solve's end, from the window's start
    traced = devtrace.Slice(dev) if h.trace else None
    reading, counts = None, {}
    if traced:
        counts["start"] = launch_counts()
        traced.start()
    start = time.perf_counter()
    resume = (start, 0)  # the untraced rest of the window: its start, its solves
    while True:
        with torch.profiler.record_function("bench.solve"):
            r = variant.run(bundle, **kw)
            if cuda:
                torch.cuda.synchronize()
        i = len(iterations)
        iterations.append(r.iterations)
        ends.append(time.perf_counter() - start)
        # the first solve, and a uniform reservoir of SAMPLE - 1 of the others
        if i == 0:
            kept[0] = r.pr
        elif len(reservoir) < SAMPLE - 1:
            reservoir.append(i)
            kept[i] = r.pr
        else:
            slot = int(rng.integers(0, i))
            if slot < SAMPLE - 1:
                del kept[reservoir[slot]]
                reservoir[slot] = i
                kept[i] = r.pr
        elapsed = time.perf_counter() - start
        if traced and (elapsed >= h.trace_s or elapsed >= h.seconds):
            reading = traced.stop()
            counts["stop"] = launch_counts()
            traced = None
            resume = (time.perf_counter(), len(iterations))
        if elapsed >= h.seconds:
            break
    end = time.perf_counter()
    window_s = end - start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    solves = len(iterations)
    log(f"window {window_s:.3f} s: {solves} solves, passes {sorted(set(iterations))}; "
        f"solves ending in each {SEGMENT:g} s: "
        f"{np.bincount((np.array(ends) // SEGMENT).astype(int)).tolist()}")

    # the reference runs once the program's state is freed
    outputs = {i: x.to(torch.float64) for i, x in kept.items()}
    del kept, r, bundle, g, variant
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    op = reference.Operator(n, torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev))
    tele = torch.full((n, 1), 1.0 / n, dtype=torch.float64, device=dev)
    xstar, first = reference.iterate(op, tele, d=d, dangling=kw["handle_dangling"],
                                     stop=kw["threshold"])
    xstar = xstar[:, 0]
    readings = [reference.judge_ranks(x, xstar) for x in outputs.values()]
    checks = {k: (worst(rd[k] for rd in readings), float(h.limits[k]))
              for k in ("l1", "max_rel")}
    failed = sum(any(not rd[k] <= h.limits[k] for k in ("l1", "max_rel"))
                 for rd in readings)
    log(f"reference: {time.perf_counter() - t:.3f} s, {first[0]} Jacobi sweeps "
        f"to the stop rule; solves compared: {sorted(outputs)}")

    launches = {}
    if "stop" in counts:
        launches = {k: counts["stop"][k] - counts["start"][k] for k in counts["stop"]}
    n_pad = yardstick.padded(n, block)
    # the mean solve of the window's untraced part (all of it without a trace)
    untraced = solves - resume[1]
    solve_s = (end - resume[0]) / untraced if untraced else window_s / solves
    context = dict(ingest_s=ingest_s, iterations=iterations, solve_s=solve_s,
                   sweeps_ref=first[0], n_pad=n_pad, m=int(src.size), launches=launches)
    return Outcome(e2e={tr["metric"]: 1e3 * window_s / solves, "setup_s": setup_s},
                   checks=checks, attempted=solves, failed=failed,
                   memory_peak_bytes=int(peak), context=context, reading=reading)
