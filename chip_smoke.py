#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases, one or more lines each; any failure exits non-zero:

1. device   — the card's name, and its name and power limit from nvidia-smi;
2. build    — nvcc builds the kernels from src/repro_torch/kernels/spmv/csrc;
3. kernels  — on the full-size webStanford surrogate (n=281,903,
               m=2,312,497) at block 256, unweighted and weighted+biased,
               each kernel is held against its plain PyTorch version and
               timed beside it, beside one library call where PyTorch has
               one, and beside its bound from the H100's 3.35 TB/s;
4. solve    — the launcher's solve path (repro_torch.launch.pagerank_run)
               at full size with --handle-dangling for blocked,
               blocked_nosync, blocked_nosync_opt, nosync and barrier, with
               launch counts and L1 to the float64 oracle; then Fig 7
               (no-sync needs no more iterations than barrier) on the
               paper's setting, without dangling redistribution;
5. repeat   — barrier, nosync and blocked solved twice at full size must
               give the same iterations and ranks, and the residual curve
               of barrier, blocked and blocked_nosync run past the
               threshold shows how far 1e-8 sits above the float32 floor;
6. profile  — one traced solve of blocked and of blocked_nosync: device
               time by kernel and the device's busy share.

It then prints one JSON line naming every kernel, the nvidia-smi line, and
last the JSON device record.  Without a CUDA device, or without the port's
sources beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
KERNEL_RTOL = 1e-5  # max abs error ≤ KERNEL_RTOL · max|plain| (f32 sum order)
SOLVE_THRESHOLD = 1e-8
FLOOR_ITERS = 150  # solves run past the threshold to find the float32 floor
# L1 to the float64 oracle at full size: the reference's tests hold 1e-5 on
# graphs of ≤ 256 vertices; float32 rank error grows with n.
L1_BOUND = {"blocked_nosync_opt": 1e-3}
L1_DEFAULT = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median over ``reps`` launches of ``fn``, each between CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(g, gw, dev):
    from repro_torch.kernels.spmv import (
        BlockedGraph, gs_pass, gs_pass_ref, spmv_csr_acc, spmv_csr_acc_ref,
    )

    rng = np.random.default_rng(0)
    stats = {"spmv_csr_acc": {}, "gs_pass": {}}
    d = 0.85
    for tag, graph in (("unweighted", g), ("weighted", gw)):
        bg = BlockedGraph.build(graph, block=256, device=dev)
        n_pad, m = bg.n_blocks * bg.block, graph.m
        shape = (bg.n_blocks, bg.block)
        pr = torch.as_tensor(rng.random(n_pad).astype(np.float32) / graph.n,
                             device=dev).reshape(shape) * bg.vmask
        frozen = torch.as_tensor(rng.random(n_pad) < 0.1,
                                 device=dev).reshape(shape) & (bg.vmask > 0)
        dmass = d * float(torch.sum(pr * bg.dangling)) / graph.n
        params = torch.tensor([(1 - d) / graph.n, d, dmass], dtype=torch.float32,
                              device=dev)
        contrib = pr * bg.inv_out
        w_bytes = 0 if bg.weights is None else 4 * m
        csr_bytes = 4 * (n_pad + 1) + 4 * m + w_bytes

        def spmv():
            return spmv_csr_acc(contrib, bg.in_ptr, bg.src, bg.weights)

        def spmv_plain():
            return spmv_csr_acc_ref(contrib, bg.in_ptr, bg.src, bg.weights)

        def gs():
            return gs_pass(pr, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src,
                           bg.weights, bg.bias, frozen)

        def gs_plain():
            return gs_pass_ref(pr, bg.inv_out, bg.vmask, params, bg.in_ptr,
                               bg.src, bg.weights, bg.bias, frozen)

        out, ref = spmv(), spmv_plain()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(rel <= KERNEL_RTOL,
              f"spmv_csr_acc ({tag}) disagrees: rel err {rel:.3e}")
        check(torch.equal(out, spmv()), f"spmv_csr_acc ({tag}) not deterministic")
        vals = torch.ones(m, device=dev) if bg.weights is None else bg.weights
        csr = torch.sparse_csr_tensor(bg.in_ptr, bg.src, vals, (n_pad, n_pad))
        flat = contrib.reshape(-1)
        lib_err = float((torch.mv(csr, flat).reshape(shape) - ref).abs().max())
        s = stats["spmv_csr_acc"][tag] = dict(
            max_abs_err=err, rel_err=rel,
            ms=time_ms(spmv, 50), plain_ms=time_ms(spmv_plain, 20),
            library_ms=time_ms(lambda: torch.mv(csr, flat), 50))
        s["bound_ms"], s["bound_by"] = bound_ms(
            4 * n_pad + csr_bytes + 4 * n_pad, (2 if bg.weights is not None else 1) * m)
        print(f"kernel spmv_csr_acc {tag}: max_abs_err={err:.3e} "
              f"rel={rel:.3e} (bound {KERNEL_RTOL:g}) ms={s['ms']:.4f} "
              f"plain_ms={s['plain_ms']:.4f} library_ms={s['library_ms']:.4f} "
              f"(torch.sparse CSR mv, max_abs_err={lib_err:.3e}) "
              f"bound_ms={s['bound_ms']:.4f} ({s['bound_by']})", flush=True)

        out, ref = gs(), gs_plain()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(rel <= KERNEL_RTOL, f"gs_pass ({tag}) disagrees: rel err {rel:.3e}")
        check(torch.equal(out[frozen], pr[frozen]),
              f"gs_pass ({tag}) moved a frozen lane")
        check(torch.equal(out, gs()), f"gs_pass ({tag}) not deterministic")
        rank_ops = 5 * n_pad  # commit: two multiplies, two adds, the mask
        s = stats["gs_pass"][tag] = dict(
            max_abs_err=err, rel_err=rel,
            ms=time_ms(gs, 20), plain_ms=time_ms(gs_plain, 3, warmup=1),
            library_ms=None)
        rank_bytes = 4 * n_pad * (4 + (bg.bias is not None)) + n_pad + 12
        s["bound_ms"], s["bound_by"] = bound_ms(
            rank_bytes + csr_bytes, (3 if bg.weights is not None else 2) * m + rank_ops)
        print(f"kernel gs_pass {tag}: max_abs_err={err:.3e} rel={rel:.3e} "
              f"(bound {KERNEL_RTOL:g}) ms={s['ms']:.4f} "
              f"plain_ms={s['plain_ms']:.4f} library_ms=null "
              f"bound_ms={s['bound_ms']:.4f} ({s['bound_by']}; plus "
              f"{bg.n_blocks} dependent block steps per pass)", flush=True)
    return stats


def solve_phase():
    from repro_torch.kernels.spmv import launch_counts, reset_launch_counts
    from repro_torch.launch import pagerank_run

    base = ["--dataset", "webStanford", "--scale-down", "1", "--device", "cuda",
            "--threshold", str(SOLVE_THRESHOLD)]
    expect = {"blocked": "spmv_csr_acc", "blocked_nosync": "gs_pass",
              "blocked_nosync_opt": "gs_pass"}
    # the main path of each kernel: its first variant, --handle-dangling
    main_solve = {"spmv_csr_acc": "blocked", "gs_pass": "blocked_nosync"}
    launches = {}
    reports = {}
    runs = [(v, True) for v in ("blocked", "blocked_nosync", "blocked_nosync_opt",
                                "nosync", "barrier")]
    runs += [("blocked", False), ("blocked_nosync", False)]
    for variant, dangling in runs:
        argv = base + ["--variant", variant] + (["--handle-dangling"] if dangling else [])
        reset_launch_counts()
        rep = pagerank_run.run(argv)
        counts = launch_counts()
        if dangling:
            launches.update({k: n for k, n in counts.items()
                             if main_solve[k] == variant})
        it = rep["iterations"]
        for k, n in counts.items():
            want = it if expect.get(variant) == k else 0
            check(n == want, f"{variant}: {k} launched {n} times, expected {want}")
        check(it > 0, f"{variant}: no iterations")
        bound = L1_BOUND.get(variant, L1_DEFAULT)
        check(rep["l1"] <= bound, f"{variant}: L1 {rep['l1']:.3e} > {bound:g}")
        print(f"solve {variant} handle_dangling={dangling}: iterations={it} "
              f"err={rep['err']:.3e} wall_s={rep['wall_s']:.4f} "
              f"l1={rep['l1']:.3e} (bound {bound:g}) launches={counts}", flush=True)
        reports[(variant, dangling)] = rep
    fig7 = (reports[("blocked_nosync", False)]["iterations"],
            reports[("blocked", False)]["iterations"])
    check(fig7[0] <= fig7[1], f"Fig 7 fails: blocked_nosync {fig7[0]} > blocked {fig7[1]}")
    print(f"fig7: blocked_nosync {fig7[0]} <= blocked {fig7[1]} iterations "
          f"(no dangling redistribution); with it: blocked_nosync "
          f"{reports[('blocked_nosync', True)]['iterations']}, blocked "
          f"{reports[('blocked', True)]['iterations']}", flush=True)
    return launches


def repeat_phase(g, dev):
    """Same-input solves must repeat exactly (fixed-order sums on every
    path), and the residual curve past the threshold shows the float32
    floor that the 1e-8 stop rule sits above."""
    from repro_torch.core.solver import build_variant

    for variant in ("barrier", "nosync", "blocked"):
        v, bundle = build_variant(variant, g, device=dev)
        a, b = (v.run(bundle, threshold=SOLVE_THRESHOLD, handle_dangling=True)
                for _ in range(2))
        check(a.iterations == b.iterations and torch.equal(a.pr, b.pr),
              f"{variant}: two solves of one input differ "
              f"({a.iterations} vs {b.iterations} iterations)")
        print(f"repeat {variant}: two solves give {a.iterations} iterations "
              f"and identical ranks", flush=True)
    for variant in ("barrier", "blocked", "blocked_nosync"):
        v, bundle = build_variant(variant, g, device=dev)
        r = v.run(bundle, threshold=0.0, max_iter=FLOOR_ITERS,
                  handle_dangling=True)
        res = r.residuals[:r.iterations].double().numpy()
        first = {t: int(np.argmax(res <= t)) + 1 if np.any(res <= t) else None
                 for t in (1e-7, SOLVE_THRESHOLD, 1e-9)}
        # the residuals after the 1e-8 stop would have ended the solve
        after = res[first[SOLVE_THRESHOLD] or r.iterations:]
        after = after if after.size else res[-1:]
        print(f"floor {variant}: threshold 0, {r.iterations} iterations; first "
              f"at or below 1e-7/1e-8/1e-9: {first[1e-7]}/"
              f"{first[SOLVE_THRESHOLD]}/{first[1e-9]}; after the 1e-8 stop: "
              f"median {np.median(after):.3e} max {after.max():.3e}; min "
              f"{res.min():.3e}; max rank {float(r.pr.max()):.3e}", flush=True)


def profile_phase(g, dev):
    """One traced solve per blocked variant: device time by kernel and the
    device's busy share of the traced wall (the trace adds host overhead,
    so the untraced wall of the solve phase is the end-to-end number)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.solver import build_variant

    for variant in ("blocked", "blocked_nosync"):
        v, bundle = build_variant(variant, g, device=dev)
        v.run(bundle, threshold=SOLVE_THRESHOLD, handle_dangling=True)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            r = v.run(bundle, threshold=SOLVE_THRESHOLD, handle_dangling=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
        if not rows:
            print(f"profile {variant}: no device time in the trace (not measured)")
            continue
        print(f"profile {variant}: iterations={r.iterations} traced_wall_ms="
              f"{wall * 1e3:.3f} device_busy_ms={busy_ms:.3f} "
              f"busy_share={busy_ms / (wall * 1e3):.3f}")
        rows.sort(key=lambda e: -e.self_device_time_total)
        for e in rows[:6]:
            print(f"profile {variant}:   {e.self_device_time_total / 1e3:9.3f} ms "
                  f"x{e.count:<5d} {e.key[:70]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
          f"nvidia-smi: {smi}", flush=True)

    from repro_torch.graphs import Graph, make_dataset
    from repro_torch.kernels.spmv import build

    t0 = time.perf_counter()
    path, log = build.build()
    build.load()
    print(f"build: {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: {line.strip()}")

    g = make_dataset("webStanford", scale_down=1)
    rng = np.random.default_rng(1)
    gw = Graph.from_arrays(g.n, g.src, g.dst, g.out_degree, g.in_ptr,
                           weights=1.0 - rng.random(g.m),  # in (0, 1]
                           bias=rng.uniform(0.5, 1.5, g.n))
    print(f"data: webStanford surrogate n={g.n} m={g.m} "
          f"dangling={int((g.out_degree == 0).sum())}", flush=True)

    stats = kernel_phase(g, gw, dev)
    launches = solve_phase()
    repeat_phase(g, dev)
    profile_phase(g, dev)

    replaces = {"spmv_csr_acc": "src/repro/kernels/spmv/kernel.py:67",
                "gs_pass": "src/repro/kernels/spmv/kernel.py:181"}
    kernels = []
    for name, by_tag in stats.items():
        s = by_tag["unweighted"]  # the shapes the main path gives the kernel
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/spmv/csrc/spmv.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(t["max_abs_err"] for t in by_tag.values()),
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
        })
    check(all(k["launches"] > 0 for k in kernels), "a kernel never launched")
    print(f"total: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
