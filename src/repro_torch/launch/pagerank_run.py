"""PageRank driver of the port: run a registered variant on a Table-1
dataset surrogate, on the GPU by default.

    PYTHONPATH=src python -m repro_torch.launch.pagerank_run \
        --dataset webStanford --variant blocked_nosync --scale-down 1

It builds the surrogate, builds the variant's device bundle, solves, and
prints the iterations, the error, the wall time, the L1 distance to the
float64 oracle, the top-5 vertices, the device and the CUDA kernel launches
of the solve; a plan-staged variant (``*_sticd``) also prints its plan's
core size and pruned counts.  The ``ppr_*`` variants solve one uniform
teleport row, the global question.  ``--device cpu`` runs the same path on
the CPU (the kernels' plain versions).  ``--list`` prints the registry
with each variant's contract audit (``repro_torch.analysis.contracts``):
✓, or the checks it fails.

The ``query`` subcommand answers one personalized-PageRank query as a
top-k, by forward push on the host (``--solver push``) or by
``ppr_barrier`` on the device (``--solver batched``):

    ... -m repro_torch.launch.pagerank_run query --seeds 7,42 --top-k 10

The ``serve`` subcommand runs continuous-batching PPR serving (the
engine behind the serving runtime) over a synthetic query stream, all at
once or as a ``--qps`` closed loop, with ``--updates`` random edge updates
applied mid-stream (the runtime quiesces, the engine rebuilds its backend
on the updated graph, stale cached answers are dropped):

    ... -m repro_torch.launch.pagerank_run serve --backend cuda \
        --slots 8 --queries 32 --updates 500 --update-batches 2

``serve --mesh-shards N`` splits the slot batch over
``make_serving_mesh(N)``: ``min(N, cards)`` shards (one on the CPU).
``--local-sweeps`` and ``--send-fraction`` reach the ``distributed_*``
variants.

The ``build`` subcommand runs the out-of-core build pipeline
(:mod:`repro_torch.graphs.pipeline`) on the host: an R-MAT graph
(``--scale``) or a Table-1 surrogate (``--dataset``) streamed to disk in
chunks of ``--chunk-edges``, reordered (``--order``), laid out, and
resumable: run it again with the same ``--out`` after an interruption, or
with ``--stages`` to run a subset:

    ... -m repro_torch.launch.pagerank_run build --dataset socLiveJournal1 \
        --scale-down 1 --order bfs --out build/lj

``--store DIR`` solves a graph store (:mod:`repro_torch.graphs.store`),
or the final store of a ``build`` directory, memmap-backed instead of
``--dataset``; a reordered store solves in its stored order and the
ranks, L1 and top-5 are reported in original vertex ids.  ``--ckpt PATH``
writes the ranks as a :class:`repro_torch.core.runtime.SolverCheckpoint`
(``PATH.npz``) with the partition count the bundle was built with:

    ... -m repro_torch.launch.pagerank_run --store build/lj \
        --variant blocked_nosync --handle-dangling --ckpt build/lj_pr
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core.pagerank import l1_norm, pagerank_numpy
from repro_torch.core.runtime import SolverCheckpoint
from repro_torch.core.solver import (
    build_variant,
    bundle_partitions,
    get_variant,
    list_variants,
    plan_stats,
)
from repro_torch.graphs import DATASETS, make_dataset
from repro_torch.kernels.spmv import launch_counts
from repro_torch.serving.runtime import ServingRuntime

# dst-block size (the Gauss–Seidel unit) of the blocked variants
DEFAULT_BLOCK = 256


def _parse_seeds(spec: str) -> tuple[int, ...]:
    """``"7,42"`` → ``(7, 42)``; an empty string → the uniform teleport."""
    return tuple(int(s) for s in spec.split(",") if s.strip() != "")


def query(argv) -> dict:
    """The ``query`` subcommand: print and return (``solver``, ``seeds``,
    ``wall_s``, ``top``: (vertex, value) pairs, and ``rounds``, ``pushes``,
    ``l1_bound`` for push or ``iterations``, ``err`` for batched)."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.pagerank_run query")
    ap.add_argument("--dataset", choices=tuple(DATASETS), default="webStanford")
    ap.add_argument("--scale-down", type=float, default=256.0)
    ap.add_argument("--seeds", default="", help="comma-separated seed vertices"
                    " (empty = uniform teleport, i.e. global PageRank)")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--solver", choices=("push", "batched"), default="push",
                    help="push: forward push on the host; batched: ppr_barrier "
                         "on --device")
    ap.add_argument("--threshold", type=float, default=1e-8,
                    help="push residual bound rmax / engine threshold")
    ap.add_argument("--handle-dangling", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --solver batched runs")
    args = ap.parse_args(argv)

    from repro_torch.core.pagerank import DeviceGraph
    from repro_torch.ppr import ppr_barrier, ppr_push, teleport_from_seeds, topk

    g = make_dataset(args.dataset, scale_down=args.scale_down)
    seeds = _parse_seeds(args.seeds)
    print(f"{args.dataset}: n={g.n} m={g.m}  seeds={list(seeds) or 'uniform'}")
    report = dict(solver=args.solver, seeds=seeds)
    t0 = time.perf_counter()
    if args.solver == "push":
        res = ppr_push(g, seeds, rmax=args.threshold,
                       handle_dangling=args.handle_dangling)
        idx, vals = res.topk(args.top_k)
        report.update(rounds=res.rounds, pushes=res.pushes, l1_bound=res.l1_bound)
        extra = (f"rounds={res.rounds} pushes={res.pushes} "
                 f"l1_bound={res.l1_bound:.2e}")
    else:
        r = ppr_barrier(DeviceGraph.from_graph(g, args.device),
                        teleport_from_seeds([seeds], g.n),
                        threshold=args.threshold,
                        handle_dangling=args.handle_dangling)
        idx, vals = topk(r.pr[0].double().cpu().numpy(), args.top_k)
        report.update(iterations=r.iterations, err=r.err)
        extra = f"iterations={r.iterations} err={r.err:.2e}"
    report["wall_s"] = time.perf_counter() - t0
    report["top"] = [(int(v), float(x)) for v, x in zip(idx, vals)]
    print(f"solver={args.solver}: {extra} wall={report['wall_s']:.3f}s")
    for rank, (v, x) in enumerate(report["top"], 1):
        print(f"  #{rank:<3d} vertex {v:<8d} ppr={x:.6e}")
    return report


class _VersionedRuntime(ServingRuntime):
    """A :class:`ServingRuntime` that records every response with the
    version of the graph it answers (the update batches applied before it
    was solved, or for a cached answer before it was served) and the
    kernel launches while each version served.  The graphs are not kept:
    the seeded update stream rebuilds them."""

    def __init__(self, engine, **kw):
        super().__init__(engine, **kw)
        self.versions: list[int] = []
        self.responses: list = []
        self.launches: list[dict] = []
        self.applied = 0
        self._counts = launch_counts()

    def _record(self, responses):
        self.versions += [len(self.launches)] * len(responses)
        self.responses += list(responses)

    def close_version(self):
        now = launch_counts()
        self.launches.append({k: n - self._counts[k] for k, n in now.items()})
        self._counts = now

    def offer(self, q, **kw):
        adm = super().offer(q, **kw)
        if adm.response is not None:
            self._record([adm.response])
        return adm

    def pump(self):
        out = super().pump()
        self._record(out)
        return out

    def apply_updates(self, **kw):
        delta, drained = super().apply_updates(**kw)
        self._record(drained)  # solved on the graph before the batch
        self.close_version()
        self.applied += delta.num_ops
        return delta, drained


def serve(argv) -> dict:
    """The ``serve`` subcommand: print the reference's figures and return
    them (``backend``, ``device``, ``n``, ``m`` of the updated graph,
    ``applied`` update ops, and ``wall_s``, ``qps``, ``p50_ms``, ``p99_ms``
    for the all-at-once drain or the closed loop's ``load`` report), with
    ``responses``, the graph version each answers (``versions``: update
    batches applied before it), the kernel launches while each version
    served (``launches``), ``invalidations`` and the runtime's ``stats``.
    Both paths draw every
    batch with ``random_update_batch`` from one ``default_rng(--seed)``
    against the live graph, so replaying that stream from the dataset
    rebuilds the graph of each version."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.pagerank_run serve")
    ap.add_argument("--dataset", choices=tuple(DATASETS), default="webStanford")
    ap.add_argument("--scale-down", type=float, default=256.0)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--threshold", type=float, default=1e-6)
    ap.add_argument("--backend", choices=("torch", "cuda"), default="torch",
                    help="torch: the batched sweep in plain torch ops; cuda: "
                         "the gs_pass_multi kernel (the reference's jax and "
                         "pallas)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--handle-dangling", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--qps", type=float, default=0.0,
                    help="offered load: drive the serving runtime with a "
                         "target-qps Zipf-skewed closed loop instead of the "
                         "all-at-once drain")
    ap.add_argument("--queue-depth", type=int, default=32,
                    help="admission-queue bound; a full queue rejects "
                         "(backpressure)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-query queue-wait deadline; expired queries are "
                         "dropped, never solved (0 = none)")
    ap.add_argument("--mesh-shards", type=int, default=0,
                    help="shard the slot batch over this many devices "
                         "(capped at the cards present; 0 = no mesh)")
    ap.add_argument("--zipf-alpha", type=float, default=1.1,
                    help="seed-popularity skew of the --qps workload")
    ap.add_argument("--updates", type=int, default=0, metavar="N",
                    help="apply N random edge updates (adds+dels) mid-stream: "
                         "the runtime quiesces, the engine rebuilds its "
                         "backend, stale cached answers are dropped")
    ap.add_argument("--update-batches", type=int, default=1,
                    help="split --updates over this many batches")
    ap.add_argument("--localized", action="store_true",
                    help="sink-bounded updates (dangling→dangling adds) "
                         "instead of uniform random ones")
    args = ap.parse_args(argv)
    if args.queries < 1:
        ap.error("--queries must be >= 1")

    from repro_torch.core.dynamic import make_update_injector, random_update_batch
    from repro_torch.serving import PPREngine, make_query_stream

    g = make_dataset(args.dataset, scale_down=args.scale_down)
    mesh = None
    if args.mesh_shards > 0:
        from repro_torch.launch.mesh import make_serving_mesh

        mesh = make_serving_mesh(args.mesh_shards, device=args.device)
    eng = PPREngine(g, slots=args.slots, threshold=args.threshold,
                    backend=args.backend, device=args.device, mesh=mesh,
                    handle_dangling=args.handle_dangling)
    name = (torch.cuda.get_device_name(0) if eng.device.type == "cuda"
            else "cpu")
    shards = mesh.size if mesh is not None else 1
    print(f"{args.dataset}: n={g.n} m={g.m}  slots={args.slots} "
          f"backend={args.backend} device={args.device} ({name}) "
          f"mesh_shards={shards}")
    runtime = _VersionedRuntime(
        eng, queue_depth=args.queue_depth,
        deadline_s=args.deadline_ms * 1e-3 if args.deadline_ms > 0 else None)
    report = dict(backend=args.backend, device=name)

    n_batches = max(args.update_batches, 1)
    per_batch = max(1, args.updates // n_batches) if args.updates else 0
    if args.qps > 0:
        from repro_torch.serving.loadgen import LoadConfig, make_workload, run_closed_loop

        cfg = LoadConfig(queries=args.queries, qps=args.qps, top_k=args.top_k,
                         zipf_alpha=args.zipf_alpha, seed=args.seed)
        queries, arrivals = make_workload(g.n, cfg)
        kwargs = {}
        if args.updates > 0:
            step = max(1, args.queries // (n_batches + 1))
            kwargs = dict(
                update_injector=make_update_injector(
                    np.random.default_rng(args.seed), per_batch,
                    localized=args.localized),
                update_at=tuple(step * (i + 1) for i in range(n_batches)))
        rep = run_closed_loop(runtime, queries, arrivals, **kwargs)
        p50 = f"{rep.p50_ms:.1f}ms" if rep.p50_ms is not None else "n/a"
        p99 = f"{rep.p99_ms:.1f}ms" if rep.p99_ms is not None else "n/a"
        print(f"offered {rep.offered_qps:.1f} q/s → achieved "
              f"{rep.achieved_qps:.1f} q/s  p50={p50} p99={p99} (under load)")
        print(f"queue depth mean={rep.queue_depth_mean:.1f} "
              f"max={rep.queue_depth_max:.0f}  "
              f"rejected={rep.rejected} ({rep.rejection_rate:.1%})  "
              f"expired={rep.expired}  cache_hits={rep.cache_hits}  "
              f"invalidations={rep.cache_invalidations}")
        report.update(load=rep.to_dict(), wall_s=rep.wall_s,
                      qps=rep.achieved_qps, p50_ms=rep.p50_ms, p99_ms=rep.p99_ms)
    else:
        queries = make_query_stream(g.n, args.queries, top_k=args.top_k,
                                    seed=args.seed)
        t0 = time.perf_counter()
        if args.updates > 0:
            half = len(queries) // 2
            responses = runtime.serve(queries[:half])
            rng = np.random.default_rng(args.seed)
            for _ in range(n_batches):
                adds, dels = random_update_batch(eng.g, rng, per_batch,
                                                 localized=args.localized)
                _, drained = runtime.apply_updates(adds=adds, dels=dels)
                responses += drained
            print(f"applied {runtime.applied} edge updates "
                  f"({'localized' if args.localized else 'random'}, "
                  f"{n_batches} batch(es)): n={eng.g.n} m={eng.g.m}, "
                  f"warm cache now {len(eng._cache)} rows, result cache "
                  f"{runtime.result_cache_len} (invalidated "
                  f"{runtime.metrics.count('cache_invalidations')})")
            responses += runtime.serve(queries[half:])
        else:
            responses = runtime.serve(queries)
        wall = time.perf_counter() - t0
        lat = np.asarray([r.latency_s for r in responses]) * 1e3
        report.update(wall_s=wall, qps=len(responses) / wall,
                      p50_ms=float(np.percentile(lat, 50)),
                      p99_ms=float(np.percentile(lat, 99)))
        print(f"served {len(responses)} queries in {wall:.2f}s "
              f"({report['qps']:.1f} q/s)  p50={report['p50_ms']:.1f}ms "
              f"p99={report['p99_ms']:.1f}ms  warm_hits={eng.warm_hits}"
              f"  cache_hits={runtime.metrics.count('cache_hits')}")
        first = min(responses, key=lambda r: r.qid)
        top = ", ".join(f"{int(v)}:{float(x):.2e}"
                        for v, x in zip(first.indices[:5], first.values[:5]))
        print(f"sample qid={first.qid} seeds={list(first.seeds)} top5: {top}")
    print(f"slots: occupancy={eng.slot_occupancy:.0%} "
          f"submit_rejections={eng.submit_rejections} "
          f"(re-queued, not dropped)  {runtime.metrics.summary()}")
    runtime.close_version()
    report.update(
        n=eng.g.n, m=eng.g.m, applied=runtime.applied,
        responses=runtime.responses, versions=runtime.versions,
        launches=runtime.launches,
        warm_hits=eng.warm_hits,
        invalidations=runtime.metrics.count("cache_invalidations"),
        stats=runtime.stats())
    return report


def build(argv) -> dict:
    """The ``build`` subcommand: run or resume the build pipeline, print
    the final store and its layout, and return ``out``, ``store`` (the
    final store's path), ``stages`` (each stage's info, with ``wall_s``
    and ``skipped``), ``n``, ``m`` and ``nbytes`` (the store's array
    files)."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.pagerank_run build")
    ap.add_argument("--out", required=True,
                    help="pipeline directory (PIPELINE.json, raw/ and "
                         "reordered/ stores); run again with the same --out "
                         "to resume an interrupted build")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--scale", type=int, default=None,
                     help="R-MAT scale: 2**scale vertices")
    src.add_argument("--dataset", choices=tuple(DATASETS), default=None,
                     help="build a Table-1 surrogate instead of a pure R-MAT")
    ap.add_argument("--scale-down", type=float, default=1.0,
                    help="dataset surrogate scale-down (with --dataset)")
    ap.add_argument("--avg-degree", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk-edges", type=int, default=1 << 21,
                    help="edges per streamed chunk: the peak-memory knob")
    ap.add_argument("--order", choices=("none", "bfs", "degree", "random"),
                    default="bfs")
    ap.add_argument("--no-dedupe", action="store_true",
                    help="keep duplicate edges (R-MAT builds dedupe by "
                         "default, dataset surrogates never do)")
    ap.add_argument("--threads", type=int, default=56,
                    help="partitions of the layout stage's bounds")
    ap.add_argument("--block", type=int, default=256,
                    help="recorded in PIPELINE.json for parity with the "
                         "reference; the port's layout has no tiles")
    ap.add_argument("--tile-cap", type=int, default=1024,
                    help="recorded in PIPELINE.json for parity with the "
                         "reference; the port's layout has no tiles")
    ap.add_argument("--stages", default=None,
                    help="comma-separated subset of generate,reorder,layout "
                         "(default: all)")
    args = ap.parse_args(argv)
    if args.scale is None and args.dataset is None:
        ap.error("one of --scale / --dataset is required")

    import math

    from repro_torch.graphs.datasets import _dataset_rmat_params
    from repro_torch.graphs.pipeline import BuildConfig, run_pipeline
    from repro_torch.graphs.store import GraphStore

    common = dict(seed=args.seed, chunk_edges=args.chunk_edges, order=args.order,
                  threads=args.threads, block=args.block, tile_cap=args.tile_cap)
    if args.dataset is not None:
        n, m, (a, b, c) = _dataset_rmat_params(args.dataset, args.scale_down)
        cfg = BuildConfig(scale=max(6, math.ceil(math.log2(n))), n_edges=m,
                          fold_n=n, a=a, b=b, c=c, dedupe=False, **common)
    else:
        cfg = BuildConfig(scale=args.scale, avg_degree=args.avg_degree,
                          dedupe=not args.no_dedupe, **common)
    stages = args.stages.split(",") if args.stages else None
    res = run_pipeline(args.out, cfg, stages=stages)
    store = GraphStore(res["store"])
    print(f"store: {store.path}  n={store.n} m={store.m} order={store.order} "
          f"bytes={store.nbytes():,}")
    lay = store.layout()
    if lay:
        edges = np.asarray(lay["partition_edges"])
        print(f"layout: threads={lay['threads']} partitions={edges.size} "
              f"partition_edges max={int(edges.max())} mean={edges.mean():.1f}")
    return dict(out=res["out"], store=store.path, n=store.n, m=store.m,
                nbytes=store.nbytes(),
                stages={k: {**v, "skipped": v.get("skipped", False)}
                        for k, v in res["stages"].items()})


def run(argv=None) -> dict:
    """Parse ``argv``, solve, print the report, and return it as a dict
    (``variant``, ``n``, ``m``, ``device``, ``plan``: the plan's stats or
    ``None``, ``iterations``, ``sweeps``, ``err``, ``wall_s``, ``l1``,
    ``oracle_iterations``, ``top5``, ``launches``, ``pr``: the ranks, in
    original ids for a reordered ``--store``; with ``--ckpt`` also
    ``ckpt``, the file written, and ``ckpt_p``); ``--list`` prints the
    registry and returns ``{}``; ``build ...``, ``query ...`` and
    ``serve ...`` return :func:`build`'s, :func:`query`'s and
    :func:`serve`'s reports."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["build"]:
        return build(argv[1:])
    if argv[:1] == ["query"]:
        return query(argv[1:])
    if argv[:1] == ["serve"]:
        return serve(argv[1:])
    ap = argparse.ArgumentParser(prog="repro_torch.launch.pagerank_run")
    ap.add_argument("--dataset", choices=tuple(DATASETS), default="webStanford")
    ap.add_argument("--scale-down", type=float, default=256.0)
    ap.add_argument("--variant", choices=list_variants(), default="nosync")
    ap.add_argument("--threads", type=int, default=56)
    ap.add_argument("--threshold", type=float, default=1e-8)
    ap.add_argument("--block", type=int, default=DEFAULT_BLOCK,
                    help="blocked: dst-block size (the Gauss–Seidel unit)")
    ap.add_argument("--tile-cap", type=int, default=1024,
                    help="accepted for parity with the reference; the port's "
                         "CSR layout has no tiles")
    ap.add_argument("--local-sweeps", type=int, default=4,
                    help="distributed: sweeps per exchange (staleness bound)")
    ap.add_argument("--send-fraction", type=float, default=0.125,
                    help="distributed_topk: fraction of deltas published per round")
    ap.add_argument("--handle-dangling", action="store_true",
                    help="redistribute dangling mass uniformly (all variants)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="solve this graph store, or a build directory's final "
                         "store, memmap-backed instead of --dataset; ranks are "
                         "reported in original vertex ids")
    ap.add_argument("--ckpt", default=None, metavar="PATH",
                    help="write the ranks as a SolverCheckpoint to PATH.npz")
    ap.add_argument("--list", action="store_true",
                    help="list every registered variant and exit; columns are "
                         "layout (bundle-sharing key), backend (numpy | torch "
                         "| cuda), schedule (barrier | nosync | adaptive | "
                         "sequential) and the contract audit (✓, or the failed "
                         "checks)")
    args = ap.parse_args(argv)

    if args.list:
        # the static contract audit's verdict per variant: ✓, or the
        # failed check keys
        from repro_torch.analysis.contracts import audit_registry

        audit = audit_registry()
        header = (f"{'variant':20s} {'layout':18s} {'backend':8s} "
                  f"{'schedule':10s} {'contract':10s} description")
        print(header)
        print("-" * len(header))
        for name in list_variants():
            v = get_variant(name)
            flags = ",".join(sorted({f.check for f in audit[name]})) or "✓"
            print(f"{name:20s} {v.layout:18s} {v.backend:8s} {v.schedule:10s} "
                  f"{flags:10s} {v.description}")
        return {"contract": {name: sorted({f.check for f in fs})
                             for name, fs in audit.items()}}

    perm = None
    if args.store:
        from repro_torch.graphs.pipeline import final_store_path
        from repro_torch.graphs.store import GraphStore, StoreError, is_store

        path = args.store if is_store(args.store) else final_store_path(args.store)
        if not is_store(path):
            raise StoreError(
                f"{args.store} is neither a graph store nor a build directory "
                f"with a finished store (no META.json there, nor under its "
                f"raw/ or reordered/)")
        store = GraphStore(path)
        g = store.graph(mmap=True)
        perm = store.perm()
        print(f"store {store.path}: n={g.n} m={g.m} order={store.order} (memmap)")
    else:
        g = make_dataset(args.dataset, scale_down=args.scale_down)
        print(f"{args.dataset}: n={g.n} m={g.m} (scale_down={args.scale_down:g})")
    opts = dict(threads=args.threads, block=args.block, tile_cap=args.tile_cap,
                local_sweeps=args.local_sweeps,
                send_fraction=args.send_fraction, device=args.device)
    v, bundle = build_variant(args.variant, g, **opts)
    name = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "cpu")
    print(f"device: {args.device} ({name})")
    ps = plan_stats(bundle)
    if ps:
        print(f"plan: core n={ps['core_n']} m={ps['core_m']} "
              f"(pruned identical={ps['pruned_identical']} "
              f"chain={ps['pruned_chain']} dead={ps['pruned_dead']}, "
              f"contracted={ps['contracted_edges']})")
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
    if pr.ndim == 2:
        # ppr_* variants return a (b, n) batch; with no seeds passed b == 1
        # and the one row is the uniform-teleport (global) solve
        assert pr.shape[0] == 1, pr.shape
        pr = pr[0]
    wall = time.perf_counter() - t0
    launches = {k: n - before[k] for k, n in launch_counts().items()}
    if perm is not None:
        # a reordered store solves in stored order; report in original ids
        from repro_torch.graphs.reorder import unpermute_ranks

        pr, ref = unpermute_ranks(pr, perm), unpermute_ranks(ref, perm)

    report = dict(
        variant=args.variant, n=g.n, m=g.m, device=name, plan=ps,
        iterations=int(r.iterations), sweeps=r.sweeps, err=float(r.err),
        wall_s=wall, l1=l1_norm(pr, ref), oracle_iterations=it_seq,
        top5=np.argsort(pr)[::-1][:5].tolist(), launches=launches, pr=pr,
    )
    print(f"variant={args.variant}: iterations={report['iterations']} "
          f"err={report['err']:.2e} wall={wall:.3f}s")
    print(f"L1 vs sequential(1e-12, {it_seq} iters): {report['l1']:.3e}")
    print(f"top-5 ranks: {report['top5']}")
    print("kernel launches: " + " ".join(f"{k}={n}" for k, n in launches.items()))
    if args.ckpt:
        # the partition count baked into the bundle (1 when unpartitioned),
        # not --threads: a reshard on load must not assume a layout the
        # solve never used
        p = bundle_partitions(bundle)
        SolverCheckpoint(pr=pr, round=report["iterations"], n=g.n, p=p).save(args.ckpt)
        path = args.ckpt if args.ckpt.endswith(".npz") else args.ckpt + ".npz"
        report.update(ckpt=path, ckpt_p=p)
        print(f"checkpointed to {path} (p={p})")
    return report


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
