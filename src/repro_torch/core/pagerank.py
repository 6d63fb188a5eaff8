"""Vertex-centric PageRank variants of the paper on the port's engine.

Each variant is a **sweep** plus a **schedule** (plus the Alg-5
perforation transform for the ``_opt`` forms), solved by
:func:`repro_torch.core.solver.solve`:

* ``sequential``  — the numpy float64 Jacobi oracle (paper baseline).
* ``barrier``     — Alg 1: vertex-centric sweep, barrier schedule.
* ``barrier_opt`` — Alg 1 + perforation.
* ``nosync``      — Alg 3: partition sweeps on the nosync schedule, each
                    reading the freshest ranks.
* ``nosync_opt``  — Alg 3 + perforation.

These sweeps were never Pallas kernels in the reference, so they are plain
torch ops: a gather and a ``segment_reduce`` sum over the dst-sorted
in-CSR.  The sum runs in a fixed order on every device (``index_add_``
would add with atomics on the card, and change the iteration count from
run to run), as the reference's ``segment_sum`` does.  Weighted/biased
graphs are honoured with a ``None`` fast path: unweighted graphs run no
extra multiply.  The blocked kernel variants live in
``repro_torch.kernels.spmv.ops``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.solver import (
    DEFAULT_DAMPING,
    PageRankResult,
    barrier_schedule,
    nosync_schedule,
    perforation,
    register_variant,
    solve,
)
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph, inv_out_and_dangling

__all__ = [
    "DEFAULT_DAMPING",
    "PageRankResult",
    "DeviceGraph",
    "PartitionedGraph",
    "pagerank_numpy",
    "l1_norm",
    "pagerank_barrier",
    "pagerank_barrier_opt",
    "pagerank_nosync",
]


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _opt_tensor(x, dtype, device):
    return None if x is None else _tensor(x, dtype, device)


# ---------------------------------------------------------------------------
# Device-side graph bundles
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceGraph:
    """dst-sorted in-CSR on the device + degree info (vertex-centric
    variants).

    ``weights``/``bias`` mirror the host graph's optional per-edge weights
    and per-vertex teleport-bias multiplier (``None`` = unweighted fast
    path)."""

    n: int
    src: torch.Tensor  # (m,) int64 — sorted by dst
    in_ptr: torch.Tensor  # (n+1,) int64 — in-edges of v are in_ptr[v]:in_ptr[v+1]
    inv_out: torch.Tensor  # (n,) — 1/outdeg, 0 for dangling
    dangling: torch.Tensor  # (n,) float mask of outdeg==0 vertices
    weights: torch.Tensor | None = None  # (m,) per-edge weight, dst-sorted
    bias: torch.Tensor | None = None  # (n,) base multiplier

    @classmethod
    def from_graph(cls, g: Graph, device=None,
                   dtype=torch.float32) -> "DeviceGraph":
        dev = resolve_device(device)
        inv, dang = inv_out_and_dangling(g.out_degree)
        return cls(
            n=g.n,
            src=_tensor(g.src, torch.int64, dev),
            in_ptr=_tensor(g.in_ptr, torch.int64, dev),
            inv_out=_tensor(inv, dtype, dev),
            dangling=_tensor(dang, dtype, dev),
            weights=_opt_tensor(g.weights, dtype, dev),
            bias=_opt_tensor(g.bias, dtype, dev),
        )


@dataclasses.dataclass
class PartitionedGraph:
    """Static vertex partitions with padded per-partition edge lists (the
    paper's static load allocation, §4.1): every partition owns ``vp``
    contiguous vertices and a fixed-capacity edge buffer."""

    n: int
    p: int
    vp: int  # vertices per partition
    n_pad: int
    src_pad: torch.Tensor  # (p, cap) int64 global src ids (0 where invalid)
    seg_ptr: torch.Tensor  # (p, vp+1) int64 local in-CSR offsets into row i
    emask: torch.Tensor  # (p, cap) dtype — 1 for real edges
    inv_out: torch.Tensor  # (n_pad,)
    dangling: torch.Tensor  # (n_pad,)
    w_pad: torch.Tensor | None = None  # (p, cap) per-edge weight (0 = padding)
    bias_pad: torch.Tensor | None = None  # (n_pad,) base multiplier (0 padding)

    @property
    def edge_mult(self) -> torch.Tensor:
        """Effective per-edge multiplier: weights when present, else the
        {0,1} validity mask — sweeps multiply by exactly one of the two."""
        return self.emask if self.w_pad is None else self.w_pad

    @classmethod
    def from_graph(cls, g: Graph, p: int, device=None,
                   dtype=torch.float32) -> "PartitionedGraph":
        dev = resolve_device(device)
        vp = -(-g.n // p)
        n_pad = vp * p
        bounds = np.arange(p + 1) * vp
        e_bounds = np.searchsorted(g.dst, bounds)
        cap = max(1, int(np.max(np.diff(e_bounds))))
        src_pad = np.zeros((p, cap), dtype=np.int64)
        in_ptr = np.concatenate([g.in_ptr, np.full(n_pad - g.n, g.m)])
        rows = np.arange(p)[:, None] * vp
        seg_ptr = in_ptr[rows + np.arange(vp + 1)] - in_ptr[rows]
        emask = np.zeros((p, cap), dtype=np.float64)
        w_pad = np.zeros((p, cap), dtype=np.float64) if g.weights is not None else None
        for i in range(p):
            e0, e1 = e_bounds[i], e_bounds[i + 1]
            k = e1 - e0
            src_pad[i, :k] = g.src[e0:e1]
            emask[i, :k] = 1.0
            if w_pad is not None:
                w_pad[i, :k] = g.weights[e0:e1]
        inv, dang = inv_out_and_dangling(g.out_degree, n_pad)
        bias_pad = None
        if g.bias is not None:
            bias_pad = np.zeros(n_pad, dtype=np.float64)
            bias_pad[:g.n] = g.bias
        return cls(
            n=g.n,
            p=p,
            vp=vp,
            n_pad=n_pad,
            src_pad=_tensor(src_pad, torch.int64, dev),
            seg_ptr=_tensor(seg_ptr, torch.int64, dev),
            emask=_tensor(emask, dtype, dev),
            inv_out=_tensor(inv, dtype, dev),
            dangling=_tensor(dang, dtype, dev),
            w_pad=_opt_tensor(w_pad, dtype, dev),
            bias_pad=_opt_tensor(bias_pad, dtype, dev),
        )


# ---------------------------------------------------------------------------
# Sequential oracle (numpy, float64)
# ---------------------------------------------------------------------------


def pagerank_numpy(
    g: Graph,
    d: float = DEFAULT_DAMPING,
    threshold: float = 1e-12,
    max_iter: int = 10_000,
    handle_dangling: bool = False,
    pr0: np.ndarray | None = None,
) -> tuple[np.ndarray, int]:
    """Sequential Jacobi PageRank — the paper's baseline & Lemma-2 reference,
    and the weighted float64 oracle: ``pr = base·bias + d·Σ w·pr(src)/outdeg(src)``.
    ``pr0`` seeds the iteration (default uniform ``1/n``).

    The per-dst sums use ``np.bincount``, which adds in edge order as the
    reference's ``np.add.at`` does — bit-identical results — and is far
    faster on older numpy at full dataset size."""
    n = g.n
    inv_out = np.where(g.out_degree > 0, 1.0 / np.maximum(g.out_degree, 1), 0.0)
    base = (1.0 - d) / n
    base_vec = base if g.bias is None else base * g.bias
    pr = (np.full(n, 1.0 / n) if pr0 is None
          else np.asarray(pr0, dtype=np.float64).copy())
    for it in range(1, max_iter + 1):
        contrib = (pr * inv_out)[g.src]
        if g.weights is not None:
            contrib = contrib * g.weights
        acc = np.bincount(g.dst, weights=contrib, minlength=n)
        new = base_vec + d * acc
        if handle_dangling:
            new = new + d * pr[g.out_degree == 0].sum() / n
        err = np.abs(new - pr).max()
        pr = new
        if err <= threshold:
            return pr, it
    return pr, max_iter


def _numpy64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def l1_norm(pr_a, pr_b) -> float:
    """Paper Fig 5/6 metric: sum of per-vertex rank differences (tensors on
    any device, or arrays)."""
    return float(np.abs(_numpy64(pr_a) - _numpy64(pr_b)).sum())


def _warm(pr0, size: int, dtype, device):
    """Warm start as a ``(size,)`` tensor: the ``(n,)`` host vector,
    zero-padded."""
    padded = np.zeros(size, dtype=np.float64)
    vec = np.asarray(pr0, dtype=np.float64)
    padded[:vec.shape[0]] = vec
    return _tensor(padded, dtype, device)


# ---------------------------------------------------------------------------
# Alg 1 — Barrier (Jacobi) and Alg 5 — Barrier-Opt (perforated Jacobi)
# ---------------------------------------------------------------------------


def _pagerank_barrier(dg: DeviceGraph, *, d, threshold, max_iter,
                      handle_dangling, perforate, pr0) -> PageRankResult:
    n = dg.n
    dtype = dg.inv_out.dtype
    base = (1.0 - d) / n
    base_vec = base if dg.bias is None else base * dg.bias

    def sweep(pr):
        contrib = (pr * dg.inv_out)[dg.src]
        if dg.weights is not None:
            contrib = contrib * dg.weights
        acc = torch.segment_reduce(contrib, "sum", offsets=dg.in_ptr)
        new = base_vec + d * acc
        if handle_dangling:
            new = new + d * torch.sum(pr * dg.dangling) / n
        return new

    transforms = (perforation(threshold),) if perforate else ()
    step = barrier_schedule(sweep, transforms)
    init = (torch.full((n,), 1.0 / n, dtype=dtype, device=dg.inv_out.device)
            if pr0 is None else _warm(pr0, n, dtype, dg.inv_out.device))
    return solve(step, init, threshold=threshold, max_iter=max_iter,
                 track_frozen=perforate)


def pagerank_barrier(
    dg: DeviceGraph,
    d: float = DEFAULT_DAMPING,
    threshold: float = 1e-8,
    max_iter: int = 10_000,
    handle_dangling: bool = False,
    pr0=None,
) -> PageRankResult:
    return _pagerank_barrier(dg, d=d, threshold=threshold, max_iter=max_iter,
                             handle_dangling=handle_dangling, perforate=False,
                             pr0=pr0)


def pagerank_barrier_opt(
    dg: DeviceGraph,
    d: float = DEFAULT_DAMPING,
    threshold: float = 1e-8,
    max_iter: int = 10_000,
    handle_dangling: bool = False,
    pr0=None,
) -> PageRankResult:
    return _pagerank_barrier(dg, d=d, threshold=threshold, max_iter=max_iter,
                             handle_dangling=handle_dangling, perforate=True,
                             pr0=pr0)


# ---------------------------------------------------------------------------
# Alg 3 — No-Sync (barrier-free; fresh in-iteration reads, single pr array)
# ---------------------------------------------------------------------------


def pagerank_nosync(
    pg: PartitionedGraph,
    d: float = DEFAULT_DAMPING,
    threshold: float = 1e-8,
    max_iter: int = 10_000,
    perforate: bool = False,
    thread_level: bool = True,
    handle_dangling: bool = False,
    pr0=None,
) -> PageRankResult:
    n, vp = pg.n, pg.vp
    dtype = pg.inv_out.dtype
    base = (1.0 - d) / n
    emask = pg.edge_mult

    def sweep(i, pr, dmass):
        # emask is the effective per-edge multiplier: {0,1} validity on
        # unweighted graphs, per-edge weights (0 on padding) on weighted ones
        contrib = (pr * pg.inv_out)[pg.src_pad[i]] * emask[i]
        acc = torch.segment_reduce(contrib, "sum", offsets=pg.seg_ptr[i])
        if pg.bias_pad is None:
            return base + d * acc + dmass
        return base * pg.bias_pad[i * vp:(i + 1) * vp] + d * acc + dmass

    def dangling_mass(pr):
        # snapshot at iteration start (not per partition) — same fixed point
        if handle_dangling:
            return d * torch.sum(pr * pg.dangling) / n
        return 0.0

    transforms = (perforation(threshold),) if perforate else ()
    step = nosync_schedule(
        sweep, p=pg.p, vp=vp, threshold=threshold,
        transforms=transforms, thread_level=thread_level,
        prologue=dangling_mass,
    )
    dev = pg.inv_out.device
    # padding slots start at 1/n cold and 0 warm; their first sweep writes
    # base + dmass (they have no in-edges) and they are sliced off on return
    init = (torch.full((pg.n_pad,), 1.0 / n, dtype=dtype, device=dev)
            if pr0 is None else _warm(pr0, pg.n_pad, dtype, dev))
    r = solve(step, init, n_units=pg.p, threshold=threshold,
              max_iter=max_iter, track_frozen=perforate)
    return r._replace(pr=r.pr[:n])


# ---------------------------------------------------------------------------
# Registry entries
# ---------------------------------------------------------------------------


def _run_kw(kw: dict) -> dict:
    """Solver kwargs every run fn understands (drops build-only opts)."""
    return {k: kw[k] for k in ("d", "threshold", "max_iter", "handle_dangling",
                               "pr0")
            if k in kw}


def _sequential_run(g, **kw):
    pr, it = pagerank_numpy(g, **_run_kw(kw))
    return PageRankResult(pr, it, 0.0)


register_variant(
    "sequential", build=lambda g, **_: g, run=_sequential_run,
    description="numpy float64 Jacobi oracle (paper baseline)",
    layout="host", backend="numpy", schedule="sequential",
)
register_variant(
    "barrier",
    build=lambda g, device=None, **_: DeviceGraph.from_graph(g, device),
    run=lambda b, **kw: pagerank_barrier(b, **_run_kw(kw)),
    description="Alg 1: Jacobi power iteration (vertex-centric)",
    layout="device", backend="torch", schedule="barrier",
)
register_variant(
    "barrier_opt",
    build=lambda g, device=None, **_: DeviceGraph.from_graph(g, device),
    run=lambda b, **kw: pagerank_barrier_opt(b, **_run_kw(kw)),
    description="Alg 1 + Alg 5 loop perforation",
    layout="device", backend="torch", schedule="barrier",
)
register_variant(
    "nosync",
    build=lambda g, threads=56, device=None, **_: PartitionedGraph.from_graph(
        g, p=threads, device=device),
    run=lambda b, thread_level=True, **kw: pagerank_nosync(
        b, thread_level=thread_level, **_run_kw(kw)),
    description="Alg 3: barrier-free fresh-read partition sweeps",
    options=("thread_level",),
    layout="partitioned", backend="torch", schedule="nosync",
)
register_variant(
    "nosync_opt",
    build=lambda g, threads=56, device=None, **_: PartitionedGraph.from_graph(
        g, p=threads, device=device),
    run=lambda b, thread_level=True, **kw: pagerank_nosync(
        b, perforate=True, thread_level=thread_level, **_run_kw(kw)),
    description="Alg 3 + Alg 5 loop perforation",
    options=("thread_level",),
    layout="partitioned", backend="torch", schedule="nosync",
)
