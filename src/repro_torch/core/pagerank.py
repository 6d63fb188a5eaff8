"""Vertex-centric PageRank variants of the paper on the port's engine.

Each variant is a **sweep** plus a **schedule** (plus the Alg-5
perforation transform for the ``_opt`` forms), solved by
:func:`repro_torch.core.solver.solve`:

* ``sequential``        — the numpy float64 Jacobi oracle (paper baseline).
* ``barrier``           — Alg 1: vertex-centric sweep, barrier schedule.
* ``barrier_edge``      — Alg 2: 3-phase edge-centric sweep (phase I
                          scatters per-edge contributions through
                          ``offsetList``, phase II segment-sums them).
* ``barrier_opt``       — Alg 1 + perforation.
* ``barrier_identical`` — STIC-D identical-node sweep: vertices with equal
                          in-neighbour sets share one computation.
* ``nosync``            — Alg 3: partition sweeps on the nosync schedule,
                          each reading the freshest ranks.
* ``nosync_opt``        — Alg 3 + perforation.
* ``nosync_adaptive``   — Alg 3 on the residual-adaptive schedule:
                          partitions swept in descending residual-bound
                          order, those certified converged skipped.
* ``barrier_sticd``, ``nosync_sticd`` — the STIC-D plan stage (Alg 4:
                          identical, chain and dead vertices pruned, chains
                          contracted into a weighted, biased core) in front
                          of ``barrier`` and ``nosync``.

These sweeps were never Pallas kernels in the reference, so they are plain
torch ops: a gather and a ``segment_reduce`` sum over a dst-sorted edge
list.  The sum runs in a fixed order on every device (``index_add_``
would add with atomics on the card, and change the iteration count from
run to run), as the reference's ``segment_sum`` does.  Weighted/biased
graphs are honoured with a ``None`` fast path: unweighted graphs run no
extra multiply.  The blocked kernel variants live in
``repro_torch.kernels.spmv.ops``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.solver import (
    DEFAULT_DAMPING,
    PageRankResult,
    barrier_schedule,
    nosync_schedule,
    adaptive_schedule,
    perforation,
    plan_build,
    plan_run,
    register_variant,
    solve,
)
from repro_torch.device import resolve_device, to_device
from repro_torch.graphs.csr import Graph, inv_out_and_dangling

__all__ = [
    "DEFAULT_DAMPING",
    "PageRankResult",
    "DeviceGraph",
    "EdgeCentricGraph",
    "IdenticalNodePlan",
    "PartitionedGraph",
    "partition_gain_matrix",
    "vertex_gain_matrix",
    "pagerank_numpy",
    "l1_norm",
    "pagerank_barrier",
    "pagerank_barrier_edge",
    "pagerank_barrier_opt",
    "pagerank_identical",
    "pagerank_nosync",
    "pagerank_nosync_adaptive",
]


def _opt_tensor(x, dtype, device):
    return None if x is None else to_device(x, dtype, device)


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
            src=to_device(g.src, torch.int64, dev),
            in_ptr=to_device(g.in_ptr, torch.int64, dev),
            inv_out=to_device(inv, dtype, dev),
            dangling=to_device(dang, dtype, dev),
            weights=_opt_tensor(g.weights, dtype, dev),
            bias=_opt_tensor(g.bias, dtype, dev),
        )


@dataclasses.dataclass
class EdgeCentricGraph:
    """Alg-2 layout: out-CSR scatter slots (``offsetList``) + the dst-sorted
    segments of phase II.

    Per-edge weights stay in dst-sorted order: phase II scales the
    scattered contribution list, which keeps phase I a pure permutation."""

    n: int
    m: int
    src_by_src: torch.Tensor  # (m,) int64 — src id of each edge, src-sorted
    edge_slot: torch.Tensor  # (m,) int64 — offsetList: slot in dst-sorted order
    in_ptr: torch.Tensor  # (n+1,) int64 — phase II segments over the slots
    inv_out: torch.Tensor  # (n,)
    dangling: torch.Tensor  # (n,)
    weights: torch.Tensor | None = None  # (m,) dst-sorted per-edge weight
    bias: torch.Tensor | None = None  # (n,) base multiplier

    @classmethod
    def from_graph(cls, g: Graph, device=None,
                   dtype=torch.float32) -> "EdgeCentricGraph":
        dev = resolve_device(device)
        out_ptr, _, edge_slot = g.out_csr()
        src_ids = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(out_ptr))
        inv, dang = inv_out_and_dangling(g.out_degree)
        return cls(
            n=g.n,
            m=g.m,
            src_by_src=to_device(src_ids, torch.int64, dev),
            edge_slot=to_device(edge_slot, torch.int64, dev),
            in_ptr=to_device(g.in_ptr, torch.int64, dev),
            inv_out=to_device(inv, dtype, dev),
            dangling=to_device(dang, dtype, dev),
            weights=_opt_tensor(g.weights, dtype, dev),
            bias=_opt_tensor(g.bias, dtype, dev),
        )


def _edge_gains(g: Graph) -> np.ndarray:
    """``|w_uv| / outdeg_u`` of every edge, dst-sorted, in float64."""
    out_degree = np.asarray(g.out_degree)
    inv_out = np.where(out_degree > 0, 1.0 / np.maximum(out_degree, 1), 0.0)
    vals = inv_out[np.asarray(g.src)]
    if g.weights is not None:
        vals = vals * np.asarray(g.weights)
    return np.abs(vals)


def partition_gain_matrix(g: Graph, unit: int, p: int) -> np.ndarray:
    """Cross-unit max-norm gain matrix of one PageRank sweep,

        G[i, j] = max_{v in unit i}  Σ_{u in unit j, (u,v) ∈ E}  |w_uv|/outdeg_u ,

    for the contiguous units ``[i·unit, (i+1)·unit)`` (partitions, or dst
    blocks of the blocked layout).  If every rank in unit ``j`` moved by at
    most ``Δ_j`` this round, a fresh sweep of unit ``i`` moves any of its
    ranks by at most ``d·Σ_j G[i,j]·Δ_j``: the certificate behind the
    adaptive schedules.  Callers add the dangling term (``|dangling ∩ j|/n``
    per column) when running with ``handle_dangling``.

    Host numpy, float64, dense ``(p, p)``: quadratic in the block count,
    which is why the blocked build computes it only on request."""
    src = np.asarray(g.src)
    dst = np.asarray(g.dst).astype(np.int64)
    gain = np.zeros((p, p), dtype=np.float64)
    if src.size:
        # per-(dst vertex, src unit) sums, then a max over each dst unit's
        # vertices
        keys = dst * p + (src.astype(np.int64) // unit)
        uniq, inv_idx = np.unique(keys, return_inverse=True)
        sums = np.bincount(inv_idx, weights=_edge_gains(g), minlength=uniq.size)
        np.maximum.at(gain, ((uniq // p) // unit, uniq % p), sums)
    return gain


def vertex_gain_matrix(g: Graph, unit: int, p: int, n_pad: int) -> np.ndarray:
    """Per-vertex cross-unit gain of one PageRank sweep,

        S[v, j] = Σ_{u in unit j, (u,v) ∈ E}  |w_uv|/outdeg_u ,

    shape ``(n_pad, p)``: the row-resolved :func:`partition_gain_matrix`
    (which max-reduces S's rows over each dst unit).  The partitioned
    adaptive schedule carries a per-vertex bound inflated by ``d·S@Δ`` and
    takes the max over a partition's rows after accumulation, much tighter
    than the pre-maxed ``(p, p)`` certificate.  Host numpy, float64; the
    sums run in edge order (``np.bincount``), as the reference's
    ``np.add.at`` does, so the matrix is the reference's bit for bit."""
    src = np.asarray(g.src).astype(np.int64)
    dst = np.asarray(g.dst).astype(np.int64)
    flat = np.bincount(dst * p + src // unit, weights=_edge_gains(g),
                       minlength=n_pad * p)
    return flat.reshape(n_pad, p)


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
    gain: torch.Tensor | None = None  # (n_pad, p) per-vertex sweep gain

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
            src_pad=to_device(src_pad, torch.int64, dev),
            seg_ptr=to_device(seg_ptr, torch.int64, dev),
            emask=to_device(emask, dtype, dev),
            inv_out=to_device(inv, dtype, dev),
            dangling=to_device(dang, dtype, dev),
            w_pad=_opt_tensor(w_pad, dtype, dev),
            bias_pad=_opt_tensor(bias_pad, dtype, dev),
            # p is thread-scale, so the (n_pad, p) certificate costs about
            # one rank vector a partition: always carried, as in the
            # reference, so every partitioned bundle runs nosync_adaptive
            gain=to_device(vertex_gain_matrix(g, vp, p, n_pad), dtype, dev),
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


def _start(pr0, n: int, size: int, dtype, device):
    """The ``(size,)`` start vector: uniform ``1/n`` cold, or the ``(n,)``
    host warm start ``pr0`` zero-padded.  Padding slots (``size > n``)
    have no in-edges: their first sweep writes ``base + dmass``, and they
    are sliced off on return."""
    if pr0 is None:
        return torch.full((size,), 1.0 / n, dtype=dtype, device=device)
    padded = np.zeros(size, dtype=np.float64)
    vec = np.asarray(pr0, dtype=np.float64)
    padded[:vec.shape[0]] = vec
    return to_device(padded, dtype, device)


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
    init = _start(pr0, n, n, dtype, dg.inv_out.device)
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
# Alg 2 — Barrier-Edge (3-phase, scatter + gather)
# ---------------------------------------------------------------------------


def pagerank_barrier_edge(
    eg: EdgeCentricGraph,
    d: float = DEFAULT_DAMPING,
    threshold: float = 1e-8,
    max_iter: int = 10_000,
    handle_dangling: bool = False,
    pr0=None,
) -> PageRankResult:
    n = eg.n
    dtype = eg.inv_out.dtype
    dev = eg.inv_out.device
    base = (1.0 - d) / n
    base_vec = base if eg.bias is None else base * eg.bias

    def sweep(pr):
        # Phase I: every vertex scatters its contribution into its
        # out-edges' slots of the dst-ordered list (Alg 2 l.9-12).  The
        # slots are a permutation, so the assignment is deterministic.
        slots = torch.empty(eg.m, dtype=dtype, device=dev)
        slots[eg.edge_slot] = (pr * eg.inv_out)[eg.src_by_src]
        if eg.weights is not None:
            slots = slots * eg.weights
        # Phase II: gather per destination, a fixed-order segment sum
        # (Alg 2 l.16-23).  Phase III, the error fold, is the engine's.
        acc = torch.segment_reduce(slots, "sum", offsets=eg.in_ptr)
        new = base_vec + d * acc
        if handle_dangling:
            new = new + d * torch.sum(pr * eg.dangling) / n
        return new

    init = _start(pr0, n, n, dtype, dev)
    return solve(barrier_schedule(sweep), init, threshold=threshold,
                 max_iter=max_iter)


# ---------------------------------------------------------------------------
# Alg 3 — No-Sync (barrier-free; fresh in-iteration reads, single pr array)
# ---------------------------------------------------------------------------


def _partition_sweep(pg: PartitionedGraph, d: float, handle_dangling: bool):
    """``(sweep, dangling_mass)`` of the partitioned schedules: partition
    ``i``'s proposed ``(vp,)`` block from the current vector, and the
    dangling term snapshotted once per iteration."""
    n, vp = pg.n, pg.vp
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

    return sweep, dangling_mass


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
    sweep, dangling_mass = _partition_sweep(pg, d, handle_dangling)
    transforms = (perforation(threshold),) if perforate else ()
    step = nosync_schedule(
        sweep, p=pg.p, vp=pg.vp, threshold=threshold,
        transforms=transforms, thread_level=thread_level,
        prologue=dangling_mass,
    )
    init = _start(pr0, pg.n, pg.n_pad, pg.inv_out.dtype, pg.inv_out.device)
    r = solve(step, init, n_units=pg.p, threshold=threshold,
              max_iter=max_iter, track_frozen=perforate)
    return r._replace(pr=r.pr[:pg.n])


def pagerank_nosync_adaptive(
    pg: PartitionedGraph,
    d: float = DEFAULT_DAMPING,
    threshold: float = 1e-8,
    max_iter: int = 10_000,
    handle_dangling: bool = False,
    pr0=None,
) -> PageRankResult:
    """Alg-3 partition sweeps on the residual-adaptive schedule
    (:func:`repro_torch.core.solver.adaptive_schedule`): partitions swept in
    descending residual-bound order, partitions whose certified per-vertex
    bound sits at or below ``threshold / 2`` skipped.  Same fixed point as
    ``nosync``."""
    if pg.gain is None:
        raise ValueError(
            "PartitionedGraph bundle lacks the gain matrix required by the "
            "adaptive schedule (rebuild with PartitionedGraph.from_graph)")
    sweep, dangling_mass = _partition_sweep(pg, d, handle_dangling)
    gain = pg.gain
    if handle_dangling:
        # a unit Δ in partition j also moves the redistributed dangling mass
        # by ≤ d·|dangling ∩ j|·Δ/n, uniformly across every vertex
        dang_counts = pg.dangling.reshape(pg.p, pg.vp).sum(dim=1)
        gain = gain + (dang_counts / pg.n)[None, :]
    step = adaptive_schedule(sweep, p=pg.p, vp=pg.vp, threshold=threshold,
                             d=d, gain=gain, prologue=dangling_mass)
    aux0 = torch.full((pg.n_pad,), math.inf, dtype=pg.inv_out.dtype,
                      device=pg.inv_out.device)
    init = _start(pr0, pg.n, pg.n_pad, pg.inv_out.dtype, pg.inv_out.device)
    r = solve(step, init, n_units=pg.p, threshold=threshold,
              max_iter=max_iter, aux0=aux0)
    return r._replace(pr=r.pr[:pg.n])


# ---------------------------------------------------------------------------
# STIC-D identical-node variant
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IdenticalNodePlan:
    """Preprocessing of ``barrier_identical``.

    ``cls_of[u]`` is the class of u's identical in-neighbour set
    (:meth:`repro_torch.graphs.csr.Graph.in_neighbor_classes`; on weighted or
    biased graphs the key covers weights and bias too).  A class's
    representative is its first member, and only the edges into
    representatives are kept; each sweep sums them per class and broadcasts
    the class's rank to its members."""

    n: int
    n_classes: int
    cls_of: torch.Tensor  # (n,) int64 — class id per vertex
    src: torch.Tensor  # kept edges (into representatives), dst-sorted
    cls_ptr: torch.Tensor  # (n_classes+1,) int64 — kept edges of each class
    inv_out: torch.Tensor
    dangling: torch.Tensor
    weights: torch.Tensor | None = None  # kept-edge weights
    bias: torch.Tensor | None = None  # (n,) base multiplier

    @classmethod
    def from_graph(cls, g: Graph, device=None,
                   dtype=torch.float32) -> "IdenticalNodePlan":
        dev = resolve_device(device)
        cls_of = g.in_neighbor_classes()
        n_classes = int(cls_of.max()) + 1 if g.n else 0
        # classes are numbered by first appearance, so a class's first
        # member, its representative, is the first index of its id
        rep = np.unique(cls_of, return_index=True)[1]
        keep = rep[cls_of[g.dst]] == g.dst  # only edges into representatives
        # the kept edges are dst-sorted and representatives rise with their
        # class id, so the class ids of the kept edges never decrease: one
        # segment a class (empty where its representative has no in-edge)
        dst_class = cls_of[g.dst[keep]]
        cls_ptr = np.zeros(n_classes + 1, dtype=np.int64)
        np.cumsum(np.bincount(dst_class, minlength=n_classes), out=cls_ptr[1:])
        inv, dang = inv_out_and_dangling(g.out_degree)
        return cls(
            n=g.n,
            n_classes=n_classes,
            cls_of=to_device(cls_of, torch.int64, dev),
            src=to_device(g.src[keep], torch.int64, dev),
            cls_ptr=to_device(cls_ptr, torch.int64, dev),
            inv_out=to_device(inv, dtype, dev),
            dangling=to_device(dang, dtype, dev),
            weights=(None if g.weights is None
                     else to_device(g.weights[keep], dtype, dev)),
            bias=_opt_tensor(g.bias, dtype, dev),
        )


def pagerank_identical(
    plan: IdenticalNodePlan,
    d: float = DEFAULT_DAMPING,
    threshold: float = 1e-8,
    max_iter: int = 10_000,
    handle_dangling: bool = False,
    pr0=None,
) -> PageRankResult:
    n = plan.n
    dtype = plan.inv_out.dtype
    dev = plan.inv_out.device
    base = (1.0 - d) / n
    base_vec = base if plan.bias is None else base * plan.bias

    def sweep(pr):
        contrib = (pr * plan.inv_out)[plan.src]
        if plan.weights is not None:
            contrib = contrib * plan.weights
        acc_cls = torch.segment_reduce(contrib, "sum", offsets=plan.cls_ptr)
        new = base_vec + d * acc_cls[plan.cls_of]  # one sum a class, broadcast
        if handle_dangling:
            # dangling mass is uniform across vertices, so identical-in-
            # neighbour classes stay identical under redistribution
            new = new + d * torch.sum(pr * plan.dangling) / n
        return new

    init = _start(pr0, n, n, dtype, dev)
    return solve(barrier_schedule(sweep), init, threshold=threshold,
                 max_iter=max_iter)


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
    "barrier_edge",
    build=lambda g, device=None, **_: EdgeCentricGraph.from_graph(g, device),
    run=lambda b, **kw: pagerank_barrier_edge(b, **_run_kw(kw)),
    description="Alg 2: 3-phase edge-centric scatter/gather",
    layout="edge", backend="torch", schedule="barrier",
)
register_variant(
    "barrier_opt",
    build=lambda g, device=None, **_: DeviceGraph.from_graph(g, device),
    run=lambda b, **kw: pagerank_barrier_opt(b, **_run_kw(kw)),
    description="Alg 1 + Alg 5 loop perforation",
    layout="device", backend="torch", schedule="barrier",
)
register_variant(
    "barrier_identical",
    build=lambda g, device=None, **_: IdenticalNodePlan.from_graph(g, device),
    run=lambda b, **kw: pagerank_identical(b, **_run_kw(kw)),
    description="STIC-D identical-node sharing on the barrier schedule",
    layout="identical", backend="torch", schedule="barrier",
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
    "nosync_adaptive",
    build=lambda g, threads=56, device=None, **_: PartitionedGraph.from_graph(
        g, p=threads, device=device),
    run=lambda b, **kw: pagerank_nosync_adaptive(b, **_run_kw(kw)),
    description="Alg 3 + residual-adaptive order and certified partition skipping",
    layout="partitioned", backend="torch", schedule="adaptive",
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
# STIC-D plan stage (Alg 4) in front of the barrier and nosync solves:
# plan first, then build and partition the weighted, biased core.
register_variant(
    "barrier_sticd",
    build=plan_build("barrier"),
    run=plan_run,
    description="STIC-D plan (identical+chain+dead pruned, chains contracted) + Alg-1 core solve",
    layout="sticd_device", backend="torch", schedule="barrier",
)
register_variant(
    "nosync_sticd",
    build=plan_build("nosync"),
    run=plan_run,
    description="STIC-D plan + Alg-3 no-sync core solve (weighted core partitioned)",
    options=("thread_level",),
    layout="sticd_partitioned", backend="torch", schedule="nosync",
)
