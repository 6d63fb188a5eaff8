"""Batched multi-seed personalized PageRank (PPR) on the port's engine.

Personalized PageRank replaces the global uniform teleport ``1/n`` with a
per-query teleport distribution ``t`` (uniform over a user's seed
vertices):

    pr = (1-d)·t + d·AᵀD⁻¹·pr  [+ d·(dangling mass)·t]

The sweeps, schedules and the one convergence loop are the global
engine's with the rank state widened from ``(n,)`` to a batch of ``b``
rows sharing one graph bundle (:func:`batched_barrier_schedule`), so the
global builds are reused unchanged: ``ppr_barrier`` rides the
``DeviceGraph``, ``ppr_nosync`` the ``PartitionedGraph`` and
``ppr_blocked`` (↔ the reference's ``ppr_pallas``) the ``BlockedGraph``.
Per-row convergence lives in the engine too: ``perr`` has shape ``(b,)``
and the :func:`row_freeze` transform exits converged rows early.

Dangling mass goes back to the row's own teleport vector, which keeps the
fixed point linear in ``t``: a uniform teleport row reproduces the global
``handle_dangling`` fixed point.  A per-vertex bias scales the teleport
rows (``t_eff = t·bias``, :func:`bias_scaled`) and per-edge weights scale
each contribution inside every sweep.

Layout of the blocked state.  The reference keeps ``(n_blocks, b, block)``
so that one dst block is one contiguous VMEM panel.  The port's kernel
gathers per edge, and in that layout one edge's ``b`` values sit
``4·block`` bytes apart; the port keeps the state vertex-major,
``(n_blocks, block, b)``, so the ``b`` values of a source vertex are one
32 B sector at ``b = 8``.  The conversions live here and nowhere else:
:data:`BATCH_AXIS`, :data:`ROW_AXES`, :func:`blocked_rows`,
:func:`unblocked_rows`, :func:`write_blocked_row` and
:func:`read_blocked_row`.

The host helpers and the float64 oracle :func:`ppr_numpy` are numpy
copies of the reference's; the sweeps are torch ops that sum in a fixed
order (``segment_reduce`` over the in-CSR, never ``index_add_``), and the
blocked pass is the CUDA kernel :func:`repro_torch.kernels.spmv.gs_pass_multi`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pagerank import DeviceGraph, PartitionedGraph
from repro_torch.core.solver import (
    DEFAULT_DAMPING,
    PageRankResult,
    batched_barrier_schedule,
    nosync_schedule,
    register_variant,
    row_freeze,
    solve,
)
from repro_torch.graphs.csr import Graph
from repro_torch.kernels.spmv.kernel import gs_pass_multi, gs_pass_multi_max_batch
from repro_torch.kernels.spmv.ops import BlockedGraph

__all__ = [
    "BATCH_AXIS",
    "ROW_AXES",
    "normalize_seeds",
    "teleport_from_seeds",
    "teleport_from_seeds_like",
    "bias_scaled",
    "ppr_numpy",
    "make_batched_sweep",
    "make_batched_blocked_sweep",
    "blocked_rows",
    "unblocked_rows",
    "write_blocked_row",
    "read_blocked_row",
    "ppr_barrier",
    "ppr_nosync",
    "ppr_blocked",
]

# The blocked batched state is (n_blocks, block, b): batch last.
BATCH_AXIS = 2
ROW_AXES = (0, 1)


def normalize_seeds(seeds) -> tuple[tuple[int, ...], ...]:
    """Canonical batch form of a seeds spec.

    ``None`` → one uniform row; a bare int → one single-seed row; a flat
    sequence of ints → one multi-seed row; a sequence of those → one row
    each.  An empty row ``()`` means "uniform teleport" (a global-PageRank
    query).
    """
    if seeds is None:
        return ((),)
    if isinstance(seeds, (int, np.integer)):
        return ((int(seeds),),)
    rows = []
    flat_ints = all(isinstance(s, (int, np.integer)) for s in seeds)
    if flat_ints and len(seeds) > 0:
        return (tuple(int(s) for s in seeds),)
    for row in seeds:
        if isinstance(row, (int, np.integer)):
            rows.append((int(row),))
        else:
            rows.append(tuple(int(s) for s in row))
    return tuple(rows) if rows else ((),)


def teleport_from_seeds(seeds, n: int, n_pad: int | None = None,
                        dtype=np.float64) -> np.ndarray:
    """``(b, n_pad)`` row-stochastic teleport matrix from a seeds spec.

    Each row is uniform over its seed set (empty set → uniform over all
    ``n`` real vertices); padding columns are zero.  Seeds are sets: a
    repeated seed counts once."""
    rows = normalize_seeds(seeds)
    n_pad = n if n_pad is None else n_pad
    t = np.zeros((len(rows), n_pad), dtype=dtype)
    for i, row in enumerate(rows):
        if not row:
            t[i, :n] = 1.0 / max(n, 1)
            continue
        if min(row) < 0 or max(row) >= n:
            raise ValueError(f"seed vertex out of range [0, {n}): {row}")
        row = sorted(set(row))
        t[i, row] = 1.0 / len(row)
    return t


def teleport_from_seeds_like(teleport, n: int, n_pad: int) -> np.ndarray:
    """Pad an already-built ``(b, n)`` teleport matrix to ``(b, n_pad)``."""
    t = np.asarray(teleport, dtype=np.float64)
    if t.shape[1] == n_pad:
        return t
    assert t.shape[1] == n, (t.shape, n, n_pad)
    out = np.zeros((t.shape[0], n_pad), dtype=t.dtype)
    out[:, :n] = t
    return out


def bias_scaled(tele: np.ndarray, bias) -> np.ndarray:
    """Fold a per-vertex bias into teleport rows (``t_eff = t·bias``), the
    one place the PPR subsystem applies ``Graph.bias``.  ``tele`` may be a
    ``(b, n_pad)`` matrix or one ``(n_pad,)`` row; ``bias`` may be shorter
    than the padded width (padding columns carry no bias)."""
    if bias is None:
        return tele
    b = np.asarray(bias, dtype=tele.dtype)
    out = tele.copy()
    out[..., :b.shape[-1]] *= b
    return out


def _host(x):
    """A device tensor as a numpy array (``None`` stays ``None``)."""
    return None if x is None else x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Sequential oracle (numpy, float64) — batched Jacobi power iteration
# ---------------------------------------------------------------------------


def ppr_numpy(
    g: Graph,
    teleport: np.ndarray,
    d: float = DEFAULT_DAMPING,
    threshold: float = 1e-12,
    max_iter: int = 10_000,
    handle_dangling: bool = False,
) -> tuple[np.ndarray, int]:
    """Batched float64 PPR oracle; returns ``(pr (b, n), iterations)``.

    With a uniform teleport row this is :func:`pagerank_numpy` (teleport
    linearity).  Per-edge ``g.weights`` scale each contribution; ``g.bias``
    scales the teleport rows."""
    t = np.asarray(teleport, dtype=np.float64)
    b, n = t.shape
    assert n == g.n, f"teleport width {n} != graph n {g.n}"
    if g.bias is not None:
        t = t * g.bias[None, :]
    inv_out = np.where(g.out_degree > 0, 1.0 / np.maximum(g.out_degree, 1), 0.0)
    dang = (g.out_degree == 0).astype(np.float64)
    pr = t.copy()
    rows = np.arange(b)[:, None]
    for it in range(1, max_iter + 1):
        contrib = pr * inv_out[None, :]
        acc = np.zeros((b, n))
        vals = contrib[:, g.src]
        if g.weights is not None:
            vals = vals * g.weights[None, :]
        np.add.at(acc, (rows, g.dst[None, :]), vals)
        new = (1.0 - d) * t + d * acc
        if handle_dangling:
            new += d * (pr @ dang)[:, None] * t
        err = np.abs(new - pr).max()
        pr = new
        if err <= threshold:
            return pr, it
    return pr, max_iter


# ---------------------------------------------------------------------------
# ppr_barrier — batched vertex-centric Jacobi (DeviceGraph layout)
# ---------------------------------------------------------------------------


def make_batched_sweep(src, in_ptr, inv_out, dangling, weights=None, *,
                       n: int, d: float, handle_dangling: bool):
    """``sweep(pr (b,n), tele (b,n)) -> (b,n)``: one batched Eq.-(1)
    application over the dst-sorted in-CSR.  Shared by
    :func:`ppr_barrier` and the serving engine's torch backend.

    ``weights`` (dst-sorted per-edge, or ``None``) scales each
    contribution; a vertex bias is not applied here, callers fold it into
    the teleport rows first.  The gather is taken in the transposed
    ``(m, b)`` form so that one ``segment_reduce`` sums every row of the
    batch in a fixed order."""

    def sweep(pr, tele):
        contrib = (pr * inv_out).T[src]  # (m, b)
        if weights is not None:
            contrib = contrib * weights[:, None]
        acc = torch.segment_reduce(contrib, "sum", offsets=in_ptr).T  # (b, n)
        new = (1.0 - d) * tele + d * acc
        if handle_dangling:
            dmass = torch.sum(pr * dangling, dim=1, keepdim=True)
            new = new + d * dmass * tele
        return new

    return sweep


def ppr_barrier(
    dg: DeviceGraph,
    teleport,
    d: float = DEFAULT_DAMPING,
    threshold: float = 1e-8,
    max_iter: int = 10_000,
    handle_dangling: bool = False,
) -> PageRankResult:
    """Batched multi-seed PPR on the barrier schedule; ``pr`` is ``(b, n)``."""
    tele_np = bias_scaled(np.asarray(teleport, dtype=np.float64), _host(dg.bias))
    tele = torch.as_tensor(tele_np, dtype=dg.inv_out.dtype, device=dg.inv_out.device)
    sweep = make_batched_sweep(dg.src, dg.in_ptr, dg.inv_out, dg.dangling,
                               dg.weights, n=dg.n, d=d,
                               handle_dangling=handle_dangling)
    step = batched_barrier_schedule(lambda pr: sweep(pr, tele),
                                    transforms=(row_freeze(threshold),))
    return solve(step, tele, n_units=tele.shape[0], threshold=threshold,
                 max_iter=max_iter, track_frozen=True)


# ---------------------------------------------------------------------------
# ppr_nosync — batched partition sweeps, fresh in-iteration reads
# ---------------------------------------------------------------------------


def ppr_nosync(
    pg: PartitionedGraph,
    teleport,
    d: float = DEFAULT_DAMPING,
    threshold: float = 1e-8,
    max_iter: int = 10_000,
    thread_level: bool = True,
    handle_dangling: bool = False,
) -> PageRankResult:
    """Batched PPR on the Alg-3 no-sync schedule: partitions on the last
    axis of the ``(b, n_pad)`` state, each sweep reading every row's
    freshest ranks."""
    dev = pg.inv_out.device
    dtype = pg.inv_out.dtype
    tele_np = bias_scaled(teleport_from_seeds_like(teleport, pg.n, pg.n_pad),
                          _host(pg.bias_pad))
    tele = torch.as_tensor(tele_np, dtype=dtype, device=dev)
    vp = pg.vp
    emask = pg.edge_mult

    def sweep(i, pr, dmass):
        # dmass: (b, 1) per-row dangling snapshot from the prologue; emask
        # is {0,1} validity on unweighted graphs, per-edge weights else
        t_i = tele[:, i * vp:(i + 1) * vp]
        contrib = (pr * pg.inv_out).T[pg.src_pad[i]] * emask[i][:, None]  # (cap, b)
        acc = torch.segment_reduce(contrib, "sum", offsets=pg.seg_ptr[i]).T
        return (1.0 - d) * t_i + d * acc + dmass * t_i

    def dangling_mass(pr):
        if handle_dangling:
            return d * torch.sum(pr * pg.dangling, dim=1, keepdim=True)
        return torch.zeros((pr.shape[0], 1), dtype=dtype, device=dev)

    step = nosync_schedule(sweep, p=pg.p, vp=vp, threshold=threshold,
                           thread_level=thread_level, prologue=dangling_mass)
    r = solve(step, tele, n_units=pg.p, threshold=threshold, max_iter=max_iter)
    return r._replace(pr=r.pr[:, :pg.n])


# ---------------------------------------------------------------------------
# ppr_blocked — multi-row blocked Gauss–Seidel (BlockedGraph layout)
# ---------------------------------------------------------------------------


def blocked_rows(rows: np.ndarray, n_blocks: int, block: int) -> np.ndarray:
    """``(b, n?)`` row matrix → the vertex-major ``(n_blocks, block, b)``
    float32 state, zero-padded so padding vertices carry no mass."""
    padded = np.zeros((n_blocks * block, rows.shape[0]), dtype=np.float32)
    padded[:rows.shape[1]] = rows.T
    return padded.reshape(n_blocks, block, rows.shape[0])


def unblocked_rows(state: torch.Tensor, n: int) -> torch.Tensor:
    """``(n_blocks, block, b)`` state → the ``(b, n)`` rows, contiguous."""
    return state.reshape(-1, state.shape[BATCH_AXIS])[:n].T.contiguous()


def write_blocked_row(state: torch.Tensor, slot: int, row: np.ndarray) -> None:
    """Write one ``(n?,)`` host row into batch slot ``slot`` of ``state``."""
    n_blocks, block = state.shape[:2]
    col = blocked_rows(np.asarray(row)[None], n_blocks, block)[..., 0]
    state[:, :, slot] = torch.as_tensor(col, device=state.device)


def read_blocked_row(state: torch.Tensor, slot: int, n: int) -> np.ndarray:
    """Batch slot ``slot`` of ``state`` as a float64 ``(n,)`` host row."""
    return state[:, :, slot].reshape(-1)[:n].double().cpu().numpy()


def make_batched_blocked_sweep(bg: BlockedGraph, *, d: float,
                               handle_dangling: bool):
    """``sweep(pr, tele, frozen_rows) -> new``: one batched blocked
    Gauss–Seidel pass of the vertex-major state, on the
    :func:`gs_pass_multi` kernel.  The one home of the PPR base formula
    ``tele·((1-d) + d·dmass_row)`` on this backend, shared by
    :func:`ppr_blocked` and the serving engine's kernel backend: the
    per-row coefficient ``(1-d) + d·dmass_row`` is formed here on the card
    and the kernel multiplies it into ``tele`` in its epilogue.
    ``frozen_rows`` is a bool ``(b,)`` device mask of rows held through
    the pass.  ``tele`` must already carry any vertex bias
    (:func:`bias_scaled`).

    Any number of rows: a batch wider than one launch takes
    (:func:`gs_pass_multi_max_batch`) goes through in chunks of rows, each
    launched on every pass.  Rows are independent within a pass, so the
    chunks change no row and no pass count."""
    dangling = bg.dangling.unsqueeze(BATCH_AXIS)
    per_launch = gs_pass_multi_max_batch(bg.block, bg.vmask.device)

    def sweep(pr, tele, frozen_rows):
        b = pr.shape[BATCH_AXIS]
        if handle_dangling:
            dmass = torch.sum(pr * dangling, dim=ROW_AXES)  # (b,)
        else:
            dmass = torch.zeros(b, dtype=pr.dtype, device=pr.device)
        coef = (1.0 - d) + d * dmass
        parts = []
        for lo in range(0, b, per_launch) or [0]:  # b = 0 meets the kernel's check
            rows = slice(lo, lo + per_launch)
            # a chunk that is the whole batch is a view of it: no copy
            parts.append(gs_pass_multi(
                pr[..., rows].contiguous(), bg.inv_out, bg.vmask,
                tele[..., rows].contiguous(), coef[rows], d, bg.in_ptr, bg.src,
                bg.weights, frozen_rows[rows]))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=BATCH_AXIS)

    return sweep


def _row_error(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(new - old), dim=ROW_AXES)


def ppr_blocked(
    bg: BlockedGraph,
    teleport,
    d: float = DEFAULT_DAMPING,
    threshold: float = 1e-8,
    max_iter: int = 10_000,
    handle_dangling: bool = False,
) -> PageRankResult:
    """Batched PPR on the multi-row blocked Gauss–Seidel kernel: every
    pass reads the in-CSR once for all ``b`` rows.  ``pr`` is ``(b, n)``."""
    t = np.asarray(teleport, dtype=np.float32)
    dev = bg.vmask.device
    if bg.n == 0:
        return PageRankResult(torch.zeros((t.shape[0], 0), device=dev), 0, 0.0)
    if bg.bias is not None:
        t = bias_scaled(t, _host(bg.bias).reshape(-1)[:bg.n])
    tele = torch.as_tensor(blocked_rows(t, bg.n_blocks, bg.block), device=dev)
    psweep = make_batched_blocked_sweep(bg, d=d, handle_dangling=handle_dangling)

    def sweep(pr, frozen):
        return psweep(pr, tele, frozen.flatten(0, 1).any(dim=0))

    step = batched_barrier_schedule(
        sweep, transforms=(row_freeze(threshold, axes=ROW_AXES),),
        pass_frozen=True, row_error=_row_error)
    r = solve(step, tele, n_units=tele.shape[BATCH_AXIS], threshold=threshold,
              max_iter=max_iter, track_frozen=True)
    return r._replace(pr=unblocked_rows(r.pr, bg.n))


# ---------------------------------------------------------------------------
# Registry entries — PPR rides the global builds
# ---------------------------------------------------------------------------


def _ppr_barrier_run(b, *, d=DEFAULT_DAMPING, threshold=1e-8, max_iter=10_000,
                     handle_dangling=False, seeds=None, **_):
    return ppr_barrier(b, teleport_from_seeds(seeds, b.n), d=d,
                       threshold=threshold, max_iter=max_iter,
                       handle_dangling=handle_dangling)


def _ppr_nosync_run(b, *, d=DEFAULT_DAMPING, threshold=1e-8, max_iter=10_000,
                    handle_dangling=False, seeds=None, thread_level=True, **_):
    return ppr_nosync(b, teleport_from_seeds(seeds, b.n, n_pad=b.n_pad), d=d,
                      threshold=threshold, max_iter=max_iter,
                      thread_level=thread_level,
                      handle_dangling=handle_dangling)


def _ppr_blocked_run(b, *, d=DEFAULT_DAMPING, threshold=1e-8, max_iter=10_000,
                     handle_dangling=False, seeds=None, **_):
    return ppr_blocked(b, teleport_from_seeds(seeds, b.n), d=d,
                       threshold=threshold, max_iter=max_iter,
                       handle_dangling=handle_dangling)


register_variant(
    "ppr_barrier",
    build=lambda g, device=None, **_: DeviceGraph.from_graph(g, device),
    run=_ppr_barrier_run,
    description="batched multi-seed PPR, vertex-centric Jacobi + per-row freeze",
    options=("seeds",),
    layout="device", backend="torch", schedule="barrier",
)
register_variant(
    "ppr_nosync",
    build=lambda g, threads=56, device=None, **_: PartitionedGraph.from_graph(
        g, p=threads, device=device),
    run=_ppr_nosync_run,
    description="batched multi-seed PPR on the Alg-3 fresh-read partition schedule",
    options=("seeds", "thread_level"),
    layout="partitioned", backend="torch", schedule="nosync",
)
register_variant(
    "ppr_blocked",
    build=lambda g, block=256, device=None, **_: BlockedGraph.build(
        g, block=block, device=device),
    run=_ppr_blocked_run,
    description="batched multi-seed PPR, CUDA multi-row blocked Gauss–Seidel kernel",
    options=("seeds",),
    layout="blocked", backend="cuda", schedule="nosync",
)
