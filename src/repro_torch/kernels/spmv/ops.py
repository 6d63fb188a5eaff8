"""Blocked PageRank on the hand-written CUDA kernels — the port's
counterpart of the reference's Pallas path (``PallasGraph``/``pagerank_pallas``).

Three schedules share the one convergence engine:

* ``schedule="barrier"`` — Jacobi: one :func:`spmv_csr_acc` per iteration
  against the previous iterate (registry ``blocked``, the counterpart of
  ``pallas``).
* ``schedule="nosync"`` — the paper's Alg-3 schedule: one :func:`gs_pass`
  per iteration sweeps dst blocks in order, each reading the freshest
  ranks (``blocked_nosync`` ↔ ``pallas_nosync``), optionally with Alg-5
  perforation (``blocked_nosync_opt`` ↔ ``pallas_nosync_opt``): the
  engine's ``perforation`` transform owns the freeze mask and the kernel
  only respects it.
* ``schedule="adaptive"`` — one :func:`gs_pass` per iteration with whole
  dst blocks frozen: blocks whose certified residual bound (from the
  ``(n_blocks, n_blocks)`` gain certificate, built with ``gain=True``)
  sits at or below ``threshold / 2`` keep their ranks for the pass
  (``blocked_adaptive`` ↔ ``pallas_adaptive``).

All three refresh the dangling mass from the current ranks at the top of each
pass, which leaves the fixed point unchanged.

Layout: the reference bins edges into one-hot ``(dst_block, src_block)``
tiles, a TPU workaround for the missing gather; at full webStanford and
block 256 that is 863,463 tiles of 0.26 % occupancy.  The H100 gathers, so
the port keeps the graph's dst-sorted in-CSR and keeps ``block`` only as the
Gauss–Seidel unit; ``tile_cap`` is accepted and has no meaning here.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core.pagerank import partition_gain_matrix
from repro_torch.core.solver import (
    DEFAULT_DAMPING,
    PageRankResult,
    barrier_schedule,
    freeze_adaptive_schedule,
    perforation,
    register_variant,
    solve,
)
from repro_torch.device import resolve_device, to_device
from repro_torch.graphs.csr import Graph, inv_out_and_dangling
from repro_torch.kernels.spmv.kernel import gs_pass, spmv_csr_acc

SCHEDULES = ("barrier", "nosync", "adaptive")


@dataclasses.dataclass
class BlockedGraph:
    """Device bundle of the blocked path: the in-CSR plus rank-shaped
    ``(n_blocks, block)`` operands.  ``weights``/``bias`` are ``None`` on
    unweighted/unbiased graphs (the kernels then skip those multiplies).
    ``gain`` is the adaptive schedule's ``(n_blocks, n_blocks)`` block
    certificate, ``None`` unless the build asked for it."""

    n: int
    block: int
    n_blocks: int
    in_ptr: torch.Tensor  # (n_blocks·block + 1,) int32; padding rows empty
    src: torch.Tensor  # (m,) int32, dst-sorted
    inv_out: torch.Tensor  # (n_blocks, block) — 1/outdeg, 0 dangling/padding
    dangling: torch.Tensor  # (n_blocks, block) — outdeg==0 mask, padded 0
    vmask: torch.Tensor  # (n_blocks, block) — 1 for real vertices
    weights: torch.Tensor | None = None  # (m,) per-edge weight
    bias: torch.Tensor | None = None  # (n_blocks, block) base multiplier
    gain: torch.Tensor | None = None  # (n_blocks, n_blocks) cross-block gain

    @classmethod
    def build(cls, g: Graph, block: int = 256, tile_cap=None,
              device=None, gain: bool = False) -> "BlockedGraph":
        """``tile_cap`` is accepted for parity with ``PallasGraph.build``
        and ignored: the CSR layout has no tiles.  ``gain=True`` also
        builds the dense block certificate, quadratic in the block count,
        so it is built only on request, as the reference's is."""
        dev = resolve_device(device)
        if g.m >= 2**31:
            raise ValueError(f"m={g.m} edges overflow the kernels' int32 offsets")
        n_blocks = -(-g.n // block)
        n_pad = n_blocks * block
        in_ptr = np.full(n_pad + 1, g.m, dtype=np.int32)
        in_ptr[:g.n + 1] = g.in_ptr
        inv, dang = inv_out_and_dangling(g.out_degree, n_pad)
        vmask = (np.arange(n_pad) < g.n).astype(np.float32)
        bias = None
        if g.bias is not None:
            bias = np.zeros(n_pad, dtype=np.float32)
            bias[:g.n] = g.bias

        def blocks(a):
            return to_device(np.asarray(a).reshape(n_blocks, block),
                             torch.float32, dev)

        # the edge arrays may be a store's read-only memmaps: to_device
        # pages them in chunk by chunk and never aliases them
        return cls(
            n=g.n,
            block=block,
            n_blocks=n_blocks,
            in_ptr=to_device(in_ptr, torch.int32, dev),
            src=to_device(g.src, torch.int32, dev),
            inv_out=blocks(inv),
            dangling=blocks(dang),
            vmask=blocks(vmask),
            weights=(None if g.weights is None
                     else to_device(g.weights, torch.float32, dev)),
            bias=None if bias is None else blocks(bias),
            gain=(torch.as_tensor(partition_gain_matrix(g, block, n_blocks),
                                  dtype=torch.float32, device=dev)
                  if gain else None),
        )


def pagerank_blocked(
    bg: BlockedGraph,
    d: float = DEFAULT_DAMPING,
    threshold: float = 1e-8,
    max_iter: int = 10_000,
    schedule: str = "barrier",
    handle_dangling: bool = False,
    perforate: bool = False,
    pr0=None,
) -> PageRankResult:
    """Blocked-kernel PageRank on the chosen schedule.  ``pr0`` warm-starts
    from a full-length ``(n,)`` host vector (padding lanes zeroed) — same
    fixed point, fewer passes after a small graph update."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got {schedule!r}")
    if perforate and schedule != "nosync":
        raise ValueError("perforate requires the nosync schedule "
                         "(the freeze mask is a gs_pass operand; the "
                         "adaptive schedule owns the mask itself)")
    if schedule == "adaptive" and bg.gain is None:
        raise ValueError(
            "adaptive schedule needs the block gain certificate — rebuild "
            "with BlockedGraph.build(g, gain=True)")
    dev = bg.vmask.device
    if bg.n == 0:
        return PageRankResult(torch.zeros(0, device=dev), 0, 0.0)
    n = bg.n
    base = (1.0 - d) / n
    vmask = bg.vmask
    bz = vmask if bg.bias is None else bg.bias

    def dangling_mass(pr):
        return torch.sum(pr * bg.dangling) / n

    if schedule == "barrier":

        def sweep(pr):
            acc = spmv_csr_acc(pr * bg.inv_out, bg.in_ptr, bg.src, bg.weights)
            dm = d * dangling_mass(pr) if handle_dangling else 0.0
            return (base * bz + d * acc + dm) * vmask

    else:  # nosync/adaptive: one blocked Gauss–Seidel pass per iteration
        head = torch.tensor([base, d], dtype=torch.float32, device=dev)
        params_cold = torch.tensor([base, d, 0.0], dtype=torch.float32, device=dev)

        def sweep(pr, frozen=None):
            params = (torch.cat([head, (d * dangling_mass(pr)).reshape(1)])
                      if handle_dangling else params_cold)
            return gs_pass(pr, bg.inv_out, vmask, params, bg.in_ptr, bg.src,
                           bg.weights, bg.bias, frozen)

    if pr0 is None:
        init = torch.full((bg.n_blocks, bg.block), 1.0 / n, dtype=torch.float32,
                          device=dev) * vmask
    else:
        padded = np.zeros(bg.n_blocks * bg.block, dtype=np.float32)
        padded[:n] = np.asarray(pr0)
        init = torch.as_tensor(padded.reshape(bg.n_blocks, bg.block), device=dev)
    if schedule == "adaptive":
        # whole-block skipping: the freeze mask that perforation feeds per
        # vertex is driven per dst block here, from the certified block
        # gain (one engine unit = one block row)
        gain = bg.gain
        if handle_dangling:
            dang_counts = torch.sum(bg.dangling, dim=1)
            gain = gain + (dang_counts / n)[None, :]
        step = freeze_adaptive_schedule(sweep, threshold=threshold, d=d,
                                        gain=gain)
        aux0 = torch.full((bg.n_blocks,), math.inf, dtype=torch.float32,
                          device=dev)
        r = solve(step, init, n_units=bg.n_blocks, threshold=threshold,
                  max_iter=max_iter, aux0=aux0)
        return r._replace(pr=r.pr.reshape(-1)[:n])
    # Perforation is the engine's transform (Alg 5), not a kernel fork: the
    # kernel only respects the mask the transform maintains.
    transforms = (perforation(threshold),) if perforate else ()
    step = barrier_schedule(sweep, transforms, pass_frozen=perforate)
    r = solve(step, init, threshold=threshold, max_iter=max_iter,
              track_frozen=perforate)
    return r._replace(pr=r.pr.reshape(-1)[:n])


# ---------------------------------------------------------------------------
# Registry entries
# ---------------------------------------------------------------------------


def _build(g, block: int = 256, tile_cap=None, device=None, gain=False, **_):
    return BlockedGraph.build(g, block=block, tile_cap=tile_cap, device=device,
                              gain=gain)


def _run(schedule, perforate=False):
    def run(b, *, d=DEFAULT_DAMPING, threshold=1e-8, max_iter=10_000,
            handle_dangling=False, pr0=None, **_):
        return pagerank_blocked(
            b, d=d, threshold=threshold, max_iter=max_iter, schedule=schedule,
            handle_dangling=handle_dangling, perforate=perforate, pr0=pr0,
        )

    return run


register_variant(
    "blocked", build=_build, run=_run("barrier"),
    description="CUDA in-CSR SpMV kernel, Jacobi (barrier) schedule",
    layout="blocked", backend="cuda", schedule="barrier",
)
register_variant(
    "blocked_nosync", build=_build, run=_run("nosync"),
    description="CUDA blocked Gauss–Seidel kernel, Alg-3 fresh-read schedule",
    layout="blocked", backend="cuda", schedule="nosync",
)
register_variant(
    "blocked_nosync_opt", build=_build, run=_run("nosync", perforate=True),
    description="CUDA blocked Gauss–Seidel kernel, Alg-3 + Alg-5 perforation",
    layout="blocked", backend="cuda", schedule="nosync",
)
register_variant(
    "blocked_adaptive",
    # its own layout: the "blocked" bundle lacks the gain certificate
    build=functools.partial(_build, gain=True), run=_run("adaptive"),
    description="CUDA blocked Gauss–Seidel kernel, residual-adaptive certified block skipping",
    layout="blocked_gain", backend="cuda", schedule="adaptive",
)
