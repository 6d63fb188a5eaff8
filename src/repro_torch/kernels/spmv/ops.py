"""Blocked PageRank on the hand-written CUDA kernels — the port's
counterpart of the reference's Pallas path (``PallasGraph``/``pagerank_pallas``).

Two schedules share the one convergence engine:

* ``schedule="barrier"`` — Jacobi: one :func:`spmv_csr_acc` per iteration
  against the previous iterate (registry ``blocked``, the counterpart of
  ``pallas``).
* ``schedule="nosync"`` — the paper's Alg-3 schedule: one :func:`gs_pass`
  per iteration sweeps dst blocks in order, each reading the freshest
  ranks (``blocked_nosync`` ↔ ``pallas_nosync``), optionally with Alg-5
  perforation (``blocked_nosync_opt`` ↔ ``pallas_nosync_opt``): the
  engine's ``perforation`` transform owns the freeze mask and the kernel
  only respects it.

Both refresh the dangling mass from the current ranks at the top of each
pass, which leaves the fixed point unchanged.

Layout: the reference bins edges into one-hot ``(dst_block, src_block)``
tiles, a TPU workaround for the missing gather; at full webStanford and
block 256 that is 863,463 tiles of 0.26 % occupancy.  The H100 gathers, so
the port keeps the graph's dst-sorted in-CSR and keeps ``block`` only as the
Gauss–Seidel unit; ``tile_cap`` is accepted and has no meaning here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.solver import (
    DEFAULT_DAMPING,
    PageRankResult,
    barrier_schedule,
    perforation,
    register_variant,
    solve,
)
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph, inv_out_and_dangling
from repro_torch.kernels.spmv.kernel import gs_pass, spmv_csr_acc

SCHEDULES = ("barrier", "nosync")


@dataclasses.dataclass
class BlockedGraph:
    """Device bundle of the blocked path: the in-CSR plus rank-shaped
    ``(n_blocks, block)`` operands.  ``weights``/``bias`` are ``None`` on
    unweighted/unbiased graphs (the kernels then skip those multiplies)."""

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

    @classmethod
    def build(cls, g: Graph, block: int = 256, tile_cap=None,
              device=None) -> "BlockedGraph":
        """``tile_cap`` is accepted for parity with ``PallasGraph.build``
        and ignored: the CSR layout has no tiles."""
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
            return torch.as_tensor(np.asarray(a, np.float32).reshape(n_blocks, block),
                                   device=dev)

        return cls(
            n=g.n,
            block=block,
            n_blocks=n_blocks,
            in_ptr=torch.as_tensor(in_ptr, device=dev),
            src=torch.as_tensor(np.asarray(g.src, np.int32), device=dev),
            inv_out=blocks(inv),
            dangling=blocks(dang),
            vmask=blocks(vmask),
            weights=(None if g.weights is None else torch.as_tensor(
                np.asarray(g.weights, np.float32), device=dev)),
            bias=None if bias is None else blocks(bias),
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
    if schedule == "adaptive":
        raise ValueError("schedule 'adaptive' is not ported yet: it comes "
                         "with the adaptive-schedule slice of the port")
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got {schedule!r}")
    if perforate and schedule != "nosync":
        raise ValueError("perforate requires the nosync schedule "
                         "(the freeze mask is a gs_pass operand)")
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

    else:  # nosync: one blocked Gauss–Seidel pass per iteration
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


def _build(g, block: int = 256, tile_cap=None, device=None, **_):
    return BlockedGraph.build(g, block=block, tile_cap=tile_cap, device=device)


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
