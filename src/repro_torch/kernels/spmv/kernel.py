"""Wrappers of the hand-written CUDA kernels of the PageRank main path and
of batched personalized PageRank.

Each wrapper checks its operands, allocates its output with ``torch.empty``
and, for CUDA tensors, launches its kernel from ``csrc/spmv.cu`` on the
current stream and raises if the launch fails.  For CPU tensors it calls
the kernel's plain version in :mod:`repro_torch.kernels.spmv.ref` — only
because the tensors lie on the CPU; there is no fallback from the card.
Each CUDA launch adds one to the wrapper's count (:func:`launch_counts`).

Graph operands are the port's in-CSR (:class:`repro_torch.kernels.spmv.ops.BlockedGraph`):
``in_ptr`` int32 ``(n_blocks·block + 1,)``, ``src`` int32 ``(m,)``,
optional ``weights`` float32 ``(m,)``; rank-shaped operands are float32
``(n_blocks, block)``, and the batched state of :func:`gs_pass_multi` is
float32 ``(n_blocks, block, b)``, vertex-major.  :func:`spmv_csr_rows`
takes one partition's own in-CSR (``(rows + 1,)``, its edges only) and
gathers from the whole float32 ``(n_pad,)`` vector.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.spmv import build
from repro_torch.kernels.spmv.ref import (
    gs_pass_multi_ref,
    gs_pass_ref,
    spmv_csr_acc_ref,
    spmv_csr_rows_ref,
)

# The largest block any wrapper takes.  On the card gs_pass and
# gs_pass_multi also check that their shared-memory staging at the block
# fits into a CTA (gs_pass_plan, gs_pass_multi_max_batch).
MAX_BLOCK = 16384
# gs_pass_multi runs one cluster of CTAs a row; b is bounded here, and more
# rows go through in chunks (gs_pass_multi_max_batch).  csrc/spmv.cu sizes a
# CTA's staging by block alone, which the wrapper checks against the card's
# per-CTA limit before each launch.
MAX_BATCH = 64

_LAUNCHES = {"spmv_csr_acc": 0, "gs_pass": 0, "gs_pass_multi": 0}


def launch_counts() -> dict[str, int]:
    """CUDA launches of each kernel since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _check(name: str, t: torch.Tensor | None, dtype, shape, device) -> None:
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_graph(x: torch.Tensor, in_ptr, src, weights,
                 layout: tuple[str, ...] = ("n_blocks", "block")) -> tuple[int, int]:
    if x.dim() != len(layout):
        raise ValueError(f"rank operand must be ({', '.join(layout)}), "
                         f"got {tuple(x.shape)}")
    n_blocks, block = x.shape[:2]
    if not 0 < block <= MAX_BLOCK:
        raise ValueError(f"block must be in (0, {MAX_BLOCK}], got {block}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    _check("in_ptr", in_ptr, torch.int32, (n_blocks * block + 1,), x.device)
    if src.dim() != 1:
        raise ValueError("src must be 1-D")
    _check("src", src, torch.int32, src.shape, x.device)
    _check("weights", weights, torch.float32, src.shape, x.device)
    return n_blocks, block


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError {err}")


def _device_index(dev: torch.device) -> int:
    return torch.cuda.current_device() if dev.index is None else dev.index


@functools.lru_cache(maxsize=None)
def _spmv_ctas(lib, index: int) -> int:
    """CTAs of one :func:`spmv_csr_acc` launch on card ``index``: as many
    as are resident at once, as the built library computes them."""
    ctas = lib.spmv_csr_acc_ctas(index)
    if ctas <= 0:
        raise RuntimeError(f"spmv_csr_acc: no CTA fits on card {index} ({ctas})")
    return ctas


def launch_spmv_csr_rows(lib, contrib: torch.Tensor, in_ptr: torch.Tensor,
                         src: torch.Tensor, weights: torch.Tensor | None,
                         n_rows: int) -> torch.Tensor:
    """Launch ``spmv_csr_acc`` of the loaded library ``lib`` over the
    ``n_rows`` rows of ``in_ptr`` on CUDA operands that a wrapper has
    checked, without counting it; returns the ``(n_rows,)`` sums.  The
    kernel reads ``contrib`` only at the ids in ``src``, so ``contrib`` may
    be longer than ``n_rows``: a partition's rows gather from the whole
    rank vector."""
    dev = contrib.device
    acc = torch.empty(n_rows, dtype=contrib.dtype, device=dev)
    with torch.cuda.device(dev):
        ctas = _spmv_ctas(lib, _device_index(dev))
        scratch = torch.empty(2 * ctas, dtype=torch.int32, device=dev)  # CTA carries
        err = lib.spmv_csr_acc(
            contrib.data_ptr(), in_ptr.data_ptr(), src.data_ptr(),
            None if weights is None else weights.data_ptr(), acc.data_ptr(),
            n_rows, src.numel(), ctas, scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "spmv_csr_acc")
    return acc


def launch_spmv_csr_acc(lib, contrib: torch.Tensor, in_ptr: torch.Tensor,
                        src: torch.Tensor,
                        weights: torch.Tensor | None) -> torch.Tensor:
    """Launch ``spmv_csr_acc`` of the loaded library ``lib`` on CUDA
    operands that :func:`spmv_csr_acc` has checked and found not empty,
    without counting it; ``scripts/spmv_ablation.py`` launches copies of
    the source this way."""
    return launch_spmv_csr_rows(lib, contrib, in_ptr, src, weights,
                                contrib.numel()).view_as(contrib)


def spmv_csr_acc(contrib: torch.Tensor, in_ptr: torch.Tensor,
                 src: torch.Tensor,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Jacobi SpMV ``acc[v] = Σ_{e ∈ in(v)} w_e · contrib[src_e]`` over the
    ``(n_blocks, block)`` layout; padding rows come out 0.

    Replaces the TPU kernel ``spmv_blocked`` (src/repro/kernels/spmv/kernel.py),
    which gathers and scatters each ``(dst_block, src_block)`` tile with two
    one-hot matrix products.  The H100 gathers directly from the in-CSR.
    Bound: bytes — about 4 B per edge of ``src`` (8 B weighted) plus the
    ``contrib`` gathers and 12 B per row; a handful of flops per edge.
    Design: merge-path SpMV.  A grid of as many CTAs as the card holds at
    once takes equal shares of the rows' ends and edges together, so a hub
    row is spread over CTAs instead of holding one; each thread walks an
    equal run of a share, and rows cut between threads or CTAs are joined
    by a segmented scan and a second small kernel, in a fixed order —
    deterministic, no atomics."""
    n_blocks, block = _check_graph(contrib, in_ptr, src, weights)
    _check("contrib", contrib, torch.float32, (n_blocks, block), contrib.device)
    if contrib.device.type == "cpu":
        return spmv_csr_acc_ref(contrib, in_ptr, src, weights)
    if contrib.numel() == 0:
        return torch.empty_like(contrib)
    acc = launch_spmv_csr_acc(build.load(), contrib, in_ptr, src, weights)
    _LAUNCHES["spmv_csr_acc"] += 1
    return acc


def spmv_csr_rows(contrib: torch.Tensor, in_ptr: torch.Tensor,
                  src: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Row-range SpMV ``acc[r] = Σ_{e ∈ in(r)} w_e · contrib[src_e]`` over
    the ``rows = in_ptr.numel() − 1`` rows of one partition; returns
    ``(rows,)``.  ``contrib`` is the whole float32 ``(n_pad,)`` vector and
    ``src`` holds global ids into it; ``in_ptr`` is the partition's own
    int32 in-CSR, starting at 0 and ending at ``src.numel()``.

    The same CUDA kernel as :func:`spmv_csr_acc` (it takes the row count
    apart from the gathered vector), launched once a call and counted
    under ``spmv_csr_acc``: the distributed solvers sweep each shard's
    partition with it."""
    if contrib.dim() != 1 or in_ptr.dim() != 1 or in_ptr.numel() < 1:
        raise ValueError(f"contrib must be (n,) and in_ptr (rows + 1,), got "
                         f"{tuple(contrib.shape)} and {tuple(in_ptr.shape)}")
    if contrib.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {contrib.device}")
    rows = in_ptr.numel() - 1
    dev = contrib.device
    _check("contrib", contrib, torch.float32, contrib.shape, dev)
    _check("in_ptr", in_ptr, torch.int32, in_ptr.shape, dev)
    if src.dim() != 1:
        raise ValueError("src must be 1-D")
    _check("src", src, torch.int32, src.shape, dev)
    _check("weights", weights, torch.float32, src.shape, dev)
    if dev.type == "cpu":
        return spmv_csr_rows_ref(contrib, in_ptr, src, weights)
    if rows == 0:
        return torch.empty(0, dtype=contrib.dtype, device=dev)
    acc = launch_spmv_csr_rows(build.load(), contrib, in_ptr, src, weights, rows)
    _LAUNCHES["spmv_csr_acc"] += 1
    return acc


def gs_pass(pr: torch.Tensor, inv_out: torch.Tensor, vmask: torch.Tensor,
            params: torch.Tensor, in_ptr: torch.Tensor, src: torch.Tensor,
            weights: torch.Tensor | None = None,
            bias: torch.Tensor | None = None,
            frozen: torch.Tensor | None = None) -> torch.Tensor:
    """One blocked Gauss–Seidel pass; returns the new ``(n_blocks, block)``
    ranks (see :func:`repro_torch.kernels.spmv.ref.gs_pass_ref` for the
    exact semantics).  ``params`` is a float32 ``(3,)`` device tensor
    ``[base, d, dmass]``, so the dangling mass never leaves the card;
    ``frozen`` is a bool mask of lanes that keep their rank.

    Replaces the TPU kernel ``spmv_gs_pass`` (src/repro/kernels/spmv/kernel.py),
    whose sequential grid walks the dst-block tile runs with the whole rank
    state resident in VMEM.  Bound: the order — block ``db`` must read the
    commits of every block below it, so a pass is ``n_blocks`` dependent
    steps on one SM (a hand-off between SMs costs more than a step); the
    bytes (one read of the in-CSR and the rank-shaped operands, one write of
    the ranks) are far below that.  Design: the chain of block commits
    stays on one walker CTA, and everything off it runs ahead.  A first
    kernel writes ``q = pr·inv_out`` and one 16-byte record a vertex, and
    each commit writes ``q`` beside ``pr``, so an edge is one gather.
    Helper CTAs on other SMs gather ``q[src]`` of block ``b`` into a
    per-edge array once the walker has published that every block up to
    ``b − k`` is committed; the walker copies that array, each block's
    records and its ``src`` and ``weights`` ranges (in chunks of 4,096
    edges) into rings in shared memory with TMA bulk copies, and gives a
    source in the ``k − 1`` blocks just below (committed after the
    helper's gather) the value from a window of committed values.  ``k``
    and the ``D`` stream slots are the largest that fit into a CTA's
    shared memory at ``block`` (:func:`gs_pass_plan`); where not even one
    stage fits, the call raises ``ValueError``.  The launch is cooperative,
    as the CTAs wait on each other.  Sums keep the plain blocked order of
    4,096-edge chunks, lanes strided 32 apart and a fixed xor tree
    (``tests/test_torch_spmv.py::emulated_gs_pass``), so the result is bit
    for bit :func:`gs_pass_multi`'s at ``b = 1``.  Deterministic, no
    atomics."""
    n_blocks, block = _check_graph(pr, in_ptr, src, weights)
    dev = pr.device
    for name, t in (("pr", pr), ("inv_out", inv_out), ("vmask", vmask),
                    ("bias", bias)):
        _check(name, t, torch.float32, (n_blocks, block), dev)
    _check("frozen", frozen, torch.bool, (n_blocks, block), dev)
    _check("params", params, torch.float32, (3,), dev)
    if dev.type == "cpu":
        return gs_pass_ref(pr, inv_out, vmask, params, in_ptr, src, weights,
                           bias, frozen)
    if n_blocks == 0:
        return pr.clone()
    out = launch_gs_pass(build.load(), pr, inv_out, vmask, params, in_ptr, src,
                         weights, bias, frozen)
    _LAUNCHES["gs_pass"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _gs_plan(lib, block: int, weighted: bool, smem: int) -> tuple[int, int]:
    k, d_stages = ctypes.c_int(), ctypes.c_int()
    if lib.gs_pass_plan(block, int(weighted), smem, ctypes.byref(k),
                        ctypes.byref(d_stages)) <= 0:
        raise ValueError(f"gs_pass: block={block} leaves no room for one stage of "
                         f"its ring in the {smem} B of shared memory a CTA may use")
    return k.value, d_stages.value


def gs_pass_plan(block: int, weighted: bool, device: torch.device,
                 lib=None) -> tuple[int, int]:
    """``(k, D)`` of a :func:`gs_pass` launch at ``block`` on the CUDA
    ``device``: ``k`` blocks between the helpers' gather of a block and its
    sum (the window of committed values holds ``k`` blocks), ``D`` stream
    slots, the largest that fit into a CTA's shared memory as the built
    library (or ``lib``) lays it out.  Raises ``ValueError`` where not even
    ``k = 2, D = 2`` fits."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"gs_pass_plan describes a launch on the card, not {device}")
    lib = build.load() if lib is None else lib
    return _gs_plan(lib, block, bool(weighted), _smem_per_block(lib, device))


def launch_gs_pass(lib, pr: torch.Tensor, inv_out: torch.Tensor,
                   vmask: torch.Tensor, params: torch.Tensor,
                   in_ptr: torch.Tensor, src: torch.Tensor,
                   weights: torch.Tensor | None, bias: torch.Tensor | None,
                   frozen: torch.Tensor | None) -> torch.Tensor:
    """Launch ``gs_pass`` of the loaded library ``lib`` on CUDA operands
    that :func:`gs_pass` has checked and found not empty, without counting
    it, with the stages of :func:`gs_pass_plan`; ``scripts/spmv_ablation.py``
    launches copies of the source this way."""
    n_blocks, block = pr.shape
    dev = pr.device
    k, d_stages = gs_pass_plan(block, weights is not None, dev, lib)
    for name, t in (("src", src), ("weights", weights)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"gs_pass copies {name} in 16-byte units: it must "
                             f"start on a 16-byte boundary")
    m = src.numel()
    out = torch.empty_like(pr)
    scaled = torch.empty_like(pr)  # pr · inv_out, written by each commit
    records = torch.empty((n_blocks * block + 1, 4), dtype=torch.int32, device=dev)
    vals = torch.empty(((m + 7) & ~3,), dtype=torch.float32, device=dev)  # q[src], by edge
    sync = torch.zeros(n_blocks + 1, dtype=torch.int32, device=dev)  # block flags, progress
    err = lib.gs_pass(
        out.data_ptr(), scaled.data_ptr(), records.data_ptr(), pr.data_ptr(),
        inv_out.data_ptr(), vmask.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if frozen is None else frozen.data_ptr(),
        params.data_ptr(), in_ptr.data_ptr(), src.data_ptr(),
        None if weights is None else weights.data_ptr(),
        vals.data_ptr(), sync.data_ptr(), n_blocks, block, m, k, d_stages,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "gs_pass")
    return out


def _smem_per_block(lib, dev: torch.device) -> int:
    """Shared memory a CTA may use on ``dev``, in bytes, as the card reports
    (``cuda`` with no index is the current card)."""
    have = lib.smem_per_block_optin(_device_index(dev))
    if have < 0:
        _raise_on(-have, "smem_per_block_optin")
    return have


def gs_pass_multi_max_batch(block: int, device: torch.device) -> int:
    """The most rows one :func:`gs_pass_multi` call takes at ``block``:
    :data:`MAX_BATCH`.  On the card it raises ``ValueError`` where the
    built library's staging at ``block`` (``gs_pass_multi_smem_bytes`` in
    ``csrc/spmv.cu``, the same for any number of rows) does not fit into a
    CTA's shared memory.  Callers with more rows split them into chunks of
    this size."""
    device = torch.device(device)
    if device.type != "cuda":
        return MAX_BATCH
    lib = build.load()
    have = _smem_per_block(lib, device)
    if lib.gs_pass_multi_smem_bytes(block) > have:
        raise ValueError(f"block={block} leaves no room for one row in the "
                         f"{have} B of shared memory a CTA may use on {device}")
    return MAX_BATCH


def launch_gs_pass_multi(lib, pr: torch.Tensor, inv_out: torch.Tensor,
                         vmask: torch.Tensor, tele: torch.Tensor,
                         coef: torch.Tensor, d: float, in_ptr: torch.Tensor,
                         src: torch.Tensor, weights: torch.Tensor | None,
                         frozen_rows: torch.Tensor | None) -> torch.Tensor:
    """Launch ``gs_pass_multi`` of the loaded library ``lib`` on CUDA
    operands that :func:`gs_pass_multi` has checked and found not empty,
    without counting it; ``scripts/spmv_ablation.py`` launches copies of
    the source this way."""
    n_blocks, block, b = pr.shape
    dev = pr.device
    if n_blocks * block * b >= 2**31:
        raise ValueError("state overflows the kernel's int32 vertex offsets")
    need = lib.gs_pass_multi_smem_bytes(block)
    have = _smem_per_block(lib, dev)
    if need > have:
        raise ValueError(f"block={block} needs {need} B of shared memory, "
                         f"over the {have} B a CTA may use on {dev}")
    out = torch.empty_like(pr)
    out.copy_(pr)
    scaled = torch.empty((2, *pr.shape), dtype=pr.dtype, device=dev)  # pr · inv_out, old and new
    with torch.cuda.device(dev):  # a serving shard may sit on another card
        err = lib.gs_pass_multi(
            out.data_ptr(), scaled.data_ptr(), inv_out.data_ptr(), vmask.data_ptr(),
            tele.data_ptr(),
            coef.data_ptr(), None if frozen_rows is None else frozen_rows.data_ptr(),
            float(d), in_ptr.data_ptr(), src.data_ptr(),
            None if weights is None else weights.data_ptr(),
            n_blocks, block, b, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "gs_pass_multi")
    return out


def gs_pass_multi(pr: torch.Tensor, inv_out: torch.Tensor, vmask: torch.Tensor,
                  tele: torch.Tensor, coef: torch.Tensor, d: float,
                  in_ptr: torch.Tensor, src: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  frozen_rows: torch.Tensor | None = None) -> torch.Tensor:
    """One blocked Gauss–Seidel pass over ``b`` rank rows; returns the new
    ``(n_blocks, block, b)`` state (see
    :func:`repro_torch.kernels.spmv.ref.gs_pass_multi_ref` for the exact
    semantics).  ``tele`` is the teleport state in the same layout,
    ``coef`` a float32 ``(b,)`` device tensor of per-row coefficients
    ``(1-d) + d·dmass_row`` (so the dangling mass never leaves the card),
    ``frozen_rows`` a bool ``(b,)`` mask of rows that keep their values.

    Replaces the TPU kernel ``spmv_gs_pass_multi``
    (src/repro/kernels/spmv/kernel.py), which holds the whole
    ``(n_blocks, b, block)`` batch in VMEM and shares each tile's index
    stream across the batch.  Bound: the order, as for :func:`gs_pass` —
    a pass is ``n_blocks`` dependent block steps; its bytes (the in-CSR
    once, the state and teleport rows once each) are far below that.
    Design: the rows are independent within a pass, so each row walks all
    blocks on a cluster of up to 8 CTAs, each owning a share of every
    block's vertices and gathering only their edges; the cluster meets at
    a barrier before each block, and a CTA reads the values its peers
    committed from their shared memory.  Two scratch copies of the state times ``inv_out``
    (the previous pass's, and this pass's, which each commit writes) make
    an edge one 16-byte gather through L2.
    Each CTA copies the next round of edges into shared memory with
    ``cp.async`` while it sums the current round, so a block step waits on
    no global round trip.  For ``b ≤ 32`` each row is summed in the parent
    kernel's order at the same ``b`` (with ``b = 1`` it computes exactly
    what :func:`gs_pass` computes), for ``b > 32`` in edge order, each
    round's run of a row added in double and rounded once."""
    n_blocks, block = _check_graph(pr, in_ptr, src, weights,
                                   layout=("n_blocks", "block", "b"))
    b = pr.shape[2]
    if not 0 < b <= MAX_BATCH:
        raise ValueError(f"batch b must be in (0, {MAX_BATCH}], got {b}")
    dev = pr.device
    _check("pr", pr, torch.float32, (n_blocks, block, b), dev)
    _check("tele", tele, torch.float32, (n_blocks, block, b), dev)
    for name, t in (("inv_out", inv_out), ("vmask", vmask)):
        _check(name, t, torch.float32, (n_blocks, block), dev)
    _check("coef", coef, torch.float32, (b,), dev)
    _check("frozen_rows", frozen_rows, torch.bool, (b,), dev)
    if dev.type == "cpu":
        return gs_pass_multi_ref(pr, inv_out, vmask, tele, coef, d, in_ptr,
                                 src, weights, frozen_rows)
    if n_blocks == 0:
        return pr.clone()
    out = launch_gs_pass_multi(build.load(), pr, inv_out, vmask, tele, coef, d,
                               in_ptr, src, weights, frozen_rows)
    _LAUNCHES["gs_pass_multi"] += 1
    return out
