"""Wrappers of the hand-written CUDA kernels of the PageRank main path.

Each wrapper checks its operands, allocates its output with ``torch.empty``
and, for CUDA tensors, launches its kernel from ``csrc/spmv.cu`` on the
current stream and raises if the launch fails.  For CPU tensors it calls
the kernel's plain version in :mod:`repro_torch.kernels.spmv.ref` — only
because the tensors lie on the CPU; there is no fallback from the card.
Each CUDA launch adds one to the wrapper's count (:func:`launch_counts`).

Graph operands are the port's in-CSR (:class:`repro_torch.kernels.spmv.ops.BlockedGraph`):
``in_ptr`` int32 ``(n_blocks·block + 1,)``, ``src`` int32 ``(m,)``,
optional ``weights`` float32 ``(m,)``; rank-shaped operands are float32
``(n_blocks, block)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.spmv import build
from repro_torch.kernels.spmv.ref import gs_pass_ref, spmv_csr_acc_ref

# Shared memory per CTA is 4·(4096 + block) + 4·(block + 1) bytes; this
# bound keeps it well inside the 227 KB a CTA may use.
MAX_BLOCK = 16384

_LAUNCHES = {"spmv_csr_acc": 0, "gs_pass": 0}


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


def _check_graph(x: torch.Tensor, in_ptr, src, weights) -> tuple[int, int]:
    if x.dim() != 2:
        raise ValueError(f"rank operand must be (n_blocks, block), got {tuple(x.shape)}")
    n_blocks, block = x.shape
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
    Design: one CTA per dst block streams the block's contiguous edge range
    with every thread (coalesced, many gathers in flight) into shared
    memory, and one owner warp per row sums its slice in a fixed order —
    deterministic, no atomics, and a hub row costs a shared-memory pass
    instead of a serial chain of global loads."""
    n_blocks, block = _check_graph(contrib, in_ptr, src, weights)
    _check("contrib", contrib, torch.float32, (n_blocks, block), contrib.device)
    if contrib.device.type == "cpu":
        return spmv_csr_acc_ref(contrib, in_ptr, src, weights)
    acc = torch.empty_like(contrib)
    if n_blocks == 0:
        return acc
    err = build.load().spmv_csr_acc(
        contrib.data_ptr(), in_ptr.data_ptr(), src.data_ptr(),
        None if weights is None else weights.data_ptr(), acc.data_ptr(),
        n_blocks, block, torch.cuda.current_stream(contrib.device).cuda_stream)
    _raise_on(err, "spmv_csr_acc")
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
    steps, each a few global-memory latencies; the bytes (one read of the
    in-CSR and the rank-shaped operands, one write of the ranks) are far
    below that.  Design: a single persistent CTA of 1024 threads walks the
    dst blocks in order, sums each block as :func:`spmv_csr_acc` does, and
    commits after a barrier; a second barrier publishes the commit to the
    next block's gathers.  Exact and deterministic, on one SM of 132."""
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
    out = torch.empty_like(pr)
    out.copy_(pr)
    if n_blocks == 0:
        return out
    err = build.load().gs_pass(
        out.data_ptr(), inv_out.data_ptr(), vmask.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if frozen is None else frozen.data_ptr(),
        params.data_ptr(), in_ptr.data_ptr(), src.data_ptr(),
        None if weights is None else weights.data_ptr(),
        n_blocks, block, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "gs_pass")
    _LAUNCHES["gs_pass"] += 1
    return out
