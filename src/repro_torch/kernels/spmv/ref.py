"""Plain PyTorch versions of the CUDA kernels.

They compute exactly what the CUDA kernels in ``csrc/spmv.cu`` compute, on
the same in-CSR operands, with eager torch ops: the CPU tests hold them
against the JAX reference, ``chip_smoke.py`` holds the kernels against them
on the card, and the kernel wrappers call them for tensors on the CPU.
"""
from __future__ import annotations

import torch


def spmv_csr_acc_ref(contrib: torch.Tensor, in_ptr: torch.Tensor,
                     src: torch.Tensor,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """``acc[v] = Σ_{e ∈ in(v)} w_e · contrib[src_e]`` in the
    ``(n_blocks, block)`` layout of ``contrib``; padding rows have no edges
    and come out 0."""
    return spmv_csr_rows_ref(contrib.reshape(-1), in_ptr, src,
                             weights).reshape(contrib.shape)


def spmv_csr_rows_ref(contrib: torch.Tensor, in_ptr: torch.Tensor,
                      src: torch.Tensor,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """``acc[r] = Σ_{e ∈ in(r)} w_e · contrib[src_e]`` over the
    ``in_ptr.numel() − 1`` rows of one partition: ``(rows,)``, gathered
    from the whole ``(n,)`` vector ``contrib`` at the global ids ``src``."""
    vals = contrib[src.long()]
    if weights is not None:
        vals = vals * weights
    return torch.segment_reduce(vals, "sum", offsets=in_ptr)


def gs_pass_ref(pr: torch.Tensor, inv_out: torch.Tensor, vmask: torch.Tensor,
                params: torch.Tensor, in_ptr: torch.Tensor, src: torch.Tensor,
                weights: torch.Tensor | None = None,
                bias: torch.Tensor | None = None,
                frozen: torch.Tensor | None = None) -> torch.Tensor:
    """One blocked Gauss–Seidel pass over ``(n_blocks, block)`` ranks.

    Dst blocks are committed in order into a copy of ``pr``.  Block ``db``
    gathers ``pr·inv_out`` from the copy as it stands — blocks below ``db``
    at this pass's values, ``db`` and above at the previous pass's — and
    commits ``(base·bias + dmass + d·acc)·vmask`` only after its whole sum,
    with frozen lanes keeping their value.  ``params = [base, d, dmass]``
    (``dmass`` already multiplied by ``d``); ``bias=None`` uses ``vmask``,
    whose ones reproduce the scalar base."""
    n_blocks, block = pr.shape
    base, d, dmass = params[0], params[1], params[2]
    out = pr.clone().reshape(-1)
    inv = inv_out.reshape(-1)
    vm = vmask.reshape(-1)
    bz = vm if bias is None else bias.reshape(-1)
    fz = None if frozen is None else frozen.reshape(-1)
    ptr = in_ptr.tolist()
    for db in range(n_blocks):
        v0, v1 = db * block, (db + 1) * block
        e0, e1 = ptr[v0], ptr[v1]
        s = src[e0:e1].long()
        vals = out[s] * inv[s]
        if weights is not None:
            vals = vals * weights[e0:e1]
        acc = torch.segment_reduce(vals, "sum", offsets=in_ptr[v0:v1 + 1] - e0)
        new = (base * bz[v0:v1] + dmass + d * acc) * vm[v0:v1]
        if fz is not None:
            new = torch.where(fz[v0:v1], out[v0:v1], new)
        out[v0:v1] = new
    return out.reshape(n_blocks, block)


def gs_pass_multi_ref(pr: torch.Tensor, inv_out: torch.Tensor,
                      vmask: torch.Tensor, tele: torch.Tensor,
                      coef: torch.Tensor, d: float, in_ptr: torch.Tensor,
                      src: torch.Tensor, weights: torch.Tensor | None = None,
                      frozen_rows: torch.Tensor | None = None) -> torch.Tensor:
    """One blocked Gauss–Seidel pass over ``b`` rank rows in the
    vertex-major ``(n_blocks, block, b)`` layout.

    Dst blocks are committed in order into a copy of ``pr``, as in
    :func:`gs_pass_ref`: block ``db`` gathers ``pr[s, j]·inv_out[s]`` (times
    the edge weight) from the copy as it stands, and commits
    ``(tele·coef[j] + d·acc)·vmask`` for every row ``j`` after its whole
    sum.  ``coef`` is the ``(b,)`` per-row base coefficient
    ``(1-d) + d·dmass_row``; rows set in the bool ``(b,)`` ``frozen_rows``
    keep their values."""
    n_blocks, block, b = pr.shape
    out = pr.clone().reshape(-1, b)
    inv = inv_out.reshape(-1)
    vm = vmask.reshape(-1, 1)
    tl = tele.reshape(-1, b)
    ptr = in_ptr.tolist()
    rows = torch.arange(b, device=in_ptr.device).unsqueeze(1)
    for db in range(n_blocks):
        v0, v1 = db * block, (db + 1) * block
        e0, e1 = ptr[v0], ptr[v1]
        s = src[e0:e1].long()
        vals = out[s] * inv[s].unsqueeze(1)
        if weights is not None:
            vals = vals * weights[e0:e1].unsqueeze(1)
        # row-major: each row's segments one after another in one 1-D
        # reduction.  On a 2-D (edges, b) tensor CUDA's segment_reduce
        # adds each segment's terms one by one, 1.755e-5 off float64 at a
        # 26,088-edge vertex of webStanford (scripts/ppr_sum_accuracy.py);
        # on 1-D data it sums by a tree.  On the CPU both add in edge
        # order: the same bits.
        off = (in_ptr[v0:v1] - e0).unsqueeze(0) + rows * (e1 - e0)
        off = torch.cat([off.reshape(-1), off.new_tensor([b * (e1 - e0)])])
        acc = torch.segment_reduce(vals.t().reshape(-1), "sum",
                                   offsets=off).reshape(b, block).t()
        new = (tl[v0:v1] * coef + d * acc) * vm[v0:v1]
        if frozen_rows is not None:
            new = torch.where(frozen_rows, out[v0:v1], new)
        out[v0:v1] = new
    return out.reshape(n_blocks, block, b)
