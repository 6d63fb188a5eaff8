"""Plain PyTorch versions of the two main-path kernels.

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
    flat = contrib.reshape(-1)
    vals = flat[src.long()]
    if weights is not None:
        vals = vals * weights
    acc = torch.segment_reduce(vals, "sum", offsets=in_ptr)
    return acc.reshape(contrib.shape)


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
