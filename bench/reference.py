"""The plain reference: global PageRank by power (Jacobi) iteration, in
plain torch, from the edge list alone.

It imports nothing of the program and takes nothing the program made: it
works out its own sparse matrix from the benchmark's ``(src, dst)`` edges.
A parallel edge is two entries, summed, as the program's in-CSR counts it.
The iteration is ``x ← (1 − d)·t + d·A·x``, ``A[v, u] = 1/outdeg(u)`` per
edge ``u → v``, with the dangling mass ``d·Σ_{sink} x / n`` spread over
every vertex where the configuration redistributes it, dropped where it
is leaky.  It is a d-contraction in L1, so a column whose last step moved
it by at most ``TIGHT_L1`` in L1 lies within ``d / (1 − d)·TIGHT_L1`` of
the fixed point.

The same iteration at a lower precision (``store=torch.bfloat16``, the
matrix and the sums in float32) is the control that the comparison has to
fail (``bench/tools/control.py``).
"""
from __future__ import annotations

import warnings

import torch

TIGHT_L1 = 1e-13  # the fixed point's last step, L1 per column
MAX_ITER = 3000


class Operator:
    """``A`` of the graph with ``n`` vertices and the int ``(m,)`` edge
    tensors ``src → dst``, as a sparse CSR matrix of ``dtype`` on their
    device, and its sink mask."""

    def __init__(self, n: int, src: torch.Tensor, dst: torch.Tensor,
                 dtype: torch.dtype = torch.float64):
        src, dst = src.long(), dst.long()
        out = torch.bincount(src, minlength=n)
        inv = torch.where(out > 0, 1.0 / out.clamp(min=1).to(torch.float64), 0.0)
        with warnings.catch_warnings():  # torch calls its sparse tensors "beta"
            warnings.simplefilter("ignore", UserWarning)
            coo = torch.sparse_coo_tensor(torch.stack([dst, src]), inv[src].to(dtype),
                                          (n, n), check_invariants=False)
            self.a = coo.coalesce().to_sparse_csr()
        self.sink = (out == 0).to(dtype)
        self.n = n
        self.dtype = dtype

    def step(self, x: torch.Tensor, tele: torch.Tensor, d: float,
             dangling: bool) -> torch.Tensor:
        """One Jacobi step of the ``(n, q)`` columns ``x`` in ``self.dtype``."""
        new = (1.0 - d) * tele + d * (self.a @ x)
        if dangling:
            new += d * (self.sink @ x) / self.n
        return new


def iterate(op: Operator, tele: torch.Tensor, *, d: float, dangling: bool,
            stop: float, tight: bool = True, store: torch.dtype = torch.float64,
            max_iter: int = MAX_ITER) -> tuple[torch.Tensor, list[int]]:
    """Iterate the ``(n, q)`` teleport columns ``tele`` from ``tele``.

    Returns the columns in float64 and, for each column, the first
    iteration whose step moved no entry by more than ``stop`` (the
    program's stop rule; ``max_iter`` where none did).  With ``tight`` it
    goes on until every column's step is at most ``TIGHT_L1`` in L1 and
    raises if ``max_iter`` comes first; without, it stops once every
    column has met ``stop``.  The columns are kept in ``store`` between
    steps and computed in the operator's dtype."""
    t = tele.to(op.dtype)
    x = tele.to(store)
    q = tele.shape[1]
    first = torch.full((q,), max_iter, dtype=torch.long)
    for it in range(1, max_iter + 1):
        new = op.step(x.to(op.dtype), t, d, dangling).to(store)
        delta = (new.to(torch.float64) - x.to(torch.float64)).abs()
        x = new
        met = (delta.amax(dim=0) <= stop).cpu() & (first == max_iter)
        first[met] = it
        if tight:
            if bool((delta.sum(dim=0) <= TIGHT_L1).all()) and bool((first < max_iter).all()):
                return x.to(torch.float64), first.tolist()
        elif bool((first < max_iter).all()):
            return x.to(torch.float64), first.tolist()
    if tight:
        raise RuntimeError(f"reference: no fixed point to {TIGHT_L1:g} in L1 "
                           f"after {max_iter} iterations")
    return x.to(torch.float64), first.tolist()


def judge_ranks(x: torch.Tensor, ref: torch.Tensor) -> dict[str, float]:
    """A rank vector against the fixed point: the L1 gap and the largest
    gap of one vertex relative to its reference rank."""
    gap = (x.to(torch.float64) - ref).abs()
    return {"l1": float(gap.sum()), "max_rel": float((gap / ref).max())}
