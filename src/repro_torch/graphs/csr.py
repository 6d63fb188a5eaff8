"""Host graph container: dst-sorted COO + CSR-by-destination (numpy).

A copy of the reference's :class:`Graph` core, kept in the port so the port
imports nothing from the JAX package.  Every solver applies the generalized
sweep

    pr(v) = base·bias(v) + d · Σ_{(u,v)∈E} w(u,v) · pr(u) / outdeg(u)

with ``base = (1-d)/n``; ``weights=None`` / ``bias=None`` mean all-ones and
every solver keeps its unweighted fast path in that case.

:func:`graph_from_arrays` is the crossing point between the two packages:
it takes a graph as plain numpy arrays (for example the reference's
``Graph`` fields), validates the invariants and copies them, so both
packages solve the identical graph.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Graph:
    """Host-side immutable graph in dst-sorted COO + CSR-by-destination.

    ``src``/``dst`` are parallel edge arrays sorted by ``dst`` (then
    ``src``); ``in_ptr`` is the CSR row pointer over ``dst``.  ``weights``
    (per edge, dst-sorted) scales each edge's ``pr(src)/outdeg(src)``
    contribution; ``bias`` (per vertex) multiplies the ``(1-d)/n`` base.
    """

    n: int
    src: np.ndarray  # (m,) int32, sorted by dst
    dst: np.ndarray  # (m,) int32, non-decreasing
    out_degree: np.ndarray  # (n,) int32
    in_ptr: np.ndarray  # (n+1,) int64 CSR indptr over dst
    weights: Optional[np.ndarray] = None  # (m,) float64, dst-sorted; None = 1s
    bias: Optional[np.ndarray] = None  # (n,) float64 base multiplier; None = 1s

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    @classmethod
    def from_arrays(cls, n: int, src: np.ndarray, dst: np.ndarray,
                    out_degree: np.ndarray, in_ptr: np.ndarray,
                    weights: Optional[np.ndarray] = None,
                    bias: Optional[np.ndarray] = None) -> "Graph":
        """Trusted constructor over pre-derived arrays — no sort, no copy.
        Callers guarantee the invariants; :func:`graph_from_arrays` checks
        them for arrays from outside the port."""
        return cls(n=n, src=src, dst=dst, out_degree=out_degree,
                   in_ptr=in_ptr, weights=weights, bias=bias)

    @classmethod
    def from_edges(cls, n: int, src: np.ndarray, dst: np.ndarray,
                   weights: Optional[np.ndarray] = None,
                   bias: Optional[np.ndarray] = None) -> "Graph":
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        if src.shape != dst.shape:
            raise ValueError("src/dst must be parallel arrays")
        if src.size and (src.min() < 0 or src.max() >= n or dst.min() < 0 or dst.max() >= n):
            raise ValueError("edge endpoint out of range")
        order = np.lexsort((src, dst))
        src, dst = src[order], dst[order]
        if weights is not None:
            weights = np.asarray(weights, dtype=np.float64)
            if weights.shape != src.shape:
                raise ValueError("weights must parallel src/dst")
            weights = weights[order]
        if bias is not None:
            bias = np.asarray(bias, dtype=np.float64)
            if bias.shape != (n,):
                raise ValueError(f"bias must have shape ({n},)")
        out_degree = np.bincount(src, minlength=n).astype(np.int32)
        in_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(dst, minlength=n), out=in_ptr[1:])
        return cls(n=n, src=src, dst=dst, out_degree=out_degree, in_ptr=in_ptr,
                   weights=weights, bias=bias)


def graph_from_arrays(n, src, dst, out_degree, in_ptr, weights=None,
                      bias=None) -> Graph:
    """Port-side :class:`Graph` from numpy arrays of another package's graph.

    The arrays are copied and checked against every invariant the solvers
    rely on (dst-sorted edges, ``in_ptr`` and ``out_degree`` derived from
    them, shapes of ``weights``/``bias``); a violation raises ``ValueError``
    instead of producing a graph that solves to something else."""
    n = int(n)
    src = np.array(src, dtype=np.int32)
    dst = np.array(dst, dtype=np.int32)
    out_degree = np.array(out_degree, dtype=np.int32)
    in_ptr = np.array(in_ptr, dtype=np.int64)
    if src.ndim != 1 or src.shape != dst.shape:
        raise ValueError("src/dst must be parallel 1-D arrays")
    if out_degree.shape != (n,) or in_ptr.shape != (n + 1,):
        raise ValueError(f"out_degree must be ({n},) and in_ptr ({n + 1},)")
    if src.size and (src.min() < 0 or src.max() >= n or dst.min() < 0 or dst.max() >= n):
        raise ValueError("edge endpoint out of range")
    if np.any(np.diff(dst) < 0):
        raise ValueError("edges must be sorted by dst")
    expect_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=expect_ptr[1:])
    if not np.array_equal(in_ptr, expect_ptr):
        raise ValueError("in_ptr disagrees with dst")
    if not np.array_equal(out_degree, np.bincount(src, minlength=n)):
        raise ValueError("out_degree disagrees with src")
    if weights is not None:
        weights = np.array(weights, dtype=np.float64)
        if weights.shape != src.shape:
            raise ValueError("weights must parallel src/dst")
    if bias is not None:
        bias = np.array(bias, dtype=np.float64)
        if bias.shape != (n,):
            raise ValueError(f"bias must have shape ({n},)")
    return Graph.from_arrays(n, src, dst, out_degree, in_ptr, weights, bias)


def inv_out_and_dangling(out_degree: np.ndarray, n_pad: Optional[int] = None):
    """``(inv_out, dangling)`` float64 host arrays shared by every device
    bundle: 1/outdeg (0 for dangling vertices) and the outdeg==0 mask.
    With ``n_pad`` both are zero-padded — padding slots are neither sources
    nor dangling."""
    n = out_degree.shape[0]
    size = n if n_pad is None else n_pad
    out = np.zeros(size, dtype=np.float64)
    out[:n] = out_degree
    inv = np.where(out > 0, 1.0 / np.maximum(out, 1), 0.0)
    dang = np.zeros(size, dtype=np.float64)
    dang[:n] = out_degree == 0
    return inv, dang
