"""R-MAT synthetic graph generator (Chakrabarti et al.).

A copy of the reference generator, host numpy.  Two entry shapes share
one random stream:

* :func:`rmat_edges` — all ``n_edges`` at once: one ``default_rng(seed)``
  stream draws ``scale`` level arrays of ``n_edges`` doubles and then one
  vertex permutation, so the same ``(scale, n_edges, seed)`` gives the
  bit-identical edge list in both packages (tests/test_torch_graphs.py).
* :func:`rmat_edge_chunks` — bounded ``(lo, src, dst)`` chunks of the same
  stream for the out-of-core build (:mod:`repro_torch.graphs.pipeline`),
  never holding the full edge list.

PCG64 consumes one 64-bit word per double, so chunk ``[lo, hi)`` of level
``ℓ`` sits at stream offset ``ℓ·n_edges + lo`` and the emitter reaches it
with ``PCG64(seed).advance(...)``; the permutation sits at
``scale·n_edges``.  Chunk ``[lo, hi)`` is therefore bit for bit
``rmat_edges(...)[lo:hi]`` at every boundary (tests/test_torch_pipeline.py).
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from repro_torch.graphs.csr import Graph


def _rng_at(seed: int, offset: int) -> np.random.Generator:
    """``default_rng(seed)`` fast-forwarded by ``offset`` double draws."""
    bg = np.random.PCG64(seed)
    bg.advance(offset)
    return np.random.Generator(bg)


def rmat_vertex_perm(scale: int, n_edges: int, seed: int = 0) -> np.ndarray:
    """The id-decorrelation permutation :func:`rmat_edges` applies last,
    drawn after the ``scale × n_edges`` level randoms, so a chunk emitter
    reaches it without drawing them."""
    return _rng_at(seed, scale * n_edges).permutation(1 << scale)


def rmat_chunk(
    scale: int,
    n_edges: int,
    lo: int,
    hi: int,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    perm: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Edges ``[lo, hi)`` of the ``(scale, n_edges, seed)`` R-MAT stream,
    bit for bit ``rmat_edges(...)[lo:hi]``.  ``perm`` lets a caller
    emitting many chunks reuse one :func:`rmat_vertex_perm`."""
    if not 0 <= lo <= hi <= n_edges:
        raise ValueError(f"chunk [{lo}, {hi}) outside [0, {n_edges})")
    k = hi - lo
    src = np.zeros(k, dtype=np.int64)
    dst = np.zeros(k, dtype=np.int64)
    for level in range(scale):
        r = _rng_at(seed, level * n_edges + lo).random(k)
        # quadrant choice: a (TL), b (TR), c (BL), d (BR)
        right = (r >= a) & (r < a + b) | (r >= a + b + c)
        down = r >= a + b
        src = src * 2 + down
        dst = dst * 2 + right
    if perm is None:
        perm = rmat_vertex_perm(scale, n_edges, seed)
    return perm[src].astype(np.int32), perm[dst].astype(np.int32)


def rmat_edge_chunks(
    scale: int,
    n_edges: int,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    chunk_edges: int = 1 << 20,
) -> Iterator[tuple[int, np.ndarray, np.ndarray]]:
    """Yield ``(lo, src, dst)`` chunks covering the edge stream in order.
    Peak memory is O(chunk_edges + 2**scale), independent of ``n_edges``."""
    if chunk_edges < 1:
        raise ValueError("chunk_edges must be >= 1")
    perm = rmat_vertex_perm(scale, n_edges, seed)
    for lo in range(0, n_edges, chunk_edges):
        hi = min(lo + chunk_edges, n_edges)
        src, dst = rmat_chunk(scale, n_edges, lo, hi, a=a, b=b, c=c,
                              seed=seed, perm=perm)
        yield lo, src, dst


def rmat_edges(
    scale: int,
    n_edges: int,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Generate ``n_edges`` edges over ``2**scale`` vertices (vectorized R-MAT)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(n_edges)
        # quadrant choice: a (TL), b (TR), c (BL), d (BR)
        right = (r >= a) & (r < a + b) | (r >= a + b + c)
        down = r >= a + b
        src = src * 2 + down
        dst = dst * 2 + right
    # permute vertex ids to decorrelate degree from id (standard practice)
    perm = rng.permutation(n)
    return perm[src].astype(np.int32), perm[dst].astype(np.int32)


def rmat_graph(scale: int, avg_degree: int = 8, seed: int = 0, dedupe: bool = True) -> Graph:
    n = 1 << scale
    src, dst = rmat_edges(scale, n * avg_degree, seed=seed)
    if dedupe:
        key = src.astype(np.int64) * n + dst
        _, idx = np.unique(key, return_index=True)
        src, dst = src[idx], dst[idx]
    return Graph.from_edges(n, src, dst)
