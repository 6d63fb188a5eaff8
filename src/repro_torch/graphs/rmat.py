"""R-MAT synthetic graph generator (Chakrabarti et al.).

A copy of the reference generator's in-RAM form: one ``default_rng(seed)``
stream draws ``scale`` level arrays of ``n_edges`` doubles and then one
vertex permutation, so the same ``(scale, n_edges, seed)`` gives the
bit-identical edge list in both packages (tests/test_torch_graphs.py pins
it).  The chunked emitter for out-of-core builds waits for the store slice.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import Graph


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
