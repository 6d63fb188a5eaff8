"""Locality-aware vertex reordering: a copy of the reference's
``graphs/reorder.py`` for the port (host numpy only).

An ordering that places a vertex near its in-neighbours concentrates each
dst block's gathers into few source blocks, and lets the adaptive
schedules' partitions decouple so that certified skips accrue.

Orders (``perm[old_id] = new_id`` everywhere):

* ``bfs``    — breadth-first over the in-CSR from highest-degree seeds:
  each wave lands a vertex next to its in-neighbourhood.
* ``degree`` — descending (in+out) degree: hubs share blocks.
* ``random`` — seeded shuffle; the locality baseline.
* ``none``   — identity (keep the stored order).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import Graph, _concat_ranges

ORDERS = ("none", "bfs", "degree", "random")


def bfs_order(g: Graph, frontier_chunk: int = 1 << 17) -> np.ndarray:
    """BFS visitation order over the in-CSR; ``perm[old] = new``.

    Traversal follows **in-neighbours** (the only adjacency the dst-sorted
    in-CSR exposes without an O(m) transpose): popping ``v`` visits the
    sources of ``v``'s in-edges, which is exactly the set a dst block
    gathers from — BFS order therefore packs each block's gather window.
    Vertices unreachable through in-edges are re-seeded in descending
    degree order, so every component is covered and hubs anchor early,
    dense blocks.  The frontier is expanded in ``frontier_chunk`` slices to
    bound the transient neighbour gather.
    """
    n = g.n
    perm = np.empty(n, dtype=np.int64)
    if n == 0:
        return perm
    # plain views: indexing a memmap subclass costs microseconds a call
    in_ptr, src = np.asarray(g.in_ptr), np.asarray(g.src)
    indeg = np.asarray(in_ptr[1:]).astype(np.int64) - np.asarray(in_ptr[:-1])
    deg = indeg + np.asarray(g.out_degree).astype(np.int64)
    seeds = np.argsort(-deg, kind="stable")
    visited = np.zeros(n, dtype=bool)
    nxt = 0
    sp = 0  # seed cursor
    while nxt < n:
        while visited[seeds[sp]]:
            sp += 1
        v = int(seeds[sp])
        visited[v] = True
        perm[v] = nxt
        nxt += 1
        frontier = np.asarray([v], dtype=np.int64)
        while frontier.size:
            wave = []
            for lo in range(0, frontier.size, frontier_chunk):
                part = frontier[lo:lo + frontier_chunk]
                neigh = src[_concat_ranges(in_ptr, part)]
                cand = np.unique(neigh[~visited[neigh]])
                visited[cand] = True  # per-slice, so later slices dedupe
                wave.append(cand)
            frontier = np.concatenate(wave) if wave else np.zeros(0, np.int64)
            if frontier.size > 1:
                frontier = np.unique(frontier)  # deterministic wave order
            perm[frontier] = nxt + np.arange(frontier.size)
            nxt += frontier.size
    return perm


def degree_order(g: Graph) -> np.ndarray:
    """Descending (in+out)-degree order; ``perm[old] = new``."""
    indeg = np.asarray(g.in_ptr[1:]).astype(np.int64) \
        - np.asarray(g.in_ptr[:-1])
    deg = indeg + np.asarray(g.out_degree).astype(np.int64)
    order = np.argsort(-deg, kind="stable")
    perm = np.empty(g.n, dtype=np.int64)
    perm[order] = np.arange(g.n)
    return perm


def random_order(g: Graph, seed: int = 0) -> np.ndarray:
    """Seeded uniform shuffle — the locality baseline."""
    return np.random.default_rng(seed).permutation(g.n).astype(np.int64)


def compute_order(g: Graph, kind: str, seed: int = 0) -> np.ndarray:
    """Dispatch on :data:`ORDERS`; ``none`` returns the identity."""
    if kind == "none":
        return np.arange(g.n, dtype=np.int64)
    if kind == "bfs":
        return bfs_order(g)
    if kind == "degree":
        return degree_order(g)
    if kind == "random":
        return random_order(g, seed=seed)
    raise ValueError(f"unknown order {kind!r}; expected one of {ORDERS}")


def invert_perm(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


def permute_graph(g: Graph, perm: np.ndarray) -> Graph:
    """In-RAM rewrite of ``g`` under ``perm[old] = new``.  ``out_degree``
    is carried over per vertex — not recomputed from edges — so graphs
    whose degrees are authoritative (decomposition cores) stay exact."""
    inv = invert_perm(perm)
    ng = Graph.from_edges(
        g.n,
        np.asarray(perm[np.asarray(g.src)], dtype=np.int32),
        np.asarray(perm[np.asarray(g.dst)], dtype=np.int32),
        weights=None if g.weights is None else np.asarray(g.weights),
        bias=None if g.bias is None else np.asarray(g.bias)[inv],
    )
    ng.out_degree = np.asarray(g.out_degree)[inv].copy()
    return ng


def unpermute_ranks(pr: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Map a rank vector solved on the reordered graph back to original
    vertex ids: ``pr_original[o] = pr_stored[perm[o]]``.  Works on the last
    axis, so batched ``(b, n)`` PPR solutions un-permute too."""
    return np.asarray(pr)[..., perm]
