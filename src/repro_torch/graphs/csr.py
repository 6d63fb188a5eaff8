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


def _update_pairs(pairs, name: str, n: int) -> np.ndarray:
    """Validate one :meth:`Graph.apply_updates` operand into ``(k, 2)``
    int64 ``(src, dst)`` rows; ``None`` or empty become a zero-row array."""
    if pairs is None:
        return np.zeros((0, 2), dtype=np.int64)
    arr = np.asarray(pairs, dtype=np.int64)
    if arr.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"{name} must be a (k, 2) array of (src, dst) pairs")
    if arr.min() < 0 or arr.max() >= n:
        raise ValueError(f"{name} endpoint out of range [0, {n})")
    return arr


@dataclasses.dataclass
class GraphDelta:
    """Record of one :meth:`Graph.apply_updates` batch: the applied edge
    lists (in the dst-major order they were merged in), the vertices whose
    out- or in-edge sets changed, and the dangling transitions (a vertex
    losing its last out-edge turns its column of the walk matrix to zero).
    Incremental consumers localize their repair with it: the residual
    correction of :class:`repro_torch.core.dynamic.IncrementalPageRank`,
    :meth:`DecompositionPlan.touched_by` and the serving caches."""

    n: int
    added: np.ndarray  # (ka, 2) int64 (src, dst), dst-major applied order
    deleted: np.ndarray  # (kd, 2) int64, dst-major applied order
    added_weights: Optional[np.ndarray]  # (ka,) float64; None when unweighted
    touched_src: np.ndarray  # unique vertices whose out-edge set changed
    touched_dst: np.ndarray  # unique vertices whose in-edge set changed
    newly_dangling: np.ndarray  # out-degree dropped >0 -> 0
    undangled: np.ndarray  # out-degree rose 0 -> >0

    @property
    def num_ops(self) -> int:
        return int(self.added.shape[0] + self.deleted.shape[0])

    def touched_vertices(self) -> np.ndarray:
        """Unique vertices appearing as either endpoint of any update."""
        return np.unique(np.r_[self.touched_src, self.touched_dst])

    def touched_dst_blocks(self, block: int) -> np.ndarray:
        """Sorted unique dst blocks (width ``block``) the updates landed in."""
        if self.touched_dst.size == 0:
            return np.zeros(0, dtype=np.int64)
        return np.unique(self.touched_dst // block)


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

    def apply_updates(self, adds=None, dels=None,
                      add_weights: Optional[np.ndarray] = None
                      ) -> tuple["Graph", GraphDelta]:
        """Apply an edge-update batch and return ``(new_graph, delta)``.

        ``adds``/``dels`` are ``(k, 2)`` arrays of ``(src, dst)`` pairs over
        the existing vertex set (``n`` never changes).  The new graph is
        derived incrementally: the dst-sorted edge arrays are patched by one
        O(m + k) merge (deleted positions and insert positions found by
        binary search), and ``out_degree`` and ``in_ptr`` are shifted by
        per-endpoint deltas, never recounted from ``src`` (a plan's core
        keeps the full graph's out-degrees, which its own ``src`` does not
        give).  ``bias`` is carried through; ``self`` is left unmodified.
        The new dst-sorted in-CSR is the layout every device bundle reads,
        so there are no tiles to patch.

        * Deletions apply first, then additions: a batch may delete an edge
          and add it back (a weight update on weighted graphs).
        * Deleting an edge that does not exist raises ``ValueError``, as does
          deleting the same edge twice in one batch.
        * Adding an edge twice in one batch raises; adding an edge that
          exists after the batch's deletions raises on unweighted graphs.
          Weighted graphs permit parallel edges (the STIC-D contraction
          emits them); a delete removes the first copy in canonical order.
        * ``add_weights`` (per added edge, default all ones) is accepted on
          weighted graphs only."""
        n = self.n
        adds_a = _update_pairs(adds, "adds", n)
        dels_a = _update_pairs(dels, "dels", n)
        if add_weights is not None:
            if self.weights is None:
                raise ValueError("add_weights given but the graph is unweighted")
            add_w = np.asarray(add_weights, dtype=np.float64)
            if add_w.shape != (adds_a.shape[0],):
                raise ValueError(
                    f"add_weights must have shape ({adds_a.shape[0]},), "
                    f"got {add_w.shape}")
        elif self.weights is not None:
            add_w = np.ones(adds_a.shape[0], dtype=np.float64)
        else:
            add_w = None

        src, dst = self.src, self.dst
        m = self.m
        key = dst.astype(np.int64) * n + src  # ascending: the canonical order

        # deletions: locate each edge by binary search, check, mask out
        del_order = np.argsort(dels_a[:, 1] * n + dels_a[:, 0], kind="stable")
        dels_s = dels_a[del_order]
        dk = dels_s[:, 1] * n + dels_s[:, 0]
        if dk.size and np.any(dk[1:] == dk[:-1]):
            i = int(np.flatnonzero(dk[1:] == dk[:-1])[0])
            raise ValueError(
                f"duplicate delete of edge ({int(dels_s[i, 0])} -> "
                f"{int(dels_s[i, 1])}) in one batch")
        keep = np.ones(m, dtype=bool)
        if dk.size:
            pos = np.searchsorted(key, dk)
            ok = np.zeros(dk.size, dtype=bool)
            if m:
                ok = (pos < m) & (key[np.minimum(pos, m - 1)] == dk)
            if not np.all(ok):
                i = int(np.flatnonzero(~ok)[0])
                raise ValueError(
                    f"cannot delete nonexistent edge ({int(dels_s[i, 0])} -> "
                    f"{int(dels_s[i, 1])})")
            keep[pos] = False

        # additions: duplicate checks, then one sorted merge-insert
        add_order = np.argsort(adds_a[:, 1] * n + adds_a[:, 0], kind="stable")
        adds_s = adds_a[add_order]
        ak = adds_s[:, 1] * n + adds_s[:, 0]
        if ak.size and np.any(ak[1:] == ak[:-1]):
            i = int(np.flatnonzero(ak[1:] == ak[:-1])[0])
            raise ValueError(
                f"duplicate add of edge ({int(adds_s[i, 0])} -> "
                f"{int(adds_s[i, 1])}) in one batch")
        key_kept = key[keep]
        if ak.size and self.weights is None and key_kept.size:
            p = np.searchsorted(key_kept, ak)
            exists = (p < key_kept.size) \
                & (key_kept[np.minimum(p, key_kept.size - 1)] == ak)
            if np.any(exists):
                i = int(np.flatnonzero(exists)[0])
                raise ValueError(
                    f"duplicate add: edge ({int(adds_s[i, 0])} -> "
                    f"{int(adds_s[i, 1])}) already present (unweighted "
                    f"graphs reject parallel edges)")
        ins = np.searchsorted(key_kept, ak)
        new_src = np.insert(src[keep], ins, adds_s[:, 0].astype(src.dtype))
        new_dst = np.insert(dst[keep], ins, adds_s[:, 1].astype(dst.dtype))
        new_w = None
        if self.weights is not None:
            new_w = np.insert(self.weights[keep], ins, add_w[add_order])

        # derived state: per-endpoint count deltas, not a recount
        new_out = self.out_degree.astype(np.int32, copy=True)
        np.subtract.at(new_out, dels_a[:, 0], 1)
        np.add.at(new_out, adds_a[:, 0], 1)
        in_counts = np.diff(self.in_ptr)
        np.subtract.at(in_counts, dels_a[:, 1], 1)
        np.add.at(in_counts, adds_a[:, 1], 1)
        in_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(in_counts, out=in_ptr[1:])

        old_out = self.out_degree
        touched_src = np.unique(np.r_[adds_a[:, 0], dels_a[:, 0]])
        touched_dst = np.unique(np.r_[adds_a[:, 1], dels_a[:, 1]])
        delta = GraphDelta(
            n=n, added=adds_s, deleted=dels_s,
            added_weights=None if add_w is None else add_w[add_order],
            touched_src=touched_src, touched_dst=touched_dst,
            newly_dangling=touched_src[(old_out[touched_src] > 0)
                                       & (new_out[touched_src] == 0)],
            undangled=touched_src[(old_out[touched_src] == 0)
                                  & (new_out[touched_src] > 0)],
        )
        g_new = Graph.from_arrays(n, new_src, new_dst, new_out, in_ptr,
                                  weights=new_w, bias=self.bias)
        return g_new, delta

    def out_csr(self):
        """CSR over out-links: ``(out_ptr, out_dst, edge_slot)``.

        ``edge_slot[j]`` gives, for the j-th edge in src-sorted order, its
        index in the canonical dst-sorted order: the paper's ``offsetList``
        (Alg 2 line 11), where a vertex writes its contribution so that the
        destination's in-link scan finds it contiguously.  Computed on each
        call (the port's ``Graph`` carries no cache)."""
        order = np.lexsort((self.dst, self.src))
        out_ptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.src, minlength=self.n), out=out_ptr[1:])
        return out_ptr, self.dst[order], order.astype(np.int64)

    def in_neighbor_classes(self) -> np.ndarray:
        """STIC-D 'identical nodes': class id per vertex; vertices with the
        same in-neighbour set share a class (identical PageRank).  Classes
        are numbered in order of first appearance, as the reference's are.

        On weighted/biased graphs the class key also covers the in-edge
        weights and the vertex's bias: two vertices share a rank only when
        their whole update rule matches, not just the neighbour set."""
        keys = {}
        cls_of = np.empty(self.n, dtype=np.int64)
        for u in range(self.n):
            lo, hi = self.in_ptr[u], self.in_ptr[u + 1]
            key = self.src[lo:hi].tobytes()
            if self.weights is not None:
                key = (key, self.weights[lo:hi].tobytes())
            if self.bias is not None:
                key = (key, float(self.bias[u]))
            cls_of[u] = keys.setdefault(key, len(keys))
        return cls_of

    def chain_nodes(self) -> np.ndarray:
        """STIC-D 'chain nodes': (n,) bool mask of in-degree-1/out-degree-1
        path vertices whose rank is a closed form of the chain head's rank.

        A run of such vertices is an affine function of its first non-chain
        ancestor, the *head*.  Members of pure indeg-1/outdeg-1 cycles have
        no head and are excluded: their ranks are genuinely iterative."""
        indeg = np.diff(self.in_ptr)
        cand = (indeg == 1) & (self.out_degree == 1)
        ok = np.zeros(self.n, dtype=bool)
        if not cand.any():
            return ok
        cidx = np.flatnonzero(cand)
        pred = self.src[self.in_ptr[:-1][cidx]]  # the single in-edge
        # headed-ness flows down the chains frontier by frontier (a
        # candidate successor's only predecessor is the frontier vertex);
        # cycle members never acquire it
        ok[cidx] = ~cand[pred]
        out_ptr, out_dst, _ = self.out_csr()
        frontier = np.flatnonzero(ok)
        while frontier.size:
            succ = out_dst[_concat_ranges(out_ptr, frontier)]
            newly = np.unique(succ[cand[succ] & ~ok[succ]])
            ok[newly] = True
            frontier = newly
        return ok

    def source_chain_nodes(self) -> np.ndarray:
        """STIC-D 'source chains': (n,) bool mask of indeg-0/outdeg-1
        vertices.  Their rank is ``base·bias`` exactly, and the run they
        start folds into its terminal's bias with no contracted edge."""
        indeg = np.diff(self.in_ptr)
        return (indeg == 0) & (self.out_degree == 1)

    def dead_nodes(self) -> np.ndarray:
        """STIC-D 'dead nodes': (n,) bool mask of vertices from which every
        forward path ends in a sink, the least fixed point of "out-degree
        0, or all out-neighbours dead".  Cycles are never marked, so the
        dead set induces a DAG that reconstruction walks topologically."""
        dead = self.out_degree == 0
        frontier = np.flatnonzero(dead)
        if frontier.size == 0:
            return dead
        # Kahn-style peel: live_out[u] counts u's edges to live vertices,
        # so every edge is touched once overall
        live_out = self.out_degree.astype(np.int64)
        while frontier.size:
            srcs = self.src[_concat_ranges(self.in_ptr, frontier)]
            np.subtract.at(live_out, srcs, 1)
            touched = np.unique(srcs)
            newly = touched[(live_out[touched] == 0) & ~dead[touched]]
            dead[newly] = True
            frontier = newly
        return dead


def _concat_ranges(ptr: np.ndarray, verts: np.ndarray) -> np.ndarray:
    """Concatenated CSR index ranges ``ptr[v]:ptr[v+1]`` for each v in
    ``verts``, so a frontier wave touches only the edges of the previous
    wave."""
    starts = ptr[verts]
    lens = (ptr[verts + 1] - starts).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    off = np.repeat(starts - np.r_[0, np.cumsum(lens)[:-1]], lens)
    return off + np.arange(total, dtype=np.int64)


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


# The solver's DEFAULT_DAMPING (csr is the dependency-free base layer, so
# it is not imported).  Contracted-edge weights are powers of d, so a plan
# bakes a concrete d; repro_torch.core.solver.plan_run re-plans when the
# run-time d differs.
_DEFAULT_DAMPING = 0.85


@dataclasses.dataclass
class DecompositionPlan:
    """Build-time STIC-D decomposition (paper Alg 4): prune identical,
    chain and dead vertices out of the iteration, solve the shrunken
    *core*, reconstruct the full vector afterwards.

    The core is an ordinary :class:`Graph` that keeps the **full graph's**
    out-degrees (a core vertex still leaks mass to its pruned
    out-neighbours), so any registered variant solves it unchanged.
    Removed, all exactly:

    * **identical**: non-representative members of an identical
      in-neighbour class whose out-degree matches the representative's;
      their out-edges are rewired to the representative;
    * **chain** (:meth:`Graph.chain_nodes`) and **source chain**
      (:meth:`Graph.source_chain_nodes`): with ``contract=True`` a run
      ``u→c₁→…→c_k→v`` re-entering the core becomes one weighted core edge
      ``u→v`` (``d^k`` on unit weights), and the run's teleport
      contribution is folded into ``v``'s bias; source-chain runs fold the
      bias and emit no edge.  ``contract=False`` keeps only the suffixes
      that drain into the dead region;
    * **dead** (:meth:`Graph.dead_nodes`): restored after the core
      converges, in topological waves.

    A contracted edge may duplicate an existing core edge; both are kept
    (parallel edges sum).  Dangling redistribution is a scalar rescale of
    the plain fixed point, so the core always solves with
    ``handle_dangling=False`` and :meth:`reconstruct` applies it; that
    needs a uniform full-graph teleport, so a biased input graph is
    rejected under ``handle_dangling``."""

    n: int
    core: Graph  # shrunken graph; out_degree holds the FULL graph's degrees
    core_index: np.ndarray  # (n_core,) full-graph ids of core vertices
    full_to_core: np.ndarray  # (n,) core slot per vertex, -1 if pruned
    struct_pruned: np.ndarray  # (n,) bool: chain/source-chain/dead prune set
    chain_mask: np.ndarray  # (n,) bool: Graph.chain_nodes()
    source_mask: np.ndarray  # (n,) bool: Graph.source_chain_nodes()
    dead_mask: np.ndarray  # (n,) bool: Graph.dead_nodes()
    ident_members: np.ndarray  # (k,) full ids pruned by identical rewiring
    ident_reps: np.ndarray  # (k,) their (core) representatives
    full: Graph  # original graph: reconstruction reads its edges
    d: float  # damping factor baked into contracted weights and bias folds
    contracted_m: int  # weighted core edges emitted by chain contraction
    d_dependent: bool = False  # core weights/bias encode d
    # the full graph's out-CSR (Graph.out_csr), built once when anything
    # was struct-pruned: the contraction walk and every reconstruct read it
    full_out: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def pruned(self) -> np.ndarray:
        """(n,) bool mask of every vertex the core solve does not iterate."""
        out = self.struct_pruned.copy()
        out[self.ident_members] = True
        return out

    def touched_by(self, delta: GraphDelta) -> bool:
        """True when an update batch breaks an analysis the plan baked, so
        it must be re-planned (:meth:`from_graph`) instead of patched: an
        endpoint of an added or deleted edge is a pruned vertex or an
        identical-class representative (a chain vertex gaining an in-edge,
        a dead vertex gaining an escape, a representative's in-set or
        out-degree leaving its members').  Updates among ordinary core
        vertices are safe to :meth:`patched`: an add only raises core
        degrees, a delete can at worst leave a core vertex that could now
        be pruned, and every core contribution divides by the patched full
        out-degree."""
        if delta.num_ops == 0:
            return False
        hot = self.pruned  # a fresh copy
        hot[self.ident_reps] = True
        return bool(hot[delta.touched_vertices()].any())

    def patched(self, g_new: Graph, delta: GraphDelta) -> "DecompositionPlan":
        """The same analyses over the updated graphs, when
        :meth:`touched_by` is False (raises otherwise): the batch is
        replayed on the core through ``full_to_core`` (every endpoint is a
        core vertex), so the core's full-graph out-degrees shift by the
        full graph's ±1, and the full graph and its out-CSR
        (:attr:`full_out`, which :meth:`reconstruct` reads) become
        ``g_new``'s.  Masks, contracted edges and bias folds stay."""
        if self.touched_by(delta):
            raise ValueError(
                "update touches a pruned vertex or identical-class "
                "representative; re-plan with DecompositionPlan.from_graph")
        if delta.num_ops == 0:
            return dataclasses.replace(self, full=g_new)
        core_adds = self.full_to_core[delta.added]
        core_dels = self.full_to_core[delta.deleted]
        add_w = None
        if self.core.weights is not None:
            add_w = delta.added_weights
            if add_w is None:
                add_w = np.ones(core_adds.shape[0], dtype=np.float64)
        core_new, _ = self.core.apply_updates(core_adds, core_dels,
                                              add_weights=add_w)
        full_out = g_new.out_csr() if self.full_out is not None else None
        return dataclasses.replace(self, core=core_new, full=g_new,
                                   full_out=full_out)

    @classmethod
    def from_graph(cls, g: Graph, identical: bool = True, chains: bool = True,
                   dead: bool = True, contract: bool = True,
                   d: float = _DEFAULT_DAMPING) -> "DecompositionPlan":
        n = g.n
        chain_mask = g.chain_nodes() if chains else np.zeros(n, dtype=bool)
        dead_mask = g.dead_nodes() if dead else np.zeros(n, dtype=bool)
        source_mask = (g.source_chain_nodes() if (chains and contract)
                       else np.zeros(n, dtype=bool))
        chainlike = chain_mask | source_mask
        if contract:
            # every chainlike vertex is prunable: runs re-entering the core
            # are contracted below, runs draining into the dead region are
            # inside the (closed) dead set already
            struct_pruned = chainlike | dead_mask
        else:
            # suffix-only closure: drop candidates with an out-edge leaving
            # the set until none remain
            s = chain_mask | dead_mask
            if s.any():
                escaping = np.unique(g.src[s[g.src] & ~s[g.dst]])
                while escaping.size:
                    s[escaping] = False
                    srcs = np.unique(g.src[_concat_ranges(g.in_ptr, escaping)])
                    escaping = srcs[s[srcs]]
            struct_pruned = s

        # identical rewiring: equal out-degree makes the rewired edge's
        # pr(rep)/outdeg(rep) equal pr(member)/outdeg(member)
        rewire = np.arange(n, dtype=np.int64)
        ident_members: list[int] = []
        ident_reps: list[int] = []
        if identical and n:
            cls_of = g.in_neighbor_classes()
            order = np.argsort(cls_of, kind="stable")
            bounds = np.flatnonzero(
                np.r_[True, cls_of[order][1:] != cls_of[order][:-1], True])
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                members = order[lo:hi]
                members = members[~struct_pruned[members]]
                if members.size < 2:
                    continue
                rep = int(members[0])
                for m in members[1:]:
                    if g.out_degree[m] == g.out_degree[rep]:
                        ident_members.append(int(m))
                        ident_reps.append(rep)
                        rewire[m] = rep
        ident_members_a = np.asarray(ident_members, dtype=np.int64)
        ident_reps_a = np.asarray(ident_reps, dtype=np.int64)

        pruned = struct_pruned.copy()
        pruned[ident_members_a] = True
        full_to_core = np.full(n, -1, dtype=np.int64)
        core_index = np.flatnonzero(~pruned)
        full_to_core[core_index] = np.arange(core_index.size)
        full_out = g.out_csr() if struct_pruned.any() else None

        # Chain contraction: walk every maximal chainlike run carrying the
        # affine closed form pr(c_i) = base·A_i + B_i·pr(u)/od(u)
        # (A_1 = bias(c_1); B_1 = d·w(u→c_1), or 0 for a source-chain run;
        # A_{i+1} = bias(c_{i+1}) + d·w_i·A_i; B_{i+1} = d·w_i·B_i).  A run
        # whose terminal edge c_k→t (weight w_t) lands on a core vertex
        # folds d·w_t·A_k into t's bias and emits the core edge u→t with
        # weight w_t·B_k.
        bias_fold = np.zeros(n, dtype=np.float64)
        extra_src: list[int] = []
        extra_dst: list[int] = []
        extra_w: list[float] = []
        if contract and chainlike.any():
            w_full = g.weights
            beta = g.bias
            out_ptr, out_dst, out_slot = full_out
            pred = np.full(n, -1, dtype=np.int64)
            cidx = np.flatnonzero(chain_mask)
            pred[cidx] = g.src[g.in_ptr[:-1][cidx]]  # the single in-edge
            starts = np.flatnonzero(
                chainlike & (source_mask | ~chainlike[np.maximum(pred, 0)]))
            for v0 in starts:
                headless = bool(source_mask[v0])
                A = 1.0 if beta is None else float(beta[v0])
                if headless:
                    B = 0.0
                else:
                    w0 = 1.0 if w_full is None else float(w_full[g.in_ptr[v0]])
                    B = d * w0
                v = int(v0)
                while True:
                    j = out_ptr[v]  # outdeg 1: the single out-edge
                    succ = int(out_dst[j])
                    w_out = 1.0 if w_full is None else float(w_full[out_slot[j]])
                    if not chainlike[succ]:
                        break
                    A = (1.0 if beta is None else float(beta[succ])) \
                        + d * w_out * A
                    B = d * w_out * B
                    v = succ
                if struct_pruned[succ]:
                    continue  # the run drains into the dead region
                # a chain-fed vertex is a singleton identical class, so the
                # terminal is a core vertex
                assert full_to_core[succ] >= 0, (v0, succ)
                bias_fold[succ] += d * w_out * A
                if not headless:
                    hu = int(rewire[pred[v0]])
                    assert full_to_core[hu] >= 0, (v0, hu)
                    extra_src.append(hu)
                    extra_dst.append(succ)
                    extra_w.append(w_out * B)

        if pruned.any():
            # keep edges between core vertices (identical members' sources
            # rewired); edges out of the struct-pruned set are replaced by
            # the contracted edges and bias folds above
            keep = ~pruned[g.dst] & ~struct_pruned[g.src]
            csrc = full_to_core[rewire[g.src[keep]]]
            cdst = full_to_core[g.dst[keep]]
            weights: Optional[np.ndarray] = None
            if g.weights is not None or extra_w:
                kept_w = (g.weights[keep] if g.weights is not None
                          else np.ones(csrc.size, dtype=np.float64))
                weights = np.r_[kept_w, np.asarray(extra_w, dtype=np.float64)]
            if extra_src:
                csrc = np.r_[csrc, full_to_core[np.asarray(extra_src)]]
                cdst = np.r_[cdst, full_to_core[np.asarray(extra_dst)]]
            core_bias: Optional[np.ndarray] = None
            if g.bias is not None or bias_fold.any():
                core_bias = (g.bias[core_index].copy() if g.bias is not None
                             else np.ones(core_index.size, dtype=np.float64))
                core_bias += bias_fold[core_index]
            core = Graph.from_edges(int(core_index.size), csrc.astype(np.int32),
                                    cdst.astype(np.int32), weights=weights,
                                    bias=core_bias)
            # contributions divide by the FULL graph's out-degree
            core.out_degree = g.out_degree[core_index].copy()
        else:
            core = g
        return cls(
            n=n, core=core, core_index=core_index, full_to_core=full_to_core,
            struct_pruned=struct_pruned, chain_mask=chain_mask,
            source_mask=source_mask, dead_mask=dead_mask,
            ident_members=ident_members_a, ident_reps=ident_reps_a, full=g,
            d=float(d), contracted_m=len(extra_w),
            d_dependent=bool(extra_w) or bool(bias_fold.any()),
            full_out=full_out,
        )

    def stats(self) -> dict:
        """Vertex and edge counters of the plan (``pruned_chain`` covers
        headed and source chains; ``core_m = full_m - pruned_edges +
        contracted_edges``)."""
        chainlike = self.chain_mask | self.source_mask
        return {
            "full_n": self.n,
            "full_m": self.full.m,
            "core_n": self.core.n,
            "core_m": self.core.m,
            "pruned_identical": int(self.ident_members.size),
            "pruned_chain": int((self.struct_pruned & chainlike).sum()),
            "pruned_dead": int((self.struct_pruned & ~chainlike).sum()),
            "pruned_edges": self.full.m + self.contracted_m - self.core.m,
            "contracted_edges": self.contracted_m,
        }

    def reconstruct(self, core_pr, d: float = _DEFAULT_DAMPING,
                    handle_dangling: bool = False) -> np.ndarray:
        """The full-length float64 rank vector from the core solution.

        ``core_pr`` is the core solved with its own ``(1-d)/n_core`` base
        and ``handle_dangling=False``.  It is rescaled by ``n_core / n``,
        identical members copy their representatives, pruned vertices are
        computed in topological waves, and with ``handle_dangling`` the
        whole vector is scaled by ``base/(base − (d/n)·Σ_dangling pr)``,
        the redistributed fixed point's factor (exact on weighted graphs
        too)."""
        g = self.full
        n = self.n
        if self.d_dependent and not np.isclose(d, self.d):
            raise ValueError(
                f"plan was contracted for d={self.d} but reconstruct got "
                f"d={d}; re-plan with DecompositionPlan.from_graph(..., d={d})")
        if handle_dangling and g.bias is not None:
            raise ValueError(
                "closed-form dangling redistribution (L1 normalisation) "
                "requires a uniform full-graph teleport; solve the biased "
                "graph with handle_dangling=False")
        pr = np.zeros(n, dtype=np.float64)
        if n == 0:
            return pr
        core_pr = np.asarray(core_pr, dtype=np.float64)
        if core_pr.shape != (self.core.n,):
            raise ValueError(
                f"core_pr has shape {core_pr.shape}, expected ({self.core.n},)")
        if self.core.n:
            pr[self.core_index] = core_pr * (self.core.n / n)
        pr[self.ident_members] = pr[self.ident_reps]

        inv_out, _ = inv_out_and_dangling(g.out_degree)
        w_full = g.weights
        beta = g.bias
        base = (1.0 - d) / n
        # Kahn pass: unknown_in counts in-edges from not-yet-computed
        # struct-pruned sources; a vertex is ready at zero
        struct = self.struct_pruned
        if struct.any():
            unknown_in = np.bincount(g.dst[struct[g.src]], minlength=n)
            done = np.zeros(n, dtype=bool)
            n_done = 0
            out_ptr, out_dst, _ = self.full_out
            ready = np.flatnonzero(struct & (unknown_in == 0))
            while ready.size:
                idx = _concat_ranges(g.in_ptr, ready)
                srcs = g.src[idx]
                lens = g.in_ptr[ready + 1] - g.in_ptr[ready]
                seg = np.repeat(np.arange(ready.size), lens)
                vals = pr[srcs] * inv_out[srcs]
                if w_full is not None:
                    vals = vals * w_full[idx]
                acc = np.bincount(seg, weights=vals, minlength=ready.size)
                pr[ready] = base * (beta[ready] if beta is not None else 1.0) \
                    + d * acc
                done[ready] = True
                n_done += ready.size
                succ = out_dst[_concat_ranges(out_ptr, ready)]
                np.subtract.at(unknown_in, succ, 1)
                touched = np.unique(succ)
                ready = touched[struct[touched] & ~done[touched]
                                & (unknown_in[touched] == 0)]
            if n_done != int(struct.sum()):
                raise AssertionError(
                    "decomposition reconstruction stalled: pruned set has a "
                    "cycle (chain_nodes/dead_nodes invariant violated)")
        if handle_dangling:
            # q = c·pr with c = base/(base − (d/n)·Σ_dang pr): substitute
            # q = c·pr into q = base·1 + d·W·q + (d/n)(Σ_dang q)·1
            dang_mass = pr[g.out_degree == 0].sum()
            denom = base - (d / n) * dang_mass
            if denom > 0:
                pr = pr * (base / denom)
        return pr
