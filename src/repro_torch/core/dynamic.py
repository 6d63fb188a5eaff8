"""Dynamic incremental PageRank: edge-stream updates with delta-push repair.

The maintained object is a pair ``(est, resid)`` over the current graph
with the Neumann-series invariant

    pr* = est + (I − d·Mᵀ)⁻¹ · resid

where ``pr*`` is the exact (float64, leaky-convention) fixed point and
``resid`` the signed rank defect ``(base·bias + d·Mᵀ·est) − est``.  Since
``‖(I − d·Mᵀ)⁻¹‖₁ ≤ 1/(1−d)`` for a substochastic ``M``,

    ‖pr* − est‖₁  ≤  Σ_v |resid[v]| / (1 − d)

is an a-posteriori L1 certificate, available at any time without ``pr*``.

An edge batch changes only the columns of ``M`` of the sources whose
out-edge set changed (``delta.touched_src``; an out-degree change rescales
the whole column), so the residual is repaired locally, in O(Σ deg of the
touched sources):

    resid += d · (M_newᵀ − M_oldᵀ) · est

Then a signed forward push (:func:`repro_torch.ppr.push.push_residual` with
``bank=1.0``) drains ``resid`` until the certificate meets ``tol``.  Pushes
decay by ``d`` a hop and die at dangling vertices, so updates near sinks
stay local.  When the cascade goes global (``max_push_rounds`` runs out)
the engine falls back to a warm global solve by the configured registry
variant, seeded with the current estimate through the ``pr0`` transport
option and run on the variant's device (the CUDA kernels for ``blocked``
and ``blocked_nosync`` on the card), then re-certifies with an exact
float64 residual and a refinement push.  The fixed point does not depend
on the start, so a warm start buys iterations, never correctness.

A plan-staged variant keeps its :class:`DecompositionPlan` across updates,
patching it (a replay on the core) while no update endpoint touches a
pruned or contracted vertex and re-planning it only when one does.

The repair and the certificate are host float64 numpy, as in the
reference; only the solves run on the device.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.solver import (
    DEFAULT_DAMPING,
    PlannedBundle,
    build_variant,
    warm_start_pr,
)
from repro_torch.graphs.csr import Graph, _concat_ranges

__all__ = [
    "IncrementalPageRank",
    "UpdateReport",
    "exact_residual",
    "make_update_injector",
    "random_update_batch",
]


def exact_residual(g: Graph, est: np.ndarray, *,
                   d: float = DEFAULT_DAMPING) -> np.ndarray:
    """Signed float64 rank defect ``(base·bias + d·Mᵀ·est) − est`` of an
    estimate against ``g`` (leaky dangling convention, the engine's
    invariant).  Zero exactly at the fixed point."""
    n = int(g.n)
    est = np.asarray(est, dtype=np.float64)
    if est.shape != (n,):
        raise ValueError(f"est must have shape ({n},), got {est.shape}")
    if n == 0:
        return est.copy()
    return warm_start_pr(g, est, d=d, handle_dangling=False) - est


def _column_correction(r: np.ndarray, g: Graph, us, est: np.ndarray,
                       d: float, sign: float) -> None:
    """Add ``sign · d · Mᵀ(g)|cols · est`` into ``r`` for the columns
    ``us`` (a :class:`GraphDelta`'s ``touched_src``): one side of
    ``resid += d(M_new − M_old)ᵀ est``."""
    us = np.asarray(us, dtype=np.int64)
    if us.size == 0:
        return
    out_ptr, out_dst, out_slot = g.out_csr()
    deg = g.out_degree.astype(np.int64)[us]
    live = deg > 0
    if not live.any():
        return
    ul, dl = us[live], deg[live]
    eidx = _concat_ranges(out_ptr, ul)
    vals = np.repeat(sign * d * est[ul] / dl, dl)
    if g.weights is not None:
        vals = vals * g.weights[out_slot][eidx]
    np.add.at(r, out_dst[eidx], vals)


def _host64(pr) -> np.ndarray:
    """A solve's ranks as a fresh host float64 array (one device-to-host
    copy when the variant returns a tensor on the card)."""
    if isinstance(pr, torch.Tensor):
        pr = pr.detach().cpu().numpy()
    return np.array(pr, dtype=np.float64)


@dataclasses.dataclass
class UpdateReport:
    """What one :meth:`IncrementalPageRank.apply` batch cost and certified.

    ``mode`` is ``"push"`` (the local repair met the certificate),
    ``"fallback"`` (warm global solve and refinement) or ``"noop"`` (empty
    batch).  ``touched``/``touched_frac`` count the vertices the repair
    pushed or scattered into (a fallback touches all of them).
    ``l1_cert`` bounds ``‖pr* − est‖₁`` after the batch; ``converged`` says
    it met ``tol``."""

    mode: str
    num_ops: int
    rounds: int = 0
    pushes: int = 0
    touched: int = 0
    touched_frac: float = 0.0
    l1_cert: float = 0.0
    converged: bool = True
    plan_action: str = "none"  # "none" | "patched" | "invalidated"


class IncrementalPageRank:
    """Certified PageRank over an evolving graph.

    >>> ipr = IncrementalPageRank(g, variant="blocked_nosync", device="cuda")
    >>> rep = ipr.apply(adds=[[3, 7]], dels=[[0, 5]])
    >>> ipr.pagerank        # ‖pr* − est‖₁ ≤ ipr.certificate

    ``variant`` names the port's registry solver of the initial solve and
    of every fallback, built with ``opts`` (``device`` among them: the card
    unless the caller asks for the CPU); its bundle is rebuilt lazily after
    updates.  Only the leaky convention (``handle_dangling=False``) is
    supported: redistribution makes every column dense in the dangling
    rows, which defeats local repair."""

    def __init__(self, g: Graph, *, variant: str = "sequential",
                 d: float = DEFAULT_DAMPING, tol: float = 1e-8,
                 max_push_rounds: int = 10_000,
                 handle_dangling: bool = False, **opts):
        if handle_dangling:
            raise NotImplementedError(
                "IncrementalPageRank supports only the leaky convention "
                "(handle_dangling=False); dangling redistribution is dense "
                "and defeats local repair")
        self.g = g
        self.variant = variant
        self.d = float(d)
        self.tol = float(tol)
        self.max_push_rounds = int(max_push_rounds)
        self.opts = dict(opts)
        self._plan = None
        self._template = None
        self._bundle = None
        v, bundle = self._ensure_bundle()
        t0 = time.perf_counter()
        res = v.run(bundle, d=self.d, threshold=self.tol, max_iter=100_000,
                    handle_dangling=False, **self.opts)
        self.est = _host64(res.pr)
        t1 = time.perf_counter()
        self.resid = exact_residual(g, self.est, d=self.d)
        # a float32 solve stops at a certificate floor above a tight tol;
        # one float64 refinement closes the gap up front
        rounds, pushes = self._refine()
        # what the initial solve and its refinement cost (host clock)
        self.init_report = dict(
            iterations=res.iterations, solve_s=t1 - t0,
            refine_rounds=rounds, refine_pushes=pushes,
            refine_s=time.perf_counter() - t1)

    @property
    def n(self) -> int:
        return int(self.g.n)

    @property
    def pagerank(self) -> np.ndarray:
        """Current float64 estimate; ``‖pr* − est‖₁ ≤`` :attr:`certificate`."""
        return self.est

    @property
    def certificate(self) -> float:
        """A-posteriori bound on ``‖pr* − est‖₁``: ``Σ|resid|/(1−d)``."""
        return float(np.abs(self.resid).sum() / (1.0 - self.d))

    @property
    def _target(self) -> float:
        return (1.0 - self.d) * self.tol  # certificate ≤ tol ⇔ Σ|r| ≤ this

    def _refine(self, touched: np.ndarray | None = None) -> tuple[int, int]:
        """One signed drain at an ``rmax`` small enough that full drainage
        meets the certificate (``n·rmax ≤ target/2``)."""
        from repro_torch.ppr.push import push_residual

        rmax = self._target / (2.0 * max(self.n, 1))
        return push_residual(
            self.g, self.est, self.resid, d=self.d, rmax=rmax, bank=1.0,
            signed=True, handle_dangling=False,
            max_rounds=self.max_push_rounds, touched=touched)

    def _ensure_bundle(self):
        if self._bundle is None:
            if self._plan is not None:
                # the patched plan survives: rebuild only the core's bundle
                inner = (self._template.inner.build(
                    self._plan.core, **self._template.build_opts)
                    if self._plan.core.n else None)
                self._bundle = dataclasses.replace(
                    self._template, plan=self._plan, bundle=inner)
                self._template = self._bundle
            else:
                self._variant_obj, self._bundle = build_variant(
                    self.variant, self.g, d=self.d, **self.opts)
                if isinstance(self._bundle, PlannedBundle):
                    self._plan = self._bundle.plan
                    self._template = self._bundle
        return self._variant_obj, self._bundle

    def apply(self, adds=None, dels=None, add_weights=None) -> UpdateReport:
        """Apply one edge batch (deletes first, then adds: see
        :meth:`Graph.apply_updates`), repair the ranks, and certify."""
        g_old = self.g
        g_new, delta = g_old.apply_updates(adds=adds, dels=dels,
                                           add_weights=add_weights)
        if delta.num_ops == 0:
            return UpdateReport(mode="noop", num_ops=0, l1_cert=self.certificate)

        plan_action = "none"
        if self._plan is not None:
            if self._plan.touched_by(delta):
                self._plan = None  # re-planned lazily at the next fallback
                plan_action = "invalidated"
            else:
                self._plan = self._plan.patched(g_new, delta)
                plan_action = "patched"
        self._bundle = None  # stale for g_new either way

        _column_correction(self.resid, g_old, delta.touched_src, self.est,
                           self.d, sign=-1.0)
        _column_correction(self.resid, g_new, delta.touched_src, self.est,
                           self.d, sign=+1.0)
        self.g = g_new

        touched = np.zeros(self.n, dtype=bool)
        touched[delta.touched_vertices()] = True
        rounds, pushes = self._refine(touched=touched)
        if float(np.abs(self.resid).sum()) <= self._target:
            return UpdateReport(
                mode="push", num_ops=delta.num_ops, rounds=rounds,
                pushes=pushes, touched=int(touched.sum()),
                touched_frac=float(touched.sum()) / max(self.n, 1),
                l1_cert=self.certificate, converged=True,
                plan_action=plan_action)

        # fallback: warm global solve from the partly repaired estimate,
        # then the exact residual and a refinement to re-certify
        v, bundle = self._ensure_bundle()
        res = v.run(bundle, d=self.d, threshold=self.tol, max_iter=100_000,
                    handle_dangling=False, pr0=self.est, **self.opts)
        self.est = _host64(res.pr)
        self.resid = exact_residual(self.g, self.est, d=self.d)
        r2, p2 = self._refine()
        cert = self.certificate
        return UpdateReport(
            mode="fallback", num_ops=delta.num_ops, rounds=rounds + r2,
            pushes=pushes + p2, touched=self.n, touched_frac=1.0,
            l1_cert=cert, converged=cert <= self.tol, plan_action=plan_action)


# ---------------------------------------------------------------------------
# Update streams (tests, chip_smoke.py, the serve launcher)
# ---------------------------------------------------------------------------


def random_update_batch(
    g: Graph,
    rng: np.random.Generator,
    n_ops: int,
    *,
    frac_adds: float = 0.5,
    localized: bool = False,
) -> tuple[np.ndarray | None, np.ndarray | None]:
    """Sample one valid ``(adds, dels)`` batch against the current graph.

    ``localized=False``, a uniform stream: deletes are distinct existing
    edges (drawn among the distinct edge keys, so a graph with parallel
    edges never gets the same pair twice); adds are pairs absent from the
    surviving edge set.  On a graph without parallel edges the draw is the
    reference's for the same generator state.

    ``localized=True``, a sink-bounded stream: adds go from a dangling
    vertex to another dangling vertex (the new column routes rank into a
    sink, where the push dies in one hop); deletes remove the single
    out-edge of a degree-1 vertex pointing at a sink.  Counts are clamped
    to the candidates; callers read the returned shapes."""
    n = int(g.n)
    n_adds = int(round(n_ops * frac_adds))
    n_dels = n_ops - n_adds
    src = np.asarray(g.src, dtype=np.int64)
    dst = np.asarray(g.dst, dtype=np.int64)
    key = dst * n + src  # canonical (ascending) edge keys
    outdeg = np.asarray(g.out_degree, dtype=np.int64)

    if localized:
        dang = np.flatnonzero(outdeg == 0)
        cand_del = np.flatnonzero((outdeg[src] == 1) & (outdeg[dst] == 0))
        # one delete per degree-1 source (its only out-edge)
        if cand_del.size:
            _, first = np.unique(src[cand_del], return_index=True)
            cand_del = cand_del[first]
        n_dels = min(n_dels, cand_del.size)
        dels = None
        if n_dels:
            pick = rng.choice(cand_del.size, size=n_dels, replace=False)
            dels = np.stack([src[cand_del[pick]], dst[cand_del[pick]]], axis=1)
        # distinct dangling sources, dangling targets, no self-pairs
        n_adds = min(n_adds, max(dang.size - 1, 0))
        adds = None
        if n_adds:
            us = rng.choice(dang, size=n_adds, replace=False)
            vs = rng.choice(dang, size=n_adds)
            clash = vs == us
            while clash.any():  # re-draw self-pairs (dang.size ≥ 2 here)
                vs[clash] = rng.choice(dang, size=int(clash.sum()))
                clash = vs == us
            adds = np.stack([us, vs], axis=1)
        return adds, dels

    # the first copy of each distinct key: every edge on a graph without
    # parallel edges, so the draw below is the reference's there
    first = np.flatnonzero(np.r_[True, key[1:] != key[:-1]]) if key.size \
        else np.zeros(0, dtype=np.int64)
    n_dels = min(n_dels, first.size)
    dels = None
    surviving = key
    if n_dels:
        pick = first[rng.choice(first.size, size=n_dels, replace=False)]
        dels = np.stack([src[pick], dst[pick]], axis=1)
        surviving = np.delete(key, pick)
    adds_list: list[np.ndarray] = []
    seen = set()
    need = n_adds
    while need > 0:
        cs = rng.integers(0, n, size=2 * need)
        cd = rng.integers(0, n, size=2 * need)
        ck = cd * n + cs
        pos = np.searchsorted(surviving, ck)
        in_set = pos < surviving.size
        in_set[in_set] = surviving[pos[in_set]] == ck[in_set]
        fresh = ~in_set
        for s, t, k in zip(cs[fresh], cd[fresh], ck[fresh]):
            if k in seen:
                continue
            seen.add(k)
            adds_list.append(np.array([s, t], dtype=np.int64))
            if len(adds_list) == n_adds:
                break
        need = n_adds - len(adds_list)
    adds = np.stack(adds_list) if adds_list else None
    return adds, dels


def make_update_injector(
    rng: np.random.Generator,
    ops_per_batch: int,
    *,
    frac_adds: float = 0.5,
    localized: bool = False,
):
    """Update hook of the serving load generator
    (:func:`repro_torch.serving.loadgen.run_closed_loop`): a closure
    ``injector(g) -> (adds, dels)`` that samples each batch against the
    runtime's live graph (an applied batch changes what a valid next batch
    is).  It owns its generator, so a fixed seed reproduces the whole
    update sequence whatever the load's timing."""

    def next_batch(g: Graph):
        return random_update_batch(g, rng, ops_per_batch,
                                   frac_adds=frac_adds, localized=localized)

    return next_batch
