"""Push-based local PPR on the host: residual/estimate forward push, and
top-k extraction of a rank vector.

The low-latency single-query solver (Andersen–Chung–Lang; Zhang et al.,
arXiv:2302.03245) keeps an estimate ``est`` and a residual ``r`` with the
invariant

    ppr_exact = est + Σ_v r[v] · ppr(e_v)

(``ppr(e_v)`` is the exact single-seed PPR from ``v``, of unit L1 mass).  A
push on ``v`` banks ``(1-d)·r_v`` into ``est[v]`` and forwards ``d·r_v``
along its out-edges (``/outdeg``, times the edge weight); dangling residual
is dropped, or with ``handle_dangling`` re-teleported onto the seed
distribution.  Since ``‖ppr(e_v)‖₁ ≤ 1``, the remaining residual sum bounds
the L1 error a priori (:attr:`PushResult.l1_bound`), so a top-k answer comes
with a certificate.

The frontier is a FIFO of rounds, vectorised over the frontier's
concatenated out-CSR ranges, or with ``priority=True`` the highest
power-of-two residual bucket of a :class:`BucketQueue`.  The drain order
changes the work, never the invariant.

The solvers run on the host in float64 numpy, as the reference's do: the
work of a query is local (a push touches only its frontier's out-edges),
and that is the algorithm, not a fallback.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.solver import DEFAULT_DAMPING, PageRankResult, register_variant
from repro_torch.graphs.csr import Graph, _concat_ranges

__all__ = ["BucketQueue", "PushResult", "ppr_push", "push_residual", "topk"]


class BucketQueue:
    """Bucketed max-priority queue over residual magnitudes.

    Bucket ``k`` holds priorities in ``(rmax·2^k, rmax·2^{k+1}]`` (at or
    below ``rmax`` in bucket 0, above the top bucket's floor clamped into
    it), so :meth:`pop_batch` returns vertices whose insert-time priority is
    within a factor of two of the queue's maximum.

    Entries are lazy: re-pushing a vertex leaves its old entry, and a
    popped batch is deduplicated but not revalidated; callers re-check
    current residuals (:func:`push_residual` does)."""

    def __init__(self, rmax: float, n_buckets: int = 64):
        if not rmax > 0:
            raise ValueError(f"rmax must be positive, got {rmax}")
        self.rmax = float(rmax)
        self.n_buckets = int(n_buckets)
        self._buckets: list[list] = [[] for _ in range(self.n_buckets)]
        self._hi = -1  # index of the highest possibly non-empty bucket

    def bucket_of(self, value):
        """Bucket index of one priority value (scalar or array)."""
        with np.errstate(divide="ignore"):
            k = np.floor(np.log2(np.maximum(
                np.abs(value), 1e-300) / self.rmax)).astype(np.int64)
        return np.clip(k, 0, self.n_buckets - 1)

    def push(self, vertices, values) -> None:
        """Insert vertices with priorities ``values`` (arrays or scalars)."""
        vertices = np.atleast_1d(np.asarray(vertices))
        if vertices.size == 0:
            return
        ks = np.atleast_1d(self.bucket_of(values))
        for k in np.unique(ks):
            self._buckets[k].append(vertices[ks == k])
            self._hi = max(self._hi, int(k))

    def pop_batch(self) -> np.ndarray:
        """Vertices of the highest non-empty bucket (deduplicated, sorted);
        an empty array once the queue is drained."""
        while self._hi >= 0 and not self._buckets[self._hi]:
            self._hi -= 1
        if self._hi < 0:
            return np.zeros(0, np.int64)
        batch = np.concatenate(self._buckets[self._hi])
        self._buckets[self._hi] = []
        return np.unique(batch)

    def __len__(self) -> int:
        return sum(sum(a.size for a in b) for b in self._buckets)


def topk(est: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Top-``k`` (indices, values) of an estimate vector, sorted descending
    (ties broken by vertex id for determinism)."""
    k = min(int(k), est.shape[0])
    if k == 0:
        return np.zeros(0, np.int64), np.zeros(0, est.dtype)
    idx = np.argpartition(-est, k - 1)[:k]
    order = np.lexsort((idx, -est[idx]))
    idx = idx[order]
    return idx, est[idx]


@dataclasses.dataclass
class PushResult:
    """Forward-push answer: dense estimates and the residual certificate."""

    est: np.ndarray  # (n,) float64 lower-bound PPR estimates
    resid: np.ndarray  # (n,) float64 unpushed residual mass
    rounds: int  # frontier rounds executed
    pushes: int  # vertex pushes in all

    @property
    def l1_bound(self) -> float:
        """A-priori bound on ``‖ppr_exact − est‖₁``: the residual left."""
        return float(self.resid.sum())

    def topk(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        return topk(self.est, k)


def push_residual(
    g: Graph,
    est: np.ndarray,
    r: np.ndarray,
    *,
    d: float = DEFAULT_DAMPING,
    rmax: float = 1e-8,
    teleport: np.ndarray | None = None,
    handle_dangling: bool = False,
    max_rounds: int = 10_000,
    priority: bool = False,
) -> tuple[int, int]:
    """Drain residual mass from ``r`` into ``est`` in place until every
    residual is at or below ``rmax``; returns ``(rounds, pushes)``.

    A push on ``v`` banks ``(1-d)·r_v``.  With ``handle_dangling`` the
    residual a dangling vertex would forward is re-teleported along
    ``teleport``.  ``priority=True`` pushes the :class:`BucketQueue`'s top
    bucket each round (a round is one popped batch, so round counts do not
    compare across modes; push counts do)."""
    bank = 1.0 - d
    out_ptr, out_dst, out_slot = g.out_csr()
    w_out = None if g.weights is None else g.weights[out_slot]
    outdeg = g.out_degree.astype(np.int64)
    dangling = outdeg == 0
    pushes = 0
    rounds = 0

    def push_batch(frontier):
        """Push every frontier vertex once; returns the scatter targets."""
        nonlocal pushes
        pushes += int(frontier.size)
        moved = r[frontier].copy()
        r[frontier] = 0.0  # zeroed before the scatter, so self-loops add up
        est[frontier] += bank * moved
        live = ~dangling[frontier]
        scattered = np.zeros(0, out_dst.dtype)
        if live.any():
            fl = frontier[live]
            deg = outdeg[fl]
            eidx = _concat_ranges(out_ptr, fl)
            vals = np.repeat(d * moved[live] / deg, deg)
            if w_out is not None:
                vals = vals * w_out[eidx]
            np.add.at(r, out_dst[eidx], vals)
            scattered = out_dst[eidx]
        if handle_dangling:
            dang_mass = d * float(moved[~live].sum())
            if dang_mass != 0.0:
                r[...] += dang_mass * teleport
                scattered = np.concatenate([scattered, np.flatnonzero(teleport)])
        return scattered

    if not priority:
        frontier = np.flatnonzero(r > rmax)
        while frontier.size and rounds < max_rounds:
            rounds += 1
            push_batch(frontier)
            frontier = np.flatnonzero(r > rmax)
        return rounds, pushes

    q = BucketQueue(rmax)
    init = np.flatnonzero(r > rmax)
    q.push(init, r[init])
    while rounds < max_rounds:
        batch = q.pop_batch()
        if batch.size == 0:
            # lazy entries make an empty queue a candidate exit: one full
            # recheck confirms convergence or refills the queue
            left = np.flatnonzero(r > rmax)
            if left.size == 0:
                break
            q.push(left, r[left])
            continue
        batch = batch[r[batch] > rmax]  # drop stale entries
        if batch.size == 0:
            continue
        rounds += 1
        scattered = push_batch(batch)
        if scattered.size:
            uniq = np.unique(scattered)
            mag = r[uniq]
            risen = mag > rmax
            q.push(uniq[risen], mag[risen])
    return rounds, pushes


def ppr_push(
    g: Graph,
    seeds,
    *,
    d: float = DEFAULT_DAMPING,
    rmax: float = 1e-8,
    handle_dangling: bool = False,
    max_rounds: int = 10_000,
    priority: bool = False,
) -> PushResult:
    """Forward push from ``seeds`` (an int, an iterable of ints, or empty or
    ``None`` for the uniform global query) until every residual is at or
    below ``rmax``.

    One seed set per call: a batched (nested) spec raises; batches go
    through the ``ppr_push`` registry variant, which loops rows.  The
    ``l1_bound`` certificate needs edge weights in ``(0, 1]`` (the
    decomposition's ``d^k`` always are); a vertex bias scales the
    teleport row (``t_eff = t·bias``, as in :mod:`repro_torch.ppr.batched`)."""
    from repro_torch.ppr.batched import bias_scaled, normalize_seeds, teleport_from_seeds

    rows = normalize_seeds(seeds)
    if len(rows) != 1:
        raise ValueError(
            f"ppr_push answers one seed set per call, got a batch of "
            f"{len(rows)}; use solve_variant('ppr_push', ..., seeds=batch)")
    t = bias_scaled(teleport_from_seeds(rows, g.n)[0], g.bias)
    est = np.zeros(g.n)
    r = t.copy()
    if g.n == 0:
        return PushResult(est=est, resid=r, rounds=0, pushes=0)
    rounds, pushes = push_residual(
        g, est, r, d=d, rmax=rmax, teleport=t, handle_dangling=handle_dangling,
        max_rounds=max_rounds, priority=priority)
    return PushResult(est=est, resid=r, rounds=rounds, pushes=pushes)


# ---------------------------------------------------------------------------
# Registry entries: the host-local low-latency solvers
# ---------------------------------------------------------------------------


def _push_run(priority=False):
    def run(g: Graph, *, d=DEFAULT_DAMPING, threshold=1e-8, max_iter=10_000,
            handle_dangling=False, seeds=None, rmax=None, **_):
        """One push solve per seed row, stacked to a float64 ``(b, n)``
        array; ``rmax`` defaults to ``threshold``.  ``iterations`` is the
        most rounds of a row, ``err`` the largest ``l1_bound``, and the
        pushes of all rows ride the ``sweeps`` slot."""
        from repro_torch.ppr.batched import normalize_seeds

        rmax_eff = threshold if rmax is None else rmax
        ests, rounds, bound, pushes = [], 0, 0.0, 0
        for row in normalize_seeds(seeds):
            res = ppr_push(g, row, d=d, rmax=rmax_eff,
                           handle_dangling=handle_dangling,
                           max_rounds=max_iter, priority=priority)
            ests.append(res.est)
            rounds = max(rounds, res.rounds)
            bound = max(bound, res.l1_bound)
            pushes += res.pushes
        return PageRankResult(np.stack(ests), rounds, bound, None, pushes)

    return run


register_variant(
    "ppr_push",
    build=lambda g, **_: g,
    run=_push_run(),
    description="forward-push local PPR: residual certificate + sparse top-k",
    options=("seeds", "rmax"),
    layout="host", backend="numpy", schedule="sequential",
)
register_variant(
    "ppr_push_priority",
    build=lambda g, **_: g,
    run=_push_run(priority=True),
    description="forward-push local PPR, max-residual bucket-queue frontier",
    options=("seeds", "rmax"),
    layout="host", backend="numpy", schedule="adaptive",
)
