"""Fault-tolerance runtime: the paper's Wait-Free algorithm (Alg 6).

Alg 6 makes finished threads *help* slow or failed threads by adopting
their partitions, so the end-to-end time stays flat under injected sleeps
(Fig 8) and thread failures (Fig 9).  This module is the reference's:

* :func:`simulate` — an event-driven run of the ``barrier``, ``nosync``
  and ``waitfree`` disciplines under a :class:`FaultPlan`, with a
  deterministic cost model (host Python, line for line the reference's)
  around *real* partition sweeps.  A sweep is plain torch in float64 on
  the device the :class:`~repro_torch.core.pagerank.PartitionedGraph`
  lives on: a gather and a ``segment_reduce`` over ``seg_ptr``, a fixed
  order.  On the CPU it adds each vertex's in-edges in edge order, the
  reference's ``np.add.at`` order, bit for bit; on the card by a tree, a
  few float64 ulps from it.
* :func:`partition_sweep_costs` and :func:`simulate_jittered` — the
  makespan cost model of the speedup figures, numpy, bit for bit the
  reference's.
* :class:`SolverCheckpoint` — rank-vector checkpoints in the reference's
  ``.npz`` format (the launcher's ``--ckpt``).

The reference's sweep reads only the edge mask: it drops per-edge weights
and vertex biases, so on a weighted or biased graph it solves another
graph than the one given.  :func:`simulate` refuses such a graph instead.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.pagerank import PartitionedGraph
from repro_torch.core.solver import DEFAULT_DAMPING

__all__ = [
    "FaultPlan",
    "SimResult",
    "SolverCheckpoint",
    "partition_sweep_costs",
    "simulate",
    "simulate_jittered",
]


@dataclasses.dataclass
class FaultPlan:
    """Injected perturbations, mirroring the paper's case studies.

    ``sleeps[(worker, iteration)] = seconds`` — worker stalls before that sweep.
    ``failures[worker] = iteration`` — worker dies permanently at that sweep.
    """

    sleeps: dict = dataclasses.field(default_factory=dict)
    failures: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SimResult:
    pr: np.ndarray  # (n,) float64 on the host
    iterations: int
    sim_time: float  # modelled wall-clock (seconds)
    work_done: dict  # worker -> number of partition-sweeps executed


def _sweep_operands(pg: PartitionedGraph) -> tuple[torch.Tensor, torch.Tensor]:
    """``(inv_out, emask)`` in float64 on ``pg``'s device: the float32
    values the bundle holds, widened exactly, as the reference's numpy
    sweep reads them."""
    if pg.w_pad is not None or pg.bias_pad is not None:
        raise ValueError(
            "simulate sweeps the unweighted, unbiased graph (its sweep reads "
            "only the edge mask, as the reference's does, which on a weighted "
            "or biased graph solves another graph than the one given); build "
            "the PartitionedGraph from a graph without weights or bias")
    return pg.inv_out.double(), pg.emask.double()


def _partition_sweep(pg: PartitionedGraph, inv: torch.Tensor, emask: torch.Tensor,
                     pr_full: torch.Tensor, i: int, d: float) -> tuple[torch.Tensor, float]:
    """One real sweep of partition ``i`` in float64: its new ``(vp,)``
    block and the max change, read to the host (the cost model branches
    on it)."""
    vp = pg.vp
    contrib = (pr_full * inv)[pg.src_pad[i]] * emask[i]
    acc = torch.segment_reduce(contrib, "sum", offsets=pg.seg_ptr[i])
    new = (1.0 - d) / pg.n + d * acc
    old = pr_full[i * vp:(i + 1) * vp]
    err = float(torch.max(torch.abs(new - old)))
    return new, err


def simulate(
    pg: PartitionedGraph,
    discipline: str,
    plan: Optional[FaultPlan] = None,
    d: float = DEFAULT_DAMPING,
    threshold: float = 1e-8,
    max_iter: int = 1000,
    sweep_cost: float = 1.0,
) -> SimResult:
    """Event-driven simulation of ``barrier`` / ``nosync`` / ``waitfree``.

    Time model: each partition sweep costs ``sweep_cost`` (uniform because
    the partitions are edge-balanced); sleeps add their duration; a failed
    worker executes nothing after its failure point.

    * barrier  — iteration time = max over live workers (incl. sleep); a
      failed worker deadlocks the barrier: its partition never updates and
      time keeps accruing until ``max_iter``.
    * nosync   — workers proceed independently; global clock = max worker
      clock at convergence; a failed worker's partition freezes, and the
      run stops, unconverged, once the live partitions settle (No-Sync
      handles delays, not failures).
    * waitfree — helping: at each round, idle/finished workers adopt
      partitions of sleeping/failed workers, so every partition is swept
      every round; the round costs max over *assigned* loads.

    The sweeps run on ``pg``'s device in float64; ``SimResult.pr`` is the
    host copy.  Raises ``ValueError`` on a weighted or biased ``pg``.
    """
    inv, emask = _sweep_operands(pg)
    plan = plan or FaultPlan()
    p = pg.p
    pr = torch.full((pg.n_pad,), 1.0 / pg.n, dtype=torch.float64,
                    device=pg.inv_out.device)
    perr = np.full(p, np.inf)
    clocks = np.zeros(p)
    alive = np.ones(p, dtype=bool)
    work = {w: 0 for w in range(p)}

    def result(iterations: int) -> SimResult:
        return SimResult(pr[:pg.n].cpu().numpy(), iterations,
                         float(clocks.max()), work)

    for it in range(1, max_iter + 1):
        # mark failures at this iteration
        for w, fit in plan.failures.items():
            if fit == it:
                alive[w] = False

        if discipline == "barrier":
            round_costs = []
            for w in range(p):
                if not alive[w]:
                    continue
                cost = sweep_cost + plan.sleeps.get((w, it), 0.0)
                new, perr[w] = _partition_sweep(pg, inv, emask, pr, w, d)
                pr[w * pg.vp:(w + 1) * pg.vp] = new
                work[w] += 1
                round_costs.append(cost)
            # the barrier makes everyone wait for the slowest
            t = max(round_costs) if round_costs else sweep_cost
            clocks[:] = clocks.max() + t
            if not alive.all():
                # a dead thread holds the barrier: no progress is possible
                perr[~alive] = np.inf
        elif discipline == "nosync":
            for w in range(p):
                if not alive[w]:
                    continue
                if perr[w] <= threshold:  # thread-level convergence
                    continue
                clocks[w] += sweep_cost + plan.sleeps.get((w, it), 0.0)
                new, perr[w] = _partition_sweep(pg, inv, emask, pr, w, d)
                pr[w * pg.vp:(w + 1) * pg.vp] = new
                work[w] += 1
            if not alive.all():
                perr[~alive] = np.inf  # a frozen partition never converges
        elif discipline == "waitfree":
            # helping: every partition is swept this round, but nobody
            # waits on a sleeping/failed worker — partitions are adopted
            # greedily by the least-loaded worker (sleep counts as that
            # worker's initial load, so helpers route around it)
            live = [w for w in range(p) if alive[w]]
            if not live:
                break
            loads = {w: plan.sleeps.get((w, it), 0.0) for w in live}
            assigned = set()
            for part in range(p):
                owner = min(loads, key=loads.get)
                loads[owner] += sweep_cost
                assigned.add(owner)
                new, perr[part] = _partition_sweep(pg, inv, emask, pr, part, d)
                pr[part * pg.vp:(part + 1) * pg.vp] = new
                work[owner] += 1
            # the round ends when all partitions are done: idle sleepers
            # do not gate it
            t = max(loads[w] for w in assigned)
            clocks[:] = clocks.max() + t
        else:
            raise ValueError(discipline)

        live_err = perr[alive] if discipline != "waitfree" else perr
        if len(live_err) and np.max(live_err) <= threshold and (
                discipline == "waitfree" or alive.all()):
            return result(it)
        if discipline == "nosync" and len(live_err) and np.max(live_err) <= threshold:
            # delays tolerated; failures leave a frozen partition: a stall
            break

    return result(max_iter)


def partition_sweep_costs(g, p: int, edge_balanced: bool = False) -> np.ndarray:
    """Relative per-partition sweep costs (= in-edges owned, the work a
    vertex-centric sweep does) under the static allocation's boundaries,
    :meth:`repro_torch.graphs.csr.Graph.partition_ranges`.

    The paper's equal-vertex splits (``edge_balanced=False``) skew on
    power-law graphs; the edge-balanced boundaries equalize these costs.
    Feed either to :func:`simulate_jittered`'s ``rel_costs``."""
    bounds = g.partition_ranges(p, edge_balanced=edge_balanced)
    return np.diff(np.asarray(g.in_ptr)[bounds]).astype(np.float64)


def simulate_jittered(
    pg: PartitionedGraph,
    discipline: str,
    iterations: int,
    seed: int = 0,
    sigma: float = 0.3,
    rel_costs: Optional[np.ndarray] = None,
    active=None,
    stall_prob: float = 0.0,
    stall_dur: float = 0.0,
) -> float:
    """Makespan (seconds) of ``iterations`` rounds under lognormal
    per-sweep jitter, the cost model behind the speedup figures.

    ``rel_costs`` (p,) are deterministic per-partition sweep costs (e.g.
    from :func:`partition_sweep_costs`), normalized here to mean 1;
    omitted = uniform.

    * sequential — one worker sweeps all p partitions every iteration.
    * barrier    — round time = max over workers (the barrier waits).
    * nosync     — each worker's clock advances independently; makespan =
                   max total per-worker time.
    * adaptive   — nosync clocking, but a worker pays only for rounds in
                   which its partition swept (``active``).
    * waitfree   — like barrier but load-balanced via helping: round time
                   = mean over workers (idle helpers absorb the tail).

    ``active`` is an ``(iterations, p)`` bool mask of the sweeps made, or
    a scalar sweep rate in (0, 1] (Bernoulli-sampled per round and
    worker); ``sequential``/``nosync``/``adaptive`` honour it, the barrier
    disciplines sweep everyone.  ``stall_prob``/``stall_dur``: each
    executed sweep stalls by ``stall_dur`` mean-sweep units with
    probability ``stall_prob`` (the delayed/stale-sweep regime).
    """
    rng = np.random.default_rng(seed)
    p = pg.p
    costs = rng.lognormal(mean=0.0, sigma=sigma, size=(iterations, p))
    if rel_costs is not None:
        rel = np.asarray(rel_costs, dtype=np.float64)
        if rel.shape != (p,):
            raise ValueError(f"rel_costs shape {rel.shape} != ({p},)")
        costs = costs * (rel * p / max(float(rel.sum()), 1e-300))[None, :]
    if stall_prob > 0.0:
        costs = costs + stall_dur * (
            rng.random(size=(iterations, p)) < stall_prob)
    mask = np.ones((iterations, p), dtype=bool)
    if active is not None:
        if np.ndim(active) == 0:
            rate = float(active)
            if not 0.0 < rate <= 1.0:
                raise ValueError(f"active rate must be in (0, 1], got {rate}")
            mask = rng.random(size=(iterations, p)) < rate
        else:
            mask = np.asarray(active, dtype=bool)
            if mask.shape != (iterations, p):
                raise ValueError(
                    f"active mask shape {mask.shape} != ({iterations}, {p})")
    if discipline == "sequential":
        return float((costs * mask).sum())
    if discipline == "barrier":
        return float(costs.max(axis=1).sum())
    if discipline in ("nosync", "adaptive"):
        return float((costs * mask).sum(axis=0).max())
    if discipline == "waitfree":
        return float(np.maximum(costs.mean(axis=1), costs.min(axis=1)).sum())
    raise ValueError(discipline)


@dataclasses.dataclass
class SolverCheckpoint:
    """Rank-vector checkpoint for restartable solves (``.npz``: ``pr``,
    ``round``, ``n``, ``p``, the reference's format)."""

    pr: np.ndarray
    round: int
    n: int
    p: int

    def save(self, path: str) -> None:
        np.savez(path, pr=self.pr, round=self.round, n=self.n, p=self.p)

    @classmethod
    def load(cls, path: str) -> "SolverCheckpoint":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        return cls(pr=z["pr"], round=int(z["round"]), n=int(z["n"]), p=int(z["p"]))

    def reshard(self, new_p: int) -> "SolverCheckpoint":
        """Elastic re-shard: the rank vector is partition-agnostic, so
        scaling the worker count only re-chunks it (pad to the new p·vp)."""
        vp = -(-self.n // new_p)
        pr = np.full(vp * new_p, 0.0)
        pr[: self.n] = self.pr[: self.n]
        return SolverCheckpoint(pr=pr, round=self.round, n=self.n, p=new_p)
