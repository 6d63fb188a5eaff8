"""Closed-loop load generation for the PPR serving runtime.

A copy of the reference's ``repro.serving.loadgen`` over the port's runtime
(the offered-load sweep waits for the port's benchmark scripts).  A
one-shot ``drain`` measures latency with zero queueing — every query is
already waiting when the engine starts.  Under sustained load the
interesting numbers are different:
*saturation qps* (the offered rate beyond which the runtime can no longer
keep up), *p99-under-load* (queueing delay included), queue depth, and the
rejection rate of the admission queue's backpressure.  This module
generates that load and measures those numbers:

* **Arrival process** — a target-qps open-loop arrival schedule (Poisson
  exponential inter-arrivals by default, or a deterministic uniform
  spacing), precomputed from a seeded RNG so a run is reproducible.

* **Zipfian seed skew** — production query streams are heavy-tailed: a few
  hot entities dominate.  Seeds are drawn rank-``α`` Zipfian over a
  seed-decoupling permutation of the vertex ids, mixed with multi-seed and
  global (empty-seed) queries plus exact repeats, so the result cache and
  warm cache see realistic reuse.

* **Closed loop** — the loop offers each query at its arrival time,
  pumps the runtime while work is pending, and never waits on an answer
  before offering the next arrival (the client is open-loop; the *loop* is
  closed through the runtime's backpressure: rejected arrivals are lost
  and counted).  Time is an injectable clock: wall time for benchmarks, a
  :class:`VirtualClock` for deterministic tests (each pump advances
  simulated time by a fixed per-step cost).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.serving.ppr_engine import PPRQuery
from repro_torch.serving.runtime import ServingRuntime

__all__ = [
    "LoadConfig",
    "LoadReport",
    "VirtualClock",
    "make_workload",
    "run_closed_loop",
    "zipf_weights",
]


class VirtualClock:
    """Deterministic simulated clock: ``now()`` reads, ``advance()`` moves.

    The closed loop advances it by ``step_cost_s`` per pump (a
    stand-in for one engine step) and jumps it to the next arrival
    when idle — so saturation behavior in tests depends only on the
    workload and the configured step cost, never on host speed."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot advance a clock backwards ({dt})")
        self._t += dt


def zipf_weights(n: int, alpha: float) -> np.ndarray:
    """Rank-Zipfian probability vector: ``P(rank r) ∝ r^-alpha`` over ``n``
    items (``alpha=0`` = uniform)."""
    if n < 1:
        raise ValueError("zipf_weights needs n >= 1")
    w = np.arange(1, n + 1, dtype=np.float64) ** -float(alpha)
    return w / w.sum()


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """Workload shape for one closed-loop run."""

    queries: int = 64
    qps: float = 16.0  # target offered rate
    top_k: int = 10
    zipf_alpha: float = 1.1  # seed-popularity skew (0 = uniform)
    repeat_fraction: float = 0.25  # exact re-asks (result-cache traffic)
    multi_seed_fraction: float = 0.15
    global_fraction: float = 0.05  # empty-seed (global PageRank) rows
    arrival: str = "poisson"  # "poisson" | "uniform"
    seed: int = 0
    deadline_s: Optional[float] = None  # per-query max queue wait
    # hot-set size the Zipf ranks are spread over; None = all n vertices
    working_set: Optional[int] = None


def make_workload(n: int, cfg: LoadConfig
                  ) -> tuple[list[PPRQuery], np.ndarray]:
    """Build the query list and its arrival times (seconds from t0).

    Seeds are Zipf-ranked over a fixed permutation of the vertex ids (so
    vertex id and popularity are decoupled), with ``repeat_fraction`` exact
    re-asks of earlier queries, ``multi_seed_fraction`` 2–4-seed sets, and
    ``global_fraction`` uniform rows.  Arrivals are Poisson (exponential
    inter-arrival at rate ``qps``) or uniformly spaced."""
    if cfg.queries < 1:
        raise ValueError("workload needs at least one query")
    if cfg.qps <= 0:
        raise ValueError(f"target qps must be positive, got {cfg.qps}")
    rng = np.random.default_rng(cfg.seed)
    hot = min(cfg.working_set or n, n)
    ranked = rng.permutation(n)[:hot]  # rank r -> vertex ranked[r]
    probs = zipf_weights(hot, cfg.zipf_alpha)

    def draw_seed() -> int:
        return int(ranked[rng.choice(hot, p=probs)])

    queries: list[PPRQuery] = []
    for i in range(cfg.queries):
        kind = rng.random()
        if queries and kind < cfg.repeat_fraction:
            seeds = queries[int(rng.integers(0, len(queries)))].seeds
        elif kind < cfg.repeat_fraction + cfg.global_fraction:
            seeds = ()
        elif kind < (cfg.repeat_fraction + cfg.global_fraction
                     + cfg.multi_seed_fraction) and n >= 2:
            k = int(rng.integers(2, min(4, n) + 1))
            picks = {draw_seed() for _ in range(k)}
            seeds = tuple(sorted(picks))
        else:
            seeds = (draw_seed(),)
        queries.append(PPRQuery(qid=i, seeds=seeds, top_k=cfg.top_k))

    if cfg.arrival == "poisson":
        gaps = rng.exponential(1.0 / cfg.qps, size=cfg.queries)
    elif cfg.arrival == "uniform":
        gaps = np.full(cfg.queries, 1.0 / cfg.qps)
    else:
        raise ValueError(f"unknown arrival process {cfg.arrival!r}")
    arrivals = np.cumsum(gaps)
    arrivals[0] = 0.0  # the first query opens the run
    return queries, arrivals


@dataclasses.dataclass
class LoadReport:
    """Measured outcome of one closed-loop run at one offered rate."""

    offered_qps: float
    achieved_qps: float
    wall_s: float
    offered: int
    completed: int
    rejected: int
    expired: int
    cache_hits: int
    p50_ms: Optional[float]  # None when nothing completed
    p99_ms: Optional[float]
    queue_depth_mean: float
    queue_depth_max: float
    rejection_rate: float
    update_batches: int
    cache_invalidations: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _percentile(lat_ms: np.ndarray, q: float) -> Optional[float]:
    """Latency percentile guarded for the all-rejected/all-expired case —
    ``np.percentile`` of an empty array raises, a saturated run must not."""
    if lat_ms.size == 0:
        return None
    return float(np.percentile(lat_ms, q))


def run_closed_loop(
    runtime: ServingRuntime,
    queries: list[PPRQuery],
    arrivals: np.ndarray,
    *,
    deadline_s: Optional[float] = None,
    clock: Optional[VirtualClock] = None,
    step_cost_s: float = 1e-3,
    update_injector: Optional[Callable] = None,
    update_at: tuple[int, ...] = (),
    max_wall_s: float = 600.0,
) -> LoadReport:
    """Drive one run: offer each query at its arrival time, pump while work
    is pending, harvest until drained.

    ``clock=None`` runs against wall time.  Passing a :class:`VirtualClock`
    runs in simulated time (each pump advances ``step_cost_s``); the
    runtime must share the same clock for deadlines to line up —
    construct it with ``ServingRuntime(..., clock=vc.now)``.

    ``update_injector`` (see ``repro_torch.core.dynamic.make_update_injector``)
    is called with the live graph when the arrival index crosses each entry
    of ``update_at``, and the batch is applied through
    :meth:`ServingRuntime.apply_updates` — exercising quiesce + result-cache
    invalidation mid-stream."""
    virtual = clock is not None
    now_fn = clock.now if virtual else time.perf_counter
    t0 = now_fn()
    due_updates = sorted(update_at)
    latencies_ms: list[float] = []
    arrival_clock: dict[int, float] = {}  # qid -> offer-time (for latency)
    completed = 0
    i = 0
    n_q = len(queries)

    def harvest(responses, now):
        nonlocal completed
        for r in responses:
            completed += 1
            t_in = arrival_clock.get(r.qid)
            if t_in is not None:
                # latency under load = arrival -> harvest, queue wait
                # included (r.latency_s only covers submit -> harvest)
                latencies_ms.append(1e3 * (now - t_in))

    while i < n_q or runtime.pending:
        now = now_fn() - t0
        if now > max_wall_s:
            raise RuntimeError(
                f"closed loop exceeded max_wall_s={max_wall_s}; offered "
                f"{i}/{n_q}, pending={runtime.pending}")
        while due_updates and i >= due_updates[0] and update_injector:
            due_updates.pop(0)
            adds, dels = update_injector(runtime.engine.g)
            _, drained = runtime.apply_updates(adds=adds, dels=dels)
            harvest(drained, now_fn() - t0)
        while i < n_q and arrivals[i] <= now:
            adm = runtime.offer(queries[i], deadline_s=deadline_s)
            if adm.status != "rejected":
                arrival_clock[queries[i].qid] = now
            if adm.response is not None:
                harvest([adm.response], now)
            i += 1
        if runtime.pending:
            responses = runtime.pump()
            if virtual:
                clock.advance(step_cost_s)
            harvest(responses, now_fn() - t0)
        elif i < n_q:
            gap = arrivals[i] - (now_fn() - t0)
            if gap > 0:
                if virtual:
                    clock.advance(gap)
                else:
                    time.sleep(min(gap, 0.01))

    wall = max(now_fn() - t0, 1e-9)
    m = runtime.metrics
    lat = np.asarray(latencies_ms)
    offered = m.count("offered")
    return LoadReport(
        offered_qps=n_q / max(float(arrivals[-1]), 1e-9),
        achieved_qps=completed / wall,
        wall_s=float(wall),
        offered=offered,
        completed=completed,
        rejected=m.count("rejected"),
        expired=m.count("expired"),
        cache_hits=m.count("cache_hits"),
        p50_ms=_percentile(lat, 50),
        p99_ms=_percentile(lat, 99),
        queue_depth_mean=m.gauges["queue_depth"].mean,
        queue_depth_max=m.gauges["queue_depth"].max,
        rejection_rate=m.count("rejected") / offered if offered else 0.0,
        update_batches=m.count("update_batches"),
        cache_invalidations=m.count("cache_invalidations"),
    )
