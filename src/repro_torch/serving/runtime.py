"""Serving runtime: admission queue + result cache around the PPR engine.

A copy of the reference's ``repro.serving.runtime`` over the port's engine.
:class:`ServingRuntime` wraps :class:`repro_torch.serving.ppr_engine.PPREngine`
into a production-shaped queueing system:

* **Admission queue with backpressure** — offered queries land in a bounded
  FIFO in front of seed-slot allocation.  A full queue *rejects* (the
  backpressure signal a closed-loop client keys off), and each entry
  carries a deadline: a query that waited past it is *expired* at pop time
  instead of occupying a slot to compute an answer nobody is waiting for.
  Admission and harvest never barrier with the solve — the engine's slots
  run stale/independent rounds (Blanco et al., delayed asynchronous
  iteration; PAPERS.md), so the queue drains whenever a slot frees, not at
  sweep boundaries.

* **Invalidating top-k result cache** — a bounded LRU of *answers* (not
  warm starts: a hit skips the solve entirely and costs zero slot time),
  keyed by the engine's canonical seed-set key plus ``top_k``.  Updates
  applied through :meth:`apply_updates` invalidate on a *sound* reach
  argument: an edge update perturbs the fixed point of every seed set that
  can reach it (the source's whole out-column rescales and the change
  propagates transitively downstream), so an entry survives only when NO
  touched vertex is weakly connected to its seeds in the union of the old
  and new graphs — directed reachability is contained in weak
  connectivity, and an unreachable source holds zero PPR mass in both
  fixed points, so its column edit is a no-op for that entry.  Everything
  else is dropped, including always the global (empty-seed) entry, and
  the entire cache when ``handle_dangling`` is on and dangling vertices
  exist (redistributed dangling mass couples otherwise-disconnected
  components).  The regression tests (tests/test_torch_serving_runtime.py)
  assert a stale answer is never served after an update anywhere upstream
  or downstream of it on a connected graph.

* **Metrics** — every stage reports into a
  :class:`repro_torch.serving.metrics.ServingMetrics` bag (admit/solve/
  harvest timers, queue-depth + slot-occupancy gauges, offered/completed/
  rejected/expired/cache counters) that the launcher summary prints.

With ``PPREngine(mesh=...)`` the engine's slot batch is split across the
mesh's devices; the runtime's scheduling is unchanged, and
``stats()["mesh_shards"]`` is the mesh's size (1 without a mesh).
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Callable, Optional

import numpy as np

from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.ppr_engine import PPREngine, PPRQuery, PPRResponse

__all__ = ["Admission", "QueueEntry", "ServingRuntime"]


def _weak_components(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Weak-connectivity labels (label = min vertex id in the component) by
    min-label hooking + pointer jumping — O(m) numpy work per round,
    O(log n) rounds even on chains/rings, no per-edge Python loop."""
    label = np.arange(n, dtype=np.int64)
    if src.size == 0:
        return label
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    while True:
        ls, ld = label[src], label[dst]
        if (ls == ld).all():
            return label
        # hook the larger label onto the smaller (writes strictly decrease,
        # so chains stay acyclic), then compress to fixpoint
        np.minimum.at(label, np.maximum(ls, ld), np.minimum(ls, ld))
        while True:
            jumped = label[label]
            if (jumped == label).all():
                break
            label = jumped


@dataclasses.dataclass(frozen=True)
class Admission:
    """Outcome of one :meth:`ServingRuntime.offer`.

    ``status`` is ``"queued"`` (admitted to the queue), ``"cached"``
    (answered immediately from the result cache — ``response`` is set), or
    ``"rejected"`` (queue full: the backpressure signal)."""

    status: str
    response: Optional[PPRResponse] = None


@dataclasses.dataclass
class QueueEntry:
    query: PPRQuery
    t_offer: float  # runtime clock at offer time
    deadline_s: Optional[float]  # max queue wait; None = no deadline

    def expired(self, now: float) -> bool:
        return self.deadline_s is not None and \
            (now - self.t_offer) > self.deadline_s


class ServingRuntime:
    """Queueing front-end over a :class:`PPREngine` (see module docstring).

    ``clock`` is injectable (default ``time.perf_counter``) so tests and the
    virtual-time load generator can drive deadlines deterministically;
    stage *timers* always use real wall time — they measure host cost, not
    simulated time.
    """

    def __init__(self, engine: PPREngine, *, queue_depth: int = 64,
                 deadline_s: Optional[float] = None,
                 result_cache_size: int = 512,
                 clock: Callable[[], float] = time.perf_counter):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.engine = engine
        self.queue_depth = queue_depth
        self.deadline_s = deadline_s
        self.clock = clock
        self._queue: deque[QueueEntry] = deque()
        # key -> (indices, values, seeds): the harvested top-k answer
        self._results: OrderedDict[tuple, tuple] = OrderedDict()
        self._results_size = result_cache_size
        self.metrics = ServingMetrics()
        # one runtime per engine: wrapping an engine REPLACES any previous
        # runtime's invalidation hook (repeated make_runtime() patterns must
        # not accumulate callbacks that keep dead runtimes alive and
        # re-invalidate their caches); close() detaches explicitly
        engine.update_callbacks[:] = [
            cb for cb in engine.update_callbacks
            if not isinstance(getattr(cb, "__self__", None), ServingRuntime)]
        engine.update_callbacks.append(self._invalidate)

    # -- admission ----------------------------------------------------------

    def _result_key(self, q: PPRQuery) -> tuple:
        # top_k is clamped to n exactly as the harvest-side topk() clamps
        # it, so an over-asking query still round-trips to one cache entry
        return (self.engine._cache_key(q), min(int(q.top_k), self.engine.g.n))

    def offer(self, q: PPRQuery, *, deadline_s: Optional[float] = None
              ) -> Admission:
        """Offer one query: result-cache lookup, then bounded admission.

        Raises on malformed seeds (validated before any state is touched);
        a full queue returns ``rejected`` — the runtime never blocks the
        caller, which is what lets a closed-loop client measure its own
        backpressure."""
        self.engine.validate(q)
        self.metrics.incr("offered")
        cached = self._results.get(self._result_key(q))
        if cached is not None:
            self._results.move_to_end(self._result_key(q))
            self.metrics.incr("cache_hits")
            idx, vals, seeds = cached
            # warm_start=False: no iteration was seeded from the warm cache
            # (no iteration ran at all) — `cached` alone marks the hit
            return Admission("cached", PPRResponse(
                qid=q.qid, seeds=seeds, indices=idx.copy(),
                values=vals.copy(), iterations=0, latency_s=0.0,
                warm_start=False, cached=True))
        self.metrics.incr("cache_misses")
        if len(self._queue) >= self.queue_depth:
            self.metrics.incr("rejected")
            return Admission("rejected")
        self._queue.append(QueueEntry(
            query=q, t_offer=self.clock(),
            deadline_s=self.deadline_s if deadline_s is None else deadline_s))
        return Admission("queued")

    # -- the pump -----------------------------------------------------------

    def pump(self) -> list[PPRResponse]:
        """One scheduler turn: admit queued queries into free slots (expiring
        the dead ones), advance the engine one step, harvest, and
        insert fresh answers into the result cache.  Returns the responses
        completed this turn."""
        eng = self.engine
        now = self.clock()
        t0 = time.perf_counter()
        admitted = 0
        while self._queue and eng.active_count < eng.slots:
            entry = self._queue.popleft()
            if entry.expired(now):
                self.metrics.incr("expired")
                continue
            if not eng.submit(entry.query):
                # unreachable by the active_count guard, but never inside an
                # assert: under `python -O` that would silently drop the
                # already-popped entry
                raise RuntimeError(
                    "engine refused a submit despite a free slot")
            self.metrics.incr("admitted")
            admitted += 1
        if admitted:
            self.metrics.timers["admit"].add(time.perf_counter() - t0)
        self.metrics.gauges["queue_depth"].sample(len(self._queue))
        self.metrics.gauges["slot_occupancy"].sample(
            eng.active_count / eng.slots)
        if not eng.active_count:
            return []
        t0 = time.perf_counter()
        responses = eng.step()
        self.metrics.timers["solve"].add(time.perf_counter() - t0)
        if responses:
            t0 = time.perf_counter()
            for r in responses:
                key = (self.engine._cache_key(
                    PPRQuery(qid=r.qid, seeds=r.seeds)), len(r.indices))
                self._results[key] = (r.indices, r.values, r.seeds)
                self._results.move_to_end(key)
                while len(self._results) > self._results_size:
                    self._results.popitem(last=False)
                    self.metrics.incr("cache_evictions")
            self.metrics.incr("completed", len(responses))
            self.metrics.timers["harvest"].add(time.perf_counter() - t0)
        return responses

    @property
    def pending(self) -> int:
        """Queries admitted but not yet answered (queued + in a slot)."""
        return len(self._queue) + self.engine.active_count

    def serve(self, queries, max_pumps: int = 1_000_000,
              deadline_s: Optional[float] = None) -> list[PPRResponse]:
        """Offer everything, pump to completion; cached hits are returned
        inline with the solved responses.  Rejected offers are re-offered
        as the queue drains (this closed loop has no independent client to
        apply backpressure to), expired entries are simply dropped."""
        pending_q = deque(queries)
        out: list[PPRResponse] = []
        pumps = 0
        while pending_q or self.pending:
            # closed loop: hold the next offer until the queue has room, so
            # the rejection counter keeps meaning client-visible drops
            while pending_q and len(self._queue) < self.queue_depth:
                adm = self.offer(pending_q.popleft(), deadline_s=deadline_s)
                if adm.response is not None:
                    out.append(adm.response)
            out += self.pump()
            pumps += 1
            if pumps > max_pumps:
                raise RuntimeError(f"serve did not drain in {max_pumps} pumps")
        return out

    # -- updates + invalidation --------------------------------------------

    def quiesce(self, max_pumps: int = 1_000_000) -> list[PPRResponse]:
        """Finish every in-flight slot WITHOUT admitting from the queue —
        the precondition for an engine backend swap.  Queued queries stay
        queued and are served against the updated graph afterwards."""
        out: list[PPRResponse] = []
        pumps = 0
        while self.engine.active_count:
            out += self.engine.step()
            pumps += 1
            if pumps > max_pumps:
                raise RuntimeError("quiesce did not converge")
        self.metrics.incr("completed", len(out))
        return out

    def apply_updates(self, adds=None, dels=None, add_weights=None):
        """Apply an edge batch mid-stream: quiesce in-flight slots, swap the
        engine's graph/backend, and invalidate stale result-cache entries
        (via the engine's update callback).  Returns
        ``(delta, drained_responses)`` — the drained responses completed
        against the OLD graph and are NOT inserted into the result cache."""
        drained = self.quiesce()
        self.metrics.incr("update_batches")
        delta = self.engine.apply_updates(adds=adds, dels=dels,
                                          add_weights=add_weights)
        return delta, drained

    def _invalidate(self, delta) -> None:
        """Result-cache invalidation contract: an entry
        survives an update batch only when NO touched vertex is weakly
        connected to its seed set in the union of the old and new graphs.

        Why that is sound for a fixed point (not just one step): PPR mass
        from seeds ``S`` reaches exactly the vertices directed-reachable
        from ``S``, and reachability — in either graph — is contained in
        weak connectivity over the union.  If no updated edge endpoint
        shares a weak component with ``S``, every updated source ``a`` has
        ``pr(a) = 0`` in both fixed points, so rescaling ``a``'s out-column
        (and adding/removing in-edges that carry ``pr(a)``'s mass) changes
        nothing the entry can see.  Any intersection drops the entry: the
        perturbation propagates transitively downstream, so no
        block/distance cutoff short of reachability is safe.  The global
        (empty-seed) entry always drops, and ``handle_dangling`` with any
        dangling vertex present drops the whole cache — redistributed
        dangling mass couples otherwise-disconnected components."""
        if not self._results or not delta.num_ops:
            return
        g = self.engine.g  # the callback fires after the graph swap
        if self.engine.handle_dangling and (
                bool((g.out_degree == 0).any()) or delta.undangled.size > 0):
            dropped = len(self._results)
            self._results.clear()
            self.metrics.incr("cache_invalidations", dropped)
            return
        # union graph = post-update edges + the deleted edges (which existed
        # pre-update), so one labeling covers reachability in both graphs
        label = _weak_components(
            g.n,
            np.r_[g.src.astype(np.int64), delta.deleted[:, 0]],
            np.r_[g.dst.astype(np.int64), delta.deleted[:, 1]])
        hot = np.zeros(g.n, dtype=bool)
        hot[label[delta.touched_vertices()]] = True
        stale = [key for key, (_idx, _vals, seeds) in self._results.items()
                 if not seeds or hot[label[list(seeds)]].any()]
        for key in stale:
            del self._results[key]
        self.metrics.incr("cache_invalidations", len(stale))

    # -- bookkeeping --------------------------------------------------------

    @property
    def result_cache_len(self) -> int:
        return len(self._results)

    def reset(self) -> None:
        """Forget queue, caches, and metrics (engine must be idle) — lets a
        benchmark reuse one runtime (and the engine's built backend) across
        measured runs.  The update callback stays registered: the runtime is
        still live; use :meth:`close` to detach from the engine."""
        self.engine.reset()
        self._queue.clear()
        self._results.clear()
        self.metrics = ServingMetrics()

    def close(self) -> None:
        """Detach from the engine: deregister the invalidation callback so a
        discarded runtime is neither kept alive nor re-invalidated by future
        engine updates.  Idempotent; the runtime must not be used after."""
        cbs = self.engine.update_callbacks
        if self._invalidate in cbs:
            cbs.remove(self._invalidate)

    def stats(self) -> dict:
        """The structured metrics dict the launcher and benchmarks print:
        runtime metrics plus the engine's own counters."""
        eng = self.engine
        return {
            "backend": eng.backend_name,
            "slots": eng.slots,
            "mesh_shards": eng.mesh.size if eng.mesh is not None else 1,
            "queue_depth_limit": self.queue_depth,
            "result_cache": {"len": len(self._results),
                             "limit": self._results_size},
            "warm_hits": eng.warm_hits,
            "submit_rejections": eng.submit_rejections,
            "slot_occupancy": eng.slot_occupancy,
            **self.metrics.to_dict(),
        }
