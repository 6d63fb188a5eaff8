"""Continuous-batching PPR query engine of the port (core of the
reference's ``repro.serving.ppr_engine``).

A host-side scheduler owns a fixed batch of ``slots`` rank rows on the
device and advances every active slot at once:

* **submit** — a seed query takes a free slot: its teleport row is
  written into the batch's teleport state and its rank row is initialized
  from the **warm cache** (the converged vector of an identical earlier
  query) or, cold, from the teleport row itself.
* **step** — ``iters_per_step`` batched passes run on the device; frozen
  rows (free slots and converged ones) are held in place.  The ``(slots,)``
  per-row errors of the last pass come back to the host once per step.
* **harvest** — a converged slot's row is read to the host once, its
  top-k taken (ties broken by vertex id), the vector cached, and the slot
  recycled for the next queued query.

Two backends share the scheduler.  The port names them after what runs
the passes; the reference's names map as ``"jax"`` → ``"torch"`` (the
batched vertex-centric sweep, :func:`repro_torch.ppr.batched.make_batched_sweep`,
plain torch ops) and ``"pallas"`` → ``"cuda"`` (the multi-row blocked
Gauss–Seidel kernel :func:`repro_torch.kernels.spmv.gs_pass_multi` through
:func:`repro_torch.ppr.batched.make_batched_blocked_sweep`; its plain
version on a CPU device).

Not ported yet: serving a batch split across devices (``mesh=``) and
``apply_updates``, which come with the serving-runtime and dynamic-update
slices; both raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core.pagerank import DeviceGraph
from repro_torch.core.solver import DEFAULT_DAMPING
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph
from repro_torch.kernels.spmv.ops import BlockedGraph
from repro_torch.ppr.batched import (
    BATCH_AXIS,
    ROW_AXES,
    bias_scaled,
    make_batched_blocked_sweep,
    make_batched_sweep,
    read_blocked_row,
    teleport_from_seeds,
    write_blocked_row,
)
from repro_torch.ppr.push import topk

__all__ = ["PPRQuery", "PPRResponse", "PPREngine", "make_query_stream"]


@dataclasses.dataclass(frozen=True)
class PPRQuery:
    """One PPR request: rank the graph from ``seeds``' point of view.

    ``seeds`` is the teleport support (uniform over the set; duplicates
    count once, so ``(3, 3, 5)`` and ``(3, 5)`` share a cache entry); an
    empty tuple means a uniform teleport, the global PageRank question.
    ``top_k`` bounds the answer size; ``qid`` is echoed on the response."""

    qid: int
    seeds: tuple[int, ...] = ()
    top_k: int = 10


@dataclasses.dataclass
class PPRResponse:
    """A harvested answer: the converged slot's top-``k`` vertices,
    rank-descending (ties by vertex id).  ``iterations`` counts the passes
    charged to the slot at ``iters_per_step`` granularity; ``warm_start``
    marks rows seeded from the cache of converged vectors."""

    qid: int
    seeds: tuple[int, ...]
    indices: np.ndarray  # (top_k,) vertex ids, rank-descending
    values: np.ndarray  # (top_k,) PPR estimates
    iterations: int
    latency_s: float  # submit → harvest wall time
    warm_start: bool


def make_query_stream(n: int, count: int, *, top_k: int = 10,
                      repeat_fraction: float = 0.25,
                      seed: int = 0) -> list[PPRQuery]:
    """Synthetic mixed PPR traffic, the reference's generator: ~60%
    single-seed, ~25% multi-seed (2–4 seeds), ~15% uniform rows, with
    ``repeat_fraction`` of queries re-asking an earlier seed set."""
    rng = np.random.default_rng(seed)
    queries: list[PPRQuery] = []
    for i in range(count):
        if queries and rng.random() < repeat_fraction:
            seeds = queries[int(rng.integers(0, len(queries)))].seeds
        else:
            kind = rng.random()
            if kind < 0.60 or n < 2:  # tiny graphs can't host multi-seed
                seeds = (int(rng.integers(0, n)),)
            elif kind < 0.85:
                hi = min(4, n)
                seeds = tuple(int(s) for s in
                              rng.choice(n, size=int(rng.integers(2, hi + 1)),
                                         replace=False))
            else:
                seeds = ()
        queries.append(PPRQuery(qid=i, seeds=seeds, top_k=top_k))
    return queries


@dataclasses.dataclass
class _Active:
    query: PPRQuery
    t0: float
    iters: int = 0
    warm: bool = False


class _TorchBackend:
    """``(slots, n)`` rank batch advanced by the batched vertex-centric
    sweep (the reference's ``_JaxBackend``)."""

    def __init__(self, g: Graph, *, slots: int, d: float,
                 handle_dangling: bool, iters_per_step: int, device):
        dg = DeviceGraph.from_graph(g, device)
        self.n = g.n
        self.iters_per_step = iters_per_step
        self.sweep = make_batched_sweep(dg.src, dg.in_ptr, dg.inv_out,
                                        dg.dangling, dg.weights, n=g.n, d=d,
                                        handle_dangling=handle_dangling)
        self.state = torch.zeros((slots, g.n), device=device)
        self.tele = torch.zeros((slots, g.n), device=device)

    def set_row(self, slot: int, row: np.ndarray, trow: np.ndarray) -> None:
        self.state[slot] = torch.as_tensor(row, dtype=torch.float32)
        self.tele[slot] = torch.as_tensor(trow, dtype=torch.float32)

    def get_row(self, slot: int) -> np.ndarray:
        return self.state[slot].double().cpu().numpy()

    def step(self, frozen: np.ndarray) -> np.ndarray:
        fz = torch.as_tensor(frozen, device=self.state.device)[:, None]
        pr = self.state
        # no pass leaves every row unconverged, as the reference's loop does
        err = torch.full((pr.shape[0],), float("inf"), device=pr.device)
        for _ in range(self.iters_per_step):
            new = torch.where(fz, pr, self.sweep(pr, self.tele))
            err = torch.amax(torch.abs(new - pr), dim=1)
            pr = new
        self.state = pr
        return err.cpu().numpy()


class _KernelBackend:
    """Vertex-major ``(n_blocks, block, slots)`` rank batch advanced by the
    multi-row blocked Gauss–Seidel kernel (the reference's
    ``_PallasBackend``)."""

    def __init__(self, g: Graph, *, slots: int, d: float,
                 handle_dangling: bool, iters_per_step: int, device,
                 block: int = 256):
        bg = BlockedGraph.build(g, block=block, device=device)
        self.n = g.n
        self.iters_per_step = iters_per_step
        self.sweep = make_batched_blocked_sweep(bg, d=d,
                                                handle_dangling=handle_dangling)
        shape = (bg.n_blocks, bg.block, slots)
        self.state = torch.zeros(shape, device=device)
        self.tele = torch.zeros(shape, device=device)

    def set_row(self, slot: int, row: np.ndarray, trow: np.ndarray) -> None:
        write_blocked_row(self.state, slot, row)
        write_blocked_row(self.tele, slot, trow)

    def get_row(self, slot: int) -> np.ndarray:
        return read_blocked_row(self.state, slot, self.n)

    def step(self, frozen: np.ndarray) -> np.ndarray:
        fz = torch.as_tensor(frozen, device=self.state.device)
        pr = self.state
        err = torch.full((pr.shape[BATCH_AXIS],), float("inf"), device=pr.device)
        for _ in range(self.iters_per_step):
            new = self.sweep(pr, self.tele, fz)
            err = torch.amax(torch.abs(new - pr), dim=ROW_AXES)
            pr = new
        self.state = pr
        return err.cpu().numpy()


_BACKENDS = {"torch": _TorchBackend, "cuda": _KernelBackend}


class PPREngine:
    """Continuous-batching PPR serving over ``slots`` fixed batch rows.

    :meth:`submit` admits a validated query into a free slot
    (warm-starting from the LRU cache when the same seed set converged
    before), :meth:`step` advances every active slot ``iters_per_step``
    passes and harvests the converged ones, :meth:`drain` runs a whole
    query list to completion.  ``backend`` is ``"torch"`` or ``"cuda"``
    (the reference's ``"jax"`` and ``"pallas"``, see the module
    docstring); both honour weighted/biased graphs, the bias folding into
    each teleport row at submit time.  ``device`` places the batch
    (default ``cuda``); ``backend_opts`` pass through to the backend
    (``block`` for ``cuda``)."""

    def __init__(self, g: Graph, *, slots: int = 8, d: float = DEFAULT_DAMPING,
                 threshold: float = 1e-7, handle_dangling: bool = False,
                 backend: str = "torch", iters_per_step: int = 8,
                 cache_size: int = 256, mesh=None, device=None,
                 **backend_opts):
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {sorted(_BACKENDS)}, "
                             f"got {backend!r}")
        if g.n == 0:
            raise ValueError("cannot serve PPR over an empty graph")
        if mesh is not None:
            raise NotImplementedError(
                "mesh= is not ported yet: a batch split across devices comes "
                "with the serving-runtime slice of the port")
        self.g = g
        self.slots = slots
        self.d = d
        self.threshold = threshold
        self.handle_dangling = handle_dangling
        self.iters_per_step = iters_per_step
        self.backend_name = backend
        self._backend = _BACKENDS[backend](
            g, slots=slots, d=d, handle_dangling=handle_dangling,
            iters_per_step=iters_per_step, device=resolve_device(device),
            **backend_opts)
        self._active: list[Optional[_Active]] = [None] * slots
        # free slots stay frozen: their rows are held in place by the pass
        self._frozen = np.ones(slots, dtype=bool)
        self._cache: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._cache_size = cache_size
        self.warm_hits = 0
        self.submit_rejections = 0
        self.busy_slot_steps = 0
        self.total_slot_steps = 0

    @property
    def slot_occupancy(self) -> float:
        """Busy fraction of the batch over every step so far (0 before the
        first step)."""
        if not self.total_slot_steps:
            return 0.0
        return self.busy_slot_steps / self.total_slot_steps

    @property
    def active_count(self) -> int:
        return sum(a is not None for a in self._active)

    def _cache_key(self, q: PPRQuery) -> tuple:
        return tuple(sorted(set(int(s) for s in q.seeds)))

    def validate(self, q: PPRQuery) -> None:
        """Raise for a malformed query, before any engine state is touched."""
        for s in q.seeds:
            if not 0 <= int(s) < self.g.n:
                raise ValueError(
                    f"query {q.qid}: seed vertex {int(s)} out of range "
                    f"[0, {self.g.n})")

    def submit(self, q: PPRQuery) -> bool:
        """Admit ``q`` into a free slot; False when the batch is full.
        Raises on malformed seeds without mutating engine state."""
        self.validate(q)
        try:
            slot = self._active.index(None)
        except ValueError:
            self.submit_rejections += 1
            return False
        trow = bias_scaled(
            teleport_from_seeds([tuple(q.seeds)], self.g.n)[0], self.g.bias)
        key = self._cache_key(q)
        cached = self._cache.get(key)
        warm = cached is not None
        if warm:
            self._cache.move_to_end(key)
            self.warm_hits += 1
        row = cached if warm else trow
        self._backend.set_row(slot, np.asarray(row, np.float64), trow)
        self._active[slot] = _Active(query=q, t0=time.perf_counter(), warm=warm)
        self._frozen[slot] = False
        return True

    def step(self) -> list[PPRResponse]:
        """Advance every active slot ``iters_per_step`` passes; harvest and
        recycle the slots that converged."""
        if all(a is None for a in self._active):
            return []
        self.busy_slot_steps += self.active_count
        self.total_slot_steps += self.slots
        err = self._backend.step(self._frozen)
        out: list[PPRResponse] = []
        for slot, act in enumerate(self._active):
            if act is None:
                continue
            act.iters += self.iters_per_step
            if err[slot] <= self.threshold:
                row = self._backend.get_row(slot)
                idx, vals = topk(row, act.query.top_k)
                key = self._cache_key(act.query)
                self._cache[key] = row
                self._cache.move_to_end(key)
                while len(self._cache) > self._cache_size:
                    self._cache.popitem(last=False)
                out.append(PPRResponse(
                    qid=act.query.qid, seeds=tuple(act.query.seeds),
                    indices=idx, values=vals, iterations=act.iters,
                    latency_s=time.perf_counter() - act.t0,
                    warm_start=act.warm))
                self._active[slot] = None
                self._frozen[slot] = True
        return out

    def apply_updates(self, adds=None, dels=None, add_weights=None):
        raise NotImplementedError(
            "apply_updates is not ported yet: it needs Graph.apply_updates "
            "and comes with the dynamic-update slice of the port")

    def reset(self) -> None:
        """Forget the warm cache and counters (the engine must be idle), so
        a benchmark can reuse one engine for a cold measured run."""
        if self.active_count:
            raise RuntimeError("cannot reset a PPREngine with active slots")
        self._cache.clear()
        self.warm_hits = 0
        self.submit_rejections = 0
        self.busy_slot_steps = 0
        self.total_slot_steps = 0

    def drain(self, queries, max_steps: int = 100_000) -> list[PPRResponse]:
        """Feed ``queries`` through the engine (admitting as slots free up)
        and run until every response is harvested.  The whole batch is
        validated first: one malformed query raises before any work
        starts."""
        queries = list(queries)
        for q in queries:
            self.validate(q)
        pending = deque(queries)
        out: list[PPRResponse] = []
        steps = 0
        while pending or self.active_count:
            while pending and self.submit(pending[0]):
                pending.popleft()
            out += self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"PPREngine.drain did not converge within {max_steps} "
                    f"steps (threshold={self.threshold})")
        return out
