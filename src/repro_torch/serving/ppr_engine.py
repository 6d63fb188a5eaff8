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

Between queries (no active slot), :meth:`PPREngine.apply_updates` applies
an edge batch: it swaps in the updated graph, rebuilds the backend on the
same device with the same options, drops the warm-cache rows the batch may
have moved, and fires ``update_callbacks`` (the serving runtime's
result-cache invalidation).

With ``mesh=`` (a 1-D :class:`repro_torch.core.distributed.ShardMesh`,
``launch/mesh.py::make_serving_mesh``) the batch is split across the
mesh's devices (:func:`shard_batch_step`): each shard owns ``slots/shards``
consecutive slot rows and advances them with its own sweep on its device.
Rows are independent solves, so no exchange runs inside a step; a step
enqueues every shard's passes before it reads any shard's errors back.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core.distributed import ShardMesh
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

__all__ = ["PPRQuery", "PPRResponse", "PPREngine", "make_query_stream",
           "shard_batch_step"]


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
    cached: bool = False  # answered from the runtime's top-k result cache


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


def _to_device(bundle, device):
    """A copy of the dataclass ``bundle`` with every tensor on ``device``."""
    return dataclasses.replace(bundle, **{
        f.name: getattr(bundle, f.name).to(device)
        for f in dataclasses.fields(bundle)
        if isinstance(getattr(bundle, f.name), torch.Tensor)})


class _TorchBackend:
    """``(slots, n)`` rank batch advanced by the batched vertex-centric
    sweep (the reference's ``_JaxBackend``).  ``graph`` is a built
    :class:`DeviceGraph` to share (a serving shard's), else one is built
    from ``g`` on ``device``."""

    def __init__(self, g: Graph, *, slots: int, d: float,
                 handle_dangling: bool, iters_per_step: int, device,
                 graph: DeviceGraph | None = None):
        dg = DeviceGraph.from_graph(g, device) if graph is None else graph
        self.graph, self.n = dg, g.n
        self.iters_per_step = iters_per_step
        self.sweep = make_batched_sweep(dg.src, dg.in_ptr, dg.inv_out,
                                        dg.dangling, dg.weights, n=g.n, d=d,
                                        handle_dangling=handle_dangling)
        self.state = torch.zeros((slots, g.n), device=dg.inv_out.device)
        self.tele = torch.zeros((slots, g.n), device=dg.inv_out.device)

    def set_row(self, slot: int, row: np.ndarray, trow: np.ndarray) -> None:
        self.state[slot] = torch.as_tensor(row, dtype=torch.float32)
        self.tele[slot] = torch.as_tensor(trow, dtype=torch.float32)

    def get_row(self, slot: int) -> np.ndarray:
        return self.state[slot].double().cpu().numpy()

    def step_async(self, frozen: torch.Tensor) -> torch.Tensor:
        """Enqueue ``iters_per_step`` passes, ``frozen`` a bool ``(slots,)``
        tensor on the state's device; returns the per-row errors of the
        last pass, still on the device."""
        fz = frozen[:, None]
        pr = self.state
        # no pass leaves every row unconverged, as the reference's loop does
        err = torch.full((pr.shape[0],), float("inf"), device=pr.device)
        for _ in range(self.iters_per_step):
            new = torch.where(fz, pr, self.sweep(pr, self.tele))
            err = torch.amax(torch.abs(new - pr), dim=1)
            pr = new
        self.state = pr
        return err


class _KernelBackend:
    """Vertex-major ``(n_blocks, block, slots)`` rank batch advanced by the
    multi-row blocked Gauss–Seidel kernel (the reference's
    ``_PallasBackend``).  ``graph`` is a built :class:`BlockedGraph` to
    share (a serving shard's), else one is built from ``g`` on
    ``device``."""

    def __init__(self, g: Graph, *, slots: int, d: float,
                 handle_dangling: bool, iters_per_step: int, device,
                 block: int = 256, graph: BlockedGraph | None = None):
        bg = BlockedGraph.build(g, block=block, device=device) if graph is None else graph
        self.graph, self.n = bg, g.n
        self.block = bg.block
        self.iters_per_step = iters_per_step
        self.sweep = make_batched_blocked_sweep(bg, d=d,
                                                handle_dangling=handle_dangling)
        shape = (bg.n_blocks, bg.block, slots)
        self.state = torch.zeros(shape, device=bg.vmask.device)
        self.tele = torch.zeros(shape, device=bg.vmask.device)

    def set_row(self, slot: int, row: np.ndarray, trow: np.ndarray) -> None:
        write_blocked_row(self.state, slot, row)
        write_blocked_row(self.tele, slot, trow)

    def get_row(self, slot: int) -> np.ndarray:
        return read_blocked_row(self.state, slot, self.n)

    def step_async(self, frozen: torch.Tensor) -> torch.Tensor:
        """As :meth:`_TorchBackend.step_async`."""
        pr = self.state
        err = torch.full((pr.shape[BATCH_AXIS],), float("inf"), device=pr.device)
        for _ in range(self.iters_per_step):
            new = self.sweep(pr, self.tele, frozen)
            err = torch.amax(torch.abs(new - pr), dim=ROW_AXES)
            pr = new
        self.state = pr
        return err


class _ShardedBackend:
    """A slot batch split over a mesh: shard ``i`` owns slots
    ``[i·rows, (i+1)·rows)`` in its own backend on its device.  The
    engine steps every batch through it; without a mesh it has one
    shard."""

    def __init__(self, shards: list, rows: int):
        self.shards = shards
        self.rows = rows
        self.n = shards[0].n
        if hasattr(shards[0], "block"):
            self.block = shards[0].block

    def set_row(self, slot: int, row: np.ndarray, trow: np.ndarray) -> None:
        self.shards[slot // self.rows].set_row(slot % self.rows, row, trow)

    def get_row(self, slot: int) -> np.ndarray:
        return self.shards[slot // self.rows].get_row(slot % self.rows)

    def step(self, frozen: np.ndarray) -> np.ndarray:
        # every mask on its card first, then every shard's passes, then
        # the errors: no host read sits between two shards' launches
        masks = [torch.as_tensor(frozen[i * self.rows:(i + 1) * self.rows],
                                 device=s.state.device)
                 for i, s in enumerate(self.shards)]
        errs = [s.step_async(fz) for s, fz in zip(self.shards, masks)]
        return np.concatenate([e.cpu().numpy() for e in errs])


def shard_batch_step(backend_cls, g: Graph, mesh: ShardMesh, *, slots: int,
                     **opts) -> _ShardedBackend:
    """Split a ``slots``-row batch of ``backend_cls`` over the 1-D ``mesh``
    (``launch/mesh.py::make_serving_mesh``): shard ``i`` owns
    ``slots/shards`` consecutive slot rows and runs the backend's own sweep
    on ``mesh.devices[i]``; ``opts`` are the backend's options.  The graph
    operands are built once, by the first shard, and copied once to each
    other distinct device of the mesh.

    Batch rows are independent solves, so no collective runs inside a
    step.  On a one-device mesh the shard runs the unsharded program on
    the same operands: the serving tests assert equal answers, bit for
    bit."""
    if not isinstance(mesh, ShardMesh):
        raise ValueError(f"serving mesh must be a 1-D ShardMesh, got {mesh!r}")
    if slots % mesh.size:
        raise ValueError(
            f"slots ({slots}) must be divisible by the mesh axis size "
            f"({mesh.size}) — each device owns slots/shards rows")
    rows = slots // mesh.size
    first = backend_cls(g, slots=rows, device=mesh.devices[0], **opts)
    graphs = {mesh.devices[0]: first.graph}
    shards = [first]
    for dev in mesh.devices[1:]:
        if dev not in graphs:
            graphs[dev] = _to_device(first.graph, dev)
        shards.append(backend_cls(g, slots=rows, device=dev, graph=graphs[dev],
                                  **opts))
    return _ShardedBackend(shards, rows)


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
    (default ``cuda``); with a ``mesh`` (a 1-D :class:`ShardMesh` whose
    size divides ``slots``) the batch is split over the mesh's devices
    instead, and ``device`` defaults to its first.  ``backend_opts`` pass
    through to the backend (``block`` for ``cuda``)."""

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
            if not isinstance(mesh, ShardMesh):
                raise ValueError(f"serving mesh must be a 1-D ShardMesh, got {mesh!r}")
            if device is not None and resolve_device(device).type != mesh.devices[0].type:
                raise ValueError(f"device {device} is not where the mesh "
                                 f"{mesh.devices} serves")
        self.g = g
        self.slots = slots
        self.d = d
        self.threshold = threshold
        self.handle_dangling = handle_dangling
        self.iters_per_step = iters_per_step
        self.backend_name = backend
        # kept so the backend rebuilt after an update is the same
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else resolve_device(device)
        self.backend_opts = dict(backend_opts)
        self._backend = self._make_backend(g)
        self._active: list[Optional[_Active]] = [None] * slots
        # free slots stay frozen: their rows are held in place by the pass
        self._frozen = np.ones(slots, dtype=bool)
        self._cache: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._cache_size = cache_size
        self.warm_hits = 0
        self.submit_rejections = 0
        self.busy_slot_steps = 0
        self.total_slot_steps = 0
        # fired with the GraphDelta after every applied update batch: the
        # serving runtime hangs its result-cache invalidation here
        self.update_callbacks: list = []

    def _make_backend(self, g: Graph):
        return shard_batch_step(
            _BACKENDS[self.backend_name], g,
            self.mesh or ShardMesh((self.device,)), slots=self.slots,
            d=self.d, handle_dangling=self.handle_dangling,
            iters_per_step=self.iters_per_step, **self.backend_opts)

    @property
    def cache_block(self) -> int:
        """Warm-cache invalidation granularity: the ``cuda`` backend's dst
        block, or the default 256 for the ``torch`` backend, which has no
        blocks."""
        return getattr(self._backend, "block", 256)

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
        """Apply an edge batch between queries: swap in the updated graph,
        rebuild the backend, and drop stale warm-cache rows.  Returns the
        :class:`repro_torch.graphs.csr.GraphDelta`.

        The engine must be idle: in-flight rows belong to the old graph's
        fixed points.  Cached rows are only warm starts (every query still
        iterates to convergence), so invalidation is a latency heuristic:
        rows whose seed set shares a :attr:`cache_block` with a touched
        vertex are dropped, and always the empty-seed global row."""
        if self.active_count:
            raise RuntimeError(
                "cannot apply updates with active slots; drain first")
        g_new, delta = self.g.apply_updates(adds=adds, dels=dels,
                                            add_weights=add_weights)
        if delta.num_ops:
            self.g = g_new
            self._backend = self._make_backend(g_new)
            block = self.cache_block
            hot = set((delta.touched_vertices() // block).tolist())
            stale = [k for k in self._cache
                     if not k or any(s // block in hot for s in k)]
            for k in stale:
                del self._cache[k]
            for cb in self.update_callbacks:
                cb(delta)
        return delta

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
