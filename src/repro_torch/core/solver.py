"""Single convergence engine + variant registry for the port's solvers.

The reference factors every PageRank variant into a **sweep** (how one unit
of rank propagation is computed) and a **schedule** (when a sweep observes
other units' writes: ``barrier`` = Jacobi, ``nosync`` = Gauss–Seidel-style
fresh reads, paper Alg 3), with optional **transforms** (Alg 5 loop
perforation) and one stop rule.  This module keeps that factoring.

Where the reference runs one ``jax.lax.while_loop``, :func:`solve` is a host
loop over eager torch ops: each iteration enqueues its device work, then
reads the max unit error back once (the one host sync per iteration) to
apply the same stop rule.  ``iterations``, ``sweeps`` and the inf-padded
``residuals`` trajectory keep the reference's meaning.  Comparisons against
``threshold`` are made at float32, as the reference's weakly-typed compare
against a float32 error is.

The residual-adaptive schedules (:func:`adaptive_schedule`,
:func:`freeze_adaptive_schedule`) carry a certified per-unit residual bound
in ``EngineState.aux`` and skip the units whose bound sits at or below
``threshold / 2``.

The port has its own registry (:func:`register_variant`); it never touches
the reference's.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

DEFAULT_DAMPING = 0.85


class PageRankResult(NamedTuple):
    """Result of one solve.

    ``pr`` is the ``(n,)`` rank vector: a float32 tensor on the solve's
    device (a float64 numpy array for the ``sequential`` oracle and for
    the plan-staged variants, which reconstruct on the host).
    ``iterations`` and ``sweeps`` are ints, ``err`` a float.  ``residuals``,
    when present, is the per-iteration max observed error as a CPU float32
    tensor of shape ``(max_iter,)``, ``inf`` past the last iteration — slice
    it with ``residuals[:iterations]``.  ``sweeps`` counts executed
    schedule-unit updates: ``iterations`` for the single-unit barrier
    schedules, at most ``iterations · p`` for the partitioned ones; the
    ``sequential`` oracle, and a plan whose core is empty, leave both
    ``None``.
    """

    pr: Any
    iterations: int
    err: float
    residuals: Any = None
    sweeps: Any = None


class EngineState(NamedTuple):
    """Loop-carried state of the convergence engine.

    ``pr`` may be any layout (flat, padded, blocked 2-D); only the
    schedule's step touches it.  ``frozen`` is the perforation mask (bool,
    same shape as ``pr``, or a zero-size stub when no transform needs it).
    ``perr`` holds the last observed error per schedule unit, on the
    device; for units an adaptive schedule skipped it holds the pre-round
    certified bound instead (at or below the skip cut, so it never blocks
    the stop rule).  ``it`` is a host int; ``sweeps`` is a host int, or a
    0-dim device tensor where a schedule decides on the device whether a
    unit swept (thread-level termination, block skipping).  ``aux`` is
    schedule-owned carried state the engine never touches: the adaptive
    schedules keep their staleness-inflated bound vector there; every other
    schedule leaves it the empty default.
    """

    pr: torch.Tensor
    frozen: torch.Tensor
    perr: torch.Tensor
    it: int
    sweeps: Any
    aux: Any = ()


# A transform post-processes one proposed update: (old, new, frozen) ->
# (new', frozen').  Applied inside the schedule, per unit.
Transform = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                     tuple[torch.Tensor, torch.Tensor]]


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float: comparisons against it
    decide the same way in float32 and float64."""
    return float(np.float32(x))


def perforation(threshold: float) -> Transform:
    """Alg 5 loop perforation: freeze vertices whose delta is tiny but nonzero."""
    cut = _f32(threshold * 1e-5)

    def transform(old, new, frozen):
        delta = torch.abs(new - old)
        frozen_new = frozen | ((delta > 0) & (delta < cut))
        return torch.where(frozen, old, new), frozen_new

    return transform


def row_freeze(threshold: float, axes: tuple[int, ...] = (-1,)) -> Transform:
    """Per-row convergence freeze for batched solves (the PPR subsystem).

    A row whose observed delta (max over ``axes``, the non-batch axes of
    the rank layout) is at or below ``threshold`` is frozen: it holds its
    converged value while the other rows keep iterating.  The order is the
    reference's: mask ``new`` with the old freeze first, then take the row
    error of the masked update, then grow the freeze."""
    thr = _f32(threshold)

    def transform(old, new, frozen):
        new = torch.where(frozen, old, new)
        row_err = torch.amax(torch.abs(new - old), dim=axes, keepdim=True)
        return new, frozen | (row_err <= thr).expand_as(frozen)

    return transform


def _apply_transforms(transforms: Sequence[Transform], old, new, frozen):
    for t in transforms:
        new, frozen = t(old, new, frozen)
    return new, frozen


# ---------------------------------------------------------------------------
# Schedules — combinators turning a sweep fn into one engine step
# ---------------------------------------------------------------------------


def barrier_schedule(sweep: Callable[..., torch.Tensor],
                     transforms: Sequence[Transform] = (),
                     *, pass_frozen: bool = False) -> Callable:
    """Jacobi: ``sweep(pr)`` proposes a full replacement computed from the
    previous iterate (paper Alg 1).  One schedule unit.

    ``pass_frozen`` calls ``sweep(pr, frozen)`` instead, for sweeps that
    must respect the perforation mask *inside* the sweep (the blocked
    Gauss–Seidel pass, whose in-pass fresh reads must see frozen vertices at
    their frozen values).  The freeze *decision* stays in the engine's
    :func:`perforation` transform.  Requires ``track_frozen=True`` in
    :func:`solve`."""

    def step(state: EngineState) -> EngineState:
        new = sweep(state.pr, state.frozen) if pass_frozen else sweep(state.pr)
        new, frozen = _apply_transforms(transforms, state.pr, new, state.frozen)
        err = torch.max(torch.abs(new - state.pr))
        return EngineState(new, frozen, err.expand_as(state.perr),
                           state.it + 1, state.sweeps + 1)

    return step


def batched_barrier_schedule(
    sweep: Callable[..., torch.Tensor],
    transforms: Sequence[Transform] = (),
    *,
    pass_frozen: bool = False,
    row_error: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
) -> Callable:
    """Jacobi over a batch of ``b`` independent solves sharing one graph.

    Each batch row is one schedule unit: ``perr`` has shape ``(b,)`` (pass
    ``n_units=b`` to :func:`solve`), so the stop rule fires only when every
    row has converged, while a :func:`row_freeze` transform exits single
    rows early.  ``row_error(new, old) -> (b,)`` reduces the non-batch
    axes; the default takes the batch as axis 0.  ``pass_frozen`` is as in
    :func:`barrier_schedule` (the blocked batched pass takes the freeze as
    a kernel operand)."""

    def step(state: EngineState) -> EngineState:
        new = sweep(state.pr, state.frozen) if pass_frozen else sweep(state.pr)
        new, frozen = _apply_transforms(transforms, state.pr, new, state.frozen)
        if row_error is not None:
            err = row_error(new, state.pr)
        else:
            err = torch.amax(torch.abs(new - state.pr),
                             dim=tuple(range(1, new.ndim)))
        return EngineState(new, frozen, err, state.it + 1, state.sweeps + 1)

    return step


def nosync_schedule(
    sweep: Callable[..., torch.Tensor],
    *,
    p: int,
    vp: int,
    threshold: float,
    transforms: Sequence[Transform] = (),
    thread_level: bool = False,
    prologue: Callable[[torch.Tensor], Any] | None = None,
) -> Callable:
    """No-Sync (paper Alg 3): partitions are swept **in order within an
    iteration**, each reading the freshest ranks.  ``sweep(i, pr)`` returns
    partition ``i``'s proposed ``(vp,)`` block from the current full vector
    (partitions live on the last axis of ``pr``).

    ``prologue(pr)``, when given, computes once-per-iteration context shared
    by every partition sweep (the dangling-mass snapshot), and the sweep is
    called as ``sweep(i, pr, ctx)``.

    ``thread_level`` is the paper's thread-level convergence (Alg 3
    l.17-19) as termination semantics: a unit skips its sweep only when it
    observes every unit's last error at or below threshold.  The decision
    stays on the device — a skipped unit's sweep is computed and discarded
    by a select — so the schedule adds no host sync per partition; the
    ranks, errors and sweep count are those of a real skip.

    The step copies the rank vector once and updates the copy in place,
    partition by partition.
    """
    thr = _f32(threshold)

    def step(state: EngineState) -> EngineState:
        ctx = prologue(state.pr) if prologue is not None else None
        pr = state.pr.clone()
        frozen = state.frozen.clone() if transforms else state.frozen
        perr = state.perr.clone()
        nsw = state.sweeps
        for i in range(p):
            part = slice(i * vp, (i + 1) * vp)
            old = pr[..., part]
            new = sweep(i, pr) if prologue is None else sweep(i, pr, ctx)
            fr = None
            if transforms:
                fr_old = frozen[..., part]
                new, fr = _apply_transforms(transforms, old, new, fr_old)
            err = torch.max(torch.abs(new - old))
            if thread_level:
                go = torch.max(perr) > thr
                new = torch.where(go, new, old)
                err = torch.where(go, err, perr[i])
                if fr is not None:
                    fr = torch.where(go, fr, fr_old)
                nsw = nsw + go.to(torch.int64)
            else:
                nsw = nsw + 1
            if fr is not None:
                frozen[..., part] = fr
            pr[..., part] = new
            perr[i] = err
        return EngineState(pr, frozen, perr, state.it + 1, nsw)

    return step


def adaptive_schedule(
    sweep: Callable[..., torch.Tensor],
    *,
    p: int,
    vp: int,
    threshold: float,
    d: float,
    gain: torch.Tensor,
    prologue: Callable[[torch.Tensor], Any] | None = None,
) -> Callable:
    """Residual-adaptive No-Sync: :func:`nosync_schedule` with the order and
    the skip set chosen per partition from a certified residual bound.

    * **ordering** — partitions are swept in descending bound order each
      round (a stable sort, so round one, all ``inf``, runs 0…p−1);
    * **skipping** — a partition whose bound is at or below
      ``threshold / 2`` (compared in float32) is not swept this round.

    The bound lives in ``EngineState.aux``, one entry per vertex: ``gain``
    is the ``(n_pad, p)`` per-vertex certificate and a partition's bound is
    the max over its vertices.  A swept vertex restarts from 0, and every
    vertex is inflated by the worst-case influence of this round's updates,
    ``bound += d · gain @ maxΔ``, where ``maxΔ_j`` is the max-abs update
    partition ``j`` applied.  ``perr`` is the observed delta of a swept
    partition and the *pre-inflation* bound of a skipped one, so the stop
    rule is the reference's.

    The sweep order and the skip set are read to the host once a round
    (``2p`` values); the partition loop then launches only the sweeps that
    run.  ``sweep``/``prologue`` are as in :func:`nosync_schedule`.  Pass
    ``aux0=torch.full((p · vp,), inf)`` to :func:`solve`."""
    cut = _f32(threshold / 2)
    df = _f32(d)

    def step(state: EngineState) -> EngineState:
        ctx = prologue(state.pr) if prologue is not None else None
        bound = state.aux
        pbound = torch.amax(bound.reshape(p, vp), dim=1)
        active = pbound > cut
        order = torch.argsort(-pbound, stable=True)
        plan = torch.cat([order, active.to(order.dtype)]).tolist()
        pr = state.pr.clone()
        deltas = torch.zeros(p, dtype=pr.dtype, device=pr.device)
        nsw = state.sweeps
        for i in plan[:p]:
            if not plan[p + i]:
                continue
            part = slice(i * vp, (i + 1) * vp)
            old = pr[..., part]
            new = sweep(i, pr) if prologue is None else sweep(i, pr, ctx)
            deltas[i] = torch.max(torch.abs(new - old))
            pr[..., part] = new
            nsw += 1
        swept = active.repeat_interleave(vp)
        bound = bound.masked_fill(swept, 0.0) + df * torch.mv(gain, deltas)
        perr = torch.where(active, deltas, pbound)
        return EngineState(pr, state.frozen, perr, state.it + 1, nsw, bound)

    return step


def freeze_adaptive_schedule(
    sweep: Callable[..., torch.Tensor],
    *,
    threshold: float,
    d: float,
    gain: torch.Tensor,
) -> Callable:
    """Residual-adaptive scheduling for a sweep that takes a freeze mask
    instead of a partition index: the blocked Gauss–Seidel pass, whose walk
    of dst blocks is fixed.  Each unit is one row of the ``(n_blocks,
    block)`` rank layout.

    A block whose certified bound is at or below ``threshold / 2`` is
    frozen for the whole pass (``sweep(pr, frozen)`` keeps its ranks) and
    unfrozen once its neighbours' updates inflate the bound past the cut;
    the bound model, ``perr`` and the stop rule are
    :func:`adaptive_schedule`'s, with ``gain`` per block (``(n_blocks,
    n_blocks)``).  There is no reordering.  Everything stays on the device:
    ``sweeps`` (blocks swept) is a device count.  Pass
    ``aux0=torch.full((n_blocks,), inf)`` to :func:`solve`."""
    cut = _f32(threshold / 2)
    df = _f32(d)

    def step(state: EngineState) -> EngineState:
        bound = state.aux
        active = bound > cut
        # gs_pass takes a contiguous bool mask, not a broadcast view
        frozen = (~active)[:, None].expand(state.pr.shape).contiguous()
        new = sweep(state.pr, frozen)
        err = torch.amax(torch.abs(new - state.pr), dim=1)
        deltas = err.masked_fill(~active, 0.0)
        new_bound = bound.masked_fill(active, 0.0) + df * torch.mv(gain, deltas)
        perr = torch.where(active, err, bound)
        sweeps = state.sweeps + active.sum()
        return EngineState(new, state.frozen, perr, state.it + 1, sweeps,
                           new_bound)

    return step


# ---------------------------------------------------------------------------
# The engine: the one loop every variant shares
# ---------------------------------------------------------------------------


def solve(
    step: Callable[[EngineState], EngineState],
    pr0: torch.Tensor,
    *,
    n_units: int = 1,
    threshold: float,
    max_iter: int,
    track_frozen: bool = False,
    aux0: Any = (),
) -> PageRankResult:
    """Iterate ``step`` until every observed unit error is at or below
    ``threshold`` (or ``max_iter``).  Returns the rank tensor in the
    solver's own layout — callers strip padding / reshape.

    ``track_frozen`` allocates the perforation freeze mask; otherwise the
    state carries a zero-size stub.  ``aux0`` seeds the schedule-owned
    ``EngineState.aux`` (the adaptive schedules' bound vector).  The stop
    rule reads the max unit error back to the host once per iteration, and
    records it in the ``residuals`` trajectory."""
    thr = _f32(threshold)
    dev = pr0.device
    state = EngineState(
        pr=pr0,
        frozen=torch.zeros(pr0.shape if track_frozen else (0,),
                           dtype=torch.bool, device=dev),
        perr=torch.full((n_units,), math.inf, dtype=pr0.dtype, device=dev),
        it=0,
        sweeps=0,
        aux=aux0,
    )
    residuals = torch.full((max_iter,), math.inf, dtype=torch.float32)
    err = math.inf
    while err > thr and state.it < max_iter:
        state = step(state)
        err = float(torch.max(state.perr))
        residuals[state.it - 1] = err
    return PageRankResult(state.pr, state.it, err, residuals,
                          int(state.sweeps))


# ---------------------------------------------------------------------------
# Variant registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Variant:
    """A registered PageRank variant of the port.

    ``build(g, **opts)`` turns a host :class:`repro_torch.graphs.csr.Graph`
    into the variant's device bundle; ``run(bundle, d=..., threshold=...,
    max_iter=..., handle_dangling=..., **opts)`` solves it.  ``options``
    names extra run options beyond the transport set.  Metadata:

    * ``layout``  — bundle-layout key: variants with the same layout build
      identical bundles from identical options.
    * ``backend`` — what executes the sweeps: ``"numpy"`` (host oracle),
      ``"torch"`` (eager torch ops), ``"cuda"`` (the port's hand-written
      CUDA kernels; their plain torch versions on a CPU device).
    * ``schedule`` — ``"barrier"``, ``"nosync"``, ``"adaptive"`` or
      ``"sequential"``.
    """

    name: str
    build: Callable[..., Any]
    run: Callable[..., PageRankResult]
    description: str = ""
    options: tuple[str, ...] = ()
    layout: str = ""
    backend: str = "torch"
    schedule: str = "barrier"


_REGISTRY: dict[str, Variant] = {}

BACKENDS = frozenset({"numpy", "torch", "cuda"})
SCHEDULES = frozenset({"barrier", "nosync", "adaptive", "sequential"})

# Options every driver may pass; a variant that does not need one ignores it.
# ``pr0`` is the warm-start vector, a numpy ``(n,)`` array.  ``device``
# places the bundle (default ``cuda``; see repro_torch.device).  ``tile_cap``
# is accepted for command-line parity with the reference and has no meaning
# in the port's CSR layout.  ``local_sweeps`` and ``send_fraction`` reach
# the distributed variants (sweeps per exchange, the share of deltas
# published a round), as in the reference.
_TRANSPORT_OPTS = frozenset({"threads", "block", "tile_cap", "pr0", "device",
                             "local_sweeps", "send_fraction"})


def register_variant(name: str, build: Callable, run: Callable,
                     description: str = "",
                     options: tuple[str, ...] = (),
                     layout: str = "",
                     backend: str = "torch",
                     schedule: str = "barrier") -> Variant:
    """Register a variant under ``name`` and return the record.

    The metadata is validated here, so a bad registration fails at import
    of its defining module (``ValueError``), not at first use."""
    problems = []
    if not description:
        problems.append("description must be non-empty (printed by --list)")
    if not layout:
        problems.append("layout must be non-empty (bundle-sharing key)")
    if backend not in BACKENDS:
        problems.append(f"backend {backend!r} not in {sorted(BACKENDS)}")
    if schedule not in SCHEDULES:
        problems.append(f"schedule {schedule!r} not in {sorted(SCHEDULES)}")
    if problems:
        raise ValueError(
            f"register_variant({name!r}): " + "; ".join(problems))
    v = Variant(name=name, build=build, run=run, description=description,
                options=options, layout=layout, backend=backend,
                schedule=schedule)
    _REGISTRY[name] = v
    return v


def _ensure_registered() -> None:
    # Variants self-register at import; pull in every module that defines one.
    import repro_torch.core.distributed  # noqa: F401
    import repro_torch.core.pagerank  # noqa: F401
    import repro_torch.kernels.spmv.ops  # noqa: F401
    import repro_torch.ppr.batched  # noqa: F401
    import repro_torch.ppr.push  # noqa: F401


def list_variants() -> tuple[str, ...]:
    _ensure_registered()
    return tuple(sorted(_REGISTRY))


def get_variant(name: str) -> Variant:
    _ensure_registered()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown PageRank variant {name!r}; registered: {list_variants()}"
        ) from None


def build_variant(name: str, g, *, d: float = DEFAULT_DAMPING,
                  **opts) -> tuple[Variant, Any]:
    """Validate ``opts`` and build ``name``'s bundle from host graph ``g``
    on ``opts["device"]`` (default ``cuda``); returns ``(variant, bundle)``.

    ``g`` may also be the path (``str`` / ``os.PathLike``) of a graph store
    (:mod:`repro_torch.graphs.store`): it is opened memmap-backed, so the
    build pages the edge arrays in instead of holding them resident.

    Unknown options raise ``TypeError`` instead of being silently dropped,
    and a ``cuda`` device where there is none raises ``RuntimeError``."""
    if isinstance(g, (str, os.PathLike)):
        from repro_torch.graphs.store import load_graph

        g = load_graph(g, mmap=True)
    v = get_variant(name)
    unknown = set(opts) - _TRANSPORT_OPTS - set(v.options)
    if unknown:
        raise TypeError(
            f"variant {name!r} does not accept option(s) {sorted(unknown)}; "
            f"accepted: {sorted(_TRANSPORT_OPTS | set(v.options))}"
        )
    opts["device"] = resolve_device(opts.get("device"))
    return v, v.build(g, d=d, **opts)


def bundle_partitions(bundle) -> int:
    """Partition count baked into a built bundle: ``p`` for the
    partitioned and distributed layouts, 1 for the others.  Checkpoints
    record this, not the requested ``threads``: an unpartitioned solve
    resharded on load as if it had 56 partitions would be padded to a
    layout it never used."""
    return int(getattr(bundle, "p", 1))


def warm_start_pr(g, prev_pr, *, d: float = DEFAULT_DAMPING,
                  handle_dangling: bool = False) -> np.ndarray:
    """Warm-start seed after a graph update: one exact float64 sweep of
    ``g`` applied to the stale fixed point ``prev_pr``, so contributions
    already divide by the new out-degrees and mass through deleted edges
    has stopped.  The fixed point does not depend on the start, so a warm
    start buys iterations, never correctness."""
    n = int(g.n)
    prev = np.asarray(prev_pr, dtype=np.float64)
    if prev.shape != (n,):
        raise ValueError(f"prev_pr must have shape ({n},), got {prev.shape}")
    if n == 0:
        return prev.copy()
    out_degree = np.asarray(g.out_degree)
    inv_out = np.where(out_degree > 0, 1.0 / np.maximum(out_degree, 1), 0.0)
    contrib = (prev * inv_out)[np.asarray(g.src)]
    if g.weights is not None:
        contrib = contrib * np.asarray(g.weights)
    acc = np.zeros(n, dtype=np.float64)
    np.add.at(acc, np.asarray(g.dst), contrib)
    base = (1.0 - d) / n
    base_vec = base if g.bias is None else base * np.asarray(g.bias)
    new = base_vec + d * acc
    if handle_dangling:
        new = new + d * prev[out_degree == 0].sum() / n
    return new


# ---------------------------------------------------------------------------
# Plan stage: STIC-D decomposition in front of any inner variant
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlannedBundle:
    """Bundle of a plan-staged variant: the decomposition plan and the
    inner variant's bundle built on the plan's core (``None`` when the
    plan pruned every vertex).  ``build_opts``/``plan_opts`` record what
    built it, so :func:`plan_run` can re-plan for another ``d``."""

    plan: Any  # repro_torch.graphs.csr.DecompositionPlan
    inner: Variant
    bundle: Any
    build_opts: dict = dataclasses.field(default_factory=dict)
    plan_opts: dict = dataclasses.field(default_factory=dict)

    @property
    def p(self) -> int:
        # plan_run returns the full-length reconstructed vector, which was
        # never partitioned (only the core bundle was): a checkpoint of it
        # records an unpartitioned layout
        return 1


def plan_build(inner: str, **plan_opts) -> Callable:
    """A ``build(g, **opts)`` that decomposes ``g``
    (:meth:`DecompositionPlan.from_graph` with ``plan_opts``) and builds
    ``inner`` on the core, with the other options (the resolved ``device``
    among them).  The plan bakes the build's ``d`` unless ``plan_opts``
    pins one."""

    def build(g, **opts):
        from repro_torch.graphs.csr import DecompositionPlan

        p_opts = dict(plan_opts)
        p_opts.setdefault("d", opts.get("d", DEFAULT_DAMPING))
        b_opts = {k: val for k, val in opts.items() if k != "d"}
        plan = DecompositionPlan.from_graph(g, **p_opts)
        v = get_variant(inner)
        bundle = v.build(plan.core, **b_opts) if plan.core.n else None
        return PlannedBundle(plan=plan, inner=v, bundle=bundle,
                             build_opts=b_opts, plan_opts=p_opts)

    return build


def plan_run(
    b: PlannedBundle,
    *,
    d: float = DEFAULT_DAMPING,
    threshold: float = 1e-8,
    max_iter: int = 10_000,
    handle_dangling: bool = False,
    pr0=None,
    **opts,
) -> PageRankResult:
    """Run fn of every plan-staged variant: the inner solve of the core,
    then :meth:`DecompositionPlan.reconstruct` on the host.

    The inner solve always runs with ``handle_dangling=False``;
    reconstruction applies the redistribution in closed form, from one
    device-to-host copy of the core ranks.  A run-time ``d`` other than
    the plan's re-plans and rebuilds first when the plan's weights encode
    ``d``.  A full-length warm start ``pr0`` is restricted to the core and
    rescaled to the core's own ``(1-d)/n_core`` base.  ``pr`` is a float64
    numpy ``(n,)`` array."""
    if b.plan.d_dependent and not np.isclose(d, b.plan.d):
        from repro_torch.graphs.csr import DecompositionPlan

        plan_opts = dict(b.plan_opts, d=d)
        plan = DecompositionPlan.from_graph(b.plan.full, **plan_opts)
        bundle = (b.inner.build(plan.core, **b.build_opts)
                  if plan.core.n else None)
        b = PlannedBundle(plan=plan, inner=b.inner, bundle=bundle,
                          build_opts=b.build_opts, plan_opts=plan_opts)
    if b.bundle is None:  # fully pruned: reconstruction does it all
        it, err, residuals, sweeps = 0, 0.0, None, None
        core_pr = np.zeros(0, dtype=np.float64)
    else:
        if pr0 is not None:
            pr0 = np.asarray(pr0, dtype=np.float64)
            if pr0.shape != (b.plan.n,):
                raise ValueError(
                    f"pr0 must be full-length ({b.plan.n},), got {pr0.shape}")
            opts = dict(opts, pr0=pr0[b.plan.core_index]
                        * (b.plan.n / b.plan.core.n))
        r = b.inner.run(b.bundle, d=d, threshold=threshold, max_iter=max_iter,
                        handle_dangling=False, **opts)
        it, err, residuals, sweeps = r.iterations, r.err, r.residuals, r.sweeps
        core_pr = r.pr
        if isinstance(core_pr, torch.Tensor):
            core_pr = core_pr.detach().cpu().numpy()
    pr = b.plan.reconstruct(core_pr, d=d, handle_dangling=handle_dangling)
    return PageRankResult(pr, it, err, residuals, sweeps)


def plan_stats(bundle) -> dict | None:
    """Decomposition counters of a built bundle (``None`` when unplanned)."""
    if isinstance(bundle, PlannedBundle):
        return bundle.plan.stats()
    return None


def solve_variant(
    name: str,
    g,
    *,
    d: float = DEFAULT_DAMPING,
    threshold: float = 1e-8,
    max_iter: int = 10_000,
    handle_dangling: bool = False,
    **opts,
) -> PageRankResult:
    """Build the bundle for ``name`` and solve — the one-call entry point."""
    v, bundle = build_variant(name, g, d=d, **opts)
    return v.run(bundle, d=d, threshold=threshold, max_iter=max_iter,
                 handle_dangling=handle_dangling, **opts)
