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

The port has its own registry (:func:`register_variant`); it never touches
the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

DEFAULT_DAMPING = 0.85


class PageRankResult(NamedTuple):
    """Result of one solve.

    ``pr`` is the ``(n,)`` rank vector: a float32 tensor on the solve's
    device (a float64 numpy array for the ``sequential`` oracle).
    ``iterations`` and ``sweeps`` are ints, ``err`` a float.  ``residuals``,
    when present, is the per-iteration max observed error as a CPU float32
    tensor of shape ``(max_iter,)``, ``inf`` past the last iteration — slice
    it with ``residuals[:iterations]``.  ``sweeps`` counts executed
    schedule-unit updates: ``iterations`` for the single-unit barrier
    schedules, at most ``iterations · p`` for the partitioned ones; the
    ``sequential`` oracle leaves both ``None``.
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
    device.  ``it`` is a host int; ``sweeps`` is a host int, or a 0-dim
    device tensor where a schedule decides on the device whether a unit
    swept (thread-level termination).
    """

    pr: torch.Tensor
    frozen: torch.Tensor
    perr: torch.Tensor
    it: int
    sweeps: Any


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
) -> PageRankResult:
    """Iterate ``step`` until every observed unit error is at or below
    ``threshold`` (or ``max_iter``).  Returns the rank tensor in the
    solver's own layout — callers strip padding / reshape.

    ``track_frozen`` allocates the perforation freeze mask; otherwise the
    state carries a zero-size stub.  The stop rule reads the max unit error
    back to the host once per iteration, and records it in the
    ``residuals`` trajectory."""
    thr = _f32(threshold)
    dev = pr0.device
    state = EngineState(
        pr=pr0,
        frozen=torch.zeros(pr0.shape if track_frozen else (0,),
                           dtype=torch.bool, device=dev),
        perr=torch.full((n_units,), math.inf, dtype=pr0.dtype, device=dev),
        it=0,
        sweeps=0,
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
# in the port's CSR layout.
_TRANSPORT_OPTS = frozenset({"threads", "block", "tile_cap", "pr0", "device"})


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
    import repro_torch.core.pagerank  # noqa: F401
    import repro_torch.kernels.spmv.ops  # noqa: F401


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

    Unknown options raise ``TypeError`` instead of being silently dropped,
    and a ``cuda`` device where there is none raises ``RuntimeError``."""
    v = get_variant(name)
    unknown = set(opts) - _TRANSPORT_OPTS - set(v.options)
    if unknown:
        raise TypeError(
            f"variant {name!r} does not accept option(s) {sorted(unknown)}; "
            f"accepted: {sorted(_TRANSPORT_OPTS | set(v.options))}"
        )
    opts["device"] = resolve_device(opts.get("device"))
    return v, v.build(g, d=d, **opts)


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
