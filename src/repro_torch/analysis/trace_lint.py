"""Dispatch-trace lint: run every registry variant's solve under a
:class:`~torch.utils._python_dispatch.TorchDispatchMode` that records each
aten op, and check the record against the schedule contract its registry
metadata declares — the port's counterpart of the reference's jaxpr lint
(``repro.analysis.jaxpr_lint``).

The port's engine is a host loop over eager ops, so where the reference
reads a closed jaxpr, this pass reads the ops a solve dispatches: their
names, the devices of their tensor inputs and outputs, and their output
dtypes (:class:`OpRecord`).  Each variant is built on the reference's tiny
graph (``rmat_graph(scale=4, avg_degree=4, seed=7)``, 16 vertices) with the
reference's options, outside the trace, and solved inside it at
``threshold=1e-4, max_iter=3, handle_dangling=True``.  STIC-D planned
variants are traced through their inner variant on the core bundle — the
plan and the reconstruction are host numpy by design.  The PPR engine's
``step_async`` is linted on both backends (``serving_torch``,
``serving_cuda``) at 2 slots and 2 passes a step.

Checks (:func:`lint_ops`, pure, so tests can feed it broken records):

* ``float64-leak`` — an op with a float64 output on the solve's device
  (``aten.lift_fresh``, host data wrapped as a tensor on its way to the
  device, lies on the host and is not one);
* ``device-transfer`` — a copy that touches a device other than the
  solve's devices and the host, or more uploads from the host to the
  solve's devices than :func:`upload_contract` allows: state is placed
  once, on the mesh, before the sweep;
* ``collective-in-nosync`` — a ``nosync`` variant whose solve runs a
  cross-shard exchange.  On a mesh whose shards share one device the
  exchange copies nothing, so the trace adds one ``exchange.<kind>``
  record for each exchange the distributed solvers count
  (:func:`repro_torch.core.distributed.exchange_counts`);
* ``untraceable`` — the build or the solve raised (a finding, not a crash);
* ``host-reads`` — more reads of the device from the host than the
  contract allows (:data:`HOST_READ_CONTRACT`, reads an iteration keyed
  on the traced variant's schedule and layout).  A host read is a
  ``_local_scalar_dense`` (``float(t)``, ``int(t)``, ``t.item()``) of a
  tensor on the solve's device, or a copy from a device to the host.
  Where a schedule counts its sweeps on the device (the thread-level
  No-Sync of ``nosync``, ``nosync_opt``, ``nosync_sticd`` and
  ``ppr_nosync``; ``blocked_adaptive``'s block skipping), ``solve`` reads
  the count once after the loop (``int(state.sweeps)``) to return it as a
  host int: one read over the contract, which the suppression list in
  :mod:`repro_torch.analysis.findings` names with its reason.

**What a CPU run cannot see.**  On the CPU ``Tensor.tolist()`` and
``Tensor.numpy()`` of a CPU tensor read memory without dispatching an op,
so the adaptive schedule's order and skip-set read
(``core/solver.py::adaptive_schedule``, a ``tolist()``) and every
``.cpu().numpy()`` are invisible there: the CPU count is a lower bound.
On the card each is an ``aten._to_copy`` to the host, which the mode sees.
The CUDA kernels are ``ctypes`` calls the dispatcher never sees; the trace
reports the launch counters' increments beside the ops around them, and a
float64 inside a kernel (``gs_pass_multi``'s double sums) is not a leak on
the device path.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.findings import Finding

# The options every variant is built and run with (the reference's); the
# serving engine's cuda backend takes the same block.
LINT_OPTS = dict(threads=2, block=8, tile_cap=16, local_sweeps=2,
                 send_fraction=0.5)
LINT_RUN = dict(threshold=1e-4, max_iter=3, handle_dangling=True)
SERVING_BACKENDS = (("torch", {}), ("cuda", {"block": LINT_OPTS["block"]}))
SERVING_SLOTS = 2
SERVING_ITERS = 2

HOST = "cpu"
READ_OPS = frozenset({"aten._local_scalar_dense.default"})
COPY_OPS = frozenset({"aten._to_copy.default", "aten.copy_.default"})
# host data wrapped as a tensor (torch.as_tensor of a numpy array)
HOST_DATA_OPS = frozenset({"aten.lift_fresh.default"})
# the records of the distributed solvers' counted exchanges
EXCHANGE = "exchange"

# Host reads an iteration of a solve, keyed on (schedule, layout) of the
# variant that runs ("*": any layout).
#
# * one read an iteration: ``solve``'s stop rule reads the max unit error
#   (``core/solver.py::solve``); the distributed solvers read the round's
#   max residual instead (``core/distributed.py::_round_error``);
# * the adaptive partition schedule reads its sweep order and skip set on
#   top of that, once a round (``adaptive_schedule``'s ``tolist()``);
# * the engine's ``step_async`` keeps its errors on the device (the engine's
#   ``step`` reads them once a step, outside it).
HOST_READ_CONTRACT: dict[tuple[str, str], int] = {
    ("barrier", "*"): 1,
    ("nosync", "*"): 1,
    ("adaptive", "partitioned"): 2,
    ("adaptive", "blocked_gain"): 1,
    ("nosync", "serving"): 0,
}


def read_contract(schedule: str, layout: str) -> int:
    """Host reads an iteration of :data:`HOST_READ_CONTRACT` for a
    variant's schedule and layout; 0 for a schedule with no device loop."""
    for key in ((schedule, layout), (schedule, "*")):
        if key in HOST_READ_CONTRACT:
            return HOST_READ_CONTRACT[key]
    return 0


def upload_contract(options: Iterable[str]) -> int:
    """Copies from the host to the device a solve may make: one for a
    variant that takes ``seeds`` (its teleport row, built on the host from
    the seed list), none for any other — the graph is placed by ``build``."""
    return int("seeds" in options)


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched op: its overload name (``aten._to_copy.default``, or
    ``exchange.all_gather`` for a counted exchange), the devices of its
    tensor inputs, and the ``(device, dtype)`` of each tensor output."""

    op: str
    ins: tuple[str, ...] = ()
    outs: tuple[tuple[str, str], ...] = ()


class OpRecorder(TorchDispatchMode):
    """Records every aten op dispatched while it is active.  The mode is
    off while an op runs, so an op's own decomposition is not recorded."""

    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = tuple(str(t.device) for t in tree_flatten((args, kwargs))[0]
                    if isinstance(t, torch.Tensor))
        outs = tuple((str(t.device), str(t.dtype))
                     for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor))
        self.records.append(OpRecord(str(func), ins, outs))
        return out


@dataclasses.dataclass
class OpSummary:
    """What :func:`lint_ops` counts in a record list."""

    reads: int = 0
    uploads: int = 0
    transfers: list = dataclasses.field(default_factory=list)
    collectives: dict = dataclasses.field(default_factory=dict)
    float64_ops: set = dataclasses.field(default_factory=set)


def summarize(records: Iterable[OpRecord], devices: Iterable[str] = (HOST,)) -> OpSummary:
    """Host reads, host-to-device uploads, foreign transfers, collectives
    and float64 producers in ``records`` of a solve on ``devices`` (a copy
    from the host to a mesh that holds the host is the exchange, not an
    upload)."""
    devices = set(devices)
    s = OpSummary()
    for r in records:
        if r.op.split(".")[0] == EXCHANGE:
            s.collectives[r.op] = s.collectives.get(r.op, 0) + 1
            continue
        out_devs = {d for d, _ in r.outs}
        if r.op in READ_OPS and set(r.ins) & devices:
            s.reads += 1
        elif r.op in COPY_OPS:
            touched = set(r.ins) | out_devs
            if touched - devices - {HOST}:
                s.transfers.append(f"{r.op}: {sorted(set(r.ins))} -> {sorted(out_devs)}")
            elif HOST in out_devs and set(r.ins) - {HOST}:
                s.reads += 1
            elif HOST in set(r.ins) and out_devs - {HOST} and HOST not in devices:
                s.uploads += 1
        if r.op not in HOST_DATA_OPS and any(
                dt == "torch.float64" and d in devices for d, dt in r.outs):
            s.float64_ops.add(r.op)
    return s


def lint_ops(records: Iterable[OpRecord], *, target: str, schedule: str = "",
             iterations: int = 0, layout: str = "*", uploads: int = 0,
             devices: Iterable[str] = (HOST,)) -> list[Finding]:
    """Lint the ops of one solve on ``devices`` (the host alone by default)
    that ran ``iterations`` iterations against the read contract of its
    ``schedule`` and ``layout`` and ``uploads`` copies from the host.  Pure
    function of the record — the registry pass and the test fixtures both
    funnel through here."""
    s = summarize(records, devices)
    findings: list[Finding] = []
    if s.float64_ops:
        findings.append(Finding(
            "trace", target, "float64-leak",
            f"the solve computes float64 on the device path (ops: "
            f"{sorted(s.float64_ops)}) — a numpy default has leaked past the "
            f"float32 boundary"))
    if s.transfers:
        findings.append(Finding(
            "trace", target, "device-transfer",
            f"{len(s.transfers)} copy(ies) to or from a device outside the "
            f"solve's ({sorted(set(devices))}), first {s.transfers[0]} — state "
            f"should be placed once, before the sweep"))
    elif s.uploads > uploads:
        findings.append(Finding(
            "trace", target, "device-transfer",
            f"{s.uploads} copies from the host to {sorted(set(devices))} in "
            f"{iterations} iterations, over the {uploads} a solve allowed — "
            f"state should be placed once, before the sweep"))
    if s.collectives and schedule == "nosync":
        findings.append(Finding(
            "trace", target, "collective-in-nosync",
            f"schedule metadata says 'nosync' but the solve synchronizes via "
            f"{dict(sorted(s.collectives.items()))}"))
    per_it = read_contract(schedule, layout)
    if s.reads > per_it * iterations:
        findings.append(Finding(
            "trace", target, "host-reads",
            f"{s.reads} host reads in {iterations} iterations, over the "
            f"contract's {per_it} an iteration for schedule {schedule!r}, layout "
            f"{layout!r} — each read stalls the host on the device"))
    return findings


# ---------------------------------------------------------------------------
# Tracing the real registry and engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TraceReport:
    """One traced target: what ran, what the trace counted, its findings."""

    target: str
    schedule: str
    layout: str
    iterations: int = 0
    reads: int = 0
    uploads: int = 0
    contract: int = 0
    upload_contract: int = 0
    launches: dict = dataclasses.field(default_factory=dict)
    exchanges: dict = dataclasses.field(default_factory=dict)
    ops: int = 0
    findings: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["findings"] = [f.to_dict() for f in self.findings]
        return d

    def line(self) -> str:
        per = f"{self.reads / self.iterations:.2f}" if self.iterations else "n/a"
        out = (f"trace: {self.target} ({self.schedule}, {self.layout}): "
               f"{self.iterations} iterations, {self.reads} host reads = {per} an "
               f"iteration (contract {self.contract} an iteration), {self.uploads} "
               f"uploads (contract {self.upload_contract} a solve), {self.ops} ops")
        if any(self.exchanges.values()):
            out += f", exchanges {self.exchanges}"
        if any(self.launches.values()):
            out += f", launches {self.launches}"
        return out


@functools.lru_cache(maxsize=1)
def tiny_graph():
    from repro_torch.graphs import rmat_graph

    return rmat_graph(scale=4, avg_degree=4, seed=7)


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _traced(report: TraceReport, fn, devices) -> TraceReport:
    """Run ``fn`` under the recorder and fill ``report``; ``fn`` returns the
    iterations its solve ran."""
    from repro_torch.core.distributed import exchange_counts, reset_exchange_counts
    from repro_torch.kernels.spmv import launch_counts

    reset_exchange_counts()
    before = launch_counts()
    with OpRecorder() as rec:
        report.iterations = int(fn())
    report.launches = {k: n - before[k] for k, n in launch_counts().items()}
    report.exchanges = exchange_counts()
    records = rec.records + [OpRecord(f"{EXCHANGE}.{kind}")
                             for kind, n in report.exchanges.items() for _ in range(n)]
    s = summarize(records, devices)
    report.reads, report.uploads, report.ops = s.reads, s.uploads, len(rec.records)
    report.contract = read_contract(report.schedule, report.layout)
    report.findings = lint_ops(records, target=report.target, schedule=report.schedule,
                               iterations=report.iterations, layout=report.layout,
                               uploads=report.upload_contract, devices=devices)
    return report


def _untraceable(report: TraceReport, e: Exception, what: str) -> TraceReport:
    report.findings = [Finding(
        "trace", report.target, "untraceable",
        f"{what} could not be traced: {type(e).__name__}: {e}")]
    return report


def trace_variant(name: str, device="cuda") -> TraceReport | None:
    """Build one registry variant on the tiny graph on ``device``, trace its
    solve and lint it.  ``None`` for host-side (numpy-backend) variants —
    there is no device program to lint.  STIC-D planned variants are traced
    through their inner solver on the contracted core bundle, under the
    inner variant's contract."""
    from repro_torch.core.solver import PlannedBundle, build_variant, get_variant
    from repro_torch.device import resolve_device

    v = get_variant(name)
    if v.backend == "numpy":
        return None
    dev = resolve_device(device)
    opts = dict(LINT_OPTS, device=dev)
    report = TraceReport(name, v.schedule, v.layout,
                         upload_contract=upload_contract(v.options))
    try:
        v, bundle = build_variant(name, tiny_graph(), **opts)
        run, target_bundle = v.run, bundle
        if isinstance(bundle, PlannedBundle):
            run, target_bundle = bundle.inner.run, bundle.bundle
            report.schedule, report.layout = bundle.inner.schedule, bundle.inner.layout
        mesh = getattr(target_bundle, "mesh", None)
        devices = ({str(d) for d in mesh.devices} if mesh is not None
                   else {_device_name(dev)})
        return _traced(report, lambda: run(target_bundle, **LINT_RUN, **opts).iterations,
                       devices)
    except Exception as e:  # untraceable IS a finding, not a crash
        return _untraceable(report, e, "variant")


def trace_engine(backend: str, opts: dict, device="cuda") -> TraceReport:
    """Trace one step of the PPR engine's ``backend`` (``step_async``: the
    batched passes of every slot) and lint it under the serving contract."""
    from repro_torch.device import resolve_device
    from repro_torch.serving.ppr_engine import PPREngine

    dev = resolve_device(device)
    report = TraceReport(f"serving_{backend}", "nosync", "serving")
    try:
        eng = PPREngine(tiny_graph(), slots=SERVING_SLOTS, iters_per_step=SERVING_ITERS,
                        backend=backend, device=dev, **opts)
        shard = eng._backend.shards[0]
        frozen = torch.zeros(eng.slots, dtype=torch.bool, device=shard.state.device)

        def step():
            shard.step_async(frozen)
            return SERVING_ITERS

        return _traced(report, step, {_device_name(shard.state.device)})
    except Exception as e:
        return _untraceable(report, e, "serving backend")


def trace_reports(device="cuda") -> list[TraceReport]:
    """Trace every device-backend registry variant and both engine
    backends."""
    from repro_torch.core.solver import list_variants

    reports = [trace_variant(name, device) for name in list_variants()]
    reports += [trace_engine(b, opts, device) for b, opts in SERVING_BACKENDS]
    return [r for r in reports if r is not None]
