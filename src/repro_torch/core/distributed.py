"""Distributed PageRank over a 1-D mesh of devices, driven by one process.

The port's counterpart of the reference's ``repro.core.distributed``, the
paper's coordination schemes carried to many devices:

* ``barrier`` — one Jacobi sweep per global exchange (Alg 1).  The
  exchange of the rank vector is the barrier: no shard starts round
  ``t+1`` before every shard published round ``t``.
* ``stale``   — No-Sync with bounded staleness: each shard runs
  ``local_sweeps`` sweeps of its partition against the round's snapshot
  of the other shards' ranks, its own ranks always fresh.  Exchanges drop
  by ``local_sweeps``; the fixed point is unchanged (Lemma 2).
* ``topk``    — communication perforation: each round a shard publishes
  only its ``vp·send_fraction`` largest rank deltas; the rest wait in an
  error-feedback ledger (``sent``) until they grow.

With ``handle_dangling`` the dangling mass is snapshotted once a round
from the exchanged vector and folded into every sweep's base term.

The reference maps each solver over a 1-D ``jax.sharding.Mesh`` with
``shard_map``: one program under one controller, every device a
partition.  The port keeps that shape without a process group.
:class:`ShardMesh` names one device per shard, and a device may appear
more than once, which runs several partitions on one card.  The solver
loop enqueues each shard's sweeps on its device in turn.  Launches are
asynchronous, so the cards of a multi-GPU mesh sweep at once, and each
round ends in one host read of the largest residual, the reference's
``pmax``.  The exchange (``all_gather``) concatenates every shard's ranks
onto each distinct device of the mesh.  Each exchange adds one to its
count (:func:`exchange_counts`): on a mesh whose shards share one device
no copy runs, so the count is how a trace sees the collective.

Every shard's sweep is the CUDA kernel ``spmv_csr_acc`` over the shard's
rows (:func:`repro_torch.kernels.spmv.spmv_csr_rows`), its plain version
on a CPU device; the sums run in a fixed order (no ``index_add_``).

The three solvers are registry entries (``distributed_barrier``,
``distributed_stale``, ``distributed_topk``): the build makes a
:class:`DistributedBundle` over ``min(threads, devices)`` shards, where
the devices are the cards (the CPU counts as one).  The reference's
``shard_level_convergence`` and the mesh's axis names are not ported: no
registry entry, launcher or reference test reaches them.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.pagerank import PartitionedGraph
from repro_torch.core.solver import (
    DEFAULT_DAMPING,
    PageRankResult,
    _f32,
    register_variant,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.spmv.kernel import spmv_csr_rows

__all__ = [
    "DistributedBundle",
    "MeshOperands",
    "ShardMesh",
    "distributed_pagerank",
    "distributed_pagerank_topk",
    "exchange_counts",
    "reset_exchange_counts",
    "solver_mesh",
]

# Cross-shard exchanges since the last reset: the whole rank vector
# (``all_gather``, the barrier and stale rounds) and the top-k deltas
# (``topk``, the perforated rounds), one a round each.
_EXCHANGES = {"all_gather": 0, "topk": 0}


def exchange_counts() -> dict[str, int]:
    """Exchanges of each kind since the last reset."""
    return dict(_EXCHANGES)


def reset_exchange_counts() -> None:
    for name in _EXCHANGES:
        _EXCHANGES[name] = 0


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """A 1-D mesh: one device per shard (the stand-in for a 1-D
    ``jax.sharding.Mesh``).  Devices may repeat.
    A ``cuda`` device without an index becomes the current card, so equal
    devices compare equal."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(self.devices)
        if not devs:
            raise ValueError("a ShardMesh needs at least one device")
        if any(isinstance(x, (tuple, list)) for x in devs):
            raise ValueError(f"a ShardMesh is 1-D, got nested devices {devs!r}")
        resolved = []
        for x in devs:
            dev = resolve_device(x)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            resolved.append(dev)
        object.__setattr__(self, "devices", tuple(resolved))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """The mesh's devices, each once, in mesh order."""
        return tuple(dict.fromkeys(self.devices))


def solver_mesh(p: int | None = None, device=None) -> ShardMesh:
    """``min(p, devices)`` shards (all devices when ``p`` is None), one per
    card starting at ``device`` (default ``cuda``); the CPU is one device.
    Asking for more partitions than devices thus degrades to fewer, as in
    the reference; a caller that wants several shards on one device builds
    the :class:`ShardMesh` itself."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        count = 1
        first = 0
    else:
        count = torch.cuda.device_count()
        first = torch.cuda.current_device() if dev.index is None else dev.index
    p = count if p is None else max(1, min(int(p), count))
    if dev.type == "cpu":
        return ShardMesh((dev,) * p)
    return ShardMesh(tuple(torch.device("cuda", (first + i) % count)
                           for i in range(p)))


@dataclasses.dataclass
class _Shard:
    """One shard's partition on its device: the int32 in-CSR of its ``vp``
    rows (local offsets), the global int32 source ids of its real edges
    and their weights (``None`` unweighted)."""

    device: torch.device
    offset: int
    in_ptr: torch.Tensor
    src: torch.Tensor
    weights: torch.Tensor | None


@dataclasses.dataclass
class _Replica:
    """The operands every shard reads whole, once per distinct device."""

    inv_out: torch.Tensor  # (n_pad,)
    dangling: torch.Tensor  # (n_pad,)
    bias_pad: torch.Tensor | None  # (n_pad,), 0 on padding


@dataclasses.dataclass
class MeshOperands:
    """The kernel's operands of a :class:`PartitionedGraph` on a mesh,
    built once: each shard's partition on its device, the replicated
    vectors once per distinct device."""

    shards: list[_Shard]
    replicas: dict[torch.device, _Replica]

    @classmethod
    def build(cls, pg: PartitionedGraph, mesh: ShardMesh) -> "MeshOperands":
        _check_mesh(pg, mesh)
        seg = pg.seg_ptr.cpu()
        shards = []
        for i, dev in enumerate(mesh.devices):
            k = int(seg[i, -1])
            # fresh allocations: the kernel reads src and weights in
            # 16-byte units from a 16-byte aligned start
            shards.append(_Shard(
                device=dev, offset=i * pg.vp,
                in_ptr=seg[i].to(dev, torch.int32),
                src=pg.src_pad[i, :k].to(dev, torch.int32),
                weights=(None if pg.w_pad is None
                         else pg.w_pad[i, :k].to(dev, copy=True))))
        replicas = {dev: _Replica(
            inv_out=pg.inv_out.to(dev), dangling=pg.dangling.to(dev),
            bias_pad=None if pg.bias_pad is None else pg.bias_pad.to(dev))
            for dev in mesh.distinct}
        return cls(shards=shards, replicas=replicas)


def _check_mesh(pg: PartitionedGraph, mesh: ShardMesh) -> None:
    if pg.p != mesh.size:
        raise ValueError(f"graph partitions ({pg.p}) != mesh axis size ({mesh.size})")
    if pg.n_pad + pg.src_pad.shape[1] >= 2**31:
        raise ValueError("the graph overflows the kernel's int32 offsets")


def _sweep(pr_full, local, shard: _Shard, rep: _Replica, base, d: float):
    """One sweep of ``shard``'s partition against ``pr_full``, this shard's
    own copy of the round's vector: the fresh ``local`` is written into its
    slice in place, then ``new = base + d·Σ w·(pr·inv_out)[src]`` over the
    partition's rows.  Returns ``new`` and ``max|new − local|``."""
    pr_full[shard.offset:shard.offset + local.numel()] = local
    contrib = pr_full * rep.inv_out
    acc = spmv_csr_rows(contrib, shard.in_ptr, shard.src, shard.weights)
    new = base + d * acc
    return new, torch.max(torch.abs(new - local))


def _base_terms(pg: PartitionedGraph, ops: MeshOperands, d: float) -> list:
    """Each shard's additive term before the dangling mass: ``(1-d)/n`` as
    a float32 scalar, times its slice of the bias on biased graphs."""
    out = []
    for s in ops.shards:
        base = torch.tensor((1.0 - d) / pg.n, dtype=pg.inv_out.dtype, device=s.device)
        bias = ops.replicas[s.device].bias_pad
        out.append(base if bias is None else base * bias[s.offset:s.offset + pg.vp])
    return out


def _round_error(errs: list[torch.Tensor], device: torch.device) -> float:
    """The round's largest residual over the shards: one host read, after
    every shard's work is enqueued."""
    return float(torch.stack([e.to(device) for e in errs]).max())


def distributed_pagerank(
    pg: PartitionedGraph,
    mesh: ShardMesh,
    mode: str = "barrier",
    local_sweeps: int = 4,
    d: float = DEFAULT_DAMPING,
    threshold: float = 1e-8,
    max_rounds: int = 10_000,
    handle_dangling: bool = False,
    operands: MeshOperands | None = None,
) -> PageRankResult:
    """PageRank with ``pg``'s partitions sharded over ``mesh``, ``mode``
    ``"barrier"`` or ``"stale"``; ``operands`` are the kernel's operands
    of ``pg`` on ``mesh`` when a bundle built them already.

    ``iterations`` counts rounds, that is global exchanges (the paper's
    Fig-7 comparison maps to rounds × sweeps for compute and rounds for
    synchronisation); ``sweeps`` counts partition sweeps over all shards,
    rounds × (``local_sweeps`` in stale mode, 1 in barrier mode) × p.  A
    round's error is the largest first-sweep residual over the shards:
    later sweeps of a round iterate against the same snapshot, so their
    shrinking residual reflects only local convergence."""
    if mode not in ("barrier", "stale"):
        raise ValueError(f"unknown mode {mode!r}")
    _check_mesh(pg, mesh)
    ops = MeshOperands.build(pg, mesh) if operands is None else operands
    vp, n = pg.vp, pg.n
    k = local_sweeps if mode == "stale" else 1
    dtype = pg.inv_out.dtype
    thr = _f32(threshold)
    base = _base_terms(pg, ops, d)
    locals_ = [torch.full((vp,), 1.0 / n, dtype=dtype, device=s.device)
               for s in ops.shards]
    err_local = [torch.tensor(math.inf, dtype=dtype, device=s.device)
                 for s in ops.shards]
    err, rounds = math.inf, 0
    while err > thr and rounds < max_rounds:
        # the exchange (all_gather): every shard's ranks onto each device
        full = {dev: torch.cat([x.to(dev) for x in locals_]) for dev in ops.replicas}
        _EXCHANGES["all_gather"] += 1
        dmass = {dev: d * torch.sum(full[dev] * rep.dangling) / n
                 for dev, rep in ops.replicas.items()} if handle_dangling else {}
        for i, s in enumerate(ops.shards):
            rep = ops.replicas[s.device]
            base_eff = base[i] + dmass[s.device] if handle_dangling else base[i]
            pr_full = full[s.device].clone()
            for j in range(k):
                locals_[i], e = _sweep(pr_full, locals_[i], s, rep, base_eff, d)
                if j == 0:
                    err_local[i] = e
        err = _round_error(err_local, mesh.devices[0])
        rounds += 1
    pr = torch.cat([x.to(mesh.devices[0]) for x in locals_])[:n]
    return PageRankResult(pr, rounds, err, None, rounds * k * pg.p)


def _top_deltas(delta: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of ``delta``, largest first,
    the lower index first among equal values, as ``jax.lax.top_k`` orders
    them (``torch.topk`` promises no order among ties, and vertices with
    no in-edges all move by the same delta)."""
    return torch.sort(delta, descending=True, stable=True).indices[:k]


def distributed_pagerank_topk(
    pg: PartitionedGraph,
    mesh: ShardMesh,
    send_fraction: float = 0.125,
    local_sweeps: int = 2,
    d: float = DEFAULT_DAMPING,
    threshold: float = 1e-8,
    max_rounds: int = 10_000,
    handle_dangling: bool = False,
    operands: MeshOperands | None = None,
) -> PageRankResult:
    """**Communication perforation**: each round a shard publishes only its
    ``k = vp·send_fraction`` largest rank deltas (index and value) instead
    of its whole ``vp`` ranks; unsent deltas stay in the error-feedback
    ledger ``sent`` and go out once they grow.  Every shard folds the
    published pairs into its snapshot of the global vector (the same
    snapshot on every shard, so it is kept once per device) and runs
    ``local_sweeps`` sweeps against it.

    Ties among the deltas go to the lower index, as ``jax.lax.top_k``
    breaks them: a stable descending sort, then the first ``k``.  The
    residual covers the unpublished deltas too, ``max(first sweep's
    residual, max|local − sent|)``, so the ledger drains before the solve
    stops.  ``iterations`` counts rounds, ``sweeps`` rounds ×
    ``local_sweeps`` × p."""
    _check_mesh(pg, mesh)
    ops = MeshOperands.build(pg, mesh) if operands is None else operands
    p, vp, n, n_pad = pg.p, pg.vp, pg.n, pg.n_pad
    k = max(1, int(vp * send_fraction))
    dtype = pg.inv_out.dtype
    thr = _f32(threshold)
    base = _base_terms(pg, ops, d)

    def full_of(size, dev):
        return torch.full((size,), 1.0 / n, dtype=dtype, device=dev)

    locals_ = [full_of(vp, s.device) for s in ops.shards]
    sent = [full_of(vp, s.device) for s in ops.shards]
    snap = {dev: full_of(n_pad, dev) for dev in ops.replicas}
    err_local = [torch.tensor(math.inf, dtype=dtype, device=s.device)
                 for s in ops.shards]
    resid = list(err_local)
    err, rounds = math.inf, 0
    while err > thr and rounds < max_rounds:
        # 1. communication perforation: publish the top-k deltas only
        g_idx, g_val = [], []
        for i, s in enumerate(ops.shards):
            top = _top_deltas(torch.abs(locals_[i] - sent[i]), k)
            top_val = locals_[i][top]
            sent[i][top] = top_val
            g_idx.append(top + s.offset)
            g_val.append(top_val)
        for dev, vec in snap.items():
            vec[torch.cat([x.to(dev) for x in g_idx])] = torch.cat(
                [x.to(dev) for x in g_val])
        _EXCHANGES["topk"] += 1
        # 2. sweeps against the snapshot with the shard's fresh ranks in
        # it; the dangling mass is taken from that view before the first
        for i, s in enumerate(ops.shards):
            rep = ops.replicas[s.device]
            pr_full = snap[s.device].clone()
            base_eff = base[i]
            if handle_dangling:
                pr_full[s.offset:s.offset + vp] = locals_[i]
                base_eff = base_eff + d * torch.sum(pr_full * rep.dangling) / n
            for j in range(local_sweeps):
                locals_[i], e = _sweep(pr_full, locals_[i], s, rep, base_eff, d)
                if j == 0:
                    err_local[i] = e
            resid[i] = torch.maximum(
                err_local[i], torch.max(torch.abs(locals_[i] - sent[i])))
        err = _round_error(resid, mesh.devices[0])
        rounds += 1
    pr = torch.cat([x.to(mesh.devices[0]) for x in locals_])[:n]
    return PageRankResult(pr, rounds, err, None, rounds * local_sweeps * p)


# ---------------------------------------------------------------------------
# Registry entries — DistributedBundle build + the three modes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistributedBundle:
    """Device bundle of the distributed variants: the partitioned graph,
    the 1-D mesh its partitions are sharded over, and the kernel's
    operands on that mesh."""

    pg: PartitionedGraph
    mesh: ShardMesh
    operands: MeshOperands

    @property
    def p(self) -> int:
        return self.pg.p


def _dist_build(g, threads: int = 8, device=None, **_) -> DistributedBundle:
    mesh = solver_mesh(threads, device=device)
    pg = PartitionedGraph.from_graph(g, p=mesh.size, device=mesh.devices[0])
    return DistributedBundle(pg=pg, mesh=mesh,
                             operands=MeshOperands.build(pg, mesh))


def _dist_run(mode: str):
    def run(b: DistributedBundle, *, d=DEFAULT_DAMPING, threshold=1e-8,
            max_iter=10_000, handle_dangling=False, local_sweeps=4, **_):
        return distributed_pagerank(
            b.pg, b.mesh, mode=mode, local_sweeps=local_sweeps, d=d,
            threshold=threshold, max_rounds=max_iter,
            handle_dangling=handle_dangling, operands=b.operands)

    return run


def _dist_topk_run(b: DistributedBundle, *, d=DEFAULT_DAMPING, threshold=1e-8,
                   max_iter=10_000, handle_dangling=False, local_sweeps=2,
                   send_fraction=0.125, **_):
    return distributed_pagerank_topk(
        b.pg, b.mesh, send_fraction=send_fraction, local_sweeps=local_sweeps,
        d=d, threshold=threshold, max_rounds=max_iter,
        handle_dangling=handle_dangling, operands=b.operands)


register_variant(
    "distributed_barrier", build=_dist_build, run=_dist_run("barrier"),
    description="sharded Jacobi on the CUDA SpMV: one exchange per sweep (Alg 1 across devices)",
    layout="distributed", backend="cuda", schedule="barrier",
)
register_variant(
    "distributed_stale", build=_dist_build, run=_dist_run("stale"),
    description="sharded No-Sync: local_sweeps sweeps per exchange (bounded staleness)",
    layout="distributed", backend="cuda", schedule="nosync",
)
register_variant(
    "distributed_topk", build=_dist_build, run=_dist_topk_run,
    description="communication perforation: top-k delta exchange + error-feedback ledger",
    layout="distributed", backend="cuda", schedule="nosync",
)
