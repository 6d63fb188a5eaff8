"""Meshes: the serving mesh of the PageRank side, a 1-D
:class:`ShardMesh` over the cards one process drives (the CPU is one
device); and the LM's production and host meshes of the reference, as
their named axis sizes (the port has no mesh object for the model: the
dry run's sharding rules, ``repro_torch.sharding.rules``, read the sizes).

The distributed solvers take their mesh from
:func:`repro_torch.core.distributed.solver_mesh`, which the registry's
``distributed_*`` build calls.
"""
from __future__ import annotations

from repro_torch.core.distributed import ShardMesh, solver_mesh


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """Single pod: 256 chips as ``{"data": 16, "model": 16}``.  Multi-pod:
    512 as ``{"pod": 2, "data": 16, "model": 16}``; the ``pod`` axis carries
    pure data parallelism, so the slow links between pods see only
    gradient and parameter traffic, never a layer's tensor-parallel
    collectives."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_host_mesh(n_data: int = 1, n_model: int = 1) -> dict:
    """A small ``(data, model)`` mesh, for tests and the card's one-card
    cells (1 × 1)."""
    return {"data": n_data, "model": n_model}


def make_serving_mesh(shards: int | None = None, device=None) -> ShardMesh:
    """1-D mesh for the PPR serving engine: its slot batch is split over it
    (``repro_torch.serving.ppr_engine.shard_batch_step``).
    ``min(shards, devices)`` shards, all devices when ``shards`` is None;
    the engine requires ``slots`` divisible by the mesh's size."""
    return solver_mesh(shards, device=device)
