"""The serving mesh of the PageRank side: a 1-D :class:`ShardMesh` over
the cards one process drives (the CPU is one device).

The distributed solvers take their mesh from
:func:`repro_torch.core.distributed.solver_mesh`, which the registry's
``distributed_*`` build calls.  The reference's production and host meshes
of the LM (``make_production_mesh``, ``make_host_mesh``) come with the LM
items of the port.
"""
from __future__ import annotations

from repro_torch.core.distributed import ShardMesh, solver_mesh


def make_serving_mesh(shards: int | None = None, device=None) -> ShardMesh:
    """1-D mesh for the PPR serving engine: its slot batch is split over it
    (``repro_torch.serving.ppr_engine.shard_batch_step``).
    ``min(shards, devices)`` shards, all devices when ``shards`` is None;
    the engine requires ``slots`` divisible by the mesh's size."""
    return solver_mesh(shards, device=device)
