"""The paper's non-blocking PageRank variants on one convergence engine
(solver.py); the blocked CUDA-kernel variants register from
``repro_torch.kernels.spmv.ops``."""
from repro_torch.core.solver import (
    DEFAULT_DAMPING,
    EngineState,
    PageRankResult,
    Variant,
    barrier_schedule,
    build_variant,
    get_variant,
    list_variants,
    nosync_schedule,
    perforation,
    register_variant,
    solve,
    solve_variant,
)
from repro_torch.core.pagerank import (
    DeviceGraph,
    PartitionedGraph,
    l1_norm,
    pagerank_barrier,
    pagerank_barrier_opt,
    pagerank_nosync,
    pagerank_numpy,
)

__all__ = [
    "DEFAULT_DAMPING",
    "EngineState",
    "PageRankResult",
    "Variant",
    "barrier_schedule",
    "build_variant",
    "get_variant",
    "list_variants",
    "nosync_schedule",
    "perforation",
    "register_variant",
    "solve",
    "solve_variant",
    "DeviceGraph",
    "PartitionedGraph",
    "l1_norm",
    "pagerank_barrier",
    "pagerank_barrier_opt",
    "pagerank_nosync",
    "pagerank_numpy",
]
