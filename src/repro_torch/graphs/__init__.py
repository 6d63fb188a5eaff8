from repro_torch.graphs.csr import (
    DecompositionPlan,
    Graph,
    GraphDelta,
    graph_from_arrays,
    inv_out_and_dangling,
)
from repro_torch.graphs.datasets import DATASETS, dataset_cache_path, make_dataset
from repro_torch.graphs.reorder import (
    ORDERS,
    bfs_order,
    compute_order,
    degree_order,
    invert_perm,
    permute_graph,
    random_order,
    unpermute_ranks,
)
from repro_torch.graphs.pipeline import BuildConfig, final_store_path, run_pipeline
from repro_torch.graphs.rmat import rmat_edge_chunks, rmat_edges, rmat_graph
from repro_torch.graphs.store import (
    GraphStore,
    StoreChecksumError,
    StoreError,
    StoreWriter,
    is_store,
    load_graph,
    save_graph,
)

__all__ = [
    "DecompositionPlan",
    "Graph",
    "GraphDelta",
    "graph_from_arrays",
    "inv_out_and_dangling",
    "DATASETS",
    "dataset_cache_path",
    "make_dataset",
    "ORDERS",
    "bfs_order",
    "compute_order",
    "degree_order",
    "invert_perm",
    "permute_graph",
    "random_order",
    "unpermute_ranks",
    "BuildConfig",
    "final_store_path",
    "run_pipeline",
    "rmat_edge_chunks",
    "rmat_edges",
    "rmat_graph",
    "GraphStore",
    "StoreChecksumError",
    "StoreError",
    "StoreWriter",
    "is_store",
    "load_graph",
    "save_graph",
]
