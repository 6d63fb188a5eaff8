from repro_torch.graphs.csr import (
    DecompositionPlan,
    Graph,
    GraphDelta,
    graph_from_arrays,
    inv_out_and_dangling,
)
from repro_torch.graphs.datasets import DATASETS, make_dataset
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
from repro_torch.graphs.rmat import rmat_edges, rmat_graph

__all__ = [
    "DecompositionPlan",
    "Graph",
    "GraphDelta",
    "graph_from_arrays",
    "inv_out_and_dangling",
    "DATASETS",
    "make_dataset",
    "ORDERS",
    "bfs_order",
    "compute_order",
    "degree_order",
    "invert_perm",
    "permute_graph",
    "random_order",
    "unpermute_ranks",
    "rmat_edges",
    "rmat_graph",
]
