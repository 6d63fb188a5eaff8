from repro_torch.graphs.csr import Graph, graph_from_arrays, inv_out_and_dangling
from repro_torch.graphs.datasets import DATASETS, make_dataset
from repro_torch.graphs.rmat import rmat_edges, rmat_graph

__all__ = [
    "Graph",
    "graph_from_arrays",
    "inv_out_and_dangling",
    "DATASETS",
    "make_dataset",
    "rmat_edges",
    "rmat_graph",
]
