from repro_torch.kernels.spmv.kernel import (
    gs_pass,
    launch_counts,
    reset_launch_counts,
    spmv_csr_acc,
)
from repro_torch.kernels.spmv.ops import BlockedGraph, pagerank_blocked
from repro_torch.kernels.spmv.ref import gs_pass_ref, spmv_csr_acc_ref

__all__ = [
    "gs_pass",
    "launch_counts",
    "reset_launch_counts",
    "spmv_csr_acc",
    "BlockedGraph",
    "pagerank_blocked",
    "gs_pass_ref",
    "spmv_csr_acc_ref",
]
