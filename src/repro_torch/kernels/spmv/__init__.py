from repro_torch.kernels.spmv.kernel import (
    gs_pass,
    gs_pass_multi,
    launch_counts,
    reset_launch_counts,
    spmv_csr_acc,
    spmv_csr_rows,
)
from repro_torch.kernels.spmv.ops import BlockedGraph, pagerank_blocked
from repro_torch.kernels.spmv.ref import (
    gs_pass_multi_ref,
    gs_pass_ref,
    spmv_csr_acc_ref,
    spmv_csr_rows_ref,
)

__all__ = [
    "gs_pass",
    "gs_pass_multi",
    "launch_counts",
    "reset_launch_counts",
    "spmv_csr_acc",
    "spmv_csr_rows",
    "BlockedGraph",
    "pagerank_blocked",
    "gs_pass_multi_ref",
    "gs_pass_ref",
    "spmv_csr_acc_ref",
    "spmv_csr_rows_ref",
]
