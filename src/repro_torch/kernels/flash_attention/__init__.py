from repro_torch.kernels.flash_attention.kernel import (
    HEAD_DIMS,
    launch_counts,
    reset_launch_counts,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = [
    "HEAD_DIMS",
    "launch_counts",
    "reset_launch_counts",
    "flash_attention",
    "attention_ref",
]
