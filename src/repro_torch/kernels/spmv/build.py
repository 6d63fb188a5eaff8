"""Load the CUDA kernels of ``csrc/spmv.cu``, built at first use by
:mod:`repro_torch.kernels.nvcc`, with their C signatures declared, and
report what the built library launches (:func:`kernel_info`)."""
from __future__ import annotations

import ctypes
import functools
import pathlib

from repro_torch.kernels import nvcc

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "spmv.cu"
# The device functions of csrc/spmv.cu in spmv_kernel_info's numbering: the
# merge-path SpMV and its join of rows cut between CTAs (spmv_csr_acc),
# gs_pass's prep and walk, gs_pass_multi's scaling and walk.
KERNELS = ("spmv_csr_acc", "spmv_carry", "gs_prep", "gs_pass", "scale_state",
           "gs_pass_multi")


def build() -> tuple[pathlib.Path, str]:
    """Compile ``csrc/spmv.cu`` unless it is built (see :func:`nvcc.build`)."""
    return nvcc.build(SOURCE)


@functools.lru_cache(maxsize=None)
def load(path: pathlib.Path | None = None) -> ctypes.CDLL:
    """The built library with its C signatures declared (built on first
    call; one load per process).  ``path`` loads another library built
    from a copy of the source with the same C interface instead."""
    if path is None:
        path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.spmv_csr_acc.argtypes = [p, p, p, p, p, i, i, i, p, p]
    lib.spmv_csr_acc.restype = i
    lib.spmv_csr_acc_ctas.argtypes = [i]
    lib.spmv_csr_acc_ctas.restype = i
    lib.gs_pass.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.gs_pass.restype = i
    lib.gs_pass_plan.argtypes = [i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.gs_pass_plan.restype = i
    lib.gs_pass_multi.argtypes = [p, p, p, p, p, p, p, ctypes.c_float, p, p, p,
                                  i, i, i, p]
    lib.gs_pass_multi.restype = i
    lib.gs_pass_multi_smem_bytes.argtypes = [i]
    lib.gs_pass_multi_smem_bytes.restype = ctypes.c_size_t
    lib.smem_per_block_optin.argtypes = [i]
    lib.smem_per_block_optin.restype = i
    lib.spmv_kernel_info.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.spmv_kernel_info.restype = i
    return lib


def kernel_info(kernel: str, block: int = 256, weighted: bool = False) -> dict[str, int]:
    """Registers, local (spill) bytes a thread, static and dynamic shared
    memory a CTA, resident CTAs an SM and threads a CTA of ``kernel`` (one
    of :data:`KERNELS`) as launched at ``block`` rows (``weighted`` picks
    gs_pass's streams), as the built library reports them on the current
    card."""
    out = (ctypes.c_int * 6)()
    err = load().spmv_kernel_info(KERNELS.index(kernel), block, int(weighted), out)
    if err != 0:
        raise RuntimeError(f"spmv_kernel_info({kernel}, block={block}) failed "
                           f"with cudaError {err}")
    return dict(zip(("registers", "spill_bytes", "static_smem_bytes", "smem_bytes",
                     "ctas_per_sm", "threads"), out))
