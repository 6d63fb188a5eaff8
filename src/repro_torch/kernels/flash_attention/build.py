"""Load the CUDA kernel of ``csrc/flash_attention.cu``, built at first use
by :mod:`repro_torch.kernels.nvcc`, with its C signature declared."""
from __future__ import annotations

import ctypes
import functools
import pathlib

from repro_torch.kernels import nvcc

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"


def build() -> tuple[pathlib.Path, str]:
    """Compile ``csrc/flash_attention.cu`` unless it is built (see
    :func:`nvcc.build`)."""
    return nvcc.build(SOURCE)


@functools.lru_cache(maxsize=None)
def load(path: pathlib.Path | None = None) -> ctypes.CDLL:
    """The built library with its C signature declared (built on first
    call; one load per process).  ``path`` loads another library built
    from a copy of the source with the same C interface instead."""
    if path is None:
        path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                        ctypes.c_float, i, i, p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_scratch_bytes.argtypes = [i, i, i, i, i, i, i]
    lib.flash_attention_scratch_bytes.restype = ctypes.c_longlong
    lib.flash_attention_info.argtypes = [i, i, ctypes.POINTER(i)]
    lib.flash_attention_info.restype = i
    return lib


INFO_FIELDS = ("registers", "spill_bytes", "smem_bytes", "ctas_per_sm", "p_terms", "terms",
               "qk_products", "pv_products")


def kernel_info(dh: int, bf16: bool, lib: ctypes.CDLL | None = None) -> dict[str, int]:
    """Registers, spill bytes a thread, dynamic shared memory a CTA and
    resident CTAs an SM of the kernel launched for ``dh`` and the dtype, and
    its arithmetic: the bf16 terms P is summed as, the bf16 terms of each of
    q, k and v (1 for bf16 inputs, which are exact) and the term products
    of Q·Kᵀ and of P·V, as the built library (``lib``, else :func:`load`'s)
    reports them."""
    out = (ctypes.c_int * len(INFO_FIELDS))()
    err = (lib or load()).flash_attention_info(dh, int(bf16), out)
    if err != 0:
        raise RuntimeError(f"flash_attention_info failed with cudaError {err}")
    return dict(zip(INFO_FIELDS, out))
