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
def load() -> ctypes.CDLL:
    """The built library with its C signature declared (built on first
    call; one load per process)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                        ctypes.c_float, i, i, p]
    lib.flash_attention_fwd.restype = i
    return lib
