"""PyTorch/CUDA port of the non-blocking PageRank system.

The package mirrors the JAX reference's layout (``graphs/``, ``core/``,
``kernels/spmv/``, ``ppr/``, ``serving/``, ``launch/``) so each module has
an obvious counterpart, but imports nothing from it: the host graph code
is a copy, the engine is a host loop over eager torch ops, and the
reference's Pallas kernels are CUDA C++ for Hopper
(``kernels/spmv/csrc/spmv.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU they raise rather than fall back (:func:`resolve_device`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
