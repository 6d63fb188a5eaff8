"""PyTorch/CUDA port of the non-blocking PageRank system.

The package mirrors the JAX reference's layout (``graphs/``, ``core/``,
``kernels/``, ``ppr/``, ``serving/``, ``launch/``, and for the dense LM
``configs/`` and ``models/``) so each module has an obvious counterpart,
but imports nothing from it: the host graph code and the configs are
copies, the engines are host loops over eager torch ops, and the
reference's Pallas kernels are CUDA C++ for Hopper
(``kernels/spmv/csrc/spmv.cu``, ``kernels/flash_attention/csrc/``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU they raise rather than fall back (:func:`resolve_device`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
