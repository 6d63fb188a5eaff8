"""Public attention op used by the model stack."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """The package's one attention entry point (``models/attention.py``,
    the tests and ``chip_smoke.py`` call it); ``scale`` defaults to
    ``dh**-0.5``.  It forwards to the launching wrapper
    :func:`~repro_torch.kernels.flash_attention.kernel.flash_attention_kernel`.

    On CUDA tensors it always launches the CUDA kernel, whatever ``sq`` and
    ``sk``; on CPU tensors it runs the plain version for every shape.  The
    reference's ``ops.py`` drops to its plain version when the lengths do
    not divide its block sizes; this one has no such fallback, and so no
    ``block_q``/``block_k``/``use_kernel``/``interpret`` options."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return flash_attention_kernel(q, k, v, scale=scale, causal=causal, window=window)
