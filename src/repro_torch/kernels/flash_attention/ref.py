"""Plain PyTorch version of flash attention (GQA + causal + sliding window):
a copy of the reference's ``kernels/flash_attention/ref.py``, plus a
``q_offset`` for the q-chunked plain route of ``models/attention.py``.

The CPU tests hold it against the JAX package, and ``chip_smoke.py`` holds
the CUDA kernel against it on the card.  A row with no live key (possible
only with a window and ``sq > sk``) comes out as the mean of ``v`` here,
as in the reference's plain version, and as 0 from the kernels (the TPU
one and this port's CUDA one).  Scores, softmax and P·V run in float32
for bfloat16 and float32 inputs, as the reference's, and in float64 for
float64 inputs (``chip_smoke.py`` holds the float32 kernel to that)."""
from __future__ import annotations

import torch


def attention_ref(
    q: torch.Tensor,  # (b, hq, sq, dh)
    k: torch.Tensor,  # (b, hkv, sk, dh)
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """``q_offset`` is the absolute position of ``q``'s first row (0 for a
    whole sequence)."""
    b, hq, sq, dh = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    ct = torch.promote_types(q.dtype, torch.float32)
    kx = k.repeat_interleave(group, dim=1)
    vx = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), kx.to(ct)) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx.to(ct)).to(q.dtype)
