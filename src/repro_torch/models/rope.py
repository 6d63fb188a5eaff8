"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE."""
from __future__ import annotations

import torch

# M-RoPE: fraction of rotary dims assigned to (temporal, height, width)
MROPE_SECTIONS = (0.25, 0.375, 0.375)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, H, S, Dh); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (dh/2,)
    angles = positions[:, None, :, None].float() * freqs  # (B,1,S,dh/2)
    return _rotate(x, angles)


def mrope_sections(head_dim: int) -> tuple[int, int]:
    """Boundaries of the (temporal, height, width) sections over the
    ``head_dim // 2`` frequency slots: 16 and 40 for head_dim 128."""
    half = head_dim // 2
    s1 = int(half * MROPE_SECTIONS[0])
    return s1, s1 + int(half * MROPE_SECTIONS[1])


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    positions3: (B, 3, S) — (temporal, height, width) position ids. The
    rotary dim is split into three contiguous sections, each rotated by its
    own position stream. For pure text all three streams are equal and
    M-RoPE degenerates to RoPE.
    """
    dh = x.shape[-1]
    half = dh // 2
    freqs = rope_freqs(dh, theta, x.device)  # (half,)
    s1, s2 = mrope_sections(dh)
    sec = torch.zeros(half, dtype=torch.long, device=x.device)
    sec[s1:s2] = 1
    sec[s2:] = 2
    pos = positions3.float()[:, sec, :]  # (B, half, S): each slot's stream
    angles = pos.transpose(1, 2)[:, None, :, :] * freqs  # (B,1,S,half)
    return _rotate(x, angles)
