"""Shared building blocks: init, RMSNorm and LayerNorm, softcap, vocab
padding.

Weights keep the reference's layouts (``(in, out...)`` for dense weights,
``(vocab, dim)`` for embeddings) so that ``convert.params_from_jax`` copies
them as they are.  Every parameter is created with ``requires_grad=False``,
for inference; ``training.train_step.init_train_state`` turns it on for a
model it trains.
"""
from __future__ import annotations

import math

import torch
from torch import nn

_TRUNC = 2.0  # truncated-normal bounds, in standard deviations


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialized inference parameter."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


@torch.no_grad()
def truncated_normal_(t: torch.Tensor, generator: torch.Generator,
                      scale: float) -> torch.Tensor:
    """Fill ``t`` with ``scale`` × a standard normal truncated to ±2, drawn
    in float32 by inverse-CDF sampling (as ``jax.random.truncated_normal``
    does; the two give different numbers from one seed) and then cast to
    ``t``'s dtype."""
    lo = math.erf(-_TRUNC / math.sqrt(2.0))
    u = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    u.uniform_(lo, -lo, generator=generator)
    z = u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-_TRUNC, _TRUNC)
    return t.copy_(z.mul_(scale))


def dense_init_(w: torch.Tensor, generator: torch.Generator, in_dim: int) -> torch.Tensor:
    """Truncated-normal fan-in init of a dense weight ``(in_dim, *out)``."""
    return truncated_normal_(w, generator, in_dim**-0.5)


def embed_init_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``(vocab, dim)`` embedding at scale ``dim**-0.5``, which keeps
    tied-unembed logits at unit variance."""
    return truncated_normal_(w, generator, w.shape[-1] ** -0.5)


RMS_EPS = 1e-6
LN_EPS = 1e-5
VOCAB_MULTIPLE = 256


class RMSNorm(nn.Module):
    """The reference's ``rmsnorm``: float32 statistics, ``eps`` 1e-6, the
    result cast back to the input's dtype."""

    def __init__(self, dim: int, *, dtype, device):
        super().__init__()
        self.scale = param((dim,), dtype, device)
        nn.init.ones_(self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = x.float()
        x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + RMS_EPS)
        return (x * self.scale.float()).to(dt)


class LayerNorm(nn.Module):
    """The reference's ``layernorm``: ``scale`` and ``bias``, float32
    statistics, ``eps`` 1e-5, the result cast back to the input's dtype."""

    def __init__(self, dim: int, *, dtype, device):
        super().__init__()
        self.scale = param((dim,), dtype, device)
        self.bias = param((dim,), dtype, device)
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = x.float()
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + LN_EPS)
        return (y * self.scale.float() + self.bias.float()).to(dt)


_NORMS = {"rmsnorm": RMSNorm, "layernorm": LayerNorm}


def make_norm(kind: str, dim: int, *, dtype, device) -> nn.Module:
    """The norm ``cfg.norm`` names (``rmsnorm`` or ``layernorm``) over
    ``dim``, as the reference's ``make_norm`` picks it; raises
    ``ValueError`` for another kind."""
    if kind not in _NORMS:
        raise ValueError(kind)
    return _NORMS[kind](dim, dtype=dtype, device=device)


def records_grad(x: torch.Tensor) -> bool:
    """Whether autograd records an op on ``x``: grad mode on and ``x``
    requiring grad.  Where it does, an op that overwrites a tensor the
    backward needs takes its out-of-place form."""
    return torch.is_grad_enabled() and x.requires_grad


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Gemma-2 soft-capping ``cap·tanh(x/cap)``; ``x`` as it is for None.
    One new tensor, the rest in place: gemma2's float32 logits at b 1,
    s 8192 are 8.4 GB each.  Out of place where autograd records (tanh's
    backward reads its output), with the same numbers."""
    if cap is None:
        return x
    if records_grad(x):
        return torch.tanh(x / cap) * cap
    return (x / cap).tanh_().mul_(cap)


def pad_vocab(vocab: int) -> int:
    """Pad vocab to a multiple of 256 (151,936 → 152,064)."""
    return -(-vocab // VOCAB_MULTIPLE) * VOCAB_MULTIPLE
