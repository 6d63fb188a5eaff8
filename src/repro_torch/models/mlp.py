"""Feed-forward block: SwiGLU or GELU, as ``cfg.mlp`` says.  Mixture of
Experts comes with the slice of the models that use it."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init_, param


class MLP(nn.Module):
    """``wi (d, f)``, ``wg (d, f)`` (SwiGLU only) and ``wo (f, d)``, in the
    reference's layout; uninitialized until :meth:`reset_parameters` or
    ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.d_ff
        self.wi = param((d, f), dtype, device)
        if cfg.mlp == "swiglu":
            self.wg = param((d, f), dtype, device)
        self.wo = param((f, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        dense_init_(self.wi, generator, self.cfg.d_model)
        if self.cfg.mlp == "swiglu":
            dense_init_(self.wg, generator, self.cfg.d_model)
        dense_init_(self.wo, generator, self.cfg.d_ff)


def mlp_init(cfg: ModelConfig, dtype, *, generator: torch.Generator,
             device: torch.device | str) -> MLP:
    m = MLP(cfg, dtype=dtype, device=device)
    m.reset_parameters(generator)
    return m


def mlp_apply(params: MLP, x: torch.Tensor) -> torch.Tensor:
    """``silu(x·wg) · (x·wi) · wo`` (SwiGLU), else ``gelu(x·wi) · wo`` with
    the tanh approximation, which ``jax.nn.gelu`` takes by default."""
    h = x @ params.wi
    if params.cfg.mlp == "swiglu":
        h = F.silu(x @ params.wg) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ params.wo
