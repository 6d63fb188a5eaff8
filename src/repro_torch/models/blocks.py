"""Pre-norm decoder block (RMSNorm, causal GQA, SwiGLU MLP): init, apply,
decode and its ring cache.

The other blocks of the reference (sliding-window and local/global
attention, MLA, MoE, the SSM blocks, post norms) come with the slices of
the models that use them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import GQAttention, gqa_apply, gqa_decode
from repro_torch.models.common import RMSNorm
from repro_torch.models.mlp import MLP, mlp_apply


class DecoderBlock(nn.Module):
    """``ln_attn``, ``attn``, ``ln_mlp``, ``mlp``; uninitialized until
    :meth:`reset_parameters` or ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, dtype=dtype, device=device)
        self.attn = GQAttention(cfg, dtype=dtype, device=device)
        self.ln_mlp = RMSNorm(cfg.d_model, dtype=dtype, device=device)
        self.mlp = MLP(cfg, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)


def decoder_block_init(cfg: ModelConfig, dtype, *, generator: torch.Generator,
                       device: torch.device | str) -> DecoderBlock:
    blk = DecoderBlock(cfg, dtype=dtype, device=device)
    blk.reset_parameters(generator)
    return blk


def decoder_block_apply(params: DecoderBlock, cfg: ModelConfig, x, positions, *,
                        use_kernel: bool = True):
    x = x + gqa_apply(params.attn, cfg, params.ln_attn(x), positions, use_kernel=use_kernel)
    return x + mlp_apply(params.mlp, params.ln_mlp(x))


def decoder_block_decode(params: DecoderBlock, cfg: ModelConfig, x, cache: dict):
    a, cache_a = gqa_decode(params.attn, cfg, params.ln_attn(x), cache)
    x = x + a
    return x + mlp_apply(params.mlp, params.ln_mlp(x)), cache_a


def decoder_block_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> dict:
    hk, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, hk, max_len, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, hk, max_len, dh), dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
