"""Pre-norm decoder block (RMSNorm or LayerNorm; GQA with a full, sliding
or local/global window, or deepseek-v2's MLA; a SwiGLU or GELU MLP, or a
top-k MoE; gemma2's optional post norms): init, apply, decode and its
cache.

gemma2's local/global alternation is a per-layer window: local layers
mask to ``cfg.window``, global layers take a window that masks nothing
(``s + 1`` in prefill, ``1 << 30`` in decode), and every such layer goes
through the plain attention route, as the reference's
``_dynamic_window_attention`` does.  An MoE block runs the sparse
dispatch in decode, and in prefill the dispatch ``moe_dispatch`` names
(sparse by default), as the reference's.

An SSM block (falcon-mamba-7b's Mamba-1, zamba2-2.7b's Mamba-2) is
``x + ssm(norm(x))``: init, apply, decode and its cache, as the
reference's ``ssm_block_*``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    GQAttention,
    MLAttention,
    gqa_apply,
    gqa_decode,
    mla_apply,
    mla_decode,
    mla_init_cache,
)
from repro_torch.models.common import make_norm
from repro_torch.models.mlp import MLP, MoE, mlp_apply, moe_apply, moe_apply_sparse
from repro_torch.models.ssm import (
    Mamba1,
    Mamba2,
    mamba1_apply,
    mamba1_decode,
    mamba1_init_cache,
    mamba2_apply,
    mamba2_decode,
    mamba2_init_cache,
)


class DecoderBlock(nn.Module):
    """``ln_attn``, ``attn`` (:class:`MLAttention` for ``attn == "mla"``,
    else :class:`GQAttention`), ``ln_mlp``, ``mlp`` (:class:`MoE` where
    ``cfg.moe``, else :class:`MLP`), and with ``post_norm``
    ``ln_attn_post`` and ``ln_mlp_post``; uninitialized until
    :meth:`reset_parameters` or ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.ln_attn = make_norm(cfg.norm, cfg.d_model, dtype=dtype, device=device)
        attn = MLAttention if cfg.attn == "mla" else GQAttention
        self.attn = attn(cfg, dtype=dtype, device=device)
        self.ln_mlp = make_norm(cfg.norm, cfg.d_model, dtype=dtype, device=device)
        self.mlp = (MoE if cfg.moe else MLP)(cfg, dtype=dtype, device=device)
        if cfg.post_norm:
            self.ln_attn_post = make_norm(cfg.norm, cfg.d_model, dtype=dtype, device=device)
            self.ln_mlp_post = make_norm(cfg.norm, cfg.d_model, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)


def decoder_block_init(cfg: ModelConfig, dtype, *, generator: torch.Generator,
                       device: torch.device | str) -> DecoderBlock:
    blk = DecoderBlock(cfg, dtype=dtype, device=device)
    blk.reset_parameters(generator)
    return blk


def _ffn(params: DecoderBlock, cfg: ModelConfig, h, moe_dispatch: str):
    if not cfg.moe:
        return mlp_apply(params.mlp, h)
    if moe_dispatch == "sparse":
        return moe_apply_sparse(params.mlp, cfg, h)
    return moe_apply(params.mlp, cfg, h)


def decoder_block_apply(params: DecoderBlock, cfg: ModelConfig, x, positions, *,
                        is_local: bool = False, moe_dispatch: str = "sparse",
                        use_kernel: bool = True):
    h = params.ln_attn(x)
    if cfg.attn == "mla":
        a = mla_apply(params.attn, cfg, h, positions)
    elif cfg.attn == "local_global":
        win = cfg.window if is_local else x.shape[1] + 1
        a = gqa_apply(params.attn, cfg, h, positions, window=win, use_kernel=False)
    else:
        a = gqa_apply(params.attn, cfg, h, positions,
                      window=cfg.window if cfg.attn == "swa" else None,
                      use_kernel=use_kernel)
    if cfg.post_norm:
        a = params.ln_attn_post(a)
    x = x + a
    m = _ffn(params, cfg, params.ln_mlp(x), moe_dispatch)
    if cfg.post_norm:
        m = params.ln_mlp_post(m)
    return x + m


def decoder_block_decode(params: DecoderBlock, cfg: ModelConfig, x, cache: dict, *,
                         is_local: bool = False):
    if cfg.attn == "mla":
        a, cache_a = mla_decode(params.attn, cfg, params.ln_attn(x), cache)
    else:
        window = cfg.window if cfg.attn == "swa" else None
        if cfg.attn == "local_global":
            window = cfg.window if is_local else 1 << 30
        a, cache_a = gqa_decode(params.attn, cfg, params.ln_attn(x), cache, window=window)
    if cfg.post_norm:
        a = params.ln_attn_post(a)
    x = x + a
    m = _ffn(params, cfg, params.ln_mlp(x), "sparse")
    if cfg.post_norm:
        m = params.ln_mlp_post(m)
    return x + m, cache_a


def decoder_block_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> dict:
    """``k`` and ``v`` of ``T`` ring slots, ``T = min(max_len, window)``
    for a sliding-window arch (the memory win of SWA), else ``max_len``;
    for MLA the compressed cache (``attention.mla_init_cache``)."""
    if cfg.attn == "mla":
        return mla_init_cache(cfg, batch, max_len, dtype, device)
    hk, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    t = min(max_len, cfg.window) if cfg.attn == "swa" and cfg.window else max_len
    return {
        "k": torch.zeros((batch, hk, t, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, hk, t, dh), dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# SSM blocks
# ---------------------------------------------------------------------------


_SSM_VARIANTS = {
    "mamba1": (Mamba1, mamba1_apply, mamba1_decode, mamba1_init_cache),
    "mamba2": (Mamba2, mamba2_apply, mamba2_decode, mamba2_init_cache),
}


def _variant(cfg: ModelConfig):
    if cfg.ssm.variant not in _SSM_VARIANTS:
        raise ValueError(f"ssm variant {cfg.ssm.variant!r} not in {sorted(_SSM_VARIANTS)}")
    return _SSM_VARIANTS[cfg.ssm.variant]


class SSMBlock(nn.Module):
    """``ln`` and ``ssm`` (:class:`~repro_torch.models.ssm.Mamba1` or
    :class:`~repro_torch.models.ssm.Mamba2`, as ``cfg.ssm.variant`` says);
    the dense weights uninitialized until :meth:`reset_parameters` or
    ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.ln = make_norm(cfg.norm, cfg.d_model, dtype=dtype, device=device)
        self.ssm = _variant(cfg)[0](cfg, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ssm.reset_parameters(generator)


def ssm_block_init(cfg: ModelConfig, dtype, *, generator: torch.Generator,
                   device: torch.device | str) -> SSMBlock:
    blk = SSMBlock(cfg, dtype=dtype, device=device)
    blk.reset_parameters(generator)
    return blk


def ssm_block_apply(params: SSMBlock, cfg: ModelConfig, x):
    return x + _variant(cfg)[1](params.ssm, cfg, params.ln(x))


def ssm_block_decode(params: SSMBlock, cfg: ModelConfig, x, cache: dict):
    out, cache = _variant(cfg)[2](params.ssm, cfg, params.ln(x), cache)
    return x + out, cache


def ssm_block_init_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """``conv`` (the last K−1 conv inputs, in ``dtype``) and ``h`` (the
    float32 state)."""
    return _variant(cfg)[3](cfg, batch, dtype, device)
