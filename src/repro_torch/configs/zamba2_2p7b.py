"""Zamba2-2.7B [arXiv:2411.15242]: Mamba-2 backbone with a shared attention
(+MLP) block applied every 6 SSM layers (54 SSM layers → 9 applications).
A copy of the reference's config."""
from repro_torch.configs.base import ModelConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab=32000,
        attn="full",  # the shared block's attention
        mlp="swiglu",
        norm="rmsnorm",
        ssm=SSMConfig(variant="mamba2", state=64, conv=4, expand=2, headdim=64),
        hybrid_attn_every=6,
    )
