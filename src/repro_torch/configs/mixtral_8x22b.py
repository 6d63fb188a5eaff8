"""Mixtral-8x22B [arXiv:2401.04088]: 8-expert top-2 MoE, GQA, SWA.  A copy
of the reference's config."""
from repro_torch.configs.base import ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=32768,
        attn="swa",
        window=4096,
        mlp="swiglu",
        norm="rmsnorm",
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
    )
