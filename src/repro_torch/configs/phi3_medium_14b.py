"""Phi-3-medium-14B [arXiv:2404.14219]: GQA, RoPE, SwiGLU, RMSNorm.  A
copy of the reference's config."""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        head_dim=128,
        d_ff=17920,
        vocab=100352,
        attn="full",
        mlp="swiglu",
        norm="rmsnorm",
    )
