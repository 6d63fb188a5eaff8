"""Qwen2-VL-2B [arXiv:2409.12191]: GQA backbone with M-RoPE; the vision
frontend (dynamic-resolution patch embedding) is a stub — the model takes
token ids.  A copy of the reference's config."""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab=151_936,
        attn="full",
        mlp="swiglu",
        norm="rmsnorm",
        mrope=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    )
