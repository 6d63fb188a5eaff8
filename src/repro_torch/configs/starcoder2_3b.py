"""StarCoder2-3B [arXiv:2402.19173]: GQA, RoPE, sliding-window attention,
LayerNorm + GELU MLP (GPT-style).  A copy of the reference's config."""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        head_dim=128,
        d_ff=12288,
        vocab=49152,
        attn="swa",
        window=4096,
        mlp="gelu",
        norm="layernorm",
        rope_theta=100_000.0,
    )
