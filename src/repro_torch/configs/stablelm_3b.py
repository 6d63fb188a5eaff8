"""StableLM-3B [hf:stabilityai/stablelm-2]: MHA (kv=heads), LayerNorm,
gated SiLU MLP.  A copy of the reference's config."""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=6912,
        vocab=50304,
        attn="full",
        mlp="swiglu",
        norm="layernorm",
    )
