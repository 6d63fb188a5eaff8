"""Whisper-medium [arXiv:2212.04356]: encoder-decoder, MHA, LayerNorm, GELU.
The conv audio frontend is a stub: the model takes precomputed frame
embeddings (B, 1500, d_model); positions are sinusoidal (no RoPE).  A copy
of the reference's config."""
from repro_torch.configs.base import EncoderConfig, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab=51865,
        attn="full",
        mlp="gelu",
        norm="layernorm",
        rope_enabled=False,
        encoder=EncoderConfig(n_layers=24, n_frames=1500, d_frontend=1024),
    )
