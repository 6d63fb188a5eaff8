"""Gemma-2-2B [arXiv:2408.00118]: alternating local/global attention,
attention + final-logit soft-capping, sandwich norms, tied embeddings.
A copy of the reference's config."""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab=256_000,
        attn="local_global",
        window=4096,
        attn_softcap=50.0,
        logit_softcap=30.0,
        mlp="swiglu",
        norm="rmsnorm",
        post_norm=True,
        tie_embeddings=True,
    )
