"""Falcon-Mamba-7B [arXiv:2410.05355]: attention-free Mamba-1 stack.  A
copy of the reference's config."""
from repro_torch.configs.base import ModelConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=65024,
        attn="none",
        norm="rmsnorm",
        ssm=SSMConfig(variant="mamba1", state=16, conv=4, expand=2, dt_rank=256),
    )
