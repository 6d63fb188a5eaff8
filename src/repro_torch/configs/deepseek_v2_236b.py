"""DeepSeek-V2-236B [arXiv:2405.04434]: MLA attention (kv_lora=512),
160 routed experts top-6 + 2 shared experts, per-expert d_ff=1536.

Deviation noted in DESIGN.md: the real model's first layer is a dense MLP
(d_ff=12288); we keep the stack uniform (all-MoE) so it scans.  A copy of the reference's config."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=1536,
        vocab=102_400,
        attn="mla",
        mlp="swiglu",
        norm="rmsnorm",
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2),
    )
