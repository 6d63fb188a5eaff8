"""Model configuration schema: a copy of the reference's ``configs/base.py``
(the port imports nothing of ``repro``).  Every field is carried as data;
:func:`repro_torch.models.model.check_ported` refuses the values whose
model code is not ported yet."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # deepseek shared experts


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    variant: str  # "mamba1" | "mamba2"
    state: int
    conv: int = 4
    expand: int = 2
    headdim: int = 64  # mamba2 head dim
    dt_rank: int = 0  # mamba1; 0 = d_model // 16


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    n_frames: int  # stubbed modality frontend sequence length
    d_frontend: int  # frontend embedding dim fed by input_specs()


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | hybrid | ssm | moe | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 → d_model // n_heads
    # attention flavour
    attn: str = "full"  # full | swa | local_global | mla | none
    window: Optional[int] = None  # swa / local layers
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    rope_enabled: bool = True  # whisper uses sinusoidal absolute positions
    mrope: bool = False  # qwen2-vl multimodal rope
    # glu / activation
    mlp: str = "swiglu"  # swiglu | gelu
    # extras
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    encoder: Optional[EncoderConfig] = None  # whisper enc-dec
    hybrid_attn_every: int = 0  # zamba: shared attn block every N ssm layers
    tie_embeddings: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    post_norm: bool = False  # gemma2 sandwich norms
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell: SSM, hybrid and sliding-window
        archs; pure full-attention archs are skipped, as in the reference."""
        return self.attn in ("swa", "none") or self.ssm is not None or self.hybrid_attn_every > 0

    def reduced(self) -> "ModelConfig":
        """CI-sized config of the same family for smoke tests, the
        reference's ``reduced``: the sliding window cut to at most 64; the
        MoE, MLA, SSM and encoder sub-configs shrunk as the reference
        shrinks them; a hybrid cut to 4 layers, a shared block every 2."""
        changes: dict = dict(
            n_layers=min(self.n_layers, 2 if not self.hybrid_attn_every else self.hybrid_attn_every + 1),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256,
            vocab=512,
            head_dim=32,
            window=min(self.window, 64) if self.window else None,
        )
        if self.moe:
            changes["moe"] = MoEConfig(
                n_experts=4, top_k=min(self.moe.top_k, 2), d_ff_expert=64,
                n_shared=min(self.moe.n_shared, 1),
            )
        if self.ssm:
            changes["ssm"] = SSMConfig(
                variant=self.ssm.variant, state=16, conv=4, expand=2, headdim=32, dt_rank=8,
            )
        if self.mla:
            changes["mla"] = MLAConfig(
                q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                qk_rope_head_dim=16, v_head_dim=32,
            )
            changes["head_dim"] = 0
        if self.encoder:
            changes["encoder"] = EncoderConfig(n_layers=2, n_frames=64, d_frontend=128)
        if self.hybrid_attn_every:
            changes["hybrid_attn_every"] = 2
            changes["n_layers"] = 4
        return dataclasses.replace(self, **changes)
