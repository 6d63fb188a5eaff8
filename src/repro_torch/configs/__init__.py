"""Architecture registry of the port.

A copy of the reference's ``repro.configs`` architecture registry: the
five dense decoders (starcoder2-3b, phi3-medium-14b, gemma2-2b,
stablelm-3b, qwen2-vl-2b), the hybrid zamba2-2.7b (Mamba-2 with a shared
attention block), the encoder-decoder whisper-medium, the pure-SSM
falcon-mamba-7b (Mamba-1) and the two MoE decoders (mixtral-8x22b,
deepseek-v2-236b with MLA), in the reference's order.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import EncoderConfig, MLAConfig, ModelConfig, MoEConfig, SSMConfig

_ARCH_MODULES = {
    "starcoder2-3b": "starcoder2_3b",
    "phi3-medium-14b": "phi3_medium_14b",
    "gemma2-2b": "gemma2_2b",
    "stablelm-3b": "stablelm_3b",
    "zamba2-2.7b": "zamba2_2p7b",
    "whisper-medium": "whisper_medium",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "mixtral-8x22b": "mixtral_8x22b",
    "deepseek-v2-236b": "deepseek_v2_236b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.get_config()


__all__ = [
    "ARCH_IDS",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "MLAConfig",
    "EncoderConfig",
    "get_config",
]
