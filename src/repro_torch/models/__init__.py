"""The decoder LMs of the port, at full width: the dense ones
(starcoder2-3b, phi3-medium-14b, gemma2-2b, stablelm-3b, qwen2-vl-2b) and
the MoE ones (mixtral-8x22b, deepseek-v2-236b): modules, prefill
``forward`` through the CUDA flash kernel (GQA layers), and
``decode_step``."""
from repro_torch.models.model import (
    DecoderLM,
    decode_step,
    forward,
    init_cache,
    init_params,
    unembed,
)

__all__ = ["DecoderLM", "decode_step", "forward", "init_cache", "init_params", "unembed"]
