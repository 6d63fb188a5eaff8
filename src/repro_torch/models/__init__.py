"""The dense decoder LMs of the port (starcoder2-3b, phi3-medium-14b,
gemma2-2b, stablelm-3b, qwen2-vl-2b, at full width): modules, prefill
``forward`` through the CUDA flash kernel, and ``decode_step``."""
from repro_torch.models.model import (
    DecoderLM,
    decode_step,
    forward,
    init_cache,
    init_params,
    unembed,
)

__all__ = ["DecoderLM", "decode_step", "forward", "init_cache", "init_params", "unembed"]
