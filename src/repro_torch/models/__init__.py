"""The dense decoder LM of the port (qwen2-vl-2b at full width): modules,
prefill ``forward`` through the CUDA flash kernel, and ``decode_step``."""
from repro_torch.models.model import (
    DecoderLM,
    decode_step,
    forward,
    init_cache,
    init_params,
    unembed,
)

__all__ = ["DecoderLM", "decode_step", "forward", "init_cache", "init_params", "unembed"]
