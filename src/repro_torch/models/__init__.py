"""The LMs of the port, at full width: the dense decoders (starcoder2-3b,
phi3-medium-14b, gemma2-2b, stablelm-3b, qwen2-vl-2b), the MoE ones
(mixtral-8x22b, deepseek-v2-236b), the pure SSM falcon-mamba-7b (Mamba-1)
and the hybrid zamba2-2.7b (Mamba-2 with a shared attention block):
modules, prefill ``forward`` through the CUDA flash kernel (GQA layers and
the hybrid's shared block; the SSM scans are plain torch), and
``decode_step``."""
from repro_torch.models.blocks import SSMBlock
from repro_torch.models.model import (
    DecoderLM,
    decode_step,
    forward,
    init_cache,
    init_params,
    unembed,
)
from repro_torch.models.ssm import Mamba1, Mamba2, mamba1_scan, mamba2_scan

__all__ = ["DecoderLM", "Mamba1", "Mamba2", "SSMBlock", "decode_step", "forward", "init_cache",
           "init_params", "mamba1_scan", "mamba2_scan", "unembed"]
