"""Model assembly of the dense decoder-only LM (qwen2-vl-2b's path).

Public API, as the reference's (over a :class:`DecoderLM` in place of a
params pytree):

    init_params(cfg, generator, device)       → DecoderLM
    forward(cfg, params, tokens)              → logits (B,S,Vpad) float32
    init_cache(cfg, batch, max_len, device)   → cache
    decode_step(cfg, params, tokens, cache)   → (logits, cache)

The layer stack is a Python loop over ``params.layers`` (the reference
scans stacked params).  :func:`check_ported` names the slice that brings
each model feature this one does not run.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.blocks import (
    DecoderBlock,
    decoder_block_apply,
    decoder_block_decode,
    decoder_block_init_cache,
)
from repro_torch.models.common import RMSNorm, embed_init_, pad_vocab, param

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_STARCODER2 = "the starcoder2-3b slice"
_GEMMA2 = "the gemma2-2b slice"
_SSM = "the SSM and hybrid slice (falcon-mamba-7b, zamba2-2.7b)"
_WHISPER = "the whisper-medium slice"


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a field of ``cfg`` set to a value
    whose model code is not ported yet, naming the slice that brings it.
    The port runs a dense decoder with full causal GQA, M-RoPE, a SwiGLU
    MLP, RMSNorm and tied embeddings: qwen2-vl-2b."""
    attn_slice = {"swa": _STARCODER2, "local_global": _GEMMA2,
                  "mla": "the MLA slice (deepseek-v2-236b)", "none": _SSM}
    later = (
        ("attn", cfg.attn != "full", attn_slice.get(cfg.attn, "no slice")),
        ("mlp", cfg.mlp != "swiglu", _STARCODER2),
        ("norm", cfg.norm != "rmsnorm", _STARCODER2),
        ("mrope", not cfg.mrope, _STARCODER2),
        ("tie_embeddings", not cfg.tie_embeddings, _STARCODER2),
        ("post_norm", cfg.post_norm, _GEMMA2),
        ("attn_softcap", cfg.attn_softcap is not None, _GEMMA2),
        ("logit_softcap", cfg.logit_softcap is not None, _GEMMA2),
        ("moe", cfg.moe is not None, "the MoE slice (mixtral-8x22b, deepseek-v2-236b)"),
        ("mla", cfg.mla is not None, "the MLA slice (deepseek-v2-236b)"),
        ("ssm", cfg.ssm is not None, _SSM),
        ("hybrid_attn_every", cfg.hybrid_attn_every != 0, _SSM),
        ("encoder", cfg.encoder is not None, _WHISPER),
        ("rope_enabled", not cfg.rope_enabled, _WHISPER),
    )
    for field, unported, comes_with in later:
        if unported:
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r} ({cfg.name}) is not ported yet: "
                f"it comes with {comes_with}")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype {cfg.dtype!r} not in {sorted(_DTYPES)}")


class DecoderLM(nn.Module):
    """``embed (Vpad, d)`` (tied to the unembedding), ``layers`` (one
    :class:`DecoderBlock` each) and ``ln_f``; uninitialized until
    :meth:`reset_parameters` or ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        check_ported(cfg)
        dtype = _DTYPES[cfg.dtype]
        self.embed = param((pad_vocab(cfg.vocab), cfg.d_model), dtype, device)
        self.layers = nn.ModuleList(
            DecoderBlock(cfg, dtype=dtype, device=device) for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        embed_init_(self.embed, generator)
        for layer in self.layers:
            layer.reset_parameters(generator)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None, *,
                device=None) -> DecoderLM:
    """Random init in ``cfg.dtype`` on ``device`` (``cuda`` by default),
    drawn from ``generator`` (a generator on that device; seed 0 when
    None).  Truncated normals as the reference draws them, not its
    numbers: tests take the reference's weights through
    ``convert.params_from_jax``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = DecoderLM(cfg, device=dev)
    model.reset_parameters(generator)
    return model


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    """M-RoPE positions ``(B, 3, S)`` of text: t = h = w = the index."""
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, 3, s)


def forward(
    cfg: ModelConfig,
    params: DecoderLM,
    tokens: torch.Tensor,  # (B, S) int
    *,
    use_flash_kernel: bool = True,
) -> torch.Tensor:
    """Prefill logits ``(B, S, Vpad)`` float32.

    ``use_flash_kernel`` defaults to True, where the reference's defaults
    to False because there the TPU dry run lowers the jnp path: here on a
    CUDA device every layer's attention runs the hand-written CUDA flash
    kernel, once per layer.  ``use_flash_kernel=False`` asks for the plain
    attention route, for tests and comparisons."""
    x = params.embed[tokens.long()]
    positions = _positions(tokens)
    for layer in params.layers:
        x = decoder_block_apply(layer, cfg, x, positions, use_kernel=use_flash_kernel)
    return unembed(params, params.ln_f(x))


def unembed(params: DecoderLM, x: torch.Tensor) -> torch.Tensor:
    """Logits through the tied embedding, a product in the model's dtype
    cast up to float32."""
    return (x @ params.embed.T).float()


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None) -> dict:
    """One ring cache per layer, ``{"layers": [{"k", "v", "pos"}, ...]}``."""
    check_ported(cfg)
    dev = resolve_device(device)
    return {"layers": [decoder_block_init_cache(cfg, batch, max_len, _DTYPES[cfg.dtype], dev)
                       for _ in range(cfg.n_layers)]}


def decode_step(
    cfg: ModelConfig,
    params: DecoderLM,
    tokens: torch.Tensor,  # (B, 1)
    cache: dict,
) -> tuple[torch.Tensor, dict]:
    """One token for every row of the batch: logits ``(B, 1, Vpad)``
    float32 and the cache, whose K/V tensors are updated in place.  Plain
    torch attention, as in the reference: no kernel runs here."""
    x = params.embed[tokens.long()]
    layers = []
    for layer, lc in zip(params.layers, cache["layers"]):
        x, nc = decoder_block_decode(layer, cfg, x, lc)
        layers.append(nc)
    return unembed(params, params.ln_f(x)), {"layers": layers}
