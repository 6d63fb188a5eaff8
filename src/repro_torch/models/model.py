"""Model assembly of the LMs: the dense decoders (starcoder2-3b,
phi3-medium-14b, gemma2-2b, stablelm-3b, qwen2-vl-2b), the MoE ones
(mixtral-8x22b; deepseek-v2-236b with MLA and shared experts), the pure
SSM falcon-mamba-7b (Mamba-1) and the hybrid zamba2-2.7b (Mamba-2).

Public API, as the reference's (over a :class:`DecoderLM` in place of a
params pytree):

    init_params(cfg, generator, device)       → DecoderLM
    forward(cfg, params, tokens, moe_dispatch=…) → logits (B,S,Vpad) float32
    init_cache(cfg, batch, max_len, device)   → cache
    decode_step(cfg, params, tokens, cache)   → (logits, cache)

The layer stack is a Python loop over ``params.layers`` (the reference
scans stacked params).  The hybrid is the reference's, not the published
Zamba2: its ``n_groups · g`` SSM layers (``g = hybrid_attn_every``) are
stored flat, where the reference stacks them ``(n_groups, g, …)``, and
after each group of ``g`` one shared :class:`DecoderBlock` (``shared_attn``,
the same weights every time) runs on the residual stream alone: no
concatenated embedding and no LoRA per application, RoPE over the
prefill's positions, and in decode a KV cache of its own for each
application.  :func:`check_ported` names the slice that brings each model
feature this one does not run.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.blocks import (
    DecoderBlock,
    SSMBlock,
    decoder_block_apply,
    decoder_block_decode,
    decoder_block_init_cache,
    ssm_block_apply,
    ssm_block_decode,
    ssm_block_init_cache,
)
from repro_torch.models.common import embed_init_, make_norm, pad_vocab, param, softcap

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_WHISPER = "the whisper-medium slice"


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a field of ``cfg`` set to a value
    whose model code is not ported yet, naming the slice that brings it,
    and ``ValueError`` for a field the reference cannot run either.  The
    port runs the dense and MoE decoders: full, sliding-window or
    local/global GQA with RoPE or M-RoPE and optional softcaps, or MLA; a
    SwiGLU or GELU MLP, or a top-k MoE with optional shared experts;
    RMSNorm or LayerNorm with optional post norms, tied or untied
    embeddings; and the SSM stacks: Mamba-1 or Mamba-2 layers alone
    (``attn`` is then ignored, and may be ``"none"``), or in groups of
    ``hybrid_attn_every`` with a shared decoder block after each."""
    later = (
        ("attn", cfg.attn not in ("full", "swa", "local_global", "mla", "none"), "no slice"),
        ("encoder", cfg.encoder is not None, _WHISPER),
        ("rope_enabled", not cfg.rope_enabled, _WHISPER),
    )
    for field, unported, comes_with in later:
        if unported:
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r} ({cfg.name}) is not ported yet: "
                f"it comes with {comes_with}")
    if cfg.ssm is None and (cfg.attn == "none" or cfg.hybrid_attn_every):
        field = "hybrid_attn_every" if cfg.hybrid_attn_every else "attn"
        raise ValueError(f"{field}={getattr(cfg, field)!r} ({cfg.name}) needs an ssm config: "
                         f"attn='none' is the pure-SSM stack, hybrid_attn_every the hybrid's")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype {cfg.dtype!r} not in {sorted(_DTYPES)}")


def _pure_ssm(cfg: ModelConfig) -> bool:
    return cfg.ssm is not None and not cfg.hybrid_attn_every


def _ssm_layers(cfg: ModelConfig) -> int:
    """SSM layers built: all of a pure SSM's; a hybrid's ``n_groups · g``,
    as the reference builds them."""
    if cfg.hybrid_attn_every:
        return cfg.n_layers // cfg.hybrid_attn_every * cfg.hybrid_attn_every
    return cfg.n_layers


class DecoderLM(nn.Module):
    """``embed (Vpad, d)``, ``layers``, ``ln_f``, and ``lm_head (Vpad, d)``
    where the embeddings are untied.  ``layers`` holds one
    :class:`DecoderBlock` a layer, or for an SSM config one
    :class:`SSMBlock` a layer (a hybrid's ``n_groups · g`` of them, flat),
    and a hybrid has ``shared_attn`` (one :class:`DecoderBlock`).
    Uninitialized until :meth:`reset_parameters` or ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        check_ported(cfg)
        dtype = _DTYPES[cfg.dtype]
        vpad = pad_vocab(cfg.vocab)
        self.embed = param((vpad, cfg.d_model), dtype, device)
        if cfg.ssm is not None:
            self.layers = nn.ModuleList(
                SSMBlock(cfg, dtype=dtype, device=device) for _ in range(_ssm_layers(cfg)))
            if cfg.hybrid_attn_every:
                self.shared_attn = DecoderBlock(cfg, dtype=dtype, device=device)
        else:
            self.layers = nn.ModuleList(
                DecoderBlock(cfg, dtype=dtype, device=device) for _ in range(cfg.n_layers))
        self.ln_f = make_norm(cfg.norm, cfg.d_model, dtype=dtype, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = param((vpad, cfg.d_model), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        embed_init_(self.embed, generator)
        if hasattr(self, "lm_head"):
            embed_init_(self.lm_head, generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        if hasattr(self, "shared_attn"):
            self.shared_attn.reset_parameters(generator)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None, *,
                device=None) -> DecoderLM:
    """Random init in ``cfg.dtype`` (an MoE router and an SSM's ``A_log``,
    ``D`` and Mamba-2 ``dt_bias`` in float32, as the reference's) on
    ``device`` (``cuda`` by default),
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


def _positions(cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """RoPE positions ``(B, S)``: the index; for M-RoPE ``(B, 3, S)`` of
    text, t = h = w = the index."""
    b, s = tokens.shape
    pos = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    if cfg.mrope:
        return pos[:, None].expand(b, 3, s)
    return pos


def _local_pattern(cfg: ModelConfig) -> list[bool]:
    """Which layers are local: gemma2's even layers, under local_global."""
    return [cfg.attn == "local_global" and i % 2 == 0 for i in range(cfg.n_layers)]


def _embed(cfg: ModelConfig, params: "DecoderLM", tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows; for gemma, times √d_model rounded to the model's
    dtype first, as the reference (which keys this on the name) does."""
    x = params.embed[tokens.long()]
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def forward(
    cfg: ModelConfig,
    params: DecoderLM,
    tokens: torch.Tensor,  # (B, S) int
    *,
    moe_dispatch: str = "sparse",
    use_flash_kernel: bool = True,
) -> torch.Tensor:
    """Prefill logits ``(B, S, Vpad)`` float32.

    ``moe_dispatch`` picks an MoE layer's dispatch, as the reference's:
    ``"sparse"`` (the default; each expert takes a capacity of tokens and
    drops the rest) or ``"dense"`` (every token through every expert,
    exact).

    ``use_flash_kernel`` defaults to True, where the reference's defaults
    to False because there the TPU dry run lowers the jnp path: here on a
    CUDA device every layer's attention runs the hand-written CUDA flash
    kernel, once per layer (a hybrid's shared block: once per application;
    a pure SSM runs no attention).  ``use_flash_kernel=False`` asks for the
    plain attention route, for tests and comparisons.  The SSM layers'
    scans are plain torch (``models/ssm.py``), as the reference's are jnp."""
    if moe_dispatch not in ("sparse", "dense"):
        raise ValueError(f"moe_dispatch {moe_dispatch!r} is neither 'sparse' nor 'dense'")
    x = _embed(cfg, params, tokens)
    if _pure_ssm(cfg):
        for layer in params.layers:
            x = ssm_block_apply(layer, cfg, x)
        return unembed(cfg, params, params.ln_f(x))
    positions = _positions(cfg, tokens)
    if cfg.hybrid_attn_every:
        g = cfg.hybrid_attn_every
        for i, layer in enumerate(params.layers):
            x = ssm_block_apply(layer, cfg, x)
            if (i + 1) % g == 0:
                x = decoder_block_apply(params.shared_attn, cfg, x, positions,
                                        moe_dispatch=moe_dispatch, use_kernel=use_flash_kernel)
        return unembed(cfg, params, params.ln_f(x))
    for layer, local in zip(params.layers, _local_pattern(cfg)):
        x = decoder_block_apply(layer, cfg, x, positions, is_local=local,
                                moe_dispatch=moe_dispatch, use_kernel=use_flash_kernel)
    return unembed(cfg, params, params.ln_f(x))


def unembed(cfg: ModelConfig, params: DecoderLM, x: torch.Tensor) -> torch.Tensor:
    """Logits through the embedding (tied) or ``lm_head``: a product in the
    model's dtype cast up to float32, then the logit softcap in float32."""
    head = params.embed if cfg.tie_embeddings else params.lm_head
    return softcap((x @ head.T).float(), cfg.logit_softcap)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None) -> dict:
    """One cache per layer, ``{"layers": [{"k", "v", "pos"}, ...]}`` (MLA:
    ``{"ckv", "kr", "pos"}``; an SSM layer: ``{"conv", "h"}``); for a
    hybrid ``{"ssm": [one per SSM layer], "attn": [one per application of
    the shared block]}``."""
    check_ported(cfg)
    dev = resolve_device(device)
    dtype = _DTYPES[cfg.dtype]
    if cfg.ssm is not None:
        ssm = [ssm_block_init_cache(cfg, batch, dtype, dev) for _ in range(_ssm_layers(cfg))]
        if not cfg.hybrid_attn_every:
            return {"layers": ssm}
        n_groups = cfg.n_layers // cfg.hybrid_attn_every
        return {"ssm": ssm, "attn": [decoder_block_init_cache(cfg, batch, max_len, dtype, dev)
                                     for _ in range(n_groups)]}
    return {"layers": [decoder_block_init_cache(cfg, batch, max_len, dtype, dev)
                       for _ in range(cfg.n_layers)]}


def decode_step(
    cfg: ModelConfig,
    params: DecoderLM,
    tokens: torch.Tensor,  # (B, 1)
    cache: dict,
) -> tuple[torch.Tensor, dict]:
    """One token for every row of the batch: logits ``(B, 1, Vpad)``
    float32 and the cache (attention caches are updated in place; an SSM
    layer's ``conv`` and ``h`` are new tensors).  Plain torch, as in the
    reference: no kernel runs here.  MoE layers run the sparse dispatch
    over the batch's B tokens, as the reference's: from B = 2 on, a pair
    whose expert an earlier row already filled to its capacity is
    dropped."""
    x = _embed(cfg, params, tokens)
    if _pure_ssm(cfg):
        layers = []
        for layer, lc in zip(params.layers, cache["layers"], strict=True):
            x, nc = ssm_block_decode(layer, cfg, x, lc)
            layers.append(nc)
        return unembed(cfg, params, params.ln_f(x)), {"layers": layers}
    if cfg.hybrid_attn_every:
        g = cfg.hybrid_attn_every
        ssm, attn = [], []
        for i, (layer, lc) in enumerate(zip(params.layers, cache["ssm"], strict=True)):
            x, nc = ssm_block_decode(layer, cfg, x, lc)
            ssm.append(nc)
            if (i + 1) % g == 0:
                x, ac = decoder_block_decode(params.shared_attn, cfg, x, cache["attn"][i // g])
                attn.append(ac)
        return unembed(cfg, params, params.ln_f(x)), {"ssm": ssm, "attn": attn}
    layers = []
    for layer, lc, local in zip(params.layers, cache["layers"], _local_pattern(cfg)):
        x, nc = decoder_block_decode(layer, cfg, x, lc, is_local=local)
        layers.append(nc)
    return unembed(cfg, params, params.ln_f(x)), {"layers": layers}
