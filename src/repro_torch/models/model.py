"""Model assembly of the LMs: the dense decoders (starcoder2-3b,
phi3-medium-14b, gemma2-2b, stablelm-3b, qwen2-vl-2b), the MoE ones
(mixtral-8x22b; deepseek-v2-236b with MLA and shared experts), the pure
SSM falcon-mamba-7b (Mamba-1), the hybrid zamba2-2.7b (Mamba-2) and the
encoder-decoder whisper-medium.

Public API, as the reference's (over a :class:`DecoderLM` in place of a
params pytree):

    init_params(cfg, generator, device)       → DecoderLM
    forward(cfg, params, tokens, frames=…, moe_dispatch=…, remat=…) → logits (B,S,Vpad) float32
    init_cache(cfg, batch, max_len, device)   → cache
    init_cross_cache(cfg, params, enc_out)    → whisper's cross K/V, cache["cross"]
    decode_step(cfg, params, tokens, cache, enc_out=…) → (logits, cache)

The layer stack is a Python loop over ``params.layers`` (the reference
scans stacked params), each layer body rematerialized in training as the
reference's (``models/remat.py``).  The hybrid is the reference's, not
the published Zamba2: its ``n_groups · g`` SSM layers (``g =
hybrid_attn_every``) are stored flat, where the reference stacks them
``(n_groups, g, …)``, and after each group of ``g`` one shared
:class:`DecoderBlock` (``shared_attn``, the same weights every time) runs
on the residual stream alone: no
concatenated embedding and no LoRA per application, RoPE over the
prefill's positions, and in decode a KV cache of its own for each
application.  whisper's audio frontend is a stub, as in the reference:
the encoder takes frame embeddings ``(B, T, d_model)``; encoder and
decoder add sinusoidal positions and rotate nothing.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    CrossAttention,
    GQAttention,
    cross_apply,
    cross_apply_cached,
    cross_kv,
    gqa_apply,
    gqa_decode,
)
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
from repro_torch.models.mlp import MLP, mlp_apply
from repro_torch.models.remat import checkpoint_body, records

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a field of ``cfg`` the reference cannot run
    either: an attention flavour it does not have, ``attn="none"`` or
    ``hybrid_attn_every`` without an ``ssm`` config, an unknown dtype.
    The port runs every model the reference does: full, sliding-window or
    local/global GQA with RoPE, M-RoPE or none, optional softcaps, or MLA;
    a SwiGLU or GELU MLP, or a top-k MoE with optional shared experts;
    RMSNorm or LayerNorm with optional post norms, tied or untied
    embeddings; the SSM stacks: Mamba-1 or Mamba-2 layers alone (``attn``
    is then ignored, and may be ``"none"``), or in groups of
    ``hybrid_attn_every`` with a shared decoder block after each; and an
    ``encoder`` (whisper), whose decoder layers add cross attention."""
    if cfg.attn not in ("full", "swa", "local_global", "mla", "none"):
        raise ValueError(f"attn={cfg.attn!r} ({cfg.name}) is no attention of the reference")
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


class EncoderBlock(nn.Module):
    """A whisper encoder layer, the reference's ``_enc_block_init``:
    ``ln_attn``, ``attn`` (:class:`GQAttention`), ``ln_mlp``, ``mlp``;
    uninitialized until :meth:`reset_parameters` or ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.ln_attn = make_norm(cfg.norm, cfg.d_model, dtype=dtype, device=device)
        self.attn = GQAttention(cfg, dtype=dtype, device=device)
        self.ln_mlp = make_norm(cfg.norm, cfg.d_model, dtype=dtype, device=device)
        self.mlp = MLP(cfg, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)


class CrossDecoderBlock(EncoderBlock):
    """A whisper decoder layer, the reference's ``_dec_block_init``: an
    encoder layer's modules and ``ln_cross``, ``cross``
    (:class:`CrossAttention`) between its attention and its MLP."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__(cfg, dtype=dtype, device=device)
        self.ln_cross = make_norm(cfg.norm, cfg.d_model, dtype=dtype, device=device)
        self.cross = CrossAttention(cfg, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        self.cross.reset_parameters(generator)


class DecoderLM(nn.Module):
    """``embed (Vpad, d)``, ``layers``, ``ln_f``, and ``lm_head (Vpad, d)``
    where the embeddings are untied.  ``layers`` holds one
    :class:`DecoderBlock` a layer, or for an SSM config one
    :class:`SSMBlock` a layer (a hybrid's ``n_groups · g`` of them, flat),
    and a hybrid has ``shared_attn`` (one :class:`DecoderBlock`); with an
    encoder (whisper), ``enc_layers`` (one :class:`EncoderBlock` a layer),
    ``enc_ln_f``, and one :class:`CrossDecoderBlock` a decoder layer.
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
        elif cfg.encoder is not None:
            self.enc_layers = nn.ModuleList(
                EncoderBlock(cfg, dtype=dtype, device=device)
                for _ in range(cfg.encoder.n_layers))
            self.enc_ln_f = make_norm(cfg.norm, cfg.d_model, dtype=dtype, device=device)
            self.layers = nn.ModuleList(
                CrossDecoderBlock(cfg, dtype=dtype, device=device) for _ in range(cfg.n_layers))
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
        for layer in getattr(self, "enc_layers", ()):
            layer.reset_parameters(generator)


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


@functools.lru_cache(maxsize=8)
def _sinusoid(s: int, d: int, dtype, device) -> torch.Tensor:
    """Sinusoidal rows of positions ``0..s-1`` ``(s, d)``: angles in float64
    numpy, sin and cos stored in float32, then cast to ``dtype``, as the
    reference's ``_sinusoid`` (prefill and the encoder).  Made once for
    each shape, dtype and device (the reference's is a constant of its
    jitted program): its host numpy costs more than a whole prefill's
    launches otherwise.  Read only: callers add it, never write it."""
    pos = np.arange(s)[:, None]
    dim = np.arange(0, d, 2)[None]
    ang = pos / np.power(10_000.0, dim / d)
    out = np.zeros((s, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out).to(device=torch.device(device), dtype=dtype)


def _sinusoid_at(pos: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """Sinusoidal rows ``(B, d)`` of the positions ``pos (B,)``, computed in
    float32 on ``pos``'s device, as the reference's ``_sinusoid_at``
    (decode).  Not :func:`_sinusoid`'s numbers: the two are the
    reference's two ways, and prefill and decode add rows made each way."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    ang = pos.float()[:, None] / torch.pow(10_000.0, dim / d)[None]
    out = torch.zeros((pos.shape[0], d), dtype=torch.float32, device=pos.device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out.to(dtype)


def encode(cfg: ModelConfig, params: DecoderLM, frames: torch.Tensor, *,
           use_kernel: bool = True) -> torch.Tensor:
    """whisper's encoder, the reference's ``_encode``: the frames ``(B, T,
    d)`` in the model's dtype plus sinusoidal positions, then each layer
    ``x + attn(ln(x))`` (non-causal self-attention, no RoPE) and ``x +
    mlp(ln(x))``, then ``enc_ln_f``.  Each layer is rematerialized
    wherever autograd records (``models/remat.py``), whatever ``forward``'s
    ``remat`` says, as the reference's encoder always is."""
    x = frames.to(params.embed.dtype)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)[None]

    def layer_body(layer, x):
        x = x + gqa_apply(layer.attn, cfg, layer.ln_attn(x), None, causal=False,
                          use_kernel=use_kernel)
        return x + mlp_apply(layer.mlp, layer.ln_mlp(x))

    on = records(params)
    for layer in params.enc_layers:
        x = checkpoint_body(layer_body, layer, x, remat=on)
    return params.enc_ln_f(x)


def cross_block_apply(params: CrossDecoderBlock, cfg: ModelConfig, x: torch.Tensor,
                      enc_out: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    """A whisper decoder layer over the whole sequence, the reference's
    ``_dec_block_apply``: causal self-attention (no RoPE), cross attention
    over ``enc_out`` (plain route), MLP, each pre-norm and residual."""
    x = x + gqa_apply(params.attn, cfg, params.ln_attn(x), None, causal=True,
                      use_kernel=use_kernel)
    x = x + cross_apply(params.cross, cfg, params.ln_cross(x), enc_out)
    return x + mlp_apply(params.mlp, params.ln_mlp(x))


def forward(
    cfg: ModelConfig,
    params: DecoderLM,
    tokens: torch.Tensor,  # (B, S) int
    *,
    frames: torch.Tensor | None = None,  # (B, T, d_model): whisper's stubbed frontend
    moe_dispatch: str = "sparse",
    use_flash_kernel: bool = True,
    remat: bool = True,
    features_only: bool = False,
) -> torch.Tensor:
    """Prefill logits ``(B, S, Vpad)`` float32; with ``features_only`` the
    features ``(B, S, d)`` before the head (``ln_f``'s output), which the
    fused chunked loss reads.  An encoder config (whisper) needs
    ``frames``.

    ``moe_dispatch`` picks an MoE layer's dispatch, as the reference's:
    ``"sparse"`` (the default; each expert takes a capacity of tokens and
    drops the rest) or ``"dense"`` (every token through every expert,
    exact).

    ``use_flash_kernel`` defaults to True, where the reference's defaults
    to False because there the TPU dry run lowers the jnp path: here on a
    CUDA device every layer's attention runs the hand-written CUDA flash
    kernel, once per layer (a hybrid's shared block: once per application;
    whisper: once per encoder layer, without the causal mask, and once per
    decoder layer; a pure SSM runs no attention).  The reference's
    ``forward`` does not pass its flag to whisper's encoder and decoder
    layers, so they run its jnp attention whatever the flag; its kernel
    route computes the same function (``gqa_apply(..., use_kernel=True)``),
    so the port routes them as every other layer.  Cross attention always
    takes the plain route, as in the reference.  ``use_flash_kernel=False``
    asks for the plain attention route, for tests, comparisons and
    training (the kernel has no backward).  The SSM layers' scans are
    plain torch (``models/ssm.py``), as the reference's are jnp.

    ``remat`` (True by default, as the reference's) rematerializes each
    layer body where autograd records (grad mode on and a parameter
    requiring grad): a decoder layer, an SSM layer, a hybrid's group of
    ``hybrid_attn_every`` SSM layers and the shared block after them, a
    whisper decoder layer.  Each keeps for its backward only its input and
    the products the reference's ``dots_with_no_batch_dims_saveable``
    keeps, and runs again in the backward (``models/remat.py``).  The
    gradients are the same bit for bit; under ``torch.no_grad()`` the same
    ops run either way.  whisper's encoder layers are rematerialized
    wherever autograd records (:func:`encode`)."""
    if moe_dispatch not in ("sparse", "dense"):
        raise ValueError(f"moe_dispatch {moe_dispatch!r} is neither 'sparse' nor 'dense'")
    x = _embed(cfg, params, tokens)
    on = remat and records(params)
    if _pure_ssm(cfg):
        for layer in params.layers:
            x = checkpoint_body(lambda lp, x: ssm_block_apply(lp, cfg, x), layer, x, remat=on)
    elif cfg.hybrid_attn_every:
        positions = _positions(cfg, tokens)
        g = cfg.hybrid_attn_every

        def group_body(group, x):
            for layer in group:
                x = ssm_block_apply(layer, cfg, x)
            return decoder_block_apply(params.shared_attn, cfg, x, positions,
                                       moe_dispatch=moe_dispatch, use_kernel=use_flash_kernel)

        for i in range(0, len(params.layers), g):
            x = checkpoint_body(group_body, params.layers[i:i + g], x, remat=on)
    elif cfg.encoder is not None:
        if frames is None:
            raise ValueError(f"{cfg.name} has an encoder: forward needs frames (B, T, d_model)")
        enc = encode(cfg, params, frames, use_kernel=use_flash_kernel)
        x = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
        for layer in params.layers:
            x = checkpoint_body(
                lambda lp, x, enc: cross_block_apply(lp, cfg, x, enc, use_kernel=use_flash_kernel),
                layer, x, enc, remat=on)
    else:
        positions = _positions(cfg, tokens)

        def layer_body(layer, x, local):
            return decoder_block_apply(layer, cfg, x, positions, is_local=local,
                                       moe_dispatch=moe_dispatch, use_kernel=use_flash_kernel)

        for layer, local in zip(params.layers, _local_pattern(cfg)):
            x = checkpoint_body(layer_body, layer, x, local, remat=on)
    x = params.ln_f(x)
    return x if features_only else unembed(cfg, params, x)


def unembed(cfg: ModelConfig, params: DecoderLM, x: torch.Tensor) -> torch.Tensor:
    """Logits through the embedding (tied) or ``lm_head``: a product in the
    model's dtype cast up to float32, then the logit softcap in float32."""
    head = params.embed if cfg.tie_embeddings else params.lm_head
    return softcap((x @ head.T).float(), cfg.logit_softcap)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None) -> dict:
    """One cache per layer, ``{"layers": [{"k", "v", "pos"}, ...]}`` (MLA:
    ``{"ckv", "kr", "pos"}``; an SSM layer: ``{"conv", "h"}``); for a
    hybrid ``{"ssm": [one per SSM layer], "attn": [one per application of
    the shared block]}``; whisper's decoder layers take the first form,
    and :func:`init_cross_cache` adds ``cache["cross"]``."""
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


def init_cross_cache(cfg: ModelConfig, params: DecoderLM,
                     enc_out: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """whisper's cross-attention K and V ``(B, h, T, dh)`` of every decoder
    layer from the encoder output, computed once a request, to be stored
    under ``cache["cross"]`` (a list, one ``(k, v)`` a layer, where the
    reference stacks them)."""
    return [cross_kv(layer.cross, enc_out) for layer in params.layers]


def decode_step(
    cfg: ModelConfig,
    params: DecoderLM,
    tokens: torch.Tensor,  # (B, 1)
    cache: dict,
    *,
    enc_out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """One token for every row of the batch: logits ``(B, 1, Vpad)``
    float32 and the cache (attention caches are updated in place; an SSM
    layer's ``conv`` and ``h`` are new tensors).  Plain torch, as in the
    reference: no kernel runs here.  MoE layers run the sparse dispatch
    over the batch's B tokens, as the reference's: from B = 2 on, a pair
    whose expert an earlier row already filled to its capacity is
    dropped.

    whisper adds the sinusoidal row of each row's position and attends
    across to the encoder through ``cache["cross"]`` (from
    :func:`init_cross_cache`) where the cache has it, else through
    ``enc_out``, projecting its K and V again every step (the reference's
    ``make_serve_step`` passes ``enc_out``)."""
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
    if cfg.encoder is not None:
        cross = cache.get("cross")
        if cross is None and enc_out is None:
            raise ValueError(f"{cfg.name} decodes against its encoder: pass enc_out or "
                             f"a cache with init_cross_cache's 'cross'")
        x = x + _sinusoid_at(cache["layers"][0]["pos"], cfg.d_model, x.dtype)[:, None, :]
        layers = []
        for i, (layer, lc) in enumerate(zip(params.layers, cache["layers"], strict=True)):
            a, nc = gqa_decode(layer.attn, cfg, layer.ln_attn(x), lc)
            x = x + a
            h = layer.ln_cross(x)
            if cross is not None:
                x = x + cross_apply_cached(layer.cross, cfg, h, *cross[i])
            else:
                x = x + cross_apply(layer.cross, cfg, h, enc_out)
            x = x + mlp_apply(layer.mlp, layer.ln_mlp(x))
            layers.append(nc)
        return unembed(cfg, params, params.ln_f(x)), dict(cache, layers=layers)
    layers = []
    for layer, lc, local in zip(params.layers, cache["layers"], _local_pattern(cfg)):
        x, nc = decoder_block_decode(layer, cfg, x, lc, is_local=local)
        layers.append(nc)
    return unembed(cfg, params, params.ln_f(x)), {"layers": layers}
