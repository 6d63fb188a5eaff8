"""Attention of the LMs: grouped-query attention (GQA) with RoPE, qwen2-vl's
M-RoPE or no rotation (whisper), causal or not, with an optional sliding
window and gemma2's score softcap; deepseek-v2's multi-head latent
attention (MLA); whisper's cross attention over the encoder's output.
Each runs over the whole sequence (prefill) or one step against its cache
(decode).

``gqa_apply`` routes to the flash-attention op when ``use_kernel`` is set
and the config has no score softcap (as the reference does), which on a
CUDA tensor is the hand-written CUDA kernel (``kernels/flash_attention``).
Unlike the reference, ``use_kernel`` defaults to True: on the card the
kernel route is the path, and the plain route is an explicit request.
``gqa_decode``, ``mla_apply``, ``mla_decode`` and the cross attention
are plain torch, as the reference's jnp versions are: no kernel runs on
them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.common import RMSNorm, dense_init_, param, softcap
from repro_torch.models.remat import dense
from repro_torch.models.rope import apply_mrope, apply_rope


class GQAttention(nn.Module):
    """GQA weights in the reference's layout: ``wq (d, h, dh)``, ``wk`` and
    ``wv (d, hk, dh)``, ``wo (h·dh, d)``; uninitialized until
    :meth:`reset_parameters` or ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        self.wq = param((d, h, dh), dtype, device)
        self.wk = param((d, hk, dh), dtype, device)
        self.wv = param((d, hk, dh), dtype, device)
        self.wo = param((h * dh, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv):
            dense_init_(w, generator, self.cfg.d_model)
        dense_init_(self.wo, generator, self.wo.shape[0])


def gqa_init(cfg: ModelConfig, dtype, *, generator: torch.Generator,
             device: torch.device | str) -> GQAttention:
    m = GQAttention(cfg, dtype=dtype, device=device)
    m.reset_parameters(generator)
    return m


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bhsk", x, w)`` as one matrix product, which a
    checkpointed layer keeps (``remat.dense``: no batch dimension)."""
    b, s, d = x.shape
    _, h, dh = w.shape
    return dense(x, w.reshape(d, h * dh)).view(b, s, h, dh).transpose(1, 2)


def _rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor | None) -> torch.Tensor:
    """``x`` as it is where RoPE is off or ``positions`` is None; M-RoPE for
    ``(B, 3, S)`` positions of an M-RoPE config; else plain RoPE on
    ``(B, S)`` positions, as the reference's ``_rope``."""
    if positions is None or not cfg.rope_enabled:
        return x
    if cfg.mrope and positions.dim() == 3:
        return apply_mrope(x, positions, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta)


def gqa_apply(
    params: GQAttention,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor | None,  # (B, S), (B, 3, S) M-RoPE positions, or None
    *,
    causal: bool = True,
    window: int | None = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    q = _rope(cfg, _heads(x, params.wq), positions)
    k = _rope(cfg, _heads(x, params.wk), positions)
    v = _heads(x, params.wv)
    scale = dh**-0.5
    if cfg.attn_softcap is None and use_kernel:
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale=scale,
                            causal=causal, window=window)
    else:
        o = _plain_attention(q, k, v, scale, causal, window, cfg.attn_softcap)
    o = o.transpose(1, 2).reshape(b, s, h * dh)
    return dense(o, params.wo)


CHUNK_Q_THRESHOLD = 4096  # q-chunk the score matrix at/above this seq len
CHUNK_Q = 1024


def _plain_attention(q, k, v, scale, causal=True, window=None, cap=None):
    """Masked attention with an optional score softcap ``cap`` and window:
    the plain route, the reference's ``_softcap_attention``.

    For seq >= CHUNK_Q_THRESHOLD the (S,S) score matrix is computed in
    q-chunks (full-k softmax per chunk — exact, no online accumulation),
    bounding live memory to (B,H,cq,S), as the reference does."""
    sq = q.shape[2]
    if sq >= CHUNK_Q_THRESHOLD and sq % CHUNK_Q == 0:
        return torch.cat([
            _full_attention(q[:, :, i:i + CHUNK_Q], k, v, scale, causal, window, cap, i)
            for i in range(0, sq, CHUNK_Q)], dim=2)
    return _full_attention(q, k, v, scale, causal, window, cap, 0)


def _full_attention(q, k, v, scale, causal, window, cap, q_offset):
    """Attention of the queries ``q`` whose first row sits at absolute
    position ``q_offset``, over every key: scores in float32, softcapped,
    masked (``qpos >= kpos`` when causal, ``qpos - kpos < window``) to
    -1e30, softmax, P·V; output in q's dtype, of v's head dim (MLA's q and
    k heads are wider than its v heads).  q head ``ih`` reads kv head
    ``ih // (hq // hkv)`` without repeating k and v."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, sq, dh)
    s_ = softcap(torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) * scale, cap)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    p = torch.softmax(s_.masked_fill_(~mask, -1e30), dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    return o.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


def gqa_decode(
    params: GQAttention,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, D)
    cache: dict,  # {"k": (B,Hk,T,dh), "v": ..., "pos": (B,) int32}
    *,
    window: int | None = None,
):
    """One decode step. The cache is a ring buffer of T slots (the max
    context; for SWA archs T = window).  The new K/V row is written into
    the cache tensors in place; the returned dict holds them and
    ``pos + 1``."""
    b = x.shape[0]
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    t = cache["k"].shape[2]
    pos = cache["pos"]  # (B,) current absolute position
    dpos = _decode_positions(cfg, pos)
    q = _rope(cfg, _heads(x, params.wq), dpos)
    k = _rope(cfg, _heads(x, params.wk), dpos)
    v = _heads(x, params.wv)
    kc = _ring_write(cache["k"], k, pos)
    vc = _ring_write(cache["v"], v, pos)
    # q head ih reads kv head ih // group: (B, h, 1, dh) → (B, hk, group, dh)
    qg = q.float().reshape(b, hk, h // hk, dh)
    s_ = torch.einsum("bkgd,bktd->bkgt", qg, kc.float()) * dh**-0.5
    s_ = softcap(s_, cfg.attn_softcap)
    # valid = slots already written (ring semantics)
    abs_pos = _slot_abs_pos(pos, t)  # (B,T) absolute token position per slot
    cur = pos[:, None].long()
    valid = (abs_pos >= 0) & (abs_pos <= cur)
    if window is not None:
        valid &= (cur - abs_pos) < window
    p = torch.softmax(s_.masked_fill(~valid[:, None, None, :], -1e30), dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", p, vc.float()).to(x.dtype)
    out = o.reshape(b, 1, h * dh) @ params.wo
    return out, {"k": kc, "v": vc, "pos": pos + 1}


def _decode_positions(cfg: ModelConfig, pos):
    """Positions of one decode step: ``(B, 3, 1)`` for M-RoPE (text: the
    three streams equal), else ``(B, 1)``."""
    p = pos[:, None]
    if cfg.mrope:
        return p[:, None, :].expand(pos.shape[0], 3, 1)
    return p


def _ring_write(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """cache (B,Hk,T,dh); new (B,Hk,1,dh): write row b at slot pos[b] % T,
    in place, with one indexed copy.  The reference computes the same with
    a one-hot blend ``cache·(1-oh) + new·oh``, a TPU idiom that rewrites
    the whole cache; for finite values the two agree bit for bit."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, :, (pos % cache.shape[2]).long()] = new[:, :, 0]
    return cache


def _slot_abs_pos(pos, t: int):
    """Absolute token position stored in each ring slot. pos (B,) → (B,T)."""
    slots = torch.arange(t, device=pos.device)[None, :]
    cur = pos[:, None].long()
    # latest write to slot s has abs position: largest p <= cur with p % t == s
    base = torch.div(cur, t, rounding_mode="floor") * t + slots
    return torch.where(base <= cur, base, base - t)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------


class MLAttention(nn.Module):
    """MLA weights in the reference's layout, ``r = q_lora_rank``,
    ``c = kv_lora_rank``: ``wdq (d, r)``, ``q_norm.scale (r)``,
    ``wuq (r, h, nope + rope)``, ``wdkv (d, c)``, ``kv_norm.scale (c)``,
    ``wkr (d, rope)`` (one rope key shared by every head), ``wuk (c, h,
    nope)``, ``wuv (c, h, v)`` and ``wo (h·v, d)``; uninitialized until
    :meth:`reset_parameters` or ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        m = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        self.wdq = param((d, m.q_lora_rank), dtype, device)
        self.q_norm = RMSNorm(m.q_lora_rank, dtype=dtype, device=device)
        self.wuq = param((m.q_lora_rank, h, m.qk_nope_head_dim + m.qk_rope_head_dim),
                         dtype, device)
        self.wdkv = param((d, m.kv_lora_rank), dtype, device)
        self.kv_norm = RMSNorm(m.kv_lora_rank, dtype=dtype, device=device)
        self.wkr = param((d, m.qk_rope_head_dim), dtype, device)
        self.wuk = param((m.kv_lora_rank, h, m.qk_nope_head_dim), dtype, device)
        self.wuv = param((m.kv_lora_rank, h, m.v_head_dim), dtype, device)
        self.wo = param((h * m.v_head_dim, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wdq, self.wuq, self.wdkv, self.wkr, self.wuk, self.wuv, self.wo):
            dense_init_(w, generator, w.shape[0])


def mla_init(cfg: ModelConfig, dtype, *, generator: torch.Generator,
             device: torch.device | str) -> MLAttention:
    m = MLAttention(cfg, dtype=dtype, device=device)
    m.reset_parameters(generator)
    return m


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def mla_apply(params: MLAttention, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    """MLA over the whole sequence, positions ``(B, S)``: the queries from
    the normed ``q_lora`` stream, the keys' nope part and the values from
    the normed compressed kv, RoPE on the rope parts.  The score
    ``q_nope·k_nopeᵀ + q_rope·k_ropeᵀ`` is one product of the two parts
    side by side (the one rope key repeated for every head), in float32
    through the plain attention route, q-chunked from 4,096 rows as the
    reference's."""
    m = cfg.mla
    b, s, _ = x.shape
    h, rope = cfg.n_heads, m.qk_rope_head_dim
    q = _heads(params.q_norm(dense(x, params.wdq)), params.wuq)  # (B,H,S,nope+rope)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, rope], dim=-1)
    q = torch.cat([q_nope, apply_rope(q_rope, positions, cfg.rope_theta)], dim=-1)
    ckv = params.kv_norm(dense(x, params.wdkv))
    k_rope = apply_rope(dense(x, params.wkr)[:, None], positions, cfg.rope_theta)  # (B,1,S,rope)
    k = torch.cat([_heads(ckv, params.wuk), k_rope.expand(b, h, s, rope)], dim=-1)
    o = _plain_attention(q, k, _heads(ckv, params.wuv), _mla_scale(cfg), causal)
    return dense(o.transpose(1, 2).reshape(b, s, h * m.v_head_dim), params.wo)


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> dict:
    """The compressed cache: ``ckv (B, T, kv_lora_rank)``, the rope key
    ``kr (B, T, rope)`` and ``pos``."""
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "kr": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def mla_decode(params: MLAttention, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """One MLA decode step against the compressed cache, whose slot
    ``pos % T`` of each row takes the new ``ckv`` and ``kr`` in place; slots
    below ``min(pos + 1, T)`` are live.  Weight absorption, as the
    reference: the query times ``W_uk`` meets ``ckv`` directly, and the
    attended ``ckv`` goes through ``W_uv`` after.  Each product the
    reference accumulates in float32 runs on float32 copies of its
    operands (exact for the products); its operands are rounded to x's
    dtype where the reference casts them."""
    m = cfg.mla
    b, h = x.shape[0], cfg.n_heads
    t = cache["ckv"].shape[1]
    pos = cache["pos"]
    dpos = pos[:, None]  # (B, 1)
    q = _heads(params.q_norm(x @ params.wdq), params.wuq)  # (B,H,1,nope+rope)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, dpos, cfg.rope_theta)
    ckv_new = params.kv_norm(x @ params.wdkv)  # (B,1,c)
    kr_new = apply_rope((x @ params.wkr)[:, None], dpos, cfg.rope_theta)[:, 0]  # (B,1,rope)
    rows, slot = torch.arange(b, device=x.device), (pos % t).long()
    ckv, kr = cache["ckv"], cache["kr"]
    ckv[rows, slot] = ckv_new[:, 0]
    kr[rows, slot] = kr_new[:, 0]

    def rounded(a):  # the reference's cast to x's dtype, held in float32
        return a.to(x.dtype).float()

    ckv32 = ckv.float()
    q_abs = torch.einsum("bhqk,rhk->bhqr", q_nope.float(), params.wuk.float())
    s_ = (torch.einsum("bhqr,btr->bhqt", rounded(q_abs), ckv32)
          + torch.einsum("bhqk,btk->bhqt", q_rope.float(), kr.float())) * _mla_scale(cfg)
    live = torch.arange(t, device=x.device)[None, :] < torch.clamp(dpos.long() + 1, max=t)
    p = torch.softmax(s_.masked_fill_(~live[:, None, None, :], -1e30), dim=-1)
    o_c = torch.einsum("bhqt,btr->bhqr", rounded(p), ckv32)
    o = torch.einsum("bhqr,rhk->bhqk", rounded(o_c), params.wuv.float()).to(x.dtype)
    out = o.transpose(1, 2).reshape(b, 1, h * m.v_head_dim) @ params.wo
    return out, {"ckv": ckv, "kr": kr, "pos": pos + 1}


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder)
# ---------------------------------------------------------------------------


class CrossAttention(nn.Module):
    """Cross-attention weights in the reference's layout, every projection
    with ``n_heads`` heads: ``wq``, ``wk``, ``wv (d, h, dh)`` and ``wo (h·dh,
    d)``; uninitialized until :meth:`reset_parameters` or
    ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, h, dh = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
        self.wq = param((d, h, dh), dtype, device)
        self.wk = param((d, h, dh), dtype, device)
        self.wv = param((d, h, dh), dtype, device)
        self.wo = param((h * dh, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv):
            dense_init_(w, generator, self.cfg.d_model)
        dense_init_(self.wo, generator, self.wo.shape[0])


def cross_kv(params: CrossAttention, enc_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A layer's cross-attention K and V ``(B, h, T, dh)`` from the encoder
    output ``(B, T, d)``: computed once a request, not once a decode step."""
    return _heads(enc_out, params.wk), _heads(enc_out, params.wv)


def cross_apply_cached(params: CrossAttention, cfg: ModelConfig, x: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Every query of ``x (B, S, d)`` over every encoder position of the
    cached ``k``, ``v``: the plain, non-causal route (``attention_ref``), as
    in the reference; no kernel runs here."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    o = attention_ref(_heads(x, params.wq), k, v, scale=dh**-0.5, causal=False)
    return dense(o.transpose(1, 2).reshape(b, s, h * dh), params.wo)


def cross_apply(params: CrossAttention, cfg: ModelConfig, x: torch.Tensor,
                enc_out: torch.Tensor) -> torch.Tensor:
    """Cross attention of ``x`` over the encoder output, its K and V
    projected here."""
    return cross_apply_cached(params, cfg, x, *cross_kv(params, enc_out))
