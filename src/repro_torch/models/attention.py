"""Grouped-query attention (GQA) of the dense decoders: RoPE or qwen2-vl's
M-RoPE, causal, with an optional sliding window and gemma2's score
softcap, over the whole sequence (prefill) or one step against the ring
cache (decode).

``gqa_apply`` routes to the flash-attention op when ``use_kernel`` is set
and the config has no score softcap (as the reference does), which on a
CUDA tensor is the hand-written CUDA kernel (``kernels/flash_attention``).
Unlike the reference, ``use_kernel`` defaults to True: on the card the
kernel route is the path, and the plain route is an explicit request.
``gqa_decode`` is plain torch attention, as the reference's jnp
``gqa_decode`` is: no kernel runs on decode.

The reference's other attention paths (MLA, cross attention) come with the
slices of the models that use them
(:func:`repro_torch.models.model.check_ported`).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import dense_init_, param, softcap
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
    """``einsum("bsd,dhk->bhsk", x, w)`` as one matrix product."""
    b, s, d = x.shape
    _, h, dh = w.shape
    return (x @ w.reshape(d, h * dh)).view(b, s, h, dh).transpose(1, 2)


def _rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """M-RoPE for ``(B, 3, S)`` positions of an M-RoPE config, else plain
    RoPE on ``(B, S)`` positions, as the reference's ``_rope``."""
    if cfg.mrope and positions.dim() == 3:
        return apply_mrope(x, positions, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta)


def gqa_apply(
    params: GQAttention,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S), or (B, 3, S) M-RoPE positions
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
    return o @ params.wo


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
    -1e30, softmax, P·V; output in q's dtype.  q head ``ih`` reads kv head
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
    return o.reshape(b, hq, sq, dh).to(q.dtype)


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
