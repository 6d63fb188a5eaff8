"""Grouped-query attention (GQA) with qwen2-vl's M-RoPE: causal,
over the whole sequence (prefill) or one step against the ring cache
(decode).

``gqa_apply`` routes to the flash-attention op when ``use_kernel`` is set,
which on a CUDA tensor is the hand-written CUDA kernel
(``kernels/flash_attention``).  Unlike the reference, ``use_kernel``
defaults to True: on the card the kernel route is the path, and the plain
route is an explicit request.  ``gqa_decode`` is plain torch attention, as
the reference's jnp ``gqa_decode`` is: no kernel runs on decode.

The reference's other attention paths (sliding windows, MLA, cross
attention, gemma2's score capping) come with the slices of the models that
use them (:func:`repro_torch.models.model.check_ported`).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.common import dense_init_, param
from repro_torch.models.rope import apply_mrope


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


def gqa_apply(
    params: GQAttention,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, 3, S) M-RoPE positions
    *,
    use_kernel: bool = True,
) -> torch.Tensor:
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    q = apply_mrope(_heads(x, params.wq), positions, cfg.rope_theta)
    k = apply_mrope(_heads(x, params.wk), positions, cfg.rope_theta)
    v = _heads(x, params.wv)
    scale = dh**-0.5
    if use_kernel:
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale=scale)
    else:
        o = _plain_attention(q, k, v, scale)
    o = o.transpose(1, 2).reshape(b, s, h * dh)
    return o @ params.wo


CHUNK_Q_THRESHOLD = 4096  # q-chunk the score matrix at/above this seq len
CHUNK_Q = 1024


def _plain_attention(q, k, v, scale):
    """Causal attention through the plain version: the plain route.

    For seq >= CHUNK_Q_THRESHOLD the (S,S) score matrix is computed in
    q-chunks (full-k softmax per chunk — exact, no online accumulation),
    bounding live memory to (B,H,cq,S), as the reference does."""
    sq = q.shape[2]
    if sq >= CHUNK_Q_THRESHOLD and sq % CHUNK_Q == 0:
        return torch.cat([
            attention_ref(q[:, :, i:i + CHUNK_Q], k, v, scale=scale, q_offset=i)
            for i in range(0, sq, CHUNK_Q)], dim=2)
    return attention_ref(q, k, v, scale=scale)


def gqa_decode(
    params: GQAttention,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, D)
    cache: dict,  # {"k": (B,Hk,T,dh), "v": ..., "pos": (B,) int32}
):
    """One decode step. The cache is a ring buffer of T slots (the max
    context).  The new K/V row is written into the cache tensors in place;
    the returned dict holds them and ``pos + 1``."""
    b = x.shape[0]
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    t = cache["k"].shape[2]
    pos = cache["pos"]  # (B,) current absolute position
    dpos = _decode_positions(pos)
    q = apply_mrope(_heads(x, params.wq), dpos, cfg.rope_theta)
    k = apply_mrope(_heads(x, params.wk), dpos, cfg.rope_theta)
    v = _heads(x, params.wv)
    kc = _ring_write(cache["k"], k, pos)
    vc = _ring_write(cache["v"], v, pos)
    # q head ih reads kv head ih // group: (B, h, 1, dh) → (B, hk, group, dh)
    qg = q.float().reshape(b, hk, h // hk, dh)
    s_ = torch.einsum("bkgd,bktd->bkgt", qg, kc.float()) * dh**-0.5
    # valid = slots already written (ring semantics)
    abs_pos = _slot_abs_pos(pos, t)  # (B,T) absolute token position per slot
    valid = (abs_pos >= 0) & (abs_pos <= pos[:, None].long())
    p = torch.softmax(s_.masked_fill(~valid[:, None, None, :], -1e30), dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", p, vc.float()).to(x.dtype)
    out = o.reshape(b, 1, h * dh) @ params.wo
    return out, {"k": kc, "v": vc, "pos": pos + 1}


def _decode_positions(pos):
    """M-RoPE positions ``(B, 3, 1)`` of one decode step."""
    return pos[:, None, None].expand(pos.shape[0], 3, 1)


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
