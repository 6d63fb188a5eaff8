"""Selective state-space blocks: Mamba-1 (falcon-mamba-7b) and Mamba-2
(zamba2-2.7b), the reference's ``models/ssm.py``: modules, prefill, and one
decode step against a cache of O(1) size in the context length (a conv
ring buffer and the state ``h``).

The reference scans time with ``lax.scan``, one step a token.  A loop that
launched the step's few ops a token would cost ``layers · S · ops``
launches a prefill, and keeping every step's state at once does not fit
(falcon-mamba-7b at b 2, S 4096: 4.3 GB a layer), so prefill runs:

- Mamba-1 (:func:`mamba1_scan`): time in chunks of at most
  ``STATE_CHUNK_BYTES`` of float32 state.  A chunk's decays ``exp(dt·A)``
  and inputs ``dt·B·x`` are made in one pass each; then one fused
  ``addcmul_`` a step turns the inputs into the states in place,
  ``h_t = dt_t·B_t·x_t + exp(dt_t·A)·h_{t-1}``, in the reference's order
  of time; then ``y = h·C`` for the chunk in one product.  One launch a
  token a layer, host-bound on the card.
- Mamba-2 (:func:`mamba2_scan`), whose decay is one scalar a head: the
  chunked SSD form in float32 matrix products.  Within a chunk of
  ``SSD_CHUNK`` steps a step's state reaches step ``t`` decayed by
  ``exp(Σ a)`` over the steps between, summed as a segment sum of the
  chunk's ``a = dt·A`` (never as a difference of prefix sums); chunk
  states pass from chunk to chunk through the same segment sum over the
  chunks' totals.  About 20 launches a layer, whatever S.

Both sum in another order than the reference's scan (Mamba-2 also takes
the decays as exponentials of sums in place of products of
exponentials), so they agree with it to float32 rounding: the tests hold
them within 1e-5 × max|ref|.  Decode is the reference's one step, with
its conv an einsum over the ring buffer (a product in float32 rounded
once to the model's dtype), another reduction than prefill's shifted
sum.

The reference's rounding points are kept, which is what the bf16 tests
hold: Mamba-1 takes ``dt``, ``B``, ``C`` and ``x`` in the model's dtype
into its float32 recurrence and casts ``y`` to it before the ``silu(z)``
gate; Mamba-2 keeps ``dt`` in float32 and ends in a gated RMSNorm (eps
1e-6 in float32, cast, then ``norm_scale``); the causal conv adds its k
shifted products in the model's dtype, in order.  ``A_log`` and ``D`` (and
Mamba-2's ``dt_bias``) stay float32 in a bf16 model, as in the reference.
The reference's ``constrain`` calls are sharding hints; the port has
none.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init_, param, records_grad
from repro_torch.models.remat import dense

STATE_CHUNK_BYTES = 256 * 2**20  # float32 state of one Mamba-1 prefill chunk
SSD_CHUNK = 64  # time steps of one Mamba-2 SSD chunk
GATED_NORM_EPS = 1e-6


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (B,S,C), w (K,C), b (C): the k shifted
    products added in ``x``'s dtype, in order, then the bias."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + s, :] * w[i]
    return out + b


def _conv_step(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Decode's conv, ``einsum("bkc,kc->bc", window, w) + b``: products and
    sum in float32, rounded once to the window's dtype, then the bias."""
    return (window.float() * w.float()).sum(dim=1).to(window.dtype) + b


def dt_rank(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or max(1, cfg.d_model // 16)


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------


class Mamba1(nn.Module):
    """``in_proj (d, 2di)``, ``conv_w (K, di)``, ``conv_b``, ``x_proj (di,
    r + 2N)``, ``dt_proj (r, di)``, ``dt_bias``, ``A_log (di, N)`` and ``D``
    in float32, ``out_proj (di, d)``; the dense weights uninitialized until
    :meth:`reset_parameters` or ``load_state_dict``, the rest set to the
    reference's constants."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        s, d = cfg.ssm, cfg.d_model
        di, r = s.expand * d, dt_rank(cfg)
        self.in_proj = param((d, 2 * di), dtype, device)
        self.conv_w = param((s.conv, di), dtype, device)
        self.conv_b = param((di,), dtype, device)
        self.x_proj = param((di, r + 2 * s.state), dtype, device)
        self.dt_proj = param((r, di), dtype, device)
        self.dt_bias = param((di,), dtype, device)
        self.A_log = param((di, s.state), torch.float32, device)
        self.D = param((di,), torch.float32, device)
        self.out_proj = param((di, d), dtype, device)
        self._constants()

    @torch.no_grad()
    def _constants(self) -> None:
        self.conv_w.fill_(1.0 / self.cfg.ssm.conv)
        self.conv_b.zero_()
        self.dt_bias.fill_(0.5)
        n = self.A_log.shape[1]
        self.A_log.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                                device=self.A_log.device)).expand_as(self.A_log))
        self.D.fill_(1.0)

    def reset_parameters(self, generator: torch.Generator) -> None:
        di = self.out_proj.shape[0]
        dense_init_(self.in_proj, generator, self.cfg.d_model)
        dense_init_(self.x_proj, generator, di)
        dense_init_(self.dt_proj, generator, self.dt_proj.shape[0])
        dense_init_(self.out_proj, generator, di)
        self._constants()


def mamba1_scan(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """The selective scan, float32: dt and x (b, S, di), A (di, N), B and C
    (b, S, N) → ``y_t = h_t·C_t`` (b, S, di), where ``h_t = exp(dt_t·A)·h_{t-1}
    + dt_t·B_t·x_t`` from ``h_{-1} = 0``.  Time in chunks of as many steps
    as ``STATE_CHUNK_BYTES`` of state hold; one ``addcmul_`` a step, in
    place, or where autograd records (the step before needs its state for
    the backward) one out-of-place ``addcmul`` a step, the same numbers."""
    b, s, di = x.shape
    n = A.shape[1]
    chunk = max(1, STATE_CHUNK_BYTES // (b * di * n * x.element_size()))
    dt_t, x_t = dt.transpose(0, 1), x.transpose(0, 1)  # time first: each step contiguous
    B_t, C_t = B.transpose(0, 1), C.transpose(0, 1)
    ys = torch.empty((s, b, di), dtype=x.dtype, device=x.device)
    h = torch.zeros((b, di, n), dtype=x.dtype, device=x.device)
    for t0 in range(0, s, chunk):
        t1 = min(s, t0 + chunk)
        d = dt_t[t0:t1, :, :, None]
        decay = torch.exp(d * A)  # (T, b, di, N)
        states = d * B_t[t0:t1, :, None, :] * x_t[t0:t1, :, :, None]  # dt·B·x, then h
        if records_grad(states):  # each step's state stays for the backward
            hs = []
            for h_t, a_t in zip(states.unbind(0), decay.unbind(0)):
                h = torch.addcmul(h_t, a_t, h)
                hs.append(h)
            states = torch.stack(hs)
        else:
            for h_t, a_t in zip(states.unbind(0), decay.unbind(0)):
                h = h_t.addcmul_(a_t, h)
        ys[t0:t1] = torch.matmul(states, C_t[t0:t1, :, :, None])[..., 0]
    return ys.transpose(0, 1)


def mamba1_apply(params: Mamba1, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B,S,D) → (B,S,D): in_proj, causal conv, the selective scan
    (:func:`mamba1_scan`), ``+ D·x``, the ``silu(z)`` gate, out_proj."""
    st = cfg.ssm.state
    di, r = cfg.ssm.expand * cfg.d_model, dt_rank(cfg)
    xi, z = dense(x, params.in_proj).split(di, dim=-1)
    xi = F.silu(causal_conv(xi, params.conv_w, params.conv_b))
    dt_in, B, C = dense(xi, params.x_proj).split([r, st, st], dim=-1)
    dt = F.softplus(dense(dt_in, params.dt_proj) + params.dt_bias)  # (B,S,di) in x's dtype
    A = -torch.exp(params.A_log)
    xf = xi.float()
    y = mamba1_scan(dt.float(), A, B.float(), C.float(), xf)
    y = y + params.D * xf
    return dense(y.to(x.dtype) * F.silu(z), params.out_proj)


def mamba1_init_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, s.conv - 1, di), dtype=dtype, device=device),
        "h": torch.zeros((batch, di, s.state), dtype=torch.float32, device=device),
    }


def mamba1_decode(params: Mamba1, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """One token (B,1,D) → ((B,1,D), the new cache): O(1) state."""
    st = cfg.ssm.state
    di, r = cfg.ssm.expand * cfg.d_model, dt_rank(cfg)
    xi, z = (x @ params.in_proj).split(di, dim=-1)  # (B,1,di) each
    window = torch.cat([cache["conv"], xi], dim=1)  # (B,K,di)
    xi1 = F.silu(_conv_step(window, params.conv_w, params.conv_b))  # (B,di)
    dt_in, B, C = (xi1 @ params.x_proj).split([r, st, st], dim=-1)
    dt = F.softplus(dt_in @ params.dt_proj + params.dt_bias).float()  # (B,di)
    A = -torch.exp(params.A_log)
    xf = xi1.float()
    dA = torch.exp(dt[:, :, None] * A[None])
    dBx = dt[:, :, None] * B.float()[:, None, :] * xf[:, :, None]
    h = dA * cache["h"] + dBx
    y = torch.matmul(h, C.float()[:, :, None])[..., 0] + params.D * xf
    y = y.to(x.dtype)[:, None, :] * F.silu(z)
    return y @ params.out_proj, {"conv": window[:, 1:, :], "h": h}


# ---------------------------------------------------------------------------
# Mamba-2 (SSD, multi-head scalar-A)
# ---------------------------------------------------------------------------


class Mamba2(nn.Module):
    """``in_proj (d, 2di + 2N + nh)`` (fused: z, x, B, C, dt), ``conv_w (K,
    di + 2N)``, ``conv_b``, ``A_log``, ``dt_bias`` and ``D`` (nh,) in
    float32, ``norm_scale (di,)``, ``out_proj (di, d)``; the dense weights
    uninitialized until :meth:`reset_parameters` or ``load_state_dict``,
    the rest set to the reference's constants."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        s, d = cfg.ssm, cfg.d_model
        di = s.expand * d
        nh = di // s.headdim
        self.in_proj = param((d, 2 * di + 2 * s.state + nh), dtype, device)
        self.conv_w = param((s.conv, di + 2 * s.state), dtype, device)
        self.conv_b = param((di + 2 * s.state,), dtype, device)
        self.A_log = param((nh,), torch.float32, device)
        self.dt_bias = param((nh,), torch.float32, device)
        self.D = param((nh,), torch.float32, device)
        self.norm_scale = param((di,), dtype, device)
        self.out_proj = param((di, d), dtype, device)
        self._constants()

    @torch.no_grad()
    def _constants(self) -> None:
        self.conv_w.fill_(1.0 / self.cfg.ssm.conv)
        self.conv_b.zero_()
        self.A_log.zero_()
        self.dt_bias.fill_(0.5)
        self.D.fill_(1.0)
        self.norm_scale.fill_(1.0)

    def reset_parameters(self, generator: torch.Generator) -> None:
        dense_init_(self.in_proj, generator, self.cfg.d_model)
        dense_init_(self.out_proj, generator, self.out_proj.shape[0])
        self._constants()


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) → (..., T, T): ``[t, s] = a_{s+1} + … + a_t`` for s ≤ t (0 on
    the diagonal) as a cumulative sum down masked columns, −inf above."""
    t = a.shape[-1]
    ones = torch.ones((t, t), dtype=torch.bool, device=a.device)
    seg = a[..., :, None].expand(*a.shape, t).masked_fill(~ones.tril(-1), 0.0).cumsum(dim=-2)
    return seg.masked_fill_(~ones.tril(), -math.inf)


def mamba2_scan(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """The scan of Mamba-2 in the chunked SSD form, float32: dt (b, S, nh),
    A (nh,), B and C (b, S, N), x (b, S, nh, hd) → ``y_t = h_t·C_t`` (b, S,
    nh, hd), where ``h_t = exp(dt_t·A)·h_{t-1} + (dt_t·x_t) ⊗ B_t`` from
    ``h_{-1} = 0``.  S in chunks of ``SSD_CHUNK`` steps, the last padded
    with dt = 0 (no decay, no input)."""
    b, s, nh, hd = x.shape
    n = B.shape[-1]
    q = SSD_CHUNK
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        dt, B, C, x = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (dt, B, C, x))
    a = (dt * A).view(b, nc, q, nh).permute(0, 3, 1, 2)  # (b, nh, nc, q)
    xdt = (dt[..., None] * x).view(b, nc, q, nh, hd).permute(0, 3, 1, 2, 4)  # (b,nh,nc,q,hd)
    Bc, Cc = B.view(b, 1, nc, q, n), C.view(b, 1, nc, q, n)
    decay = torch.exp(_segsum(a))  # (b, nh, nc, q, q): step s's weight at step t
    # within a chunk: y_t += Σ_{s≤t} decay[t,s] (C_t·B_s) dt_s x_s
    y = torch.matmul(decay * torch.matmul(Cc, Bc.transpose(-1, -2)), xdt)
    # each chunk's own end state Σ_s decay[q-1,s] (dt_s x_s) ⊗ B_s  (b,nh,nc,hd,N)
    own = torch.matmul((xdt * decay[..., -1, :, None]).transpose(-1, -2), Bc)
    # the state entering each chunk: the earlier chunks' own states, decayed
    # (entry k of ``totals`` is chunk k−1's Σ a; carry[c, c'] decays chunk
    # c''s end state through chunks c'+1 … c−1, 0 for c' ≥ c)
    totals = F.pad(a.sum(dim=-1), (1, 0))  # (b, nh, nc+1)
    carry = torch.exp(_segsum(totals))[..., :-1, 1:]  # (b, nh, nc, nc)
    entering = torch.matmul(carry, own.reshape(b, nh, nc, hd * n)).view(b, nh, nc, hd, n)
    y = y + torch.matmul(Cc, entering.transpose(-1, -2)) * torch.exp(a.cumsum(dim=-1))[..., None]
    return y.permute(0, 2, 3, 1, 4).reshape(b, nc * q, nh, hd)[:, :s]


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Mamba-2's gated RMSNorm: ``y·silu(z)`` in y's dtype, normalized in
    float32 (eps 1e-6), cast back, then times ``scale``."""
    y = y * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + GATED_NORM_EPS)).to(y.dtype)
    return y * scale


def mamba2_apply(params: Mamba2, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B,S,D) → (B,S,D): the fused in_proj, causal conv over x, B and C,
    the SSD scan (:func:`mamba2_scan`), ``+ D·x``, the gated RMSNorm,
    out_proj."""
    s_cfg = cfg.ssm
    b, s, _ = x.shape
    di, hd, st = s_cfg.expand * cfg.d_model, s_cfg.headdim, s_cfg.state
    nh = di // hd
    z, xBC, dt_in = dense(x, params.in_proj).split([di, di + 2 * st, nh], dim=-1)
    xBC = F.silu(causal_conv(xBC, params.conv_w, params.conv_b))
    xi, B, C = xBC.split([di, st, st], dim=-1)
    dt = F.softplus(dt_in.float() + params.dt_bias)  # (B,S,nh) float32
    A = -torch.exp(params.A_log)
    xh = xi.reshape(b, s, nh, hd).float()
    y = mamba2_scan(dt, A, B.float(), C.float(), xh)
    y = (y + params.D[:, None] * xh).reshape(b, s, di).to(x.dtype)
    return dense(_gated_rmsnorm(y, z, params.norm_scale), params.out_proj)


def mamba2_init_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.headdim
    return {
        "conv": torch.zeros((batch, s.conv - 1, di + 2 * s.state), dtype=dtype, device=device),
        "h": torch.zeros((batch, nh, s.headdim, s.state), dtype=torch.float32, device=device),
    }


def mamba2_decode(params: Mamba2, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """One token (B,1,D) → ((B,1,D), the new cache): O(1) state."""
    s_cfg = cfg.ssm
    b = x.shape[0]
    di, hd, st = s_cfg.expand * cfg.d_model, s_cfg.headdim, s_cfg.state
    nh = di // hd
    z, xBC, dt_in = (x @ params.in_proj).split([di, di + 2 * st, nh], dim=-1)
    window = torch.cat([cache["conv"], xBC], dim=1)
    xi, B, C = F.silu(_conv_step(window, params.conv_w, params.conv_b)).split([di, st, st],
                                                                              dim=-1)
    dt = F.softplus(dt_in.float()[:, 0] + params.dt_bias)  # (B,nh)
    A = -torch.exp(params.A_log)
    xh = xi.reshape(b, nh, hd).float()
    dA = torch.exp(dt * A[None])
    h = (dA[:, :, None, None] * cache["h"]
         + (dt[:, :, None, None] * xh[:, :, :, None]) * B.float()[:, None, None, :])
    y = torch.matmul(h, C.float()[:, None, :, None])[..., 0] + params.D[None, :, None] * xh
    y = y.reshape(b, 1, di).to(x.dtype)
    return _gated_rmsnorm(y, z, params.norm_scale) @ params.out_proj, {"conv": window[:, 1:, :],
                                                                       "h": h}
