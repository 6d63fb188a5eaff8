"""Feed-forward blocks: the SwiGLU or GELU MLP, as ``cfg.mlp`` says, and the
top-k Mixture of Experts of mixtral-8x22b and deepseek-v2-236b (with its
shared experts), in the reference's two dispatches: dense (every token
through every expert, weighted by its gates) and sparse (each expert takes
at most a capacity of token slots; the rest are dropped).

The expert products are plain torch matrix products, as they are jnp
einsums outside any Pallas kernel in the reference.  The products whose
reference einsum has no batch dimension (the MLP's, the router's, the
dense dispatch's ``wi`` and ``wg``) go through ``remat.dense``, which a
checkpointed layer keeps for its backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init_, param, records_grad
from repro_torch.models.remat import dense


class MLP(nn.Module):
    """``wi (d, f)``, ``wg (d, f)`` (SwiGLU only) and ``wo (f, d)``, in the
    reference's layout, ``f = d_ff`` or ``cfg.d_ff``; uninitialized until
    :meth:`reset_parameters` or ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, d_ff: int | None = None):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.wi = param((d, f), dtype, device)
        if cfg.mlp == "swiglu":
            self.wg = param((d, f), dtype, device)
        self.wo = param((f, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        dense_init_(self.wi, generator, self.cfg.d_model)
        if self.cfg.mlp == "swiglu":
            dense_init_(self.wg, generator, self.cfg.d_model)
        dense_init_(self.wo, generator, self.wo.shape[0])


def mlp_init(cfg: ModelConfig, dtype, *, generator: torch.Generator,
             device: torch.device | str) -> MLP:
    m = MLP(cfg, dtype=dtype, device=device)
    m.reset_parameters(generator)
    return m


def mlp_apply(params: MLP, x: torch.Tensor) -> torch.Tensor:
    """``silu(x·wg) · (x·wi) · wo`` (SwiGLU), else ``gelu(x·wi) · wo`` with
    the tanh approximation, which ``jax.nn.gelu`` takes by default."""
    h = dense(x, params.wi)
    if params.cfg.mlp == "swiglu":
        h = F.silu(dense(x, params.wg)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return dense(h, params.wo)


# ---------------------------------------------------------------------------
# Mixture of Experts (mixtral / deepseek-v2)
# ---------------------------------------------------------------------------


class MoE(nn.Module):
    """``router (d, E)`` in float32 whatever the model's dtype, as the
    reference keeps it; the SwiGLU experts ``wi``, ``wg (E, d, fe)`` and
    ``wo (E, fe, d)`` in the model's dtype; with ``n_shared`` shared
    experts, ``shared``, an :class:`MLP` of ``d_ff = fe · n_shared``.

    The reference stores the experts as ``(d, E, fe)`` and ``(fe, E, d)``;
    here the expert axis comes first, so that each expert's matrix is one
    contiguous block of a batched product (``convert.params_from_jax``
    moves the axis)."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        m = cfg.moe
        d, e, fe = cfg.d_model, m.n_experts, m.d_ff_expert
        self.router = param((d, e), torch.float32, device)
        self.wi = param((e, d, fe), dtype, device)
        self.wg = param((e, d, fe), dtype, device)
        self.wo = param((e, fe, d), dtype, device)
        if m.n_shared:
            self.shared = MLP(cfg, dtype=dtype, device=device, d_ff=fe * m.n_shared)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, fe = self.cfg.d_model, self.cfg.moe.d_ff_expert
        for w, fan_in in ((self.router, d), (self.wi, d), (self.wg, d), (self.wo, fe)):
            dense_init_(w, generator, fan_in)
        if self.cfg.moe.n_shared:
            self.shared.reset_parameters(generator)


def moe_init(cfg: ModelConfig, dtype, *, generator: torch.Generator,
             device: torch.device | str) -> MoE:
    m = MoE(cfg, dtype=dtype, device=device)
    m.reset_parameters(generator)
    return m


def moe_route(params: MoE, xf: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gates and experts ``(T, K)`` of the tokens ``xf (T, d)``: the softmax
    of ``x·router`` in float32, its top ``K`` (in descending order), the
    gates renormalised by ``max(sum, 1e-9)``."""
    weights = torch.softmax(dense(xf.float(), params.router), dim=-1)
    topw, topi = torch.topk(weights, top_k, dim=-1)
    return topw / topw.sum(-1, keepdim=True).clamp_min(1e-9), topi


def _experts(params: MoE, xe: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert ``e`` on its rows ``xe[e]`` (``(E, n, d)``, or
    ``(n, d)`` shared by all): ``(E, n, fe)``, before ``wo``.  The rows
    shared by all are the dense dispatch's ``bsd,def->bsef`` in the
    reference, products without a batch dimension (``remat.dense``); an
    expert's own rows are the sparse dispatch's ``ecd,def->ecf``, batched
    over the experts.  Out of place where autograd records (a kept product
    must not change)."""
    mm = dense if xe.dim() == 2 else torch.matmul
    h = mm(xe, params.wi)
    g = F.silu(mm(xe, params.wg))
    return h * g if records_grad(h) else h.mul_(g)


def moe_apply(params: MoE, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Dense-dispatch top-k MoE: every token through every expert, the
    outputs summed with the gates (zero outside the top k) cast to x's
    dtype.  Exact (no capacity drops).  The gate weighs each expert's
    SwiGLU rows before ``wo``, so the sum over experts is one product over
    ``E·fe``; the reference weighs ``wo``'s outputs, the same sum in
    another order."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    topw, topi = moe_route(params, xf, m.top_k)
    gate = torch.zeros((b * s, m.n_experts), device=x.device).scatter_(1, topi, topw)
    h = _experts(params, xf)  # (E, T, fe)
    g = gate.T.to(x.dtype)[:, :, None]
    h = h * g if records_grad(h) else h.mul_(g)
    out = torch.einsum("etf,efd->td", h, params.wo).reshape(b, s, d)
    if m.n_shared:
        out = out + mlp_apply(params.shared, x)
    return out


def expert_capacity(n_tok: int, cfg: ModelConfig, capacity_factor: float) -> int:
    """Token slots an expert takes in the sparse dispatch of ``n_tok``
    tokens, the reference's ``max(1, int(factor · T · K / E))``."""
    m = cfg.moe
    return max(1, int(capacity_factor * n_tok * m.top_k / m.n_experts))


def dispatch_slots(topi: torch.Tensor, cap: int) -> tuple[torch.Tensor, ...]:
    """Where the sparse dispatch puts each (token, k) pair of ``topi (T, K)``.

    The pairs, flattened in (token, k) order, are stably sorted by expert;
    a pair's slot is its place in its expert's run, and a pair at or past
    ``cap`` is dropped.  Returns ``order`` (the flat pair index of each
    sorted pair), the sorted experts, their slots and ``keep``."""
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    slot = (torch.arange(flat_e.numel(), device=topi.device)
            - torch.searchsorted(e_sorted, e_sorted, side="left"))
    return order, e_sorted, slot, slot < cap


def moe_apply_sparse(params: MoE, cfg: ModelConfig, x: torch.Tensor,
                     capacity_factor: float = 1.25) -> torch.Tensor:
    """Gathered-dispatch top-k MoE: each expert runs its
    ``cap = expert_capacity(T, cfg, capacity_factor)`` slots (the kept
    pairs of :func:`dispatch_slots`, the rest zero) as one batched product
    over ``(E, cap, d)``; a token's output sums its kept pairs' expert
    outputs, each times its gate cast to x's dtype, in k order.

    Every dropped pair writes its token's row to one spare slot ``cap`` of
    its expert, whose output is never read: so the kept pairs' slots are
    written once each, and nothing waits on the device for a count."""
    m = cfg.moe
    b, s, d = x.shape
    n_tok = b * s
    xf = x.reshape(n_tok, d)
    topw, topi = moe_route(params, xf, m.top_k)
    cap = expert_capacity(n_tok, cfg, capacity_factor)
    order, e_sorted, slot, keep = dispatch_slots(topi, cap)
    slot = torch.where(keep, slot, cap)
    tok = torch.div(order, m.top_k, rounding_mode="floor")
    buf = x.new_zeros((m.n_experts, cap + 1, d))
    buf[e_sorted, slot] = xf[tok]
    eo = torch.bmm(_experts(params, buf), params.wo)  # (E, cap + 1, d)
    contrib = eo[e_sorted, slot] * topw.reshape(-1)[order, None].to(x.dtype)
    pairs = torch.empty_like(contrib)
    pairs[order] = torch.where(keep[:, None], contrib, 0)
    out = pairs.view(n_tok, m.top_k, d).sum(dim=1).reshape(b, s, d)
    if m.n_shared:
        out = out + mlp_apply(params.shared, x)
    return out
