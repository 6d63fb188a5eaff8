"""Training step, the reference's ``training/train_step.py``: the causal-LM
loss through the fused chunked cross entropy, its gradients, AdamW.

The model (a :class:`~repro_torch.models.model.DecoderLM`) is trained in
place: its parameters require grad (:func:`init_train_state` turns that
on; inference models keep it off), the loss runs the plain attention
route (the flash kernel has no backward; the reference's ``loss_fn``
runs its jnp attention too), ``torch.autograd`` gives the gradients and
:func:`~repro_torch.training.optimizer.adamw_update` writes the new
values.  :func:`loss_fn` calls ``forward`` with its default
``remat=True``, as the reference's does: every layer body is
rematerialized (``models/remat.py``), keeping only its input and the
products the reference's ``dots_with_no_batch_dims_saveable`` keeps.
Left out of the port, as nothing in it reaches them: the unchunked
``cross_entropy`` and ``layer_unroll``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import records_grad
from repro_torch.models.model import DecoderLM, forward, init_params, unembed
from repro_torch.training.optimizer import AdamWConfig, OptState, adamw_update, init_opt_state


class TrainState(NamedTuple):
    params: DecoderLM
    opt: OptState


def init_train_state(cfg: ModelConfig, generator: torch.Generator | None = None, *,
                     device=None, params: DecoderLM | None = None) -> TrainState:
    """A model to train, its parameters requiring grad, and zero AdamW
    state: ``params`` where given (tests carry the reference's weights in),
    else :func:`~repro_torch.models.model.init_params` from ``generator``
    on ``device`` (``cuda`` by default)."""
    if params is None:
        params = init_params(cfg, generator, device=device)
    params.requires_grad_(True)
    return TrainState(params=params, opt=init_opt_state(dict(params.named_parameters())))


def _chunk_ce(cfg: ModelConfig, params: DecoderLM, feats: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Σ over the chunk of ``logsumexp(logits) − logits[label]``: the head
    in float32 (``unembed``), the padded vocab columns masked to −1e30."""
    logits = unembed(cfg, params, feats)  # (B, chunk, Vpad) float32
    vpad = logits.shape[-1]
    if vpad > cfg.vocab:
        pad = torch.arange(vpad, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum(lse - gold)


def fused_chunked_ce(cfg: ModelConfig, params: DecoderLM, feats: torch.Tensor,
                     labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mean cross entropy of ``labels (B, S)`` under the head applied to the
    pre-head ``feats (B, S, d)`` one sequence chunk at a time, so that the
    ``(B, S, Vpad)`` float32 logits never exist whole.  As the reference:
    ``n = max(1, S // chunk)`` chunks of ``S // n`` positions, the tail past
    ``n`` chunks left out.  Where autograd records, each chunk's head and
    loss are recomputed in the backward (``torch.utils.checkpoint``), so
    its logits are not kept for it either; the numbers are the same."""
    b, s, _ = feats.shape
    n = max(1, s // chunk)
    chunk = s // n
    tot = torch.zeros((), dtype=torch.float32, device=feats.device)
    for i in range(n):
        f, lb = feats[:, i * chunk:(i + 1) * chunk], labels[:, i * chunk:(i + 1) * chunk]
        if records_grad(f):
            tot = tot + checkpoint(_chunk_ce, cfg, params, f, lb, use_reentrant=False)
        else:
            tot = tot + _chunk_ce(cfg, params, f, lb)
    return tot / (b * n * chunk)


def loss_fn(params: DecoderLM, cfg: ModelConfig, batch: dict, *, moe_dispatch: str = "sparse",
            ce_chunk: Optional[int] = 512) -> torch.Tensor:
    """Next-token loss of ``batch["tokens"] (B, S)`` (whisper: with
    ``batch["frames"]``): the features of positions ``0..S-2`` against the
    tokens ``1..S-1``, through :func:`fused_chunked_ce` in chunks of
    ``ce_chunk`` (None: one chunk).  The plain attention route."""
    kw = {"frames": batch["frames"]} if cfg.encoder else {}
    feats = forward(cfg, params, batch["tokens"], moe_dispatch=moe_dispatch,
                    use_flash_kernel=False, features_only=True, **kw)
    return fused_chunked_ce(cfg, params, feats[:, :-1], batch["tokens"][:, 1:],
                            ce_chunk or feats.shape[1])


def loss_and_grads(params: DecoderLM, cfg: ModelConfig, batch: dict, **kw):
    """The loss and the gradient of every named parameter (zeros for one
    the loss does not reach, as ``jax.grad`` gives)."""
    named = dict(params.named_parameters())
    loss = loss_fn(params, cfg, batch, **kw)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip(named, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(), *,
                    moe_dispatch: str = "sparse", ce_chunk: Optional[int] = 512):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss and
    gradients, then one AdamW step written into ``state.params`` in place.
    ``metrics``: ``loss``, ``grad_norm`` (before clipping) and ``step``,
    tensors on the device."""

    def train_step(state: TrainState, batch: dict):
        loss, grads = loss_and_grads(state.params, cfg, batch, moe_dispatch=moe_dispatch,
                                     ce_chunk=ce_chunk)
        named = dict(state.params.named_parameters())
        opt, gnorm = adamw_update(opt_cfg, named, grads, state.opt)
        return TrainState(params=state.params, opt=opt), {
            "loss": loss, "grad_norm": gnorm, "step": opt.step}

    return train_step
