"""No-Sync data parallelism, the reference's ``training/local_sgd.py``: the
paper's removal of the per-iteration barrier applied to LM training.

* **local SGD / bounded-staleness DP**: each of ``R`` replicas takes ``H``
  optimizer steps on its own batches with its own AdamW state, then the
  replicas are averaged: one exchange a ``H`` steps in place of one a
  step.
* **compressed outer sync**: each replica's delta from the centre is
  quantized to int8 with a per-tensor scale and error feedback (the
  quantization error re-enters the next round), 4x fewer bytes to move.
  A tensor is one of the reference's leaves: its layers stacked, so the
  port takes one scale over a parameter's every layer
  (:func:`leaf_name`).

The reference keeps the replicas in a leading ``R`` dim sharded over its
``pod`` mesh axis.  The port keeps them on one device as a list of models
and states, as ``core.distributed.ShardMesh`` keeps its shards: the
arithmetic of the sync is the reference's, the exchange a mean over the
list.
"""
from __future__ import annotations

import copy
import re
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.training.optimizer import AdamWConfig, OptState, adamw_update
from repro_torch.training.train_step import TrainState, loss_and_grads


class LocalSGDState(NamedTuple):
    params_r: list  # R models, one a replica
    opt_r: list  # R OptStates
    error_fb: list  # R dicts name → float32 error-feedback buffer
    outer_step: torch.Tensor  # int32, 0-d


def _clone_opt(opt: OptState) -> OptState:
    return OptState(m={k: t.clone() for k, t in opt.m.items()},
                    v={k: t.clone() for k, t in opt.v.items()}, step=opt.step.clone())


def replicate_state(state: TrainState, n_replicas: int) -> LocalSGDState:
    """``n_replicas`` copies of the model and its AdamW state, zero error
    buffers, outer step 0."""
    params_r = [copy.deepcopy(state.params) for _ in range(n_replicas)]
    opt_r = [_clone_opt(state.opt) for _ in range(n_replicas)]
    err = [{k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in state.params.named_parameters()} for _ in range(n_replicas)]
    return LocalSGDState(params_r, opt_r, err,
                         torch.zeros((), dtype=torch.int32, device=state.opt.step.device))


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 ``round(x / scale)`` (half to even, as ``jnp.round``) clipped to
    ±127, with ``scale = max(max|x|, 1e-12) / 127`` in float32."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def leaf_name(name: str) -> str:
    """The reference's leaf of a parameter: its layer index dropped
    (``layers.3.attn.wq`` → ``layers.attn.wq``), as the reference stacks a
    leaf's layers in one array (a hybrid's ``(n_groups, g)`` of them)."""
    return re.sub(r"^(enc_layers|layers)\.\d+\.", r"\1.", name)


@torch.no_grad()
def _sync(p_r: list[list[torch.Tensor]], err: list[list[torch.Tensor]], compress: bool):
    """The outer sync of one reference leaf: ``p_r[r]`` holds replica
    ``r``'s tensors of the leaf (one a layer), ``err[r]`` their error
    buffers.  Each tensor becomes the centre of its replicas plus the mean
    of their float32 deltas from it, written into every replica in its
    dtype; with ``compress`` each replica's deltas are int8-quantized with
    one scale over the whole leaf, as the reference's per-tensor scale
    over its stacked array, and the quantization error is fed back.
    Returns the new error buffers, ``[r][i]``."""
    n_rep = len(p_r)
    stacked = [torch.stack([p_r[r][i].float() for r in range(n_rep)]) for i in range(len(p_r[0]))]
    centers = [torch.mean(s, dim=0, keepdim=True) for s in stacked]
    deltas = [s - c + torch.stack([err[r][i] for r in range(n_rep)])
              for i, (s, c) in enumerate(zip(stacked, centers))]
    if compress:
        sizes = [d[0].numel() for d in deltas]
        deq = []
        for r in range(n_rep):
            flat = torch.cat([d[r].reshape(-1) for d in deltas])
            deq.append(dequantize_int8(*quantize_int8(flat)).split(sizes))
        deq = [torch.stack([deq[r][i] for r in range(n_rep)]).reshape(d.shape)
               for i, d in enumerate(deltas)]
        new_err = [d - q for d, q in zip(deltas, deq)]
        deltas = deq
    else:
        new_err = [torch.zeros_like(d) for d in deltas]
    for i, (c, d) in enumerate(zip(centers, deltas)):
        avg = c[0] + torch.mean(d, dim=0)
        for r in range(n_rep):
            p_r[r][i].copy_(avg)
    return [[e[r] for e in new_err] for r in range(n_rep)]


def make_local_sgd_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(), *,
                        inner_steps: int = 4, compress: bool = True,
                        moe_dispatch: str = "sparse"):
    """Returns ``step(state, batches) -> (state, metrics)``.

    ``batches``: a dict of tensors with leading dims ``(R, H, local_batch,
    ...)``.  One call: ``H`` inner steps on each replica (the reference's
    ``loss_fn`` at its default ``ce_chunk``), then one outer sync of every
    parameter.  ``metrics``: the mean loss of the ``R·H`` inner steps and
    the outer step."""

    def step(state: LocalSGDState, batches: dict):
        losses, opt_r = [], []
        for r, (params, opt) in enumerate(zip(state.params_r, state.opt_r, strict=True)):
            for h in range(inner_steps):
                batch = {k: t[r, h] for k, t in batches.items()}
                loss, grads = loss_and_grads(params, cfg, batch, moe_dispatch=moe_dispatch)
                opt, _ = adamw_update(opt_cfg, dict(params.named_parameters()), grads, opt)
                losses.append(loss)
            opt_r.append(opt)
        named_r = [dict(p.named_parameters()) for p in state.params_r]
        leaves: dict[str, list[str]] = {}
        for name in named_r[0]:
            leaves.setdefault(leaf_name(name), []).append(name)
        new_err = [dict() for _ in state.params_r]
        for names in leaves.values():
            errs = _sync([[n[k] for k in names] for n in named_r],
                         [[e[k] for k in names] for e in state.error_fb], compress)
            for r, errs_r in enumerate(errs):
                new_err[r].update(zip(names, errs_r))
        outer = state.outer_step + 1
        metrics = {"loss": torch.mean(torch.stack(losses)), "outer_step": outer}
        return LocalSGDState(state.params_r, opt_r, new_err, outer), metrics

    return step
