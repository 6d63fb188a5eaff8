"""AdamW with global-norm clipping, the reference's ``training/optimizer.py``
over a model's named parameters (no external optimizer).

The state is float32 ``m`` and ``v`` per parameter name and an int32
``step`` on the parameters' device.  As in the reference: the gradients
are clipped to ``grad_clip`` by their global norm; the learning rate's
linear warm-up reads the step before its increment, the bias corrections
the step after it; the update runs in float32 and is cast back to each
parameter's dtype; weight decay applies to every parameter, norms and
embeddings included.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


class OptState(NamedTuple):
    m: dict  # name → float32 first moment
    v: dict  # name → float32 second moment
    step: torch.Tensor  # int32, 0-d


def init_opt_state(params: Mapping[str, torch.Tensor]) -> OptState:
    """Zero moments in float32 for every parameter of ``params`` (a name →
    tensor mapping, e.g. ``dict(model.named_parameters())``), step 0."""
    m = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
    v = {k: torch.zeros_like(t) for k, t in m.items()}
    dev = next(iter(params.values())).device
    return OptState(m=m, v=v, step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``sqrt(Σ x²)`` over every tensor of ``tree``, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    """The gradients scaled to a global norm of at most ``max_norm``, in
    float32 (the reference's product of a gradient and its float32 scale
    promotes), and their norm before."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: g.float() * scale for k, g in grads.items()}, norm


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], opt: OptState) -> tuple[OptState, torch.Tensor]:
    """One AdamW step: writes the new values into the tensors of ``params``
    and the new moments into ``opt.m`` and ``opt.v`` (in place, so that a
    second copy of the float32 moments never exists: 22 GB of them for
    stablelm-3b) and returns the state with the new step, and the
    gradients' global norm before clipping.  Each parameter's clipped
    float32 gradient is made when its turn comes, so the float32 copies of
    all the gradients never exist at once either.  The same operations in
    the same order as the reference's."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = opt.step + 1
    lr = _schedule(cfg, opt.step)
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)
    for name, p in params.items():
        g = grads[name].float() * scale
        m = opt.m[name].mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v = opt.v[name].mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        p32 = p.float()
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * upd)
    return OptState(m=opt.m, v=opt.v, step=step), gnorm
