"""Analytic FLOP and byte estimates per (arch × shape) cell, the
reference's ``utils/flops.py``: a cross-check on the dry run's counted
numbers.  All counts are GLOBAL (divide by chips for per-device).

Conventions: a matmul of (m,k)@(k,n) = 2mkn FLOPs; backward = 2× forward;
remat (full-layer rematerialization) = +1× forward; causal attention = ½.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import ShapeSpec
from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class CellEstimate:
    matmul_flops: float
    attention_flops: float
    ssm_scan_bytes: float  # HBM traffic of the time recurrence

    @property
    def total_flops(self) -> float:
        return self.matmul_flops + self.attention_flops


def _param_flops_per_token(cfg: ModelConfig) -> float:
    """2 × active params touched per token (matmul fwd)."""
    from repro_torch.launch.specs import count_params

    total, active = count_params(cfg)
    return 2.0 * active


def estimate_cell(cfg: ModelConfig, shape: ShapeSpec, *, remat: bool = True) -> CellEstimate:
    b, s = shape.global_batch, shape.seq_len
    train = shape.kind == "train"
    tokens = b * (s if shape.kind != "decode" else 1)

    mm = _param_flops_per_token(cfg) * tokens
    if train:
        mm *= 3.0  # fwd + bwd
        if remat:
            mm *= 4.0 / 3.0  # extra forward

    # attention score/value flops
    attn = 0.0
    if cfg.attn != "none":
        dh = cfg.resolved_head_dim
        h = cfg.n_heads
        if cfg.attn == "mla":
            dh = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        n_attn_layers = cfg.n_layers
        if cfg.hybrid_attn_every:
            n_attn_layers = cfg.n_layers // cfg.hybrid_attn_every
        if shape.kind == "decode":
            ctx = min(s, cfg.window) if cfg.attn == "swa" and cfg.window else s
            attn = n_attn_layers * 4.0 * b * ctx * h * dh
        else:
            eff = s if cfg.window is None else min(s, cfg.window * 2)
            causal = 0.5
            attn = n_attn_layers * 4.0 * b * s * eff * h * dh * causal
            if train:
                attn *= 3.0 * (4.0 / 3.0 if remat else 1.0)

    # SSM recurrence HBM traffic (state read+write per step)
    ssm_bytes = 0.0
    if cfg.ssm:
        di = cfg.ssm.expand * cfg.d_model
        state_bytes = b * di * cfg.ssm.state * 4.0 * 3.0  # read h, write h, inputs
        steps = s if shape.kind != "decode" else 1
        n_ssm_layers = cfg.n_layers
        ssm_bytes = n_ssm_layers * steps * state_bytes
        if train:
            ssm_bytes *= 3.0

    return CellEstimate(matmul_flops=mm, attention_flops=attn, ssm_scan_bytes=ssm_bytes)
