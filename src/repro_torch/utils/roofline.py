"""Roofline of one NVIDIA H100 SXM, and the bounds that ``chip_smoke.py``
sets beside every kernel.

Peaks from NVIDIA's data sheet (SXM part, dense rates, at the full power
limit of 700 W; a card set below it runs slower under load):

    BF16_TC_FLOPS   989e12   bf16 on the tensor cores
    FP32_FLOPS       67e12   float32 outside the tensor cores
    HBM_BYTES_PER_S 3.35e12  HBM3
    NVLINK_BYTES_PER_S 450e9 NVLink, each way, to the other cards of a host

Terms of a step (seconds, per device):

    compute    = flops / BF16_TC_FLOPS
    memory     = bytes / HBM_BYTES_PER_S
    collective = collective bytes / NVLINK_BYTES_PER_S

Every count given to :class:`Roofline` is already per device: the dry run
(``repro_torch.launch.dryrun``) divides its global counts by the chips
once, and nothing here divides again.  (The reference's printed line
divided its per-device counts by the chips a second time.)

The collective term is a lower bound: a 16-wide mesh axis spans two hosts
of 8 cards, and the link between hosts is slower than NVLink.

Collective bytes (:func:`collective_bytes`) are counted from the sharding
specs, per device, with ring algorithms over an axis of ``n`` devices
(an all-gather or reduce-scatter of ``N`` bytes moves ``(n-1)/n · N``
bytes through each device, an all-reduce twice that, an all-to-all of
``N`` bytes a device ``(n-1)/n · N``):

- FSDP over ``data``: each parameter sharded over ``data`` is gathered
  over ``data`` once a forward, and in a train step once more for the
  backward, and its gradient is reduce-scattered over ``data``; with a
  ``pod`` axis, each device's gradient shard is all-reduced over ``pod``
  once a train step (parameters are replicated across pods);
- tensor parallelism over ``model``: each block whose output projection
  (``wo``, ``out_proj``) is sharded over ``model`` all-reduces its output
  activations once a forward, twice in a train step (the backward
  all-reduces their gradient);
- expert parallelism over ``model``: each MoE layer whose experts are
  sharded over ``model`` sends its routed tokens (``top_k`` copies of a
  token's activations) through one all-to-all to the experts and one back,
  a forward; twice as many in a train step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

BF16_TC_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9


def bound_ms(nbytes: float) -> float:
    """Least time to move ``nbytes`` at the card's memory rate.  Every
    kernel here does a few float32 operations per 4–8 bytes it must move,
    far below the H100's 20 operations per byte of float32 rate over
    memory rate, so each is bound by bytes."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def attention_pairs(sq, sk, causal, window) -> int:
    """Live (query, key) pairs of one head: the work this input needs."""
    row = np.arange(sq)
    hi = np.minimum(row, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(row - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_flops(b, hq, sq, sk, dh, causal, window) -> int:
    """Operations of one attention call: ``4·dh`` a live (q, k) pair of a
    head (``2·dh`` for q·k, ``2·dh`` for p·v)."""
    return 4 * dh * b * hq * attention_pairs(sq, sk, causal, window)


def flash_bound(q, k, causal, window) -> tuple[float, str, float, float]:
    """Least time of one attention call: :func:`flash_flops` over the
    dtype's peak, against each operand read once and the output written
    once over the memory rate.  Returns (ms, bound_by, flops, bytes)."""
    b, hq, sq, dh = q.shape
    _, hkv, sk, _ = k.shape
    flops = float(flash_flops(b, hq, sq, sk, dh, causal, window))
    nbytes = q.element_size() * (2 * b * hq * sq * dh + 2 * b * hkv * sk * dh)
    peak = BF16_TC_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    ops_ms, bytes_ms = flops / peak * 1e3, bound_ms(nbytes)
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes


@dataclasses.dataclass
class Roofline:
    """The three terms of a step from per-device counts (every model of the
    repo runs in bf16)."""

    flops: float
    bytes_accessed: float
    collective_bytes: float

    @property
    def t_compute(self) -> float:
        return self.flops / BF16_TC_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BYTES_PER_S

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / NVLINK_BYTES_PER_S

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """The step's least time if the three overlap perfectly; without
        overlap it is their sum."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def row(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "step_time_s": self.step_time,
        }



def roofline_line(row: dict) -> str:
    """The printed roofline line of a row (:meth:`Roofline.row`, or a dry-run
    record that holds one): the line and the row cannot disagree."""
    return (f"roofline: compute={row['t_compute_s']:.4f}s memory={row['t_memory_s']:.4f}s "
            f"collective={row['t_collective_s']:.4f}s dominant={row['dominant']}")


def model_flops_train(n_params: float, tokens: float) -> float:
    return 6.0 * n_params * tokens


def model_flops_decode(n_params: float, tokens: float) -> float:
    return 2.0 * n_params * tokens


def _ring(n: int) -> float:
    return (n - 1) / n if n > 1 else 0.0


def collective_bytes(tensors, mesh: dict, *, train: bool, d_model: int, act_bytes: int,
                     top_k: int = 0) -> dict:
    """Per-device collective bytes of one step by the rules of this module's
    docstring.  ``tensors`` are ``(name, shape, itemsize, spec,
    act_tokens)`` of the parameters the step reads: the name without a
    layer index, ``/``-separated (:func:`repro_torch.sharding.rules.rule_path`),
    the spec of :func:`repro_torch.sharding.rules.param_spec`, and the
    tokens a device's share of the block's output holds, summed over the
    block's applications in one forward (0 where the tensor is no block's
    output projection).  ``mesh`` is the named axis sizes, ``act_bytes``
    an activation element's bytes, ``top_k`` an MoE config's experts a
    token.  Returns the bytes by kind and their ``total``."""
    from repro_torch.sharding.rules import spec_axes

    n_data, n_model, n_pod = (mesh.get(a, 1) for a in ("data", "model", "pod"))
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0, "all-to-all": 0.0}
    passes = 2 if train else 1
    for name, shape, itemsize, spec, act_tokens in tensors:
        axes = spec_axes(spec)
        per_device = float(np.prod(shape, dtype=np.float64)) * itemsize
        per_device /= float(np.prod([mesh[a] for a in axes], dtype=np.float64))
        if "data" in axes:
            gathered = per_device * n_data  # the tensor's share of one data group
            out["all-gather"] += passes * _ring(n_data) * gathered
            if train:
                out["reduce-scatter"] += _ring(n_data) * gathered
        if train and n_pod > 1:
            out["all-reduce"] += 2 * _ring(n_pod) * per_device
        if "model" not in axes or not act_tokens:
            continue
        act = float(act_tokens) * d_model * act_bytes
        if top_k and len(shape) == 3 and name.endswith("mlp/wo") and spec[0] == "model":
            out["all-to-all"] += 2 * passes * _ring(n_model) * top_k * act  # EP
        elif name.rsplit("/", 1)[-1] in ("wo", "out_proj"):
            out["all-reduce"] += passes * 2 * _ring(n_model) * act
    out["total"] = sum(out.values())
    return out
