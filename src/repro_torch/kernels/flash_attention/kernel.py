"""Wrapper of the hand-written CUDA flash-attention kernel.

:func:`flash_attention_kernel` checks its operands and calls the
dispatcher op ``repro_torch::flash_attention``.  Its CUDA implementation
launches ``csrc/flash_attention.cu`` on the current stream, raises if the
launch fails and adds one to its count (:func:`launch_counts`).  Its CPU
implementation is the plain version
(:func:`repro_torch.kernels.flash_attention.ref.attention_ref`) — only
because the tensors lie on the CPU; there is no fallback from the card.
Its fake (meta) implementation gives the output's shape and dtype, so the
dry run (``repro_torch.launch.specs``) walks the kernel route on the meta
device; its FLOP formula (:func:`repro_torch.utils.roofline.flash_flops`)
is registered with ``torch.utils.flop_counter``, so a counting mode
(``repro_torch.utils.cost``) counts the kernel's work on the card, on the
CPU and on meta alike.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention import build
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.utils.roofline import flash_flops

# head dims the CUDA kernel is instantiated for (csrc/flash_attention.cu):
# 32 for the reduced configs, 64 for the reference's test matrix, 80 for
# stablelm-3b, 128 for starcoder2-3b, phi3-medium-14b and qwen2-vl-2b
HEAD_DIMS = (32, 64, 80, 128)
DTYPES = (torch.float32, torch.bfloat16)

_LAUNCHES = {"flash_attention": 0}


def launch_counts() -> dict[str, int]:
    """CUDA launches of the kernel since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (b, hq, sq, dh) and k, v (b, hkv, sk, dh); "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    b, hq, _, dh = q.shape
    _, hkv, sk, _ = k.shape
    if tuple(k.shape) != (b, hkv, sk, dh) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (b={b}, hkv, sk, dh={dh}) alike; got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads ({hq}) must be a multiple of kv heads ({hkv})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {DTYPES}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must lie on one device; got {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def flash_attention_kernel(
    q: torch.Tensor,  # (b, hq, sq, dh)
    k: torch.Tensor,  # (b, hkv, sk, dh)
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Attention forward ``softmax(mask(q·kᵀ·scale))·v`` with GQA (q head
    ``ih`` reads kv head ``ih // (hq // hkv)``), a causal and an optional
    sliding-``window`` mask (``qpos - kpos < window``), positions counted
    from 0 for q and k; float32 math, output in q's dtype.

    Replaces the TPU kernel ``flash_attention_kernel``
    (src/repro/kernels/flash_attention/kernel.py).  On a CUDA tensor it
    launches the kernel for any ``sq, sk`` (tails are masked in the
    kernel, so there is no block-divisibility fallback) and raises
    ``ValueError`` for a head dim outside :data:`HEAD_DIMS`.  The dtype
    picks the kernel inside the one entry point; both run ``wgmma`` on the
    tensor cores over TMA-fed tiles.  bfloat16 sums P as three exact bf16
    terms.  float32 first splits q, k and v into three bf16 terms each
    (exact: a float32 value's 24 bits) in scratch of
    ``flash_attention_scratch_bytes`` that :func:`launch` allocates, and
    keeps the six term products of Q·Kᵀ, and of P·V, that carry float32
    digits.  A failed build or launch raises.  Bound: operations, ``4·dh``
    flops per live (q, k) pair, at 989 TFLOP/s for bfloat16 and at a sixth
    of it for float32-accurate work (``roofline.flash_bound``); see the
    design note in ``csrc/flash_attention.cu``.

    Forward only, as the TPU kernel: with grad mode on and any of q, k, v
    requiring grad it raises ``RuntimeError`` on either device, so that a
    training call routed here fails instead of dropping the gradients of
    q, k and v.  The plain version is differentiable: training takes the
    plain route (``use_flash_kernel=False``)."""
    _check(q, k, v, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention has no backward: call it under torch.no_grad() "
                           "or take the plain route (use_flash_kernel=False) to train")
    if q.device.type != "cpu":  # the card, or meta standing in for it
        dh = q.shape[-1]
        if dh not in HEAD_DIMS:
            raise ValueError(f"head_dim {dh} is not supported by the CUDA flash "
                             f"kernel; supported: {HEAD_DIMS}")
        if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
            raise ValueError("q, k, v must be contiguous")
        if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("bfloat16 q, k, v must start on 16-byte boundaries "
                             "(the kernel's TMA tensor maps)")
    return flash_attention_op(q, k, v, float(scale), bool(causal), window)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cpu")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                       causal: bool, window: Optional[int]) -> torch.Tensor:
    """The dispatcher op behind :func:`flash_attention_kernel`, which checks
    its operands first; this body is its CPU implementation, the plain
    version, registered for the CPU alone (the CUDA kernel is
    :func:`_flash_attention_cuda`)."""
    return attention_ref(q, k, v, scale=scale, causal=causal, window=window)


@flash_attention_op.register_kernel("cuda")
def _flash_attention_cuda(q, k, v, scale, causal, window):
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    launch(build.load(), q, k, v, out, scale=scale, causal=causal, window=window)
    _LAUNCHES["flash_attention"] += 1
    return out


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, scale, causal, window):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, scale, causal, window, *,
                           out_shape=None, **kwargs) -> int:
    b, hq, sq, dh = q_shape
    return flash_flops(b, hq, sq, k_shape[2], dh, causal, window)


def launch(lib, q, k, v, out, *, scale: float, causal: bool, window: int | None) -> None:
    """One call of ``lib``'s ``flash_attention_fwd`` (a library of
    :func:`build.load`) on checked CUDA operands, writing ``out``, with the
    float32 kernel's scratch (its bf16 planes of q, k and v) allocated
    here; raises if the launch fails.  Counts nothing:
    :func:`flash_attention_kernel` is the port's launch."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    bf16 = int(q.dtype == torch.bfloat16)
    nbytes = lib.flash_attention_scratch_bytes(b, hq, hkv, sq, sk, dh, bf16)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device) if nbytes else None
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, hq, hkv, sq, sk, dh, bf16,
        float(scale), int(causal), -1 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with cudaError {err}")
