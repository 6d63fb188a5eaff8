"""The port's flash attention on the CPU, held against the JAX reference.

On CPU tensors ``flash_attention`` runs the plain version
(``attention_ref``), so both are held against the TPU kernel itself,
``flash_attention_kernel(..., interpret=True)``, over the reference's
``test_flash_attention_sweep`` matrix (f32/bf16 × (hq, hkv) ∈ {(4,4),
(4,2), (8,1)} × {causal, causal + window 64, full}; b 2, s 256, dh 64) at
its tolerances: 2e-5 (atol = rtol) in f32, 2e-2 in bf16 — bf16 outputs
are rounded once, and two implementations may round a value to
neighbouring bf16 numbers (one ulp is 2⁻⁷ relative).  Ragged and
``sq ≠ sk`` shapes, which the TPU kernel does not take, are held against
the reference's ``attention_ref`` at the same tolerances.  Inputs are
drawn with numpy from fixed seeds and given to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention_kernel as jax_flash_kernel
from repro_torch.kernels import nvcc
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS,
    attention_ref,
    build,
    flash_attention,
    launch_counts,
)
from repro_torch.kernels.spmv import build as spmv_build

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, hq, hkv, sq, sk, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, dh)).astype(np.float32))


def _port(arrays, dtype):
    return [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a, JNP[dtype]) for a in arrays]


def _close(out, ref, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64), (False, None)])
def test_flash_attention_matches_the_tpu_kernel(dtype, hq, hkv, causal, window):
    b, s, dh = 2, 256, 64
    arrays = _inputs(hq * 10 + hkv, b, hq, hkv, s, s, dh)
    ref = jax_flash_kernel(*_jax(arrays, dtype), scale=dh**-0.5, causal=causal,
                           window=window, block_q=64, block_k=64, interpret=True)
    q, k, v = _port(arrays, dtype)
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    _close(out, ref, dtype)
    _close(attention_ref(q, k, v, scale=dh**-0.5, causal=causal, window=window),
           ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (200, 200, True, None),
    (200, 200, True, 64),
    (200, 200, False, None),
    (96, 160, True, None),
    (160, 96, True, None),
    (96, 160, False, 48),
    (1, 37, False, None),
])
def test_ragged_shapes_match_the_reference(dtype, sq, sk, causal, window):
    b, hq, hkv, dh = 2, 4, 2, 32
    arrays = _inputs(sq + sk, b, hq, hkv, sq, sk, dh)
    ref = jax_attention_ref(*_jax(arrays, dtype), scale=dh**-0.5, causal=causal,
                            window=window)
    out = flash_attention(*_port(arrays, dtype), causal=causal, window=window)
    _close(out, ref, dtype)


def test_a_row_with_no_live_key_is_the_mean_of_v_in_the_plain_version():
    """With a window and sq > sk, row 9 of sq = 10 sees no key of sk = 4
    (9 - 3 >= window 6): both plain versions give the mean of v there (the
    kernels give 0; chip_smoke.py and the card tests avoid such rows)."""
    arrays = _inputs(7, 1, 2, 2, 10, 4, 32)
    ref = jax_attention_ref(*_jax(arrays, "float32"), scale=32**-0.5, window=6)
    q, k, v = _port(arrays, "float32")
    out = attention_ref(q, k, v, scale=32**-0.5, window=6)
    _close(out, ref, "float32")
    torch.testing.assert_close(out[:, :, 9], v.mean(dim=2), atol=1e-6, rtol=1e-6)


def test_default_scale_is_inverse_sqrt_head_dim():
    q, k, v = _port(_inputs(3, 1, 2, 1, 16, 16, 32), "float32")
    torch.testing.assert_close(flash_attention(q, k, v),
                               attention_ref(q, k, v, scale=32**-0.5),
                               atol=0, rtol=0)


def test_cpu_path_launches_no_kernel():
    q, k, v = _port(_inputs(4, 1, 2, 2, 8, 8, 32), "float32")
    before = launch_counts()
    flash_attention(q, k, v)
    assert launch_counts() == before


@pytest.mark.parametrize("case,match", [
    ("dtype", "dtype"),
    ("heads", "multiple"),
    ("shape", "alike"),
    ("rank", "b, hq, sq, dh"),
    ("window", "window"),
    ("device", "device"),
])
def test_flash_attention_rejects_bad_operands(case, match):
    q, k, v = _port(_inputs(5, 1, 4, 2, 8, 8, 32), "float32")
    kw = {}
    if case == "dtype":
        k = k.double()
    elif case == "heads":
        q = q[:, :3].contiguous()
    elif case == "shape":
        v = v[:, :, :4].contiguous()
    elif case == "rank":
        q = q[0]
    elif case == "window":
        kw["window"] = 0
    elif case == "device":
        q = q.to("meta")
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, v, **kw)


def test_head_dims_cover_the_slice():
    # 32: reduced configs; 64: the reference's test matrix; 128: qwen2-vl-2b
    assert HEAD_DIMS == (32, 64, 128)


def test_both_sources_build_through_one_helper():
    flash = nvcc.library_path(build.SOURCE)
    spmv = nvcc.library_path(spmv_build.SOURCE)
    assert flash.parent == spmv.parent == nvcc.BUILD_DIR
    assert flash.name.startswith("flash_attention_") and spmv.name.startswith("spmv_")
    assert build.SOURCE.is_file() and build.SOURCE.suffix == ".cu"
    assert build.SOURCE.parent.name == "csrc"
