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

The bf16 CUDA kernel sums P·V on the tensor cores with P split into
bf16 terms.  ``_emulate`` repeats its arithmetic on the CPU (bf16 q, k,
v; S from exact products with float32 sums; P split into ``n`` bf16
terms; tile-wise ``acc·alpha + pv``) and holds it to ``chip_smoke.py``'s
bound on the cases above and one qwen2-vl-2b-width head: the kernel's
term count keeps it, one term breaks it.

The float32 CUDA kernel runs on the same tensor cores, on q, k, v and P
each split into three bf16 terms, and keeps six of the nine term
products of Q·Kᵀ and of P·V.  ``_emulate_f32`` repeats that arithmetic
and holds it to ``chip_smoke.py``'s float32 bound against the float64
plain result on the cases above and one head each of qwen2-vl-2b,
stablelm-3b and whisper-medium's encoder: the kernel's counts keep it
with room, and one product or one term fewer breaks it.
"""
import contextlib
import functools
import itertools

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


@pytest.mark.parametrize("causal,window", [(True, None), (True, 6), (False, None)])
def test_plain_version_evaluates_float64_inputs_in_float64(causal, window):
    """``chip_smoke.py`` holds the float32 kernel to the plain version
    evaluated in float64: on float64 inputs it computes in float64 (within
    1e-12 of a numpy float64 softmax), while float32 inputs still compute
    in float32, as the reference's."""
    arrays = _inputs(8, 1, 4, 2, 24, 24, 32)
    q, k, v = (torch.from_numpy(a).double() for a in arrays)
    out = attention_ref(q, k, v, scale=32**-0.5, causal=causal, window=window)
    assert out.dtype == torch.float64
    qn, kn, vn = (np.repeat(a.astype(np.float64), 2, axis=1) if a.shape[1] == 2
                  else a.astype(np.float64) for a in arrays)
    sc = np.einsum("bhqd,bhkd->bhqk", qn, kn) * 32**-0.5
    d = np.arange(24)[:, None] - np.arange(24)[None, :]
    live = np.ones((24, 24), bool)
    if causal:
        live &= d >= 0
    if window is not None:
        live &= d < window
    sc = np.where(live, sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), vn)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-12, rtol=0)
    out32 = attention_ref(*_port(arrays, "float32"), scale=32**-0.5, causal=causal,
                          window=window)
    assert out32.dtype == torch.float32
    assert 0 < float((out32.double() - out).abs().max()) < 1e-5


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
    # 32: reduced configs; 64: the reference's test matrix; 80: stablelm-3b;
    # 128: starcoder2-3b, phi3-medium-14b, qwen2-vl-2b
    assert HEAD_DIMS == (32, 64, 80, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64), (False, None)])
def test_head_dim_80_matches_the_tpu_kernel(dtype, hq, hkv, causal, window):
    """stablelm-3b's head dim, which the CUDA kernel takes from this slice
    on: the plain version against the TPU kernel at the matrix's
    tolerances."""
    b, s, dh = 2, 256, 80
    arrays = _inputs(hq * 10 + hkv + dh, b, hq, hkv, s, s, dh)
    ref = jax_flash_kernel(*_jax(arrays, dtype), scale=dh**-0.5, causal=causal,
                           window=window, block_q=64, block_k=64, interpret=True)
    out = flash_attention(*_port(arrays, dtype), causal=causal, window=window)
    _close(out, ref, dtype)


def test_both_sources_build_through_one_helper():
    flash = nvcc.library_path(build.SOURCE)
    spmv = nvcc.library_path(spmv_build.SOURCE)
    assert flash.parent == spmv.parent == nvcc.BUILD_DIR
    assert flash.name.startswith("flash_attention_") and spmv.name.startswith("spmv_")
    assert build.SOURCE.is_file() and build.SOURCE.suffix == ".cu"
    assert build.SOURCE.parent.name == "csrc"


# ---------------------------------------------------------------------------
# the bf16 kernel's split of P, emulated on the CPU
# ---------------------------------------------------------------------------

# chip_smoke.py's constants
FLASH_RTOL, BF16_ROUNDING, BF16_DIFFER_SHARE = 1e-5, 2.0**-8, 1e-3
# tc::P_TERMS of csrc/flash_attention.cu (the card test
# test_bf16_kernel_reports_its_p_terms reads it from the built library)
KERNEL_P_TERMS = 3
MATRIX = [((2, hq, hkv, 256, 256, 64), hq * 10 + hkv, causal, window)
          for (hq, hkv), (causal, window) in itertools.product(
              ((4, 4), (4, 2), (8, 1)), ((True, None), (True, 64), (False, None)))]
RAGGED = [((2, 4, 2, sq, sk, 32), sq + sk, causal, window)
          for sq, sk, causal, window in ((200, 200, True, None), (200, 200, True, 64),
                                         (200, 200, False, None), (96, 160, True, None),
                                         (160, 96, True, None), (96, 160, False, 48),
                                         (1, 37, False, None))]
QWEN_HEAD = [((1, 1, 1, 1024, 1024, 128), 1024, True, None)]  # one (b, h), dh 128
STABLELM_HEAD = [((1, 1, 1, 1024, 1024, 80), 80, True, None)]  # one (b, h), dh 80
WHISPER_HEAD = [((1, 1, 1, 1500, 1500, 64), 1500, False, None)]  # one (b, h), not causal
# The float32 kernel's tc::F32_TERMS (bf16 terms of each of q, k, v and P),
# its PAIRS (i, j) of terms with i + j < 3, smallest products first
# (left_term, right_term), and tc::QK_PRODUCTS and tc::PV_PRODUCTS, the
# last pairs that Q·Kᵀ and P·V keep; the card test
# test_bf16_kernel_reports_its_p_terms reads the counts from the built library.
KERNEL_F32_TERMS = 3
KERNEL_PAIRS = ((0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0))
KERNEL_QK_PRODUCTS = KERNEL_PV_PRODUCTS = 6


@contextlib.contextmanager
def _one_thread():
    """Torch on one thread while the emulations run: their products are
    small, and beside other test workers torch's spinning threads slow
    them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _emulate(q, k, v, *, causal, window, terms, block_k=64):
    """The bf16 kernel's arithmetic on bf16 ``q, k, v``, in float32 before
    the output's rounding: per 64-key tile, S = q·kᵀ (bf16 products are
    exact in float32) times the scale, masked to -1e30; the online max,
    p = exp(s − m) on live keys, alpha = exp(m_prev − m); P split into
    ``terms`` bf16 terms, each the rounding of what the earlier ones leave;
    pv = Σ term·v in float32, smallest term first; acc = acc·alpha + pv;
    out = acc / max(l, 1e-30)."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    k = k.float().repeat_interleave(hq // hkv, dim=1)
    v = v.float().repeat_interleave(hq // hkv, dim=1)
    q = q.float()
    acc = torch.zeros(b, hq, sq, dh)
    m = torch.full((b, hq, sq, 1), -1e30)
    l = torch.zeros(b, hq, sq, 1)
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, sk, block_k):
        kpos = torch.arange(k0, min(k0 + block_k, sk))[None, :]
        mask = torch.ones(sq, kpos.shape[1], dtype=torch.bool)
        if causal:
            mask &= qpos >= kpos
        if window is not None:
            mask &= qpos - kpos < window
        s = torch.where(mask, q @ k[:, :, k0:k0 + block_k].transpose(-1, -2) * dh**-0.5,
                        torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), torch.tensor(0.0))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        m = m_new
        parts, rest = [], p
        for _ in range(terms):
            parts.append(rest.to(torch.bfloat16).float())
            rest = rest - parts[-1]
        pv = torch.zeros_like(acc)
        for part in reversed(parts):
            pv = pv + part @ v[:, :, k0:k0 + block_k]
        acc = acc * alpha + pv
    return acc / torch.clamp(l, min=1e-30)


def _split_ratios(shape, seed, causal, window, terms):
    """(worst entry of the bf16 output over chip_smoke.py's bound, worst
    entry of the float32 result before that rounding over the float32 term
    FLASH_RTOL·(|ref| + row mean|ref|), share of bf16 entries that differ
    from ``ref`` rounded to bf16), against ``ref = attention_ref`` in
    float32 on the same bf16 inputs."""
    q, k, v = _port(_inputs(seed, *shape), "bfloat16")
    ref = attention_ref(q.float(), k.float(), v.float(), scale=shape[-1] ** -0.5,
                        causal=causal, window=window)
    with _one_thread():
        raw = _emulate(q, k, v, causal=causal, window=window, terms=terms)
    mag = ref.abs()
    f32_bound = FLASH_RTOL * (mag + mag.mean(dim=-1, keepdim=True))
    out = raw.to(torch.bfloat16)
    return (float(((out.float() - ref).abs() / (f32_bound + BF16_ROUNDING * mag)).max()),
            float(((raw - ref).abs() / f32_bound).max()),
            float((out != ref.to(torch.bfloat16)).float().mean()))


@pytest.mark.parametrize("shape,seed,causal,window",
                         MATRIX + RAGGED + QWEN_HEAD + STABLELM_HEAD)
def test_the_kernels_p_terms_keep_the_bound(shape, seed, causal, window):
    """With the kernel's 3 P terms every entry keeps chip_smoke.py's bf16
    bound, and before the rounding to bf16 the float32 result keeps half
    the float32 bound (measured: at most 0.195 of it).  The tensor cores'
    own order of summation is not emulated: chip_smoke.py reads it on the
    card, as the share of bf16 entries that differ from the float32 plain
    result rounded to bf16."""
    out_ratio, raw_ratio, _ = _split_ratios(shape, seed, causal, window, KERNEL_P_TERMS)
    assert out_ratio <= 1.0
    assert raw_ratio <= 0.5


def test_one_bf16_p_term_breaks_the_bound():
    """P rounded once to bf16 (FA-3's step) misses the bound by hundreds of
    times on rows with few live keys."""
    worst = max(_split_ratios(*case, terms=1)[0] for case in MATRIX[:1] + QWEN_HEAD)
    assert worst > 1.0


def test_two_bf16_p_terms_miss_the_float32_budget():
    """Two terms carry 16 bits of P: the bf16 output still passes, the
    rounding to bf16 hides the rest, but the float32 result before it
    exceeds the float32 bound, so the kernel keeps three."""
    worst = max(_split_ratios(*case, terms=2)[1] for case in MATRIX)
    assert worst > 1.0


def test_the_differ_share_tells_two_p_terms_from_three():
    """chip_smoke.py's limit on the share of bf16 entries that differ from
    the float32 plain result rounded to bf16 sees the float32 digits the
    bound cannot: over the test matrix 3 terms keep it, 2 exceed it (the
    emulation: about 1.7e-4 and 2.0e-3)."""
    share = {terms: sum(_split_ratios(*case, terms=terms)[2] for case in MATRIX) / len(MATRIX)
             for terms in (KERNEL_P_TERMS, 2)}
    assert share[KERNEL_P_TERMS] <= BF16_DIFFER_SHARE < share[2]


# ---------------------------------------------------------------------------
# the float32 kernel's split of q, k, v and P, emulated on the CPU
# ---------------------------------------------------------------------------

def _terms(x, n):
    """``x`` as ``n`` bf16 terms (held in float32), each the rounding of
    what the earlier ones leave; three carry a float32 value exactly."""
    parts, rest = [], x
    for _ in range(n):
        parts.append(rest.to(torch.bfloat16).float())
        rest = rest - parts[-1]
    return parts


def _emulate_f32(q, k, v, *, causal, window,
                 qk_pairs=KERNEL_PAIRS[len(KERNEL_PAIRS) - KERNEL_QK_PRODUCTS:],
                 pv_pairs=KERNEL_PAIRS[len(KERNEL_PAIRS) - KERNEL_PV_PRODUCTS:],
                 terms=(KERNEL_F32_TERMS,) * 4, block_k=64):
    """The float32 kernel's arithmetic on float32 ``q, k, v``: each split
    into bf16 terms (``terms`` of q, k, v and P); per 64-key tile S = the
    sum over ``qk_pairs`` (i, j), in order, of q_i·k_jᵀ (a product of two
    bf16 terms is exact in float32; float32 sums) times the scale, masked
    to -1e30; the online max, p = exp(s − m) on live keys, alpha =
    exp(m_prev − m); P split into its terms; pv = the sum over
    ``pv_pairs`` of p_i·v_j, in order; acc = acc·alpha + pv; out = acc /
    max(l, 1e-30).  A pair naming a term past an operand's count is
    dropped."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    nq, nk, nv, n_p = terms
    qs = _terms(q, nq)
    ks = _terms(k.repeat_interleave(hq // hkv, dim=1), nk)
    vs = _terms(v.repeat_interleave(hq // hkv, dim=1), nv)
    qk_pairs = [(i, j) for i, j in qk_pairs if i < nq and j < nk]
    pv_pairs = [(i, j) for i, j in pv_pairs if i < n_p and j < nv]
    acc = torch.zeros(b, hq, sq, dh)
    m = torch.full((b, hq, sq, 1), -1e30)
    l = torch.zeros(b, hq, sq, 1)
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, sk, block_k):
        kpos = torch.arange(k0, min(k0 + block_k, sk))[None, :]
        mask = torch.ones(sq, kpos.shape[1], dtype=torch.bool)
        if causal:
            mask &= qpos >= kpos
        if window is not None:
            mask &= qpos - kpos < window
        s = torch.zeros(b, hq, sq, kpos.shape[1])
        for i, j in qk_pairs:
            s = s + qs[i] @ ks[j][:, :, k0:k0 + block_k].transpose(-1, -2)
        s = torch.where(mask, s * dh**-0.5, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), torch.tensor(0.0))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        m = m_new
        ps = _terms(p, n_p)
        pv = torch.zeros_like(acc)
        for i, j in pv_pairs:
            pv = pv + ps[i] @ vs[j][:, :, k0:k0 + block_k]
        acc = acc * alpha + pv
    return acc / torch.clamp(l, min=1e-30)


@functools.lru_cache(maxsize=None)
def _f32_case(shape, seed, causal, window):
    """Float32 inputs of a case and the float64 plain result on them, which
    chip_smoke.py holds the float32 kernel to."""
    q, k, v = _port(_inputs(seed, *shape), "float32")
    ref = attention_ref(q.double(), k.double(), v.double(), scale=shape[-1] ** -0.5,
                        causal=causal, window=window)
    return q, k, v, ref


def _f32_ratio(shape, seed, causal, window, **emulate):
    """Worst entry of the emulated float32 kernel over chip_smoke.py's
    float32 bound, FLASH_RTOL·(|ref| + row mean|ref|) against the float64
    plain result."""
    q, k, v, ref = _f32_case(shape, seed, causal, window)
    with _one_thread():
        out = _emulate_f32(q, k, v, causal=causal, window=window, **emulate).double()
    mag = ref.abs()
    return float(((out - ref).abs() / (FLASH_RTOL * (mag + mag.mean(dim=-1, keepdim=True))))
                 .max())


@pytest.mark.parametrize("shape,seed,causal,window",
                         MATRIX + RAGGED + QWEN_HEAD + STABLELM_HEAD + WHISPER_HEAD)
def test_the_f32_kernels_terms_keep_the_bound(shape, seed, causal, window):
    """With the kernel's terms and products every entry keeps half the
    float32 bound against the float64 plain result (measured: at most 0.14
    of it).  The tensor cores' own order and rounding of their sums are not
    emulated: chip_smoke.py holds the kernel to the same bound on the
    card."""
    assert _f32_ratio(shape, seed, causal, window) <= 0.5


@pytest.mark.parametrize("side", ["qk", "pv"])
@pytest.mark.parametrize("pair", KERNEL_PAIRS)
def test_one_f32_product_fewer_breaks_the_bound(side, pair):
    """Each of the six products of Q·Kᵀ, and of P·V, is needed: without it
    some entry of the reference's test matrix passes the float32 bound
    (measured: at least 1.33 times it, without p_2·v_0)."""
    kept = tuple(p for p in KERNEL_PAIRS if p != pair)
    worst = max(_f32_ratio(*case, **{f"{side}_pairs": kept}) for case in MATRIX)
    assert worst > 1.0


@pytest.mark.parametrize("operand", range(4))
def test_one_f32_term_fewer_breaks_the_bound(operand):
    """Two bf16 terms of q, of k, of v or of P (the products on its third
    dropped) carry 16 of float32's 24 bits: the test matrix passes the
    float32 bound (measured: 1.33 times it at the least, P)."""
    terms = [KERNEL_F32_TERMS] * 4
    terms[operand] -= 1
    worst = max(_f32_ratio(*case, terms=tuple(terms)) for case in MATRIX)
    assert worst > 1.0
